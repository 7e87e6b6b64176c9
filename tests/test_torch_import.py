"""The port stands alone: a fresh interpreter that refuses every import of
jax, of the JAX package `mpeg_tpu` and of its `native` sources loads the
whole port and chip_smoke.py, decodes CPU windows (native and Python
parse), lockstep rounds of two streams, a sharded window over a mesh of
two CPU devices, and video frames and audio through `MPEG` and `Audio`,
and ends with none of them loaded."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_CHILD = r"""
import sys

_BLOCKED = ("jax", "jaxlib", "mpeg_tpu", "native")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, _Block())

import mpeg_tpu_torch
import mpeg_tpu_torch._spec_tables
import mpeg_tpu_torch.audio
import mpeg_tpu_torch.buffer
import mpeg_tpu_torch.config
import mpeg_tpu_torch.demux
import mpeg_tpu_torch.device
import mpeg_tpu_torch.mpeg
import mpeg_tpu_torch.native
import mpeg_tpu_torch.ops._build
import mpeg_tpu_torch.ops.color
import mpeg_tpu_torch.ops.cuda_kernels
import mpeg_tpu_torch.ops.filterbank
import mpeg_tpu_torch.ops.video_recon
import mpeg_tpu_torch.parallel
import mpeg_tpu_torch.parallel._runahead
import mpeg_tpu_torch.parallel.audio_batch
import mpeg_tpu_torch.parallel.multihost
import mpeg_tpu_torch.parallel.multistream
import mpeg_tpu_torch.parallel.sharding
import mpeg_tpu_torch.pipeline
import mpeg_tpu_torch.tables
import mpeg_tpu_torch.testing
import mpeg_tpu_torch.utils
import mpeg_tpu_torch.utils.profiling
import mpeg_tpu_torch.video
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
import chip_smoke

data = open("tests/testdata/test.mpeg1video", "rb").read()
dec = BatchVideoDecoder(data, window=8, device="cpu")
frames = dec.decode_window()
assert len(frames) == 7, len(frames)          # the reference delay
assert all(f.device.type == "cpu" for f in frames)
py = BatchVideoDecoder(data[:30000], window=8, device="cpu",
                       use_native=False).decode_window()
assert len(py) == 7 and all(a.equal(b) for a, b in zip(py, frames))
ms = MultiStreamVideoDecoder([data[:40000], data[:30000]], window=4,
                             device="cpu")
rnd = ms.decode_window()
assert [len(r) for r in rnd] == [3, 3], rnd   # the reference delay
rnd = ms.decode_window()
assert [len(r) for r in rnd] == [4, 4], rnd
rgba = MultiStreamVideoDecoder([data[:30000]], window=4, device="cpu",
                               emit_rgba=True).decode_window()
assert rgba[0][0].shape == (120, 160, 4), rgba[0][0].shape
m = mpeg_tpu_torch.MPEG(open("tests/testdata/test.mpg", "rb"), device="cpu")
f = m.decode_video()
assert f.y.shape == (128, 160) and f.flat.device.type == "cpu", f.y.shape
assert m.decode_audio().interleaved.shape == (2304,)
buf = mpeg_tpu_torch.Buffer(open("tests/testdata/test.mp2", "rb"))
buf.set_load_callback(buf.load_reader_callback)
a = mpeg_tpu_torch.Audio(buf, device="cpu")
assert a.decode().s16.dtype.name == "int16"
from mpeg_tpu_torch.parallel import sharding as sh
from mpeg_tpu_torch.parallel.batch import count_pool_records, pool_bucket
videos = [mpeg_tpu_torch.Video(mpeg_tpu_torch.Buffer(open(
    "tests/testdata/test.mpeg1video", "rb")), "plan") for _ in range(2)]
for v in videos:
    v.buf.set_load_callback(v.buf.load_reader_callback)
per_stream = [[v.parse_next_plan() for _ in range(3)] for v in videos]
km = pool_bucket(max(count_pool_records(p)[0] for p in per_stream), 4096)
mesh = sh.make_mesh(["cpu", "cpu"])
decode = sh.make_sharded_blob_decoder(videos[0].geom, mesh, 3, km, 64)
carry, disps, px = decode(sh.zero_carry(videos[0].geom, 2, mesh),
                          sh.stack_stream_blobs(per_stream, videos[0].geom,
                                                3, km, 64))
assert len(disps) == 2 and disps[1].shape == (1, 3, 33280), disps[1].shape
assert int(px) == 6 * videos[0].geom.frame_size and disps[1].any()
probe = mpeg_tpu_torch.probe()
assert probe["torch"] and "cuda_available" in probe
loaded = sorted(m for m in sys.modules if m.split(".")[0] in _BLOCKED)
assert not loaded, loaded
print("OK", len(frames))
"""


def test_port_imports_and_decodes_without_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK 7"), r.stdout


# An import of jax, of the JAX package (`mpeg_tpu`, not `mpeg_tpu_torch`)
# or of its `native` sources, at any indentation (lazy imports too).
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|mpeg_tpu(?![\w])|native\b)"
    r"|jax\.numpy", re.M)


def test_port_sources_name_no_jax():
    """No source file of the port, nor its examples or chip_smoke.py,
    imports jax, the JAX package or its native sources, even lazily."""
    paths = [*(REPO / "mpeg_tpu_torch").rglob("*.py"),
             *(REPO / "examples_torch").glob("*.py"), REPO / "chip_smoke.py"]
    assert len(paths) > 30
    for path in paths:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_the_package_not_the_port():
    for bad in ("import mpeg_tpu", "from mpeg_tpu.native import X",
                "    from mpeg_tpu import tables", "import native",
                "from native import parser", "import jax.numpy as jnp"):
        assert _FORBIDDEN.search(bad), bad
    for good in ("import mpeg_tpu_torch", "from mpeg_tpu_torch import x",
                 "from . import native", "from .native import load",
                 "    from .. import native as native_mod"):
        assert not _FORBIDDEN.search(good), good
