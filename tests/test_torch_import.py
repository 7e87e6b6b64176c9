"""The port never imports jax: a fresh interpreter that refuses every jax
import loads the whole port (and what chip_smoke.py imports), decodes one
CPU window, and one lockstep round of two streams."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_CHILD = r"""
import sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"jax is blocked: {name}")

sys.meta_path.insert(0, _NoJax())

import mpeg_tpu_torch
import mpeg_tpu_torch.device
import mpeg_tpu_torch.ops._build
import mpeg_tpu_torch.ops.color
import mpeg_tpu_torch.ops.cuda_kernels
import mpeg_tpu_torch.ops.video_recon
import mpeg_tpu_torch.parallel
import mpeg_tpu_torch.parallel.multistream
import mpeg_tpu_torch.testing
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
# What chip_smoke.py imports besides the port.
import chip_smoke
import mpeg_tpu.native
import mpeg_tpu.utils.profiling

data = open("tests/testdata/test.mpeg1video", "rb").read()
dec = BatchVideoDecoder(data, window=8, device="cpu")
frames = dec.decode_window()
assert len(frames) == 7, len(frames)          # the reference delay
assert all(f.device.type == "cpu" for f in frames)
ms = MultiStreamVideoDecoder([data[:40000], data[:30000]], window=4,
                             device="cpu")
rnd = ms.decode_window()
assert [len(r) for r in rnd] == [3, 3], rnd   # the reference delay
rgba = MultiStreamVideoDecoder([data[:30000]], window=4, device="cpu",
                               emit_rgba=True).decode_window()
assert rgba[0][0].shape == (120, 160, 4), rgba[0][0].shape
probe = mpeg_tpu_torch.probe()
assert probe["torch"] and "cuda_available" in probe
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not loaded, loaded
print("OK", len(frames))
"""


def test_port_imports_and_decodes_without_jax():
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK 7"), r.stdout


def test_port_sources_name_no_jax():
    """No source file of the port, nor chip_smoke.py, imports jax, even
    lazily."""
    for path in [*(REPO / "mpeg_tpu_torch").rglob("*.py"),
                 REPO / "chip_smoke.py"]:
        text = path.read_text()
        for needle in ("import jax", "from jax", "jax.numpy"):
            assert needle not in text, f"{path}: {needle}"
