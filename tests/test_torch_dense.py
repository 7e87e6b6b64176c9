"""The port's dense transport (`stack_plans`, the dense window module,
`BatchVideoDecoder(transport="dense")`) on the CPU, against the JAX
package's dense scan on the same plans.  Tolerance: exact equality of
every array, carry frame and displayed frame."""

import numpy as np
import pytest
import torch

import mpeg_tpu as mpeg
from mpeg_tpu.parallel import batch as jb
from mpeg_tpu.utils import Fnv1a64
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.parallel import (BatchVideoDecoder, make_scan_decoder,
                                     make_dense_scan_decoder)
from mpeg_tpu_torch.parallel import batch as tb
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN_VIDEO_HASH = 0xEA6D7FCB1340BA3F


def _plans(path, n):
    buf = mpeg.Buffer(open(path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    video = mpeg.Video(buf, backend="plan")
    return video.geom, [video.parse_next_plan() for _ in range(n)]


def test_stack_plans_matches_jax(mpeg1video_path):
    geom, plans = _plans(mpeg1video_path, 5)
    want = jb.stack_plans(plans, geom, 8)       # 3 no-op pad steps
    got = tb.stack_plans(plans, geom, 8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError):
        tb.stack_plans(plans, geom, 4)


def test_dense_window_matches_jax(mpeg1video_path):
    """Two windows (the second padded with no-op steps) through the JAX
    dense scan and the port's dense window decode: carry and displays
    equal, with one K1 call a valid picture (the plain version here)."""
    import jax.numpy as jnp

    geom, plans = _plans(mpeg1video_path, 11)
    window = 6
    scan = jb.make_dense_scan_decoder(geom)
    dec = make_dense_scan_decoder(geom, device="cpu")
    assert make_scan_decoder is make_dense_scan_decoder
    jcarry = tuple(jnp.zeros(geom.total_size, jnp.uint8) for _ in range(3))
    carry = tuple(torch.zeros(geom.total_size, dtype=torch.uint8)
                  for _ in range(3))
    for part in (plans[:window], plans[window:]):
        stacked = jb.stack_plans(part, geom, window)
        jcarry, want = scan(jcarry, stacked)
        carry, got = dec(carry, tb.stack_plans(part, geom, window))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for a, b in zip(carry, jcarry):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _digest(frames, geom):
    h = Fnv1a64()
    for f in frames:
        h.write(f[:geom.frame_size].numpy().tobytes())
    return h.sum64()


def test_dense_decoder_golden_and_equals_blob(mpeg1video_path):
    data = open(mpeg1video_path, "rb").read()
    dense = BatchVideoDecoder(data, window=16, transport="dense",
                              use_native=False, device="cpu")
    got = dense.decode_all()
    assert len(got) == 260
    assert _digest(got, dense.geom) == GOLDEN_VIDEO_HASH
    blob = BatchVideoDecoder(data, window=16, device="cpu").decode_all()
    assert all(a.equal(b) for a, b in zip(got, blob))


def test_dense_decoder_rgba_equals_blob(mpeg1video_path):
    """RGBA output and the end-of-stream flush through the dense
    transport, on a truncated stream: equal to the blob transport's."""
    data = open(mpeg1video_path, "rb").read()[:40000]
    cuda_kernels.reset_launches()
    got = BatchVideoDecoder(data, window=8, transport="dense",
                            use_native=False, device="cpu",
                            emit_rgba=True).decode_all()
    want = BatchVideoDecoder(data, window=8, device="cpu",
                             emit_rgba=True).decode_all()
    assert len(got) == len(want) > 8
    assert got[0].shape == (120, 160, 4)
    assert all(a.equal(b) for a, b in zip(got, want))
    assert cuda_kernels.reconstruct_picture.launches == 0   # CPU: plain


def test_dense_leading_b_drop_equals_blob(mpeg1video_path):
    """The open-GOP B drop that `at_time` turns on (its clips are program
    streams, which only the native parse reads) behaves the same through
    the dense transport: a stream cut at its second GOP, both transports
    with the drop on, give the same frames."""
    data = open(mpeg1video_path, "rb").read()
    first = data.find(b"\x00\x00\x01\xB8")
    gop = data.find(b"\x00\x00\x01\xB8", first + 4)
    clip = tb._extract_sequence_header(data) + data[gop:gop + 30000]
    out = {}
    for transport in ("dense", "blob"):
        dec = BatchVideoDecoder(clip, window=8, transport=transport,
                                use_native=False, device="cpu")
        dec._drop_leading_b = True
        out[transport] = dec.decode_all()
    plain = BatchVideoDecoder(clip, window=8, use_native=False,
                              device="cpu").decode_all()
    assert 0 < len(out["dense"]) == len(out["blob"]) < len(plain)
    assert all(a.equal(b) for a, b in zip(out["dense"], out["blob"]))


def test_dense_needs_python_parse(mpeg1video_path):
    data = open(mpeg1video_path, "rb").read()
    with pytest.raises(ValueError, match="use_native=False"):
        BatchVideoDecoder(data, window=4, transport="dense", device="cpu")
    with pytest.raises(ValueError, match="use_native=False"):
        BatchVideoDecoder(data, window=4, transport="dense", device="cpu",
                          use_native=True)
    with pytest.raises(ValueError, match="unknown transport"):
        BatchVideoDecoder(data, window=4, transport="xla", device="cpu")
    if not torch.cuda.is_available():
        geom, _ = _plans(mpeg1video_path, 0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_dense_scan_decoder(geom)
