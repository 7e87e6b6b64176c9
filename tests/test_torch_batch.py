"""The port's `BatchVideoDecoder` end to end on the CPU (plain versions of
the kernels), against the JAX package and the C++ host decoder on the
same bytes.  Tolerance: exact equality of every displayed frame."""

import pathlib

import numpy as np
import pytest
import torch

import mpeg_tpu as mpeg
from mpeg_tpu.native import NativeHostDecoder
from mpeg_tpu.parallel import BatchVideoDecoder as JaxBatchVideoDecoder
from mpeg_tpu.parallel import batch as jb
from mpeg_tpu.utils import Fnv1a64
from mpeg_tpu.utils.profiling import DecodeStats
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.parallel import BatchVideoDecoder, WindowDecoder
from torch_threads import one_torch_thread  # noqa: F401

TESTDATA = pathlib.Path(__file__).parent / "testdata"
GOLDEN_VIDEO_HASH = 0xEA6D7FCB1340BA3F
# test.mpg through the native PS pipeline: 278 frames, FNV-1a over each
# frame's frame_size bytes (chip_smoke.py checks the same constant).
PS_VIDEO_FRAMES, PS_VIDEO_HASH = 278, 0xD00818EDCAFDC702


def _digest(frames, geom):
    h = Fnv1a64()
    for f in frames:
        h.write(np.asarray(f)[:geom.frame_size].tobytes())
    return h.sum64()


@pytest.mark.parametrize("source", ["native", "native_prefetch", "buffer"])
def test_fixture_golden(source, mpeg1video_path):
    stats = DecodeStats()
    if source == "buffer":
        buf = mpeg.Buffer(open(mpeg1video_path, "rb"))
        buf.set_load_callback(buf.load_reader_callback)
        dec = BatchVideoDecoder(buf, window=16, device="cpu", stats=stats)
    else:
        dec = BatchVideoDecoder(open(mpeg1video_path, "rb").read(),
                                window=16, device="cpu", stats=stats,
                                prefetch=source == "native_prefetch")
    frames = [f.numpy() for f in dec.decode_all()]
    assert len(frames) == 260
    assert stats.frames == 261   # pictures parsed, as the JAX decoder counts
    assert all(f.shape == (dec.geom.total_size,) for f in frames)
    assert _digest(frames, dec.geom) == GOLDEN_VIDEO_HASH


def test_ps_matches_jax_decoder(mpg_path):
    data = open(mpg_path, "rb").read()
    want = [np.asarray(f) for f in JaxBatchVideoDecoder(data, window=16)
            .decode_all()]
    dec = BatchVideoDecoder(data, window=16, device="cpu")
    got = [f.numpy() for f in dec.decode_all()]
    assert len(got) == len(want) == PS_VIDEO_FRAMES
    for n, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), f"frame {n} differs"
    assert _digest(got, dec.geom) == PS_VIDEO_HASH


@pytest.mark.parametrize("window", [2, 16])
def test_at_time_clip_matches_jax_decoder(window, mpg_path):
    """A random-access clip (the inherited `at_time`) through the port:
    the open-GOP B-drop and the reference delay, which the port's window
    step repeats, give the JAX decoder's frames, also at a window whose
    first displays are all absorbed."""
    data = open(mpg_path, "rb").read()
    jdec, jpts = JaxBatchVideoDecoder.at_time(data, 4.0, window=window)
    want = [np.asarray(f) for f in jdec.decode_all()]
    dec, pts = BatchVideoDecoder.at_time(data, 4.0, window=window,
                                         device="cpu")
    got = [f.numpy() for f in dec.decode_all()]
    assert pts == jpts
    assert 100 < len(got) == len(want) < 230
    for n, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), f"frame {n} differs"


def test_first_24_pictures_match_pallas_scan(mpeg1video_path):
    """One 24-picture window blob through the JAX package's blob scan
    with the Pallas reconstruct (interpret mode) and through the port's
    window decoder: every display step equal."""
    import jax.numpy as jnp

    buf = mpeg.Buffer(open(mpeg1video_path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    video = mpeg.Video(buf, backend="plan")
    geom = video.geom
    plans = [video.parse_next_plan() for _ in range(24)]
    window = len(plans)
    nm, ne = jb.count_pool_records(plans)
    km, ke = jb.pool_bucket(nm, 4096), jb.pool_bucket(max(ne, 1), 64)
    blob = jb.pack_plans_blob(plans, geom, window, km, ke)

    scan = jb.make_blob_scan_decoder(geom, window, km, ke, recon="pallas")
    carry = tuple(jnp.zeros(geom.total_size, jnp.uint8) for _ in range(3))
    want_carry, want = scan(carry, blob)

    split = jb.blob_split(geom, window, km, ke)
    flags = jb.blob_views(blob, geom, window, km, ke)["flags"].copy()
    tcarry = tuple(torch.zeros(geom.total_size, dtype=torch.uint8)
                   for _ in range(3))
    got_carry, got = WindowDecoder(geom, window, km, ke)(
        tcarry, torch.from_numpy(blob[:split]),
        torch.from_numpy(blob[split:]), flags)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(got_carry, want_carry):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_load_carry_continues_jax_stream(mpeg1video_path):
    """The JAX decoder decodes the first window; its carry and picture
    types go to the port, which decodes the rest of the stream (sequence
    header + the bytes from the next picture on) and ends on the
    golden."""
    data = open(mpeg1video_path, "rb").read()
    jd = JaxBatchVideoDecoder(data, window=16)
    frames = [np.asarray(f) for f in jd.decode_window()]
    parsed = len(jd._types)
    pos = -1
    for _ in range(parsed + 1):   # the start code of picture parsed+1
        pos = data.find(b"\x00\x00\x01\x00", pos + 1)
    rest = jb._extract_sequence_header(data) + data[pos:]

    dec = BatchVideoDecoder(rest, window=16, device="cpu")
    dec.load_carry([np.asarray(f) for f in jd._carry], jd._types)
    frames += [f.numpy() for f in dec.decode_all()]
    assert len(frames) == 260
    assert _digest(frames, dec.geom) == GOLDEN_VIDEO_HASH


def test_load_carry_rejects_wrong_geometry(mpeg1video_path):
    dec = BatchVideoDecoder(open(mpeg1video_path, "rb").read(), window=4,
                            device="cpu")
    with pytest.raises(ValueError):
        dec.load_carry([np.zeros(100, np.uint8)] * 3)
    with pytest.raises(ValueError):
        dec.load_carry([np.zeros(dec.geom.total_size, np.int32)] * 3)


def test_1080p_fixture_matches_native_host_decoder():
    data = (TESTDATA / "test1080.m1v").read_bytes()
    ref = NativeHostDecoder(data)
    want = []
    while (f := ref.decode_next()) is not None:
        want.append(f)
    cuda_kernels.reset_launches()
    dec = BatchVideoDecoder(data, window=16, device="cpu")
    assert (dec.geom.width, dec.geom.height) == (1920, 1080)
    got = [f.numpy() for f in dec.decode_all()]
    assert len(got) == len(want) == 32
    fs = dec.geom.frame_size
    for n, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a[:fs], b[:fs]), f"frame {n} differs"
    assert cuda_kernels.reconstruct_picture.launches == 0   # CPU: plain


def test_streaming_feed_matches_whole_buffer(mpeg1video_path):
    data = open(mpeg1video_path, "rb").read()
    whole = [f.numpy() for f in BatchVideoDecoder(
        data, window=8, device="cpu").decode_all()]
    dec = BatchVideoDecoder(b"", window=8, device="cpu", streaming=True,
                            use_native=True)
    got = []
    for i in range(0, len(data), 30011):
        dec.feed(data[i:i + 30011])
        got.extend(f.numpy() for f in dec.decode_window())
    dec.signal_end()
    while chunk := dec.decode_window():
        got.extend(f.numpy() for f in chunk)
    assert len(got) == len(whole) == 260
    for n, (a, b) in enumerate(zip(got, whole)):
        assert np.array_equal(a, b), f"frame {n} differs"


def test_device_is_explicit(mpeg1video_path):
    """The entry points default to the card; "cuda" (given or by
    default) without a card raises instead of running on the CPU, and no
    device is picked from None."""
    from mpeg_tpu_torch.parallel import carry_from_numpy

    data = open(mpeg1video_path, "rb").read()
    with pytest.raises(TypeError):
        BatchVideoDecoder(data, window=4, device=None)
    with pytest.raises(ValueError):
        BatchVideoDecoder(data, window=4, device="meta")
    frames = [np.zeros(16, np.uint8)] * 3
    if not torch.cuda.is_available():
        for make in (lambda: BatchVideoDecoder(data, window=4,
                                               device="cuda"),
                     lambda: BatchVideoDecoder(data, window=4),
                     lambda: carry_from_numpy(frames)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
    else:
        assert BatchVideoDecoder(data, window=4).device.type == "cuda"
        assert carry_from_numpy(frames)[0].device.type == "cuda"


def test_unported_options_raise(mpeg1video_path):
    """Every option of the JAX decoder is ported: RGBA output
    (tests/test_torch_color.py) and the dense transport
    (tests/test_torch_dense.py) no longer raise.  The dense transport
    still refuses the native parse, as the reference does."""
    data = open(mpeg1video_path, "rb").read()
    assert BatchVideoDecoder(data, window=4, device="cpu",
                             emit_rgba=True).emit_rgba
    assert BatchVideoDecoder(data, window=4, device="cpu", transport="dense",
                             use_native=False).transport == "dense"
    with pytest.raises(ValueError, match="use_native=False"):
        BatchVideoDecoder(data, window=4, device="cpu", transport="dense",
                          use_native=True)
