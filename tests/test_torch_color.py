"""The port's YCbCr -> RGBA conversion against the JAX package's: every
(y, cb, cr) triple through `ycbcr_to_rgb_int` against its numpy path,
and `emit_rgba=True` decodes against the JAX decoders'.  Tolerance: exact
equality (all integer arithmetic)."""

import numpy as np
import pytest
import torch

from mpeg_tpu import native
from mpeg_tpu.ops import color as jcolor
from mpeg_tpu.ops.video_recon import FrameGeometry
from mpeg_tpu.parallel import BatchVideoDecoder as JaxBatchVideoDecoder
from mpeg_tpu.parallel import MultiStreamVideoDecoder as JaxMultiStream
from mpeg_tpu_torch.ops import color
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
from torch_threads import one_torch_thread  # noqa: F401


def test_every_ycbcr_triple_matches_numpy():
    """All 2^24 triples, 16 values of y at a time."""
    cb, cr = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    tcb, tcr = torch.from_numpy(cb), torch.from_numpy(cr)
    for y0 in range(0, 256, 16):
        y = np.broadcast_to(np.arange(y0, y0 + 16, dtype=np.uint8)
                            [:, None, None], (16, 256, 256))
        want = jcolor.ycbcr_to_rgb_int(y, cb, cr, np)
        got = color.ycbcr_to_rgb_int(torch.from_numpy(y.copy()), tcb, tcr)
        for name, g, w in zip("rgb", got, want):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name} "
                                          f"y in [{y0}, {y0 + 16})")


@pytest.mark.parametrize("size", [(160, 120), (75, 45)])
def test_flat_frame_to_rgba_matches_numpy(size):
    """Random frames, one at a time and batched, at an MB-aligned size
    and at an odd one whose chroma upsample is cropped."""
    geom = FrameGeometry.for_size(*size)
    rng = np.random.default_rng(size[0])
    frames = rng.integers(0, 256, (3, geom.total_size)).astype(np.uint8)
    got = color.flat_frame_to_rgba(torch.from_numpy(frames), geom)
    assert got.shape == (3, geom.height, geom.width, 4)
    for i, f in enumerate(frames):
        want = jcolor.flat_frame_to_rgba(f, geom, np)
        np.testing.assert_array_equal(got[i].numpy(), want)
        np.testing.assert_array_equal(
            color.flat_frame_to_rgba(torch.from_numpy(f), geom).numpy(), want)


def test_batch_decoder_rgba_matches_jax(mpeg1video_path):
    """Every displayed frame, the end-of-stream flush frame included."""
    data = open(mpeg1video_path, "rb").read()[:60000]
    want = [np.asarray(f) for f in
            JaxBatchVideoDecoder(data, window=8, emit_rgba=True).decode_all()]
    dec = BatchVideoDecoder(data, window=8, device="cpu", emit_rgba=True)
    got = dec.decode_all()
    assert len(got) == len(want) > 8
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (120, 160, 4) and a.dtype == torch.uint8
        assert np.array_equal(a.numpy(), b), f"frame {i}"


@pytest.mark.skipif(not native.available(), reason="needs the native parser")
def test_multistream_rgba_matches_jax(mpeg1video_path, mpg_path):
    es = open(mpeg1video_path, "rb").read()
    ps = open(mpg_path, "rb").read()
    sources = [es[:len(es) // 5], ps[:len(ps) // 4]]
    want = JaxMultiStream(sources, window=4, emit_rgba=True).decode_all()
    got = MultiStreamVideoDecoder(sources, window=4, emit_rgba=True,
                                  device="cpu").decode_all()
    for s in range(len(sources)):
        assert len(got[s]) == len(want[s]) > 0, f"stream {s}"
        for i, (a, b) in enumerate(zip(got[s], want[s])):
            # The reference's round displays come back flattened (its
            # reshape(S, window, -1)), its flush frame as [H, W, 4]; the
            # port's are all [H, W, 4].
            assert a.shape == (120, 160, 4)
            assert np.array_equal(a.numpy().reshape(-1),
                                  np.asarray(b).reshape(-1)), (s, i)
