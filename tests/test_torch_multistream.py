"""The port's `MultiStreamVideoDecoder` on the CPU (plain versions of the
kernels) against the JAX package's on the same sources: N streams in
lockstep through one global record chain.  Tolerance: exact equality of
every displayed frame."""

import numpy as np
import pytest
import torch

from mpeg_tpu import native
from mpeg_tpu.parallel import MultiStreamVideoDecoder as JaxMultiStream
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="needs the native parser")


def _mixed(mpeg1video_path, mpg_path, cut=1):
    """tests/test_multistream.py's mixed batch (raw ES, MPEG-PS, a
    truncated stream, a duplicate), each cut to 1/cut of its bytes."""
    es = open(mpeg1video_path, "rb").read()
    ps = open(mpg_path, "rb").read()
    es, ps = es[:len(es) // cut], ps[:len(ps) // cut]
    return [es, ps, es[:len(es) // 3], es]


def _assert_streams_equal(got, want, fs):
    assert len(got) == len(want)
    for s, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) > 0, f"stream {s} frame count"
        for i, (a, b) in enumerate(zip(g, w)):
            assert np.array_equal(np.asarray(a)[:fs], np.asarray(b)[:fs]), \
                f"stream {s} frame {i}"


def test_multistream_matches_jax(mpeg1video_path, mpg_path):
    """Every stream of the mixed batch equals the JAX decoder's, with the
    per-stream flushes at different rounds and the pool growth from the
    minimum buckets; and equals the port's solo decoder."""
    sources = _mixed(mpeg1video_path, mpg_path)
    want = JaxMultiStream(sources, window=4).decode_all()
    cuda_kernels.reset_launches()
    ms = MultiStreamVideoDecoder(sources, window=4, device="cpu")
    got = ms.decode_all()
    assert cuda_kernels.reconstruct_picture.launches == 0   # CPU: plain
    assert all(f.device.type == "cpu" for g in got for f in g)
    _assert_streams_equal(got, want, ms.geom.frame_size)
    assert len(got[2]) < len(got[0]) == len(got[3])
    solo = BatchVideoDecoder(sources[1], window=4, device="cpu").decode_all()
    _assert_streams_equal(got[1:2], [solo], ms.geom.frame_size)


def test_multistream_chunks_change_no_byte(mpeg1video_path):
    es = open(mpeg1video_path, "rb").read()
    sources = [es[:len(es) // 3], es[:len(es) // 4]]
    want = MultiStreamVideoDecoder(sources, window=8, chunks=1,
                                   device="cpu").decode_all()
    ms = MultiStreamVideoDecoder(sources, window=8, chunks=2, device="cpu")
    assert ms.chunks == 2
    _assert_streams_equal(ms.decode_all(), want, ms.geom.frame_size)


def test_multistream_prefetch_matches_inline(mpeg1video_path, mpg_path):
    sources = _mixed(mpeg1video_path, mpg_path, cut=3)[:3]
    want = MultiStreamVideoDecoder(sources, window=4,
                                   device="cpu").decode_all()
    got = MultiStreamVideoDecoder(sources, window=4, prefetch=True,
                                  device="cpu").decode_all()
    _assert_streams_equal(got, want, None)


def test_fill_matches_jax_fill(mpeg1video_path, mpg_path):
    """The port's copy of the reference's `_fill` (only the reuse gate
    differs) packs byte-equal slots: metadata + escapes, main records,
    picture types, fill and buckets, window after window, through the
    pool growth."""
    sources = _mixed(mpeg1video_path, mpg_path, cut=2)
    jax_ms = JaxMultiStream(sources, window=4)
    port_ms = MultiStreamVideoDecoder(sources, window=4, device="cpu")
    rounds = 0
    while True:
        js, jtypes, jnm, jcaps = jax_ms._fill()
        ps, ptypes, pnm, pcaps = port_ms._fill()
        assert (pnm, pcaps) == (jnm, jcaps), f"round {rounds}"
        np.testing.assert_array_equal(ptypes, jtypes)
        np.testing.assert_array_equal(ps.meta, js.meta)
        np.testing.assert_array_equal(ps.main, js.main)
        js.evt.set()
        ps.evt.set()
        rounds += 1
        if not jtypes.any():
            break
    assert rounds > 3 and port_ms._kmg > 4096   # the buckets grew


def test_span_overflow_raises_value_error(mpeg1video_path):
    es = open(mpeg1video_path, "rb").read()
    # 160x120: 80 macroblocks, 30,720 coefficients a picture.
    with pytest.raises(ValueError, match="span"):
        MultiStreamVideoDecoder([es, es], window=35_000, device="cpu")
    with pytest.raises(ValueError):
        MultiStreamVideoDecoder([es], window=0, device="cpu")


def test_recon_choices(mpeg1video_path):
    es = open(mpeg1video_path, "rb").read()[:20000]
    with pytest.raises(ValueError):
        MultiStreamVideoDecoder([es], recon="mosaic", device="cpu")
    if not torch.cuda.is_available():
        # The default device is the card, never a CPU fallback.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MultiStreamVideoDecoder([es])
    with pytest.raises(TypeError):
        MultiStreamVideoDecoder([es], device=None)
    ms = MultiStreamVideoDecoder([es], recon="xla", device="cpu")
    assert ms.decode_window() is not None


def test_global_window_tables_rotate_slots():
    """The host's slot rotation: a reference picture's out slot becomes
    backward and the old current frees up; a B picture's becomes
    current; a padding step runs nothing and displays current."""
    from mpeg_tpu.ops.video_recon import FrameGeometry
    from mpeg_tpu_torch.parallel.multistream import (
        GlobalWindowDecoder, initial_carry)

    geom = FrameGeometry.for_size(32, 32)
    dec = GlobalWindowDecoder(geom, 2, 3, 4096, 64, 1)
    _, slots = initial_carry(geom, 2, "cpu")
    # stream 0: I (ref), B, padding; stream 1: P (ref), P (ref), B.
    flags = np.array([3, 2, 0, 3, 3, 2], np.int32)
    table, disp, after = dec.step_tables(slots, flags)
    np.testing.assert_array_equal(table[:, 0], [[0, 2, 2, 3, 0],
                                                [1, 2, 3, 0, 1],
                                                [0, 2, 3, 1, -1]])
    np.testing.assert_array_equal(disp[:, 0], [2, 0, 0])
    np.testing.assert_array_equal(after[0], [0, 2, 3, 1])
    np.testing.assert_array_equal(table[:, 1], [[4, 6, 6, 7, 3],
                                                [5, 7, 7, 4, 4],
                                                [6, 7, 4, 5, 5]])
    np.testing.assert_array_equal(disp[:, 1], [6, 7, 5])
    np.testing.assert_array_equal(after[1], [5, 7, 4, 6])
    np.testing.assert_array_equal(slots, [[0, 1, 2, 3], [4, 5, 6, 7]])
