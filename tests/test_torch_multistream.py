"""The port's `MultiStreamVideoDecoder` on the CPU (plain versions of the
kernels) against the JAX package's on the same sources: N streams in
lockstep through one global record chain.  Tolerance: exact equality of
every displayed frame."""

import gc
import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from mpeg_tpu import native
from mpeg_tpu.parallel import MultiStreamVideoDecoder as JaxMultiStream
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
from mpeg_tpu_torch.parallel import multistream as tm
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="needs the native parser")
TESTDATA = pathlib.Path(__file__).parent / "testdata"


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


def _fill_rounds(jax_ms, port_ms):
    """Fill both decoders' slots round after round until every stream is
    dry, holding the port's to the JAX package's byte for byte; returns
    the rounds."""
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
            return rounds


@pytest.mark.parametrize("workers", [1, 2, 3, None],
                         ids=["1", "2", "3", "default"])
def test_fill_on_workers_matches_jax_fill(mpeg1video_path, mpg_path,
                                          workers):
    """The fill parsed on 1, 2, 3 and the default number of threads packs
    the slots the JAX package's one-thread `_fill` packs, through the
    pool growth from the minimum buckets."""
    sources = _mixed(mpeg1video_path, mpg_path, cut=2)
    port_ms = MultiStreamVideoDecoder(sources, window=4, device="cpu")
    port_ms._parse_workers = workers
    rounds = _fill_rounds(JaxMultiStream(sources, window=4), port_ms)
    assert rounds > 3 and port_ms._kmg > 4096   # the buckets grew
    want = workers or min(tm._physical_cores(), len(sources))
    assert port_ms._parse_workers == want
    assert len(port_ms._pool._threads) == want - 1
    port_ms.close()


def _skipped_p_picture(mb_width: int, mb_height: int) -> bytes:
    """An MPEG-1 P-picture whose macroblocks are all skipped: one slice,
    the first and the last macroblock forward-predicted with a zero
    vector and no coded block, every one between skipped.  It emits no
    record."""
    bits = []

    def put(v, n):
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def align():
        bits.extend([0] * (-len(bits) % 8))

    # picture header: start code, temporal reference 0, P, vbv_delay
    # 0xFFFF, full_pel 0, forward_f_code 1, no extra information
    for v, n in ((0x100, 32), (0, 10), (2, 3), (0xFFFF, 16), (0, 1), (1, 3),
                 (0, 1)):
        put(v, n)
    align()
    for v, n in ((0x101, 32), (8, 5), (0, 1)):   # slice 1, quantizer 8
        put(v, n)
    # macroblock 0: increment 1, type "MC, not coded", zero motion codes
    for v, n in ((1, 1), (0b001, 3), (1, 1), (1, 1)):
        put(v, n)
    inc = mb_width * mb_height - 1
    while inc > 33:
        put(0b00000001000, 11)   # macroblock_escape: 33 more
        inc -= 33
    put(*{8: (0b0000111, 7)}[inc])   # the one increment 1080p needs
    for v, n in ((0b001, 3), (1, 1), (1, 1)):   # the last macroblock
        put(v, n)
    align()
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def test_fill_on_workers_matches_jax_fill_at_1080p(monkeypatch):
    """test1080.m1v cut into four streams of 4, 7, 10 and 13 pictures at
    window 2: the 7-picture stream runs dry mid-window, and the third
    opens its second round with a picture of skipped macroblocks, so its
    first record there lies more than 64K past its chain's start (hops
    as its worker emitted them).  Every worker count packs the JAX
    package's slots, with seams that need hops on the global chain."""
    es = (TESTDATA / "test1080.m1v").read_bytes()
    starts = [i for i in range(len(es) - 3)
              if es[i:i + 4] == b"\x00\x00\x01\x00"]
    skipped = es[:starts[2]] + _skipped_p_picture(120, 68) + \
        es[starts[2]:starts[9]]
    sources = [es[:starts[4]], es[:starts[7]], skipped, es[:starts[13]]]
    seams = []
    seam = tm._seam

    def recorded(*args):
        seams.append(seam(*args))
        return seams[-1]

    monkeypatch.setattr(tm, "_seam", recorded)
    for workers in (1, 3, None):
        seams.clear()
        port_ms = MultiStreamVideoDecoder(sources, window=2, device="cpu")
        port_ms._parse_workers = workers
        assert _fill_rounds(JaxMultiStream(sources, window=2), port_ms) == 8
        assert port_ms._kmg > 4096
        port_ms.close()
        assert any(h > 0 for h, _, _ in seams)   # hops as emitted
        assert any(g > 0 for _, g, _ in seams)   # hops on the global chain


def test_prefetch_with_workers_matches_inline(mpeg1video_path, mpg_path):
    sources = _mixed(mpeg1video_path, mpg_path, cut=3)
    inline = MultiStreamVideoDecoder(sources, window=4, device="cpu")
    inline._parse_workers = 1
    want = inline.decode_all()
    ms = MultiStreamVideoDecoder(sources, window=4, prefetch=True,
                                 device="cpu")
    ms._parse_workers = 3
    got = ms.decode_all()
    assert ms._parse_workers == 3
    _assert_streams_equal(got, want, None)


def test_close_and_collection_join_the_fill_threads(mpeg1video_path):
    es = open(mpeg1video_path, "rb").read()
    sources = [es[:40000], es[:30000], es[:20000]]
    for prefetch in (False, True):
        ms = MultiStreamVideoDecoder(sources, window=2, prefetch=prefetch,
                                     device="cpu")
        ms._parse_workers = 3
        assert ms.decode_window() is not None
        threads = list(ms._pool._threads)
        assert len(threads) == 2 and all(t.is_alive() for t in threads)
        ms.close()
        assert not any(t.is_alive() for t in threads)
        assert ms.decode_window() is None
    ms = MultiStreamVideoDecoder(sources, window=2, device="cpu")
    ms._parse_workers = 3
    assert ms.decode_window() is not None
    threads = list(ms._pool._threads)
    del ms
    gc.collect()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


def test_first_fill_parses_on_at_most_first_fill_threads(
        monkeypatch, mpeg1video_path, mpg_path):
    """The first fill, where every parser zero-fills its plan arrays,
    runs on at most `_FIRST_FILL_THREADS` workers; later fills on all of
    them.  The slots stay the JAX package's, byte for byte."""
    monkeypatch.setattr(tm, "_FIRST_FILL_THREADS", 2)
    sources = _mixed(mpeg1video_path, mpg_path, cut=2)
    port_ms = MultiStreamVideoDecoder(sources, window=4, device="cpu")
    port_ms._parse_workers = 4
    fills, ran = [], []
    fill, parse = port_ms._fill, port_ms._parse_stream

    def counted_fill():
        fills.append(set())
        return fill()

    def recorded(slot, meta, parsed, worker, s):
        fills[-1].add(worker)
        ran.append(s)
        time.sleep(0.02)   # time for every allowed thread to take one
        parse(slot, meta, parsed, worker, s)

    port_ms._fill, port_ms._parse_stream = counted_fill, recorded
    rounds = _fill_rounds(JaxMultiStream(sources, window=4), port_ms)
    assert len(fills) == rounds and len(ran) == rounds * len(sources)
    assert fills[0] <= {0, 1}
    assert set().union(*fills) <= {0, 1, 2, 3}
    assert len(port_ms._pool._threads) == 3
    port_ms.close()


def test_fill_pool_limits_a_task_to_its_threads():
    """A task run on the first k workers: only those take items, every
    item runs once, and the next task may use every thread."""
    pool = tm._FillPool(5)
    try:
        for k in (1, 2, 4):
            ran, workers = [0] * 60, set()

            def item(worker, i):
                ran[i] += 1
                workers.add(worker)
                time.sleep(1e-4)

            took = pool.run(item, 60, threads=k)
            assert ran == [1] * 60
            assert workers <= set(range(k)) and took == len(workers)
        assert pool.run(lambda w, i: None, 4, threads=None) >= 1
    finally:
        pool.close()


def test_fill_pool_runs_each_item_once_under_thread_switches():
    """More threads than cores, the interpreter switching threads every
    microsecond: each item runs once, every item has run when `run`
    returns, an item's exception reaches the caller, and the pool runs
    task after task."""
    pool = tm._FillPool(2 * (os.cpu_count() or 1))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for n in (0, 1, 7, 200):
            ran = [0] * n
            workers = set()

            def item(worker, i):
                ran[i] += 1
                workers.add(worker)

            took = pool.run(item, n)
            assert ran == [1] * n
            assert took == len(workers) <= len(pool._threads) + 1
            assert (0 in workers) == (n > 0)   # the caller takes item 0

        def fails(worker, i):
            if i == 3:
                raise ValueError("item 3")

        with pytest.raises(ValueError, match="item 3"):
            pool.run(fails, 50)
        assert pool.run(lambda w, i: None, 5) >= 1
    finally:
        sys.setswitchinterval(interval)
        pool.close()
    assert not pool._threads
    assert pool.run(lambda w, i: None, 3) == 1   # the caller alone
