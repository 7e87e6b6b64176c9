"""The port's window transport on the CPU: the in-flight bookkeeping of
`BatchVideoDecoder` (`_blob_inflight`, `_reap_blobs`, `_blob_free`, as the
JAX package keeps them), the multistream slots' gates and `HostRing`,
driven by gate stand-ins that report a copy as pending; and both
decoders with the parse prefetch thread through pool growth, window for
window byte-equal to the JAX package's parse and frame for frame equal to
the JAX package's C++ host decoder, while every copy stays pending for a
few polls and checks that nobody wrote its host buffer meanwhile.
Tolerance: exact equality."""

import io

import numpy as np
import pytest
import torch

from mpeg_tpu import native
from mpeg_tpu.parallel import BatchVideoDecoder as JaxBatchVideoDecoder
from mpeg_tpu.parallel import MultiStreamVideoDecoder as JaxMultiStream
import mpeg_tpu_torch as tmpeg
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
from mpeg_tpu_torch.parallel import batch as tb
from mpeg_tpu_torch.parallel import multistream as tm
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="needs the native parser")


class Pending:
    """A gate whose copy never completes."""

    def query(self):
        return False

    def synchronize(self):
        raise AssertionError("the dispatch thread waited on a gate")


class Done:
    def query(self):
        return True

    def synchronize(self):
        pass


def _es(mpeg1video_path) -> bytes:
    return open(mpeg1video_path, "rb").read()


def _blob():
    return tb.host_blob(8, "cpu")


def test_pending_blob_never_reaches_the_free_list(mpeg1video_path):
    """A blob whose copy is pending stays in flight however often the
    dispatch reaps; past 4 in flight the oldest is dropped, never waited
    on; once the gates complete, the free list takes at most 3."""
    dec = BatchVideoDecoder(_es(mpeg1video_path), window=4, device="cpu")
    caps = (dec._km, dec._ke)
    pending = []
    for _ in range(8):
        blob = _blob()
        pending.append(blob)
        dec._blob_inflight.append((Pending(), blob, caps, caps))
        dec._reap_blobs()
        assert len(dec._blob_inflight) <= 5
        assert not dec._blob_free
    # The dropped ones are the oldest: the newest 4 are still held.
    assert [e[1] for e in dec._blob_inflight][-4:] == pending[-4:]
    dec._blob_inflight.clear()
    for _ in range(8):
        dec._blob_inflight.append((Done(), _blob(), caps, caps))
    dec._reap_blobs()
    assert not dec._blob_inflight
    assert len(dec._blob_free) == 3
    # A pending gate at the head holds every later blob back (in order).
    dec._blob_free.clear()
    dec._blob_inflight.append((Pending(), _blob(), caps, caps))
    dec._blob_inflight.append((Done(), _blob(), caps, caps))
    dec._reap_blobs()
    assert len(dec._blob_inflight) == 2 and not dec._blob_free


def test_stale_bucket_blob_is_dropped(mpeg1video_path):
    dec = BatchVideoDecoder(_es(mpeg1video_path), window=4, device="cpu")
    stale = _blob()
    dec._blob_free.append((stale, (dec._km // 2, dec._ke), (0, 0)))
    blob, views, hwm = dec._alloc_window_blob()
    assert blob is not stale and not dec._blob_free
    total = tb.blob_layout(dec.geom, 4, dec._km, dec._ke)[1]
    assert blob.numel() == total and hwm == (dec._km, dec._ke)
    assert not blob.is_pinned()          # the CPU: a plain host buffer
    # A blob of the current buckets is recycled with its marks.
    dec._blob_free.append((blob, (dec._km, dec._ke), (7, 3)))
    again, _, hwm = dec._alloc_window_blob()
    assert again is blob and hwm == (7, 3)


def test_zero_picture_return_hands_its_blob_back(mpeg1video_path):
    """A streaming poll with no whole picture buffered hands its untouched
    blob straight back, so repeated polls reuse one buffer."""
    es = _es(mpeg1video_path)
    first = es.find(b"\x00\x00\x01\x00")
    dec = BatchVideoDecoder(es[:first + 4], window=4, streaming=True,
                            device="cpu")
    blob, types, fill = dec._native_window_blob()
    assert (blob, types, fill) == (None, [], None)
    assert len(dec._blob_free) == 1
    held = dec._blob_free[0][0]
    for _ in range(3):
        assert dec._native_window_blob()[1] == []
        assert len(dec._blob_free) == 1 and dec._blob_free[0][0] is held
    assert dec.decode_window() == [] and not dec._blob_inflight


def test_cpu_device_put_is_a_plain_copy():
    tb.reset_transport_counts()
    host = tb.host_blob(16, "cpu")
    host.numpy()[:] = np.arange(16)
    (out,), gate = tb.device_put([host[:12]], "cpu")
    assert gate is None and out.data_ptr() != host.data_ptr()
    host.numpy()[:] = 0                  # the copy is done: no alias
    assert out.tolist() == list(range(12))
    counts = tb.transport_counts
    assert (counts.copies, counts.pinned_copies, counts.bytes) == (1, 0, 12)


def test_host_ring_reuses_only_completed_buffers():
    """`HostRing._take` hands out a buffer only once its last copy has
    completed: with every copy pending it adds a buffer, up to
    `_MAX_RING`, then waits on the oldest; completed buffers come back
    in rotation, grown only when too small."""
    ring = tb.HostRing("cpu")
    first = ring._take(100)
    first[1] = Done()
    second = ring._take(100)
    assert second is not first
    second[1] = Done()
    assert ring._take(50) is first      # rotation, no new memory
    first[1] = Pending()
    assert ring._take(50) is second
    second[1] = Pending()
    held = [first, second]
    while len(ring._bufs) < tb._MAX_RING:
        entry = ring._take(10)
        assert all(entry is not h for h in held)
        entry[1] = Pending()
        held.append(entry)

    class Waited(Pending):
        waited = 0

        def synchronize(self):
            Waited.waited += 1

    for h in held:
        h[1] = Waited()
    ring._take(10)
    assert Waited.waited == 1 and len(ring._bufs) == tb._MAX_RING
    grow = tb.HostRing("cpu")
    entry = grow._take(10)
    small = entry[0]
    grow._next = 0                       # the same entry again
    again = grow._take(10 ** 6)
    assert again is entry and again[0] is not small
    assert again[0].numel() >= 10 ** 6


def test_host_ring_put_on_the_cpu():
    ring = tb.HostRing("cpu")
    table = np.arange(30, dtype=np.int32).reshape(2, 3, 5)
    disp = np.arange(6, dtype=np.int64).reshape(3, 2).T    # not contiguous
    a, b = ring.put([table, disp])
    assert a.dtype == torch.int32 and b.dtype == torch.int64
    assert np.array_equal(a.numpy(), table)
    assert np.array_equal(b.numpy(), disp)


class LazyGate:
    """A copy that completes a few polls after it was enqueued, standing
    in for the card's asynchronous copy (`device_put` on the CPU is a
    clone).  Its host parts must not be written before it completes:
    every new copy, every poll and the test's end check each live gate's
    parts against their bytes at the enqueue, and a part written again
    meanwhile is a fault."""

    live, faults = [], []

    def __init__(self, parts, polls=2):
        self.parts = parts
        self.snapshot = [p.clone() for p in parts]
        self.polls = polls

    @classmethod
    def check_live(cls):
        for gate in cls.live:
            if any(not torch.equal(p, s)
                   for p, s in zip(gate.parts, gate.snapshot)):
                cls.faults.append(gate)

    def _complete(self):
        LazyGate.check_live()
        LazyGate.live.remove(self)

    def query(self):
        self.polls -= 1
        if self.polls > 0:
            return False
        if self in LazyGate.live:
            self._complete()
        return True

    def synchronize(self):
        if self in LazyGate.live:
            self._complete()


def _lazy_device_put(monkeypatch, *modules):
    plain = tb.device_put

    def put(parts, device):
        LazyGate.check_live()
        outs, _ = plain(parts, device)
        gate = LazyGate(parts)
        LazyGate.live.append(gate)
        return outs, gate

    for m in modules:
        monkeypatch.setattr(m, "device_put", put)
    LazyGate.live, LazyGate.faults = [], []


def _host_frames(data, fs):
    ref, out = native.NativeHostDecoder(data), []
    while (f := ref.decode_next()) is not None:
        out.append(f[:fs])
    return out


def test_batch_prefetch_through_growth(monkeypatch, mpeg1video_path):
    """`BatchVideoDecoder(prefetch=True)` from the minimum buckets: the
    windows the producer thread packs are byte-equal to the JAX package's
    `_native_window_blob`, every copy stays pending for a few polls and
    no host blob is written while its copy is pending, blobs are
    recycled, and every frame equals the C++ host decoder's."""
    data = _es(mpeg1video_path)
    _lazy_device_put(monkeypatch, tb)
    dec = BatchVideoDecoder(data, window=8, prefetch=True, device="cpu")
    got, produce = [], dec._native_window_blob

    def recorded():
        blob, types, fill = produce()
        if types:
            v = tb.blob_views(blob, dec.geom, dec.window, dec._km, dec._ke)
            got.append((types, (dec._km, dec._ke), fill,
                        {k: x.tobytes() for k, x in v.items()}))
        return blob, types, fill

    dec._native_window_blob = recorded
    frames = dec.decode_all()
    jdec, want = JaxBatchVideoDecoder(data, window=8), []
    while True:
        blob, types, fill = jdec._native_window_blob()
        if not types:
            break
        v = tb.blob_views(blob, jdec.geom, 8, jdec._km, jdec._ke)
        want.append((types, (jdec._km, jdec._ke), fill,
                     {k: x.tobytes() for k, x in v.items()}))
    assert len(got) == len(want) > 10
    assert got == want
    assert dec._km > tb._MIN_KM          # the buckets grew
    LazyGate.check_live()
    assert not LazyGate.faults
    assert dec._blob_free or dec._blob_inflight
    fs = dec.geom.frame_size
    host = _host_frames(data, fs)
    assert len(frames) == len(host) == 260
    for i, (a, b) in enumerate(zip(frames, host)):
        assert np.array_equal(a[:fs].numpy(), b), f"frame {i}"


def test_multistream_prefetch_through_growth(monkeypatch, mpeg1video_path):
    """`MultiStreamVideoDecoder(prefetch=True)` from the minimum buckets:
    each round's slot is byte-equal to the JAX package's `_fill`, the
    filler never writes a slot whose copies are pending (their gates),
    and each stream equals the C++ host decoder's frames."""
    es = _es(mpeg1video_path)
    starts = [i for i in range(len(es) - 3)
              if es[i:i + 4] == b"\x00\x00\x01\x00"]
    # Cut at picture starts: the host decoder, unlike the window parse,
    # shows a trailing partial picture.
    sources = [es[:starts[k]] for k in (130, 61, 97)]
    _lazy_device_put(monkeypatch, tm)
    ms = MultiStreamVideoDecoder(sources, window=4, prefetch=True,
                                 device="cpu")
    got, fill = [], ms._fill

    def recorded():
        item = fill()
        slot, types, nm, caps = item
        got.append((types.copy(), nm, caps, slot.meta.tobytes(),
                    slot.main.tobytes()))
        return item

    ms._fill = recorded
    frames = ms.decode_all()
    jms, want = JaxMultiStream(sources, window=4), []
    while True:
        slot, types, nm, caps = jms._fill()
        want.append((types, nm, caps, slot.meta.tobytes(),
                     slot.main.tobytes()))
        slot.evt.set()
        if not types.any():
            break
    # After the producer's last (dry) round the flush polls inline.
    assert len(got) >= len(want) > 3
    assert not any(g[0].any() for g in got[len(want):])
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[0], w[0], err_msg=f"round {r}")
        assert g[1:] == w[1:], f"round {r}"
    assert ms._kmg > tb._MIN_KM          # the buckets grew
    LazyGate.check_live()
    assert not LazyGate.faults
    assert all(s.meta_host.numel() == s.meta.size for s in ms._slots)
    fs = ms.geom.frame_size
    for s, data in enumerate(sources):
        host = _host_frames(data, fs)
        assert len(frames[s]) == len(host) > 0, f"stream {s}"
        for i, (a, b) in enumerate(zip(frames[s], host)):
            assert np.array_equal(a[:fs].numpy(), b), f"stream {s} frame {i}"


def test_pack_in_place_equals_a_fresh_pack(mpeg1video_path):
    """`pack_plans_blob(..., out=buffer)` writes the same bytes into a
    used buffer (its stale bytes zeroed) as into a fresh one."""
    buf = tmpeg.Buffer(io.BytesIO(_es(mpeg1video_path)))
    buf.set_load_callback(buf.load_reader_callback)
    dec = BatchVideoDecoder(buf, window=4, use_native=False, device="cpu")
    plans = dec.parse_window()
    km, ke = 1 << 14, 1 << 10
    fresh = tb.pack_plans_blob(plans, dec.geom, 4, km, ke)
    used = np.full(fresh.size + 100, 0xA5, np.uint8)
    packed = tb.pack_plans_blob(plans, dec.geom, 4, km, ke, out=used)
    assert packed.base is used or packed.base is used.base
    assert np.array_equal(packed, fresh)
    assert (used[fresh.size:] == 0xA5).all()


def test_interactive_picture_packed_in_place(monkeypatch, mpeg1video_path):
    """`Video` packs each picture straight into a buffer of its own
    `HostRing`, ships it from there, and writes no buffer whose copy is
    pending; its frames equal the C++ host decoder's."""
    data = _es(mpeg1video_path)
    _lazy_device_put(monkeypatch, tb)
    buf = tmpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    video = tmpeg.Video(buf, device="cpu")
    sent = []
    ring_send = tb.HostRing.send

    def send(ring, parts):
        bufs = [e[0] for e in ring._bufs if e[0] is not None]
        sent.append(all(any(p.data_ptr() == b.data_ptr() for b in bufs)
                        for p in parts))
        return ring_send(ring, parts)

    monkeypatch.setattr(tb.HostRing, "send", send)
    frames = []
    while len(frames) < 40 and (f := video.decode()) is not None:
        frames.append(f.flat.clone())
    assert sent and all(sent)            # no staging copy
    assert len(video._blob_ring._bufs) <= 3
    LazyGate.check_live()
    assert not LazyGate.faults
    fs = video.geom.frame_size
    host = _host_frames(data, fs)
    for i, a in enumerate(frames):
        assert np.array_equal(a[:fs].numpy(), host[i]), f"frame {i}"


def test_python_parse_blob_packed_in_place(monkeypatch, mpeg1video_path):
    """`BatchVideoDecoder(use_native=False)` packs each window into a
    recycled host blob, none written while its copy is pending; its
    frames equal the C++ host decoder's."""
    data = _es(mpeg1video_path)
    _lazy_device_put(monkeypatch, tb)
    buf = tmpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    dec = BatchVideoDecoder(buf, window=4, use_native=False, device="cpu")
    frames = []
    while len(frames) < 40 and (out := dec.decode_window()):
        frames += [f.clone() for f in out]
    assert dec._blob_free or dec._blob_inflight
    LazyGate.check_live()
    assert not LazyGate.faults
    fs = dec.geom.frame_size
    host = _host_frames(data, fs)
    for i, a in enumerate(frames):
        assert np.array_equal(a[:fs].numpy(), host[i]), f"frame {i}"
