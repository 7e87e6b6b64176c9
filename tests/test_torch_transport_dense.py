"""The dense transport in flight on the CPU: `stack_plans(out=)` byte for
byte against the JAX package's `stack_plans`; the dense
`BatchVideoDecoder`, which stacks each window straight into a buffer of
its decoder's ring and never writes one whose copy is pending (gate
stand-ins, as tests/test_torch_transport.py drives them), against the
JAX package's dense decoder and its C++ host decoder;
`make_dense_scan_decoder` with the caller's arrays overwritten after each
call; and the sharded dense decoder, one `GlobalWindowDecoder.reconstruct`
a shard a window, against the JAX package's on its CPU devices and on the
golden.  Inputs: the fixtures, and numpy seeds for the buffer garbage.
Tolerance: exact equality."""

import io

import numpy as np
import pytest
import torch

import mpeg_tpu as mpeg
import mpeg_tpu_torch as tmpeg
from mpeg_tpu import native
from mpeg_tpu.parallel import BatchVideoDecoder as JaxBatchVideoDecoder
from mpeg_tpu.parallel import batch as jb
from mpeg_tpu.parallel import sharding as jsh
from mpeg_tpu.utils import Fnv1a64
from mpeg_tpu_torch.parallel import BatchVideoDecoder, make_dense_scan_decoder
from mpeg_tpu_torch.parallel import batch as tb
from mpeg_tpu_torch.parallel import multistream as tm
from mpeg_tpu_torch.parallel import sharding as sh
from test_torch_transport import LazyGate, _lazy_device_put
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN_VIDEO_HASH = 0xEA6D7FCB1340BA3F
PICTURE_TYPE_B = 3


def _video(path):
    buf = mpeg.Buffer(open(path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    return mpeg.Video(buf, backend="plan")


def _plans(path, n):
    video = _video(path)
    return video.geom, [video.parse_next_plan() for _ in range(n)]


def _cut(data, pictures):
    """`data` up to the start of picture `pictures`."""
    pos = -1
    for _ in range(pictures + 1):
        pos = data.find(b"\x00\x00\x01\x00", pos + 1)
    return data[:pos]


@pytest.mark.parametrize("case", ["full", "short", "reused"])
def test_stack_plans_into_a_buffer_matches_jax(case, mpeg1video_path):
    """Full and short windows, and a buffer first filled with garbage and a
    full window of nonzero plans, then restacked with a short one: every
    field byte for byte the JAX package's, laid out as `stack_layout`
    says, in the caller's buffer."""
    geom, plans = _plans(mpeg1video_path, 13)
    window = 8
    offs, total = tb.stack_layout(geom, window)
    rng = np.random.default_rng(7)
    buf = rng.integers(0, 256, total + 64, dtype=np.uint8)
    if case == "reused":
        tb.stack_plans(plans[5:13], geom, window, out=buf)
    part = plans[:window] if case == "full" else plans[:3]
    got = tb.stack_plans(part, geom, window, out=buf)
    want = jb.stack_plans(part, geom, window)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32, k
        assert got[k].shape == want[k].shape == offs[k][1], k
        assert got[k].tobytes() == want[k].tobytes(), k
        assert np.shares_memory(got[k], buf), k
        assert got[k].ctypes.data - buf.ctypes.data == offs[k][0], k
    fresh = tb.stack_plans(part, geom, window)
    assert all(fresh[k].tobytes() == want[k].tobytes() for k in want)
    with pytest.raises(ValueError):
        tb.stack_plans(plans[:9], geom, window, out=buf)


def _host_frames(data, fs):
    ref, out = native.NativeHostDecoder(data), []
    while (f := ref.decode_next()) is not None:
        out.append(f[:fs])
    return out


def _dense_decoder(data, window, **kw):
    """The port's and the JAX package's dense `BatchVideoDecoder`s."""
    buf = mpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    tbuf = tmpeg.Buffer(io.BytesIO(data))
    tbuf.set_load_callback(tbuf.load_reader_callback)
    return (BatchVideoDecoder(tbuf, window=window, transport="dense",
                              use_native=False, device="cpu", **kw),
            JaxBatchVideoDecoder(buf, window=window, transport="dense",
                                 use_native=False))


@pytest.mark.skipif(not native.available(), reason="needs the native parser")
@pytest.mark.parametrize("prefetch", [False, True])
def test_dense_batch_decoder_in_flight(prefetch, monkeypatch,
                                       mpeg1video_path):
    """Every window stacked straight into a buffer of the decoder's ring
    (no staging copy), each copy pending for a few polls, no buffer
    written while its copy is pending, at most `_DENSE_RING` buffers; the
    frames equal the JAX package's dense decoder's and its C++ host
    decoder's."""
    data = _cut(open(mpeg1video_path, "rb").read(), 37)
    _lazy_device_put(monkeypatch, tb)
    sent = []
    ring_send = tb.HostRing.send

    def send(ring, parts):
        bufs = [e[0] for e in ring._bufs if e[0] is not None]
        sent.append(all(any(p.data_ptr() == b.data_ptr() for b in bufs)
                        for p in parts))
        return ring_send(ring, parts)

    monkeypatch.setattr(tb.HostRing, "send", send)
    dec, jdec = _dense_decoder(data, 4, prefetch=prefetch)
    got = dec.decode_all()
    LazyGate.check_live()
    assert not LazyGate.faults
    assert len(sent) == -(-len(dec._types) // 4) > 3 and all(sent)
    ring = dec._scan._ring
    assert 2 <= len(ring._bufs) <= tb._DENSE_RING
    want = jdec.decode_all()
    fs = dec.geom.frame_size
    host = _host_frames(data, fs)
    assert len(got) == len(want) == len(host) > 30
    for i, (a, b, c) in enumerate(zip(got, want, host)):
        assert np.array_equal(a.numpy(), np.asarray(b)), f"frame {i}"
        assert np.array_equal(a[:fs].numpy(), c), f"frame {i}"


class Held:
    """A gate that stays pending until the host waits on it."""

    waited = []

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        Held.waited.append(self)
        self.done = True


def test_dense_ring_waits_past_three_windows(monkeypatch, mpeg1video_path):
    """With every copy pending, the dense decoder takes a new buffer for
    each of three windows, then waits for the oldest copy before it
    writes that buffer again: no more than three stacks are pinned and
    none is written while its copy pends."""
    data = open(mpeg1video_path, "rb").read()
    gates = []
    plain = tb.device_put

    def put(parts, device):
        outs, _ = plain(parts, device)
        gate = Held()
        gates.append((gate, [p.data_ptr() for p in parts]))
        return outs, gate

    monkeypatch.setattr(tb, "device_put", put)
    Held.waited = []
    dec, _jdec = _dense_decoder(data, 4)
    for _ in range(3):
        assert dec._decode_window_once()[1] == 4
    assert not Held.waited
    assert len({ptrs[0] for _g, ptrs in gates}) == 3
    dec._decode_window_once()
    assert Held.waited == [gates[0][0]]
    assert gates[3][1] == gates[0][1]           # the oldest buffer again
    assert len(dec._scan._ring._bufs) == tb._DENSE_RING


def test_dense_scan_decoder_caller_overwrites(monkeypatch, mpeg1video_path):
    """`make_dense_scan_decoder` stages the caller's arrays: overwritten
    right after each call, the carry and displays still equal the JAX
    dense scan's, and no staged buffer is written while its copy pends."""
    import jax.numpy as jnp

    geom, plans = _plans(mpeg1video_path, 17)
    window = 6
    _lazy_device_put(monkeypatch, tb)
    scan = jb.make_dense_scan_decoder(geom)
    dec = make_dense_scan_decoder(geom, device="cpu")
    jcarry = tuple(jnp.zeros(geom.total_size, jnp.uint8) for _ in range(3))
    carry = tuple(torch.zeros(geom.total_size, dtype=torch.uint8)
                  for _ in range(3))
    rng = np.random.default_rng(3)
    for a in range(0, 17, window):
        part = plans[a:a + window]
        jcarry, want = scan(jcarry, jb.stack_plans(part, geom, window))
        stacked = tb.stack_plans(part, geom, window)
        carry, got = dec(carry, stacked)
        for v in stacked.values():
            v[...] = rng.integers(-9, 9, v.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for x, y in zip(carry, jcarry):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    LazyGate.check_live()
    assert not LazyGate.faults


def _stream_windows(path, n, window, count=None):
    """Per window, each of `n` streams' next plans (the same fixture)."""
    videos = [_video(path) for _ in range(n)]
    windows = []
    while count is None or len(windows) < count:
        per_stream = []
        for v in videos:
            plans = []
            while len(plans) < window and \
                    (item := v.parse_next_plan()) is not None:
                plans.append(item)
            per_stream.append(plans)
        if not any(per_stream):
            break
        windows.append(per_stream)
    return videos[0].geom, windows


@pytest.mark.parametrize("devices", [4, 2])
def test_sharded_dense_one_program_a_shard(devices, monkeypatch,
                                           mpeg1video_path):
    """Four streams over 4 and over 2 shards, three windows (two streams a
    picture short in the last): equal to the JAX package's sharded dense
    decoder on its CPU devices, with the caller's arrays overwritten
    after each call; each shard a window makes exactly one
    `GlobalWindowDecoder.reconstruct` call and no `DenseWindowDecoder`
    runs."""
    import jax

    n, window = 4, 4
    geom, windows = _stream_windows(mpeg1video_path, n, window, count=3)
    for s in (1, 3):
        windows[-1][s] = windows[-1][s][:-1]
    _lazy_device_put(monkeypatch, tb)
    calls = []
    reconstruct = tm.GlobalWindowDecoder.reconstruct

    def counted(dec, carry, plan, flags):
        calls.append((dec.n, plan[0].shape[0]))
        return reconstruct(dec, carry, plan, flags)

    def refused(*_a, **_k):
        raise AssertionError("the sharded dense decoder ran a stream alone")

    monkeypatch.setattr(tm.GlobalWindowDecoder, "reconstruct", counted)
    monkeypatch.setattr(tb.DenseWindowDecoder, "forward", refused)
    jmesh = jsh.make_mesh(jax.devices()[:devices])
    mesh = sh.make_mesh(["cpu"] * devices)
    jdec = jsh.make_sharded_scan_decoder(geom, jmesh)
    dec = sh.make_sharded_scan_decoder(geom, mesh)
    jcarry = jsh.zero_carry(geom, n, jmesh)
    carry = sh.zero_carry(geom, n, mesh)
    rng = np.random.default_rng(5)
    per = n // devices
    for per_stream in windows:
        stacked = sh.stack_stream_plans(per_stream, geom, window)
        jcarry, jdisps, jpx = jdec(jcarry,
                                   jsh.stack_stream_plans(per_stream, geom,
                                                          window))
        del calls[:]
        carry, disps, px = dec(carry, stacked)
        assert calls == [(per, per * window)] * devices
        for v in stacked.values():
            v[...] = rng.integers(-9, 9, v.shape)
        np.testing.assert_array_equal(torch.cat(disps).numpy(),
                                      np.asarray(jdisps))
        for a, b in zip(carry, jcarry):
            np.testing.assert_array_equal(torch.cat(a).numpy(),
                                          np.asarray(b))
        assert px.dtype == torch.int64 and int(px) == int(jpx) == \
            sum(len(p) for p in per_stream) * geom.frame_size
    LazyGate.check_live()
    assert not LazyGate.faults
    rings = dec.__closure__[dec.__code__.co_freevars.index("staging")] \
        .cell_contents
    assert len(rings) == 1                      # one ring a device
    assert all(len(r._bufs) <= tb._DENSE_RING for r in rings.values())


def test_sharded_dense_decode_golden(mpeg1video_path):
    """The whole fixture on two streams over two shards through the dense
    sharded decoder: every stream on the golden hash, the end-of-stream
    flush from the carry included."""
    n, window = 2, 16
    geom, windows = _stream_windows(mpeg1video_path, n, window)
    mesh = sh.make_mesh(["cpu", "cpu"])
    decode = sh.make_sharded_scan_decoder(geom, mesh)
    carry = sh.zero_carry(geom, n, mesh)
    hashes = [Fnv1a64() for _ in range(n)]
    counts, has_ref, last_type = [0] * n, [False] * n, [0] * n
    for per_stream in windows:
        carry, disps, px = decode(
            carry, sh.stack_stream_plans(per_stream, geom, window))
        disps = torch.cat(disps).numpy()
        assert int(px) == sum(len(p) for p in per_stream) * geom.frame_size
        for s, plans in enumerate(per_stream):
            for i, (_, t) in enumerate(plans):
                last_type[s] = t
                if t == PICTURE_TYPE_B or has_ref[s]:
                    hashes[s].write(disps[s, i, :geom.frame_size].tobytes())
                    counts[s] += 1
                else:
                    has_ref[s] = True
    bwd = torch.cat(carry[2]).numpy()
    for s in range(n):
        if has_ref[s] and last_type[s] != PICTURE_TYPE_B:
            hashes[s].write(bwd[s, :geom.frame_size].tobytes())
            counts[s] += 1
    assert counts == [260] * n
    assert [h.sum64() for h in hashes] == [GOLDEN_VIDEO_HASH] * n
