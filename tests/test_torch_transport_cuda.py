"""The window transport on the card (`parallel.batch.device_put`): host
blobs and slots are pinned, a pageable part is refused, no copy on the
four paths (`BatchVideoDecoder`, `MultiStreamVideoDecoder`, the sharded
decode, `Video`) makes the host wait for the card, and under an adversary
that holds the compute stream and the copy stream with
`torch.cuda._sleep` before every window, so that copies and kernels are
in flight while the prefetch thread wants a free blob, every path stays
equal to the C++ host decoder frame for frame.  Marked `cuda`: each test
skips inside its body without a card (`python -m pytest --noconftest
tests/test_torch_transport_cuda.py -q -m cuda`).  This module imports
only the port.  Tolerance: exact."""

import io
import pathlib

import numpy as np
import pytest
import torch

import mpeg_tpu_torch as mpeg
from mpeg_tpu_torch.native import NativeHostDecoder
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
from mpeg_tpu_torch.parallel import batch as tb
from mpeg_tpu_torch.parallel import sharding as sh
from mpeg_tpu_torch.tables import PICTURE_TYPE_B

TESTDATA = pathlib.Path(__file__).parent / "testdata"
ES = TESTDATA / "test.mpeg1video"
FIXTURE_1080P = TESTDATA / "test1080.m1v"

pytestmark = pytest.mark.cuda

# About 50 ms of the card's time at its ~2 GHz clock: longer than a
# window's parse, so that the copies are still pending when the prefetch
# thread wants the next blob.
HOLD_CYCLES = 100_000_000


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", torch.cuda.current_device())


def _hold(dev, cycles=HOLD_CYCLES):
    """The adversary: the compute stream and the copy stream each busy
    for `cycles` clocks from now."""
    torch.cuda._sleep(cycles)
    with torch.cuda.stream(tb.copy_stream(dev)):
        torch.cuda._sleep(cycles)


def _busy(dev) -> bool:
    """Both streams still hold work (the host did not wait for them)."""
    return not torch.cuda.current_stream(dev).query() and \
        not tb.copy_stream(dev).query()


def _host_frames(data, fs):
    ref, out = NativeHostDecoder(data), []
    while (f := ref.decode_next()) is not None:
        out.append(torch.from_numpy(f[:fs].copy()))
    return out


def _assert_frames(got, want, fs, what):
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a[:fs].cpu(), b), f"{what}: frame {i}"


def _cuts(data, pictures):
    starts, pos = [], data.find(b"\x00\x00\x01\x00")
    while pos >= 0:
        starts.append(pos)
        pos = data.find(b"\x00\x00\x01\x00", pos + 1)
    return [data if k is None else data[:starts[k]] for k in pictures]


def test_host_buffers_are_pinned_and_pageable_is_refused():
    dev = _card()
    assert tb.host_blob(1024, dev).is_pinned()
    es = ES.read_bytes()
    dec = BatchVideoDecoder(es, window=4, device="cuda")
    dec.decode_window()
    held = [b for _g, b, *_ in dec._blob_inflight] + \
        [b for b, *_ in dec._blob_free]
    assert held and all(b.is_pinned() for b in held)
    ms = MultiStreamVideoDecoder([es, es[:len(es) // 2]], window=2,
                                 device="cuda")
    ms.decode_window()
    assert all(s.meta_host.is_pinned() and s.main_host.is_pinned()
               for s in ms._slots)
    buf = mpeg.Buffer(io.BytesIO(es))
    buf.set_load_callback(buf.load_reader_callback)
    video = mpeg.Video(buf, device="cuda")
    assert video.decode() is not None
    ring = [b for b, _g in video._blob_ring._bufs if b is not None]
    assert ring and all(b.is_pinned() for b in ring)
    with pytest.raises(ValueError, match="not pinned"):
        tb.device_put([torch.zeros(64, dtype=torch.uint8)], dev)
    # A pinned part is copied on the copy stream and counted as pinned.
    tb.reset_transport_counts()
    host = tb.host_blob(64, dev)
    host.numpy()[:] = np.arange(64)
    (out,), gate = tb.device_put([host], dev)
    gate.synchronize()
    assert out.cpu().tolist() == list(range(64))
    counts = tb.transport_counts
    assert (counts.copies, counts.pinned_copies, counts.bytes) == (1, 1, 64)


def test_no_copy_blocks_the_host():
    """With both streams held, one more window, round, shard call or
    picture on each path returns while the held work is still pending:
    its copies and launches were only enqueued."""
    dev = _card()
    es = ES.read_bytes()
    dec = BatchVideoDecoder(es, window=4, pool_buckets=(1 << 16, 1 << 10),
                            device="cuda")
    assert dec.decode_window()
    torch.cuda.synchronize()
    _hold(dev)
    assert dec.decode_window()
    assert _busy(dev), "BatchVideoDecoder waited for the card"
    torch.cuda.synchronize()

    ms = MultiStreamVideoDecoder([es, es], window=2,
                                 pool_buckets=(1 << 16, 1 << 10),
                                 device="cuda")
    ms.decode_window()
    torch.cuda.synchronize()
    _hold(dev)
    ms.decode_window()
    assert _busy(dev), "MultiStreamVideoDecoder waited for the card"
    torch.cuda.synchronize()

    geom, windows = _native_windows(es, 8)
    blobs, _types, km, ke = _common_blobs([windows, windows], geom, 8)
    for devices in (None, [str(dev), str(dev)]):
        mesh = sh.make_mesh(devices)
        decode = sh.make_sharded_blob_decoder(geom, mesh, 8, km, ke)
        carry = sh.zero_carry(geom, 2, mesh)
        carry, _d, _px = decode(carry, blobs[0])
        torch.cuda.synchronize()
        _hold(dev)
        decode(carry, blobs[1])
        assert _busy(dev), f"the sharded decode on {mesh.devices} waited"
        torch.cuda.synchronize()

    buf = mpeg.Buffer(io.BytesIO(es))
    buf.set_load_callback(buf.load_reader_callback)
    video = mpeg.Video(buf, device="cuda")
    for _ in range(3):
        assert video.decode() is not None
    torch.cuda.synchronize()
    _hold(dev)
    assert video.decode() is not None
    assert _busy(dev), "Video waited for the card"
    torch.cuda.synchronize()


def _native_windows(data, window):
    dec = BatchVideoDecoder(data, window=window, device="cuda")
    out = []
    while True:
        blob, types, _fill = dec._native_window_blob()
        if not types:
            return dec.geom, out
        out.append((np.asarray(blob).copy(), dec._km, dec._ke, types))


def _common_blobs(per_stream, geom, window):
    km = max(w[1] for s in per_stream for w in s)
    ke = max(w[2] for s in per_stream for w in s)
    total = tb.blob_layout(geom, window, km, ke)[1]
    blobs, types = [], []
    for w in range(max(len(s) for s in per_stream)):
        stacked = np.zeros((len(per_stream), total), np.uint8)
        types.append([])
        for s, wins in enumerate(per_stream):
            if w >= len(wins):
                types[-1].append([])
                continue
            blob, bkm, bke, t = wins[w]
            src = tb.blob_views(blob, geom, window, bkm, bke)
            dst = tb.blob_views(stacked[s], geom, window, km, ke)
            for k in src:
                dst[k][:src[k].size] = src[k]
            types[-1].append(t)
        blobs.append(stacked)
    return blobs, types, km, ke


def test_adversary_single_stream_1080p():
    """The 1080p fixture at window 4 with the parse prefetch thread, both
    streams held before every window."""
    dev = _card()
    data = FIXTURE_1080P.read_bytes()
    dec = BatchVideoDecoder(data, window=4, prefetch=True, device="cuda")
    frames = []
    while True:
        _hold(dev)
        got = dec.decode_window()
        if not got:
            break
        frames.extend(got)
    torch.cuda.synchronize()
    fs = dec.geom.frame_size
    _assert_frames(frames, _host_frames(data, fs), fs, "1080p")


def test_adversary_eight_lockstep_streams_1080p():
    dev = _card()
    cuts = _cuts(FIXTURE_1080P.read_bytes(), (None, 25, 17, 9))
    streams = [cuts[s % 4] for s in range(8)]
    ms = MultiStreamVideoDecoder(streams, window=2, prefetch=True,
                                 device="cuda")
    frames = [[] for _ in streams]
    while True:
        _hold(dev)
        got = ms.decode_window()
        if got is None:
            break
        for s, f in enumerate(got):
            frames[s].extend(f)
    torch.cuda.synchronize()
    fs = ms.geom.frame_size
    want = [_host_frames(c, fs) for c in cuts]
    for s in range(8):
        _assert_frames(frames[s], want[s % 4], fs, f"stream {s}")


def test_adversary_sharded_on_the_card_twice():
    """8 streams of the 1080p fixture (four lengths) at window 8 on
    ["cuda:i", "cuda:i"]: one staging ring and one copy stream for the
    two shards, both streams held before every call."""
    dev = _card()
    cuts = _cuts(FIXTURE_1080P.read_bytes(), (None, 25, 17, 9))
    parsed = [_native_windows(c, 8) for c in cuts]
    geom = parsed[0][0]
    blobs, types, km, ke = _common_blobs(
        [parsed[s % 4][1] for s in range(8)], geom, 8)
    mesh = sh.make_mesh([str(dev), str(dev)])
    decode = sh.make_sharded_blob_decoder(geom, mesh, 8, km, ke)
    carry = sh.zero_carry(geom, 8, mesh)
    frames = [[] for _ in range(8)]
    has_ref, last = [False] * 8, [0] * 8
    for w, stacked in enumerate(blobs):
        _hold(dev)
        carry, disps, _px = decode(carry, stacked)
        stacked[:] = 0xA5            # the caller reuses its blobs at once
        disps = torch.cat(disps)
        for s in range(8):
            for i, t in enumerate(types[w][s]):
                last[s] = t
                if t == PICTURE_TYPE_B or has_ref[s]:
                    frames[s].append(disps[s, i])
                else:
                    has_ref[s] = True
    bwd = torch.cat(carry[2])
    for s in range(8):
        if has_ref[s] and last[s] != PICTURE_TYPE_B:
            frames[s].append(bwd[s])
    torch.cuda.synchronize()
    assert len(staging_rings(decode)) == 1
    fs = geom.frame_size
    want = [_host_frames(c, fs) for c in cuts]
    for s in range(8):
        _assert_frames(frames[s], want[s % 4], fs, f"sharded stream {s}")


def staging_rings(decode) -> dict:
    """The sharded decoder's staging rings (device -> HostRing), from its
    closure."""
    names = decode.__code__.co_freevars
    return decode.__closure__[names.index("staging")].cell_contents
