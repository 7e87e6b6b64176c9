"""The window transport on the card (`parallel.batch.device_put`): host
blobs, slots, dense stacks and MP2 samples are pinned, a pageable part is
refused, no copy on the blob paths (`BatchVideoDecoder`,
`MultiStreamVideoDecoder`, the sharded decode, `Video`), the dense paths
(`BatchVideoDecoder(transport="dense")`, `make_dense_scan_decoder`, the
sharded dense decode) or the MP2 paths (`BatchAudioDecoder(out_device=
True)`, the sharded synthesis) makes the host wait for the card, and
under an adversary that holds the compute stream and the copy stream with
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
from mpeg_tpu_torch.parallel import (BatchAudioDecoder, BatchVideoDecoder,
                                     MultiStreamVideoDecoder)
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


def _native_plans(data):
    """(geom, [(plan, picture type)]) of `data` from the C++ parser."""
    from mpeg_tpu_torch.native import NativeVideoParser

    parser, plans = NativeVideoParser(data), []
    while (item := parser.parse_next_plan()) is not None:
        plans.append(item)
    return parser.geom(), plans


def _dense_windows(per_stream, geom, window):
    """Each window's stacked dense plans [S, T, ...] and picture types."""
    n_win = -(-max(len(p) for p in per_stream) // window)
    for w in range(n_win):
        part = [p[w * window:(w + 1) * window] for p in per_stream]
        yield sh.stack_stream_plans(part, geom, window), \
            [[t for _, t in p] for p in part]


def _stream_frames(windows, decode, carry, n):
    """Every stream's displayed frames through a sharded decoder, the
    reference delay and the end-of-stream flush applied."""
    frames = [[] for _ in range(n)]
    has_ref, last = [False] * n, [0] * n
    for stacked, types in windows:
        carry, disps, _px = decode(carry, stacked)
        disps = torch.cat(disps)
        for s in range(n):
            for i, t in enumerate(types[s]):
                last[s] = t
                if t == PICTURE_TYPE_B or has_ref[s]:
                    frames[s].append(disps[s, i])
                else:
                    has_ref[s] = True
    bwd = torch.cat(carry[2])
    for s in range(n):
        if has_ref[s] and last[s] != PICTURE_TYPE_B:
            frames[s].append(bwd[s])
    return frames


def _python_parse(data):
    buf = mpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    return buf


def test_dense_and_audio_buffers_are_pinned():
    """The dense ring's stacks and `Audio`'s buffer are pinned, and every
    copy of the dense and MP2 paths is counted as pinned."""
    dev = _card()
    es = ES.read_bytes()
    tb.reset_transport_counts()
    dec = BatchVideoDecoder(_python_parse(es), window=4, transport="dense",
                            use_native=False, device="cuda")
    assert dec.decode_window()
    ring = dec._scan._ring
    for _ in range(4):
        assert dec.decode_window()
    assert dec._scan._ring is ring           # one ring for the decoder
    bufs = [b for b, _g in ring._bufs if b is not None]
    assert 2 <= len(bufs) <= tb._DENSE_RING
    assert all(b.is_pinned() for b in bufs)
    audio = mpeg.Audio(_python_parse(TESTDATA.joinpath("test.mp2")
                                     .read_bytes()), device="cuda")
    assert audio.decode() is not None
    assert audio._staging.is_pinned()
    torch.cuda.synchronize(dev)
    counts = tb.transport_counts
    assert counts.copies == counts.pinned_copies == 6


def test_new_paths_do_not_block_the_host():
    """With both streams held, one more window or call of the dense
    decoder, the dense scan decoder, the sharded dense decoder (on the
    card and on it twice), `BatchAudioDecoder(out_device=True)` and the
    sharded MP2 synthesis returns while the held work is still pending;
    each equals the same inputs run with nothing held."""
    dev = _card()
    es = ES.read_bytes()
    frames = {}
    for held in (False, True):
        dec = BatchVideoDecoder(_python_parse(es), window=4,
                                transport="dense", use_native=False,
                                device="cuda")
        assert dec.decode_window()
        torch.cuda.synchronize()
        if held:
            _hold(dev)
        frames[held] = [f.clone() for f in dec.decode_window()]
        if held:
            assert _busy(dev), "the dense BatchVideoDecoder waited"
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*frames.values()))

    geom, plans = _native_plans(es)
    stacked = [tb.stack_plans(plans[a:a + 8], geom, 8) for a in (0, 8)]
    out = {}
    for held in (False, True):
        scan = tb.make_dense_scan_decoder(geom, device="cuda")
        carry = tuple(torch.zeros(geom.total_size, dtype=torch.uint8,
                                  device=dev) for _ in range(3))
        carry, _d = scan(carry, stacked[0])
        torch.cuda.synchronize()
        if held:
            _hold(dev)
        out[held] = scan(carry, stacked[1])[1]
        if held:
            assert _busy(dev), "make_dense_scan_decoder waited"
        torch.cuda.synchronize()
    assert torch.equal(out[False], out[True])

    windows = list(_dense_windows([plans[:16], plans[:13]], geom, 8))
    for devices in (None, [str(dev), str(dev)]):
        got = {}
        for held in (False, True):
            mesh = sh.make_mesh(devices)
            decode = sh.make_sharded_scan_decoder(geom, mesh)
            carry, _d, _px = decode(sh.zero_carry(geom, 2, mesh),
                                    windows[0][0])
            torch.cuda.synchronize()
            if held:
                _hold(dev)
            got[held] = decode(carry, windows[1][0])[1]
            if held:
                assert _busy(dev), f"the sharded dense decode on " \
                    f"{mesh.devices} waited"
            torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*got.values()))

    mp2 = TESTDATA.joinpath("test.mp2").read_bytes()
    pcm = {}
    for held in (False, True):
        adec = BatchAudioDecoder(mp2, window=32, out_device=True,
                                 device="cuda")
        adec.decode_window()
        torch.cuda.synchronize()
        if held:
            _hold(dev)
        pcm[held] = adec.decode_window()
        if held:
            assert _busy(dev), "BatchAudioDecoder(out_device=True) waited"
        torch.cuda.synchronize()
    assert torch.equal(pcm[False], pcm[True])

    from mpeg_tpu_torch.native import NativeAudioParser

    parser, sub = NativeAudioParser(mp2), []
    while (f := parser.parse_next_frame()) is not None:
        sub.append(f)
    samples = np.stack([np.asarray(sub[4 * s:4 * s + 32], np.int32)
                        .reshape(-1, 2, 32) for s in range(4)])
    for devices in (None, [str(dev), str(dev)]):
        u = {}
        for held in (False, True):
            mesh = sh.make_mesh(devices)
            synth = sh.make_sharded_audio_synth(mesh)
            hist = sh.zero_audio_hist(4, mesh)
            torch.cuda.synchronize()
            if held:
                _hold(dev)
            x = samples.copy()
            u[held] = torch.cat(synth(x, hist)[0])
            x[:] = 0                 # the caller reuses its samples at once
            if held:
                assert _busy(dev), f"the sharded synthesis on " \
                    f"{mesh.devices} waited"
            torch.cuda.synchronize()
        assert torch.equal(u[False].view(torch.int32),
                           u[True].view(torch.int32))


def test_adversary_dense_paths_1080p():
    """The 1080p fixture cut to 9 pictures through the dense
    `BatchVideoDecoder` at window 4, and four streams of it (32, 25, 32 and
    17 pictures) through the sharded dense decoder on the card listed
    twice at window 8, both streams held before every window or call and
    the caller's stacks overwritten after each call: every frame equal
    to the C++ host decoder's, K1 once a step a shard."""
    from mpeg_tpu_torch.ops import cuda_kernels

    dev = _card()
    data = FIXTURE_1080P.read_bytes()
    cut, = _cuts(data, (9,))
    dec = BatchVideoDecoder(_python_parse(cut), window=4, transport="dense",
                            use_native=False, device="cuda")
    frames = []
    while True:
        _hold(dev)
        got = dec.decode_window()
        if not got:
            break
        frames.extend(got)
    torch.cuda.synchronize()
    fs = dec.geom.frame_size
    _assert_frames(frames, _host_frames(cut, fs), fs, "dense 1080p cut")
    assert len(dec._scan._ring._bufs) <= tb._DENSE_RING

    cuts = _cuts(data, (None, 25, None, 17))
    parsed = [_native_plans(c) for c in cuts]
    geom = parsed[0][0]
    mesh = sh.make_mesh([str(dev), str(dev)])
    decode = sh.make_sharded_scan_decoder(geom, mesh)

    def held_decode(carry, stacked):
        _hold(dev)
        got = decode(carry, stacked)
        for v in stacked.values():
            v[...] = -1
        return got

    cuda_kernels.reset_launches()
    frames = _stream_frames(_dense_windows([p for _, p in parsed], geom, 8),
                            held_decode, sh.zero_carry(geom, 4, mesh), 4)
    torch.cuda.synchronize()
    assert cuda_kernels.reconstruct_picture.launches == 4 * 8 * 2
    for s in range(4):
        _assert_frames(frames[s], _host_frames(cuts[s], fs), fs,
                       f"sharded dense stream {s}")
