"""The MP2 sample copies on the CPU: `BatchAudioDecoder` packs each
window into a buffer of its `HostRing` (its tail zeroed) and
`make_sharded_audio_synth` stages each shard through the ring of its
device, every copy pending for a few polls and no host buffer written
while its copy pends (the gate stand-ins of
tests/test_torch_transport.py); `Audio` and `MPEG` copy each frame from
their one host buffer on the synthesis's stream.  Against the JAX package: the windows'
PCM and the carried history of `BatchAudioDecoder` in f32 and s16, with
`out_device` on and off, a short last window after full ones; the
sharded synthesis with the caller's samples overwritten after each call;
`Audio` and `MPEG` on the audio golden.  Tolerance: exact (bit for bit)."""

import io

import numpy as np
import pytest
import torch

import mpeg_tpu_torch as tmpeg
from mpeg_tpu.parallel import BatchAudioDecoder as JaxBatchAudioDecoder
from mpeg_tpu.parallel import sharding as jsh
from mpeg_tpu_torch.parallel import BatchAudioDecoder
from mpeg_tpu_torch.parallel import batch as tb
from mpeg_tpu_torch.parallel import sharding as sh
from mpeg_tpu_torch.utils import Fnv1a64
from test_torch_transport import LazyGate, _lazy_device_put
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN_AUDIO_HASH = 0xF1B76CDF8E6CDEA5


@pytest.fixture(scope="module")
def mp2(mp2_path):
    return open(mp2_path, "rb").read()


def _windows(dec):
    out = []
    while (pcm := dec.decode_window()) is not None:
        out.append(np.asarray(pcm.cpu() if isinstance(pcm, torch.Tensor)
                              else pcm))
    return out


@pytest.mark.parametrize("out_device", [False, True])
@pytest.mark.parametrize("fmt", ["f32", "s16"])
def test_batch_audio_windows_and_history_match_jax(fmt, out_device,
                                                   monkeypatch, mp2):
    """test.mp2's 355 frames at window 32: eleven full windows and a short
    one of 3 frames, packed into recycled ring buffers whose copies stay
    pending a few polls.  Each window's PCM and the history carried out
    of the short window (15 DCT blocks of its zeroed tail) equal the JAX
    package's, bit for bit."""
    _lazy_device_put(monkeypatch, tb)
    dec = BatchAudioDecoder(mp2, window=32, out_format=fmt,
                            out_device=out_device, device="cpu")
    got = _windows(dec)
    LazyGate.check_live()
    assert not LazyGate.faults
    assert len(dec._ring._bufs) < len(got)   # buffers were reused
    jdec = JaxBatchAudioDecoder(mp2, window=32, out_format=fmt,
                                out_device=out_device)
    want = _windows(jdec)
    assert [len(w) for w in got] == [len(w) for w in want] == \
        [32 * 2304] * 11 + [3 * 2304]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"window {i}"
    np.testing.assert_array_equal(
        dec._hist[0].numpy().view(np.uint32),
        np.asarray(jdec._v).view(np.uint32))


@pytest.mark.parametrize("source", ["audio_native", "audio_python", "mpeg"])
def test_audio_frames_from_one_pinned_buffer_golden(source, monkeypatch, mp2,
                                                    mpg_path):
    """`Audio` (both parsers) and `MPEG(test.mpg)` copy each frame's
    samples from their one host buffer, one copy a frame on the stream
    the synthesis runs on (whose PCM copy back waits for it before the
    buffer is written again): on the audio golden."""
    puts = []
    plain = tb.device_put

    def put(parts, device, current_stream=False):
        puts.append(([p.data_ptr() for p in parts], current_stream))
        return plain(parts, device, current_stream=current_stream)

    monkeypatch.setattr(tb, "device_put", put)
    tb.reset_transport_counts()
    if source == "mpeg":
        m = tmpeg.MPEG(open(mpg_path, "rb"), device="cpu")
        m.set_video_enabled(False)
        decode = m.decode_audio
    else:
        buf = tmpeg.Buffer(io.BytesIO(mp2))
        buf.set_load_callback(buf.load_reader_callback)
        decode = tmpeg.Audio(buf, parser=source.split("_")[1],
                             device="cpu").decode
    h, n = Fnv1a64(), 0
    while (smp := decode()) is not None:
        h.write(smp.interleaved.astype("<f4").tobytes())
        n += 1
    assert (n, h.sum64()) == (355, GOLDEN_AUDIO_HASH)
    assert len(puts) == 355 and all(cur for _p, cur in puts)
    assert len({tuple(ptrs) for ptrs, _c in puts}) == 1
    counts = tb.transport_counts
    assert (counts.copies, counts.bytes) == (355, 355 * 36 * 2 * 32 * 4)


def _subband_frames(path):
    from mpeg_tpu_torch import native

    p = native.NativeAudioParser(open(path, "rb").read())
    frames = []
    while (f := p.parse_next_frame()) is not None:
        frames.append(f)
    return frames


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu"]])
def test_sharded_audio_synth_caller_overwrites(devices, monkeypatch,
                                               mp2_path):
    """Four streams over four shards, and over two shards on one device
    (one staging ring, one copy a shard): u, the history and the total
    equal the JAX package's sharded synthesis on as many of its devices,
    with the caller's samples overwritten right after each call."""
    import jax

    n = 4
    frames = _subband_frames(mp2_path)
    samples = np.stack([
        np.asarray(frames[8 * s:8 * s + 8], np.int32).reshape(-1, 2, 32)
        for s in range(n)])                       # [4, 288, 2, 32]
    _lazy_device_put(monkeypatch, tb)
    jmesh = jsh.make_mesh(jax.devices()[:len(devices)])
    jsynth = jsh.make_sharded_audio_synth(jmesh)
    mesh = sh.make_mesh(devices)
    synth = sh.make_sharded_audio_synth(mesh)
    jhist = jsh.zero_audio_hist(n, jmesh)
    hist = sh.zero_audio_hist(n, mesh)
    tb.reset_transport_counts()
    for half in (samples[:, :144], samples[:, 144:]):
        half = half.copy()
        ju, jhist, jtotal = jsynth(half, jhist)
        want_u, want_hist = np.asarray(ju), np.asarray(jhist)
        u, hist, total = synth(half, hist)
        half[:] = -12345                          # the caller reuses it
        np.testing.assert_array_equal(
            torch.cat(u).numpy().view(np.uint32), want_u.view(np.uint32))
        np.testing.assert_array_equal(
            torch.cat(hist).numpy().view(np.uint32),
            want_hist.view(np.uint32))
        assert total.dtype == torch.int64
        assert int(total) == int(jtotal) == n * 144 * 32
    LazyGate.check_live()
    assert not LazyGate.faults
    assert tb.transport_counts.copies == 2 * len(devices)
