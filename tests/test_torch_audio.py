"""The port's MP2 decoders (`mpeg_tpu_torch.Audio`,
`mpeg_tpu_torch.parallel.BatchAudioDecoder`) on the CPU against the
golden hash and the JAX package, byte for byte (tolerance 0)."""

import io
import os
import sys

import numpy as np
import pytest
import torch

import mpeg_tpu as jmpeg
import mpeg_tpu_torch as tmpeg
from mpeg_tpu.parallel import BatchAudioDecoder as JaxBatchAudioDecoder
from mpeg_tpu_torch.parallel import BatchAudioDecoder
from mpeg_tpu_torch.utils import Fnv1a64

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from gen_mp2 import gen_stream  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

# The no-FMA golden (mpeg_test.go:193-197): the only one the port may give.
GOLDEN_AUDIO = 0xF1B76CDF8E6CDEA5


def _port_audio(data: bytes, parser: str, reader: bool = True):
    if reader:
        buf = tmpeg.Buffer(io.BytesIO(data))
        buf.set_load_callback(buf.load_reader_callback)
    else:
        buf = tmpeg.Buffer(None)
        buf.write(data)
        buf.signal_end()
    return tmpeg.Audio(buf, parser=parser, device="cpu")


def _jax_audio(data: bytes, parser: str = "python"):
    buf = jmpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    return jmpeg.Audio(buf, backend="numpy", parser=parser)


def _frames(audio, limit: int = None) -> list:
    out = []
    while (limit is None or len(out) < limit) and \
            (s := audio.decode()) is not None:
        out.append(s.interleaved.copy())
    return out


@pytest.fixture(scope="module")
def mp2(mp2_path) -> bytes:
    return open(mp2_path, "rb").read()


@pytest.fixture(scope="module")
def jax_batch(mp2):
    """The JAX BatchAudioDecoder's whole-stream PCM, f32 and s16."""
    return {fmt: JaxBatchAudioDecoder(mp2, window=32,
                                      out_format=fmt).decode_all()
            for fmt in ("f32", "s16")}


@pytest.mark.parametrize("parser", ["python", "native"])
def test_audio_golden(mp2, parser):
    audio = _port_audio(mp2, parser)
    assert audio.has_header() and audio.samplerate() == 44100
    assert audio.get_channels() == 1
    h = Fnv1a64()
    frames = _frames(audio)
    for f in frames:
        h.write(f.astype("<f4").tobytes())
    assert len(frames) == 355
    assert h.sum64() == GOLDEN_AUDIO, f"{h.sum64():#018x}"


def test_cuda_device_needs_a_card(mp2):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    buf = tmpeg.Buffer(io.BytesIO(mp2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmpeg.Audio(buf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchAudioDecoder(mp2)


def test_samples_formats_match_jax(mp2):
    """Frame 10 (real signal, both signs): interleaved, left/right, s16,
    f32 and bytes() in every format equal to the JAX numpy backend's."""
    port, ref = _port_audio(mp2, "native"), _jax_audio(mp2)
    for _ in range(10):
        s, r = port.decode(), ref.decode()
    assert s.time == r.time and port.get_time() == ref.get_time()
    assert np.count_nonzero(r.interleaved) > 100
    for name in ("interleaved", "left", "right", "s16", "f32"):
        a, b = getattr(s, name), getattr(r, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for fmt in (tmpeg.AudioFormat.F32N, tmpeg.AudioFormat.F32,
                tmpeg.AudioFormat.S16, tmpeg.AudioFormat.F32NLR):
        s.format = r.format = fmt
        assert s.bytes() == r.bytes(), fmt


def test_batch_decoder_matches_jax(mp2, jax_batch):
    """f32 and s16, with and without out_device, and the prefetch thread:
    byte-equal to the JAX BatchAudioDecoder; close() poisons decode."""
    for fmt in ("f32", "s16"):
        host = BatchAudioDecoder(mp2, window=32, out_format=fmt,
                                 device="cpu").decode_all()
        assert host.dtype == jax_batch[fmt].dtype
        np.testing.assert_array_equal(host, jax_batch[fmt], err_msg=fmt)
        dev = BatchAudioDecoder(mp2, window=32, out_format=fmt,
                                out_device=True, device="cpu").decode_all()
        assert isinstance(dev, torch.Tensor)
        np.testing.assert_array_equal(dev.numpy(), host, err_msg=fmt)
    got = BatchAudioDecoder(mp2, window=32, prefetch=True,
                            device="cpu").decode_all()
    np.testing.assert_array_equal(got, jax_batch["f32"])
    dec = BatchAudioDecoder(mp2, window=32, prefetch=True, device="cpu")
    assert dec.decode_window() is not None
    dec.close()
    assert dec.decode_window() is None


def test_batch_s16_is_host_s16_of_f32(jax_batch, mp2):
    f32 = jax_batch["f32"]
    want = np.trunc(np.where(f32 < 0, f32 * np.float32(0x8000),
                             f32 * np.float32(0x7FFF))).astype(np.int16)
    got = BatchAudioDecoder(mp2, window=8, out_format="s16",
                            use_native=False, device="cpu").decode_all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["test.mp2", "test.mpg"])
def test_streaming_feed_matches_jax(name):
    """feed() in chunks then signal_end(): the JAX BatchAudioDecoder's
    whole-buffer PCM (ES and PS; partial windows wait for the end)."""
    data = open(os.path.join(os.path.dirname(__file__), "testdata", name),
                "rb").read()
    want = JaxBatchAudioDecoder(data, window=32).decode_all() \
        if name == "test.mpg" else None
    dec = BatchAudioDecoder(b"", window=32, streaming=True, device="cpu")
    chunks = []
    for i in range(0, len(data), 23456):
        dec.feed(data[i:i + 23456])
        while (pcm := dec.decode_window()) is not None:
            chunks.append(pcm)
        assert dec.needs_input
    dec.signal_end()
    while (pcm := dec.decode_window()) is not None:
        chunks.append(pcm)
    got = np.concatenate(chunks)
    if want is None:   # ES: the golden
        h = Fnv1a64()
        h.write(got.astype("<f4").tobytes())
        assert h.sum64() == GOLDEN_AUDIO
    else:
        np.testing.assert_array_equal(got, want)
    assert dec.samplerate == 44100 and dec.channels == 1


# tests/test_audio_modes.py's streams: (name, mode, bitrate_index,
# samplerate_index, mode_ext, seed, sparsity, channels).
MODES = [
    ("stereo_44k_192", 0x0, 9, 0, 0, 1, 0.10, 2),
    ("stereo_48k_384", 0x0, 13, 1, 0, 2, 0.25, 2),
    ("joint0_44k_384", 0x1, 13, 0, 0, 3, 0.25, 2),
    ("joint3_32k_256", 0x1, 11, 2, 3, 4, 0.20, 2),
    ("dual_48k_256", 0x2, 11, 1, 0, 5, 0.15, 0),
    ("mono_32k_192", 0x3, 9, 2, 0, 6, 0.25, 1),
]


@pytest.mark.parametrize("cfg", MODES, ids=[c[0] for c in MODES])
def test_modes_match_jax_numpy(cfg):
    """Stereo, joint-stereo, dual and mono streams of tools/gen_mp2.py:
    every frame of the port (python and native parse) equal to the JAX
    numpy backend's, and the batch decoder too."""
    _, mode, bi, si, me, seed, sp, channels = cfg
    data = gen_stream(mode, bi, si, mode_ext=me, seed=seed, sparsity=sp)
    want = _frames(_jax_audio(data))
    assert len(want) == 24
    for parser in ("python", "native"):
        audio = _port_audio(data, parser, reader=False)
        got = _frames(audio)
        assert audio.get_channels() == channels
        assert len(got) == len(want), parser
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, b, err_msg=f"{parser} {i}")
    batch = BatchAudioDecoder(data, window=8, device="cpu").decode_all()
    np.testing.assert_array_equal(batch, np.concatenate(want))


@pytest.mark.parametrize("parser", ["python", "native"])
def test_jax_state_resumes_in_port(mp2, parser):
    """A JAX `Audio.get_state()` (V ring, clocks, stream position) set
    into the port's Audio continues exactly as the JAX decoder does; the
    port's own state round-trips too."""
    ref = _jax_audio(mp2, parser)
    _frames(ref, 10)
    state = ref.get_state()
    want = _frames(ref, 5)
    port = _port_audio(mp2, parser)
    _frames(port, 3)
    port.set_state(state)
    got = _frames(port, 5)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    assert port.get_time() == ref.get_time()
    own = port.get_state()
    again = _frames(port, 3)
    port.set_state(own)
    for a, b in zip(_frames(port, 3), again):
        np.testing.assert_array_equal(a, b)
