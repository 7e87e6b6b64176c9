"""Broadcast-profile MP2 (48 kHz joint stereo at 256 kbit/s, the
`mp2_48k_joint_256` benchmark configuration) through the port's
`BatchAudioDecoder` on the CPU, against the JAX package's
`BatchAudioDecoder` and the benchmark's plain reference sample for
sample; the profile's frames held to the spec, the committed fixture to
its generator, and `gen_stream`'s streams to their bytes."""

import hashlib
import os
import sys

import numpy as np
import pytest

from benchmark import reference as ref
from mpeg_tpu.parallel import BatchAudioDecoder as JaxBatchAudioDecoder
from mpeg_tpu_torch.parallel import BatchAudioDecoder

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from gen_mp2 import gen_stream  # noqa: E402
from gen_mp2_broadcast import SEED, gen_broadcast_stream  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

FIXTURE = os.path.join(os.path.dirname(__file__), "testdata",
                       "mp2_48k_joint_256.mp2")

# Two whole windows of 32 and a partial tail; and a 36-frame stream
# played twice, so the filterbank's state carries across the loop.
STREAMS = {"broadcast72": gen_broadcast_stream(72),
           "two_loops_of_36": gen_broadcast_stream(36, seed=7) * 2}


@pytest.fixture(scope="module")
def reference():
    return {name: ref.decode_audio(data) for name, data in STREAMS.items()}


@pytest.fixture(scope="module")
def jax_pcm():
    """The JAX package's BatchAudioDecoder on each stream and window."""
    cache = {}

    def get(stream, window):
        if (stream, window) not in cache:
            cache[stream, window] = JaxBatchAudioDecoder(
                STREAMS[stream], window=window).decode_all()
        return cache[stream, window]
    return get


@pytest.mark.parametrize("window", [32, 8])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_batch_decoder_equals_the_reference(reference, jax_pcm, stream,
                                            native, window):
    want = reference[stream]
    assert want.shape == (72, 2304)
    dec = BatchAudioDecoder(STREAMS[stream], window=window,
                            use_native=native, device="cpu")
    assert (dec.channels, dec.samplerate) == (2, 48000)
    got = dec.decode_all()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.reshape(-1))
    np.testing.assert_array_equal(got, np.asarray(jax_pcm(stream, window)))
    # two channels that differ: the bound leaves the upper subbands
    # joint, the lower ones apart
    assert not np.array_equal(want[:, 0::2], want[:, 1::2])


def _headers(data: bytes) -> list:
    assert len(data) % 768 == 0
    return [data[i:i + 4] for i in range(0, len(data), 768)]


def test_the_profiles_frames_are_spec_valid():
    data = gen_broadcast_stream(120)
    mode_ext = set()
    for h in _headers(data):
        assert h[0] == 0xFF and h[1] >> 5 == 0b111
        assert (h[1] >> 3) & 3 == 0b11        # MPEG-1
        assert (h[1] >> 1) & 3 == 0b10        # layer II
        assert h[1] & 1 == 1                  # no CRC
        assert h[2] >> 4 == 12                # 256 kbit/s
        assert (h[2] >> 2) & 3 == 1           # 48 kHz
        assert (h[2] >> 1) & 1 == 0           # no padding
        assert h[3] >> 6 == 1                 # joint stereo
        mode_ext.add((h[3] >> 4) & 3)
    assert mode_ext == {0, 1, 2, 3}
    # each frame is whole: the reference parses all of them
    assert len(ref.decode_audio(data[:24 * 768])) == 24


def test_the_committed_fixture_is_the_generators_output():
    with open(FIXTURE, "rb") as f:
        data = f.read()
    assert len(data) == 500 * 768
    assert data == gen_broadcast_stream(500, SEED)
    assert {(h[3] >> 4) & 3 for h in _headers(data)} == {0, 1, 2, 3}


# SHA-256 (first 16 hex digits) of the streams tests/test_audio_modes.py
# and tests/test_torch_audio.py decode: the broadcast profile leaves them
# as they were.
GEN_STREAM_SHA = [
    ((0x0, 9, 0, 0, 1, 0.10), "381b6c83038e912f"),
    ((0x0, 13, 1, 0, 2, 0.25), "6d6a73ee23df3b19"),
    ((0x1, 13, 0, 0, 3, 0.25), "5fac62278c6ea940"),
    ((0x1, 11, 2, 3, 4, 0.20), "e70c974bc5a9ae9e"),
    ((0x2, 11, 1, 0, 5, 0.15), "22b41c75b95f91b0"),
    ((0x3, 9, 2, 0, 6, 0.25), "29fb3a0174a4681b"),
]


@pytest.mark.parametrize("cfg,sha", GEN_STREAM_SHA,
                         ids=[s for _, s in GEN_STREAM_SHA])
def test_gen_stream_keeps_its_bytes(cfg, sha):
    mode, bi, si, me, seed, sp = cfg
    data = gen_stream(mode, bi, si, mode_ext=me, seed=seed, sparsity=sp)
    assert hashlib.sha256(data).hexdigest()[:16] == sha
