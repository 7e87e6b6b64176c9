"""The frozen plain reference against the repository's goldens, against
the port's C++ host decoder, and the two facts the benchmark's
expectations rest on: a GOP-spliced clip decodes to its GOPs' frames,
and a looped MP2 decodes through the filterbank's state."""

import numpy as np
import pytest

from benchmark import harness, refcache
from benchmark import reference as ref
from benchmark.traffic import generator

TESTDATA = harness.ROOT + "/tests/testdata/"


def fnv64(chunks) -> int:
    from mpeg_tpu_torch.utils import Fnv1a64
    h = Fnv1a64()
    for c in chunks:
        h.write(c.tobytes())
    return h.sum64()


def _read(name):
    with open(TESTDATA + name, "rb") as f:
        return f.read()


def test_the_reference_reproduces_the_video_golden():
    frames = ref.decode_video(_read("test.mpeg1video"))
    assert len(frames) == 260
    assert fnv64(frames) == 0xEA6D7FCB1340BA3F


def test_the_reference_reproduces_the_audio_golden():
    pcm = ref.decode_audio(_read("test.mp2"))
    assert pcm.shape == (355, 2304)
    assert fnv64(pcm.astype("<f4")) == 0xF1B76CDF8E6CDEA5


def test_the_reference_matches_the_ports_host_decoder_at_1080p():
    from mpeg_tpu_torch.native import NativeHostDecoder
    data = _read("test1080.m1v")
    frames = ref.decode_video(data)
    host, out = NativeHostDecoder(data), []
    while (f := host.decode_next()) is not None:
        out.append(f[:frames[0].size])
    assert len(out) == len(frames) == 32
    assert all(np.array_equal(a, b) for a, b in zip(frames, out))


@pytest.fixture(scope="module")
def video_config():
    return harness.load_json(harness.HERE, "configs",
                             "mpeg1_1080p30_gop12.json")


@pytest.fixture(scope="module")
def expected(video_config):
    return refcache.expected(video_config, harness.ROOT, harness.CACHE_DIR)


@pytest.mark.parametrize("gops", [(1, 2), (2, 0, 1), (0, 0)])
def test_a_spliced_clip_decodes_to_its_gops_frames(video_config, expected,
                                                   gops):
    fx = generator.load_fixture(video_config, harness.ROOT)
    frames = ref.decode_video(b"".join(fx.gops[g] for g in gops))
    assert len(frames) == sum(fx.gop_pictures[g] for g in gops)
    for k, f in enumerate(frames):
        assert np.array_equal(f, refcache.clip_frame(expected, gops, k)), k


def test_a_gops_last_picture_hangs_on_what_follows(expected):
    """Why the expectation keeps two versions of each GOP: the middle
    GOP's last picture decodes differently at the end of the stream."""
    mid, eof = expected["gop_frames"][1], expected["gop_frames_eof"][1]
    assert np.array_equal(mid[:-1], eof[:-1])
    assert not np.array_equal(mid[-1], eof[-1])


def test_a_looped_mp2_decodes_through_the_filterbanks_state():
    mp2 = _read("test.mp2")
    one = ref.decode_audio(mp2)
    n = len(one)
    six = ref.decode_audio(mp2 * 6)
    loop = [six[k * n:(k + 1) * n] for k in range(6)]
    assert np.array_equal(loop[0], one)
    # the state carries: a pass starts from the one before's end, at a
    # ring position 768 floats on, so passes 2-5 all differ ...
    assert not np.array_equal(loop[1][0], one[0])
    for a in range(1, 5):
        for b in range(a + 1, 5):
            assert not np.array_equal(loop[a], loop[b]), (a, b)
    # ... and from the second on they repeat every four passes
    assert np.array_equal(loop[5], loop[1])
    exp = {"pcm": six[:refcache.LOOPS * n]}
    assert all(np.array_equal(refcache.pcm_frame(exp, j), six[j])
               for j in range(6 * n))
