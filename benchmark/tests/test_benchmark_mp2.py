"""The `mp2_batch` cell (broadcast MP2 through `BatchAudioDecoder`) on
the CPU: a sound run is correct, the control is not, the reference's
looped expectation holds for the fixture's 500 frames, and the window
form's roofline counts its bytes as worked out by hand."""

import json
import os

import numpy as np
import pytest

from benchmark import control, harness, refcache
from benchmark import reference as ref
from benchmark.traffic import generator

CELL = "mp2_batch"


@pytest.fixture(scope="module")
def small_mp2(tmp_path_factory):
    """A copy of the benchmark with the cell's mix cut to two items of
    40-100 frames and a warm-up of 8."""
    conftest = harness.load_file_module(
        os.path.join(os.path.dirname(__file__), "conftest.py"),
        "benchmark_tests_conftest")
    dest = conftest.small_copy(tmp_path_factory.mktemp("mp2") / "benchmark")
    path = os.path.join(dest, "traffic", "broadcast_tracks_1_5min.json")
    with open(path) as f:
        spec = json.load(f)
    spec.update(clip_frames=[40, 100], queue_clips=2, warmup_frames=8)
    with open(path, "w") as f:
        json.dump(spec, f)
    return dest


@pytest.fixture(scope="module")
def config():
    return harness.load_json(harness.HERE, "configs",
                             "mp2_48k_joint_256.json")


def test_an_item_is_the_fixture_looped_from_frame_0(config):
    fx = generator.load_fixture(config, harness.ROOT)
    spec = harness.load_json(harness.HERE, "traffic",
                             "broadcast_tracks_1_5min.json")
    traffic = generator.make(spec, fx, 2 ** 31 + 3)
    assert traffic.warmup.audio_frames == 128
    lengths = sorted(c.audio_frames for c in traffic.items)
    assert lengths == [3750, 6250, 8750, 11250]
    for c in traffic.items:
        assert c.gops == () and c.pictures == c.audio_frames
        assert c.data == b"".join(fx.audio_frames[j % 500]
                                  for j in range(c.audio_frames))


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(small_mp2, trace):
    res, lines = harness.run_cell(CELL, 2 ** 31 + 77, 1.0, trace,
                                  device="cpu", folder=small_mp2,
                                  cache_dir=harness.CACHE_DIR)
    assert res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["pcm_compared"]["value"] >= 1
    assert checks["pcm_wrong"]["value"] == 0
    assert checks["frames_missing"]["value"] == 0
    assert "frames_compared" not in checks
    if not trace:
        assert set(res["metrics"]) == {"delivery_p95_ms", "setup_s"}


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 99, 4100000003])
def test_the_control_is_not_correct(small_mp2, seed):
    checks = control.control_checks(CELL, seed, 3000, harness.CACHE_DIR,
                                    folder=small_mp2)
    assert not harness.passed(checks)
    assert checks["pcm_wrong"]["value"] > 0
    assert checks["frames_missing"]["value"] == 0


def test_the_looped_expectation_holds_for_500_frames(config):
    """500 frames of 36 steps move the V ring 1,152,000 floats, a whole
    number of its 1,024: every pass after the first starts where the one
    before did, so passes 2-6 are equal, and `pcm_frame` gives each of
    six loops decoded straight."""
    exp = refcache.expected(config, harness.ROOT, harness.CACHE_DIR)
    fx = generator.load_fixture(config, harness.ROOT)
    n = len(fx.audio_frames)
    six = ref.decode_audio(b"".join(fx.audio_frames) * 6)
    assert six.shape == (6 * n, 2304)
    assert not np.array_equal(six[n], six[0])
    assert np.array_equal(six[2 * n:3 * n], six[n:2 * n])
    assert all(np.array_equal(refcache.pcm_frame(exp, j), six[j])
               for j in range(6 * n))


def test_the_window_rooflines_bytes_by_hand():
    from benchmark.rooflines import k4, k4_window
    # 32 frames of 36 steps: 2 channels x 32 subband samples x 4 B in and
    # the same of float32 PCM out a step; the 15-block history of 2
    # channels x 64 floats once in and once out
    samples_in = 32 * 36 * 2 * 32 * 4
    pcm_out = 32 * 36 * 2 * 32 * 4
    history = 2 * 15 * 2 * 64 * 4
    assert samples_in + pcm_out + history == 605_184
    assert k4_window.window_bytes(32) == 605_184
    assert k4_window.seconds(32) == pytest.approx(605_184 / 3.35e12)
    # a frame of the ring form moves its 8 KiB ring in and out as well
    assert k4_window.seconds(1) < k4.frame_seconds()


def test_the_k4_window_reader_takes_the_harness_frame_count():
    from benchmark.rooflines import k4, k4_window
    reader = harness.load_file_module(
        os.path.join(harness.HERE, "metrics",
                     "k4_window_roofline_share.py"), "metric_k4w")
    frames = 3200
    reading = harness.Reading(
        window_s=1.0, trace={"events": [("void synth_kernel<false>", 0.0,
                                         1e-3)]},
        bound_s={"k4": frames * k4.frame_seconds()})
    want = 100.0 * k4_window.seconds(frames) / 1e-3
    assert reader.read(reading) == pytest.approx(want)
    reading.trace = None
    assert reader.read(reading) is None
