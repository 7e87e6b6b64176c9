"""The benchmark's own tests (`python -m pytest benchmark/tests -q`).
Tests that need a CUDA card carry the `cuda` marker and decide inside
the test, never at import, whether there is one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips inside the test without "
        "one")


# Each cell's traffic cut to a few clips of a few pictures, for runs on
# the CPU: written into a copy of the benchmark's folders.
SMALL_TRAFFIC = {
    "yt8m_queue_120_500s": {"clip_pictures": [12, 24], "queue_clips": 2,
                            "warmup_pictures": 8},
    "yt8m_queue_120_500s_prefetch": {"clip_pictures": [12, 24],
                                     "queue_clips": 2,
                                     "warmup_pictures": 8},
    "ssv2_jobs_64x2_6s": {"clip_pictures": [8, 20], "streams": 4,
                          "jobs": 1, "warmup_pictures": 8},
    "kinetics_player_10s": {"clip_pictures": [12, 20], "queue_clips": 1,
                            "warmup_pictures": 8},
}


def small_copy(dest):
    """A copy of the benchmark's folders at `dest` with SMALL_TRAFFIC's
    mixes and 64 samples a cell; returns its path."""
    import json
    import shutil
    here = os.path.join(ROOT, "benchmark")
    shutil.copytree(here, dest, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for mix, small in SMALL_TRAFFIC.items():
        path = os.path.join(dest, "traffic", f"{mix}.json")
        with open(path) as f:
            spec = json.load(f)
        spec.update(small)
        with open(path, "w") as f:
            json.dump(spec, f)
    for name in os.listdir(os.path.join(dest, "workloads")):
        path = os.path.join(dest, "workloads", name)
        with open(path) as f:
            wl = json.load(f)
        wl["samples"] = 64
        with open(path, "w") as f:
            json.dump(wl, f)
    return str(dest)


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    return small_copy(tmp_path_factory.mktemp("bench") / "benchmark")
