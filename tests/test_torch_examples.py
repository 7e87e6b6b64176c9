"""Smoke tests: every example of the port (examples_torch/) runs end to
end on the default fixtures with `--device cpu` (the mesh examples on a
mesh of repeated CPU devices), in a subprocess with one torch thread."""

import os
import subprocess
import sys

import pytest

from mpeg_tpu_torch import native as _native

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_EXAMPLES = os.path.join(_REPO, "examples_torch")
_TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")

# Without the native parser each example decodes through the Python
# parser: too slow for the suite's time limit.
pytestmark = pytest.mark.skipif(
    not _native.available(),
    reason="examples are too slow on the pure-Python parser")


@pytest.mark.parametrize("name", [
    "batch_decode.py", "av_serving.py", "play.py",
    "multistream_mesh.py", "clip_serving.py", "pipe_streaming.py",
    "multistream_serving.py",
])
def test_example_runs(name, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    args = ["--device", "cpu"]
    if name == "play.py":
        args = [os.path.join(_TESTDATA, "test.mpg"), str(tmp_path)] + args
    elif name == "multistream_mesh.py":
        args += ["cpu"]                      # two shards
    elif name == "clip_serving.py":
        args += ["cpu"] * 3                  # four clips, four shards
    r = subprocess.run([sys.executable, os.path.join(_EXAMPLES, name),
                        *args], capture_output=True, text=True,
                       timeout=480, env=env, cwd=_EXAMPLES)
    assert r.returncode == 0, f"{name}: {r.stderr[-800:]}"
    assert r.stdout.strip(), f"{name} printed nothing"


@pytest.mark.parametrize("name", ["batch_decode.py", "multistream_mesh.py"])
def test_example_default_is_the_card(name):
    """Without `--device` an example runs on the card (the mesh examples
    on every CUDA device): with no card it fails, and never falls back to
    the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    r = subprocess.run([sys.executable, os.path.join(_EXAMPLES, name)],
                       capture_output=True, text=True, timeout=120,
                       cwd=_EXAMPLES)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr, r.stderr[-800:]
