"""The port's multi-process decode (`parallel.multihost`) rehearsed on the
CPU: two worker processes joined by a gloo process group, two streams
each over a mesh of two CPU devices.  Each worker holds every local
stream to the full golden hash (flush frame included) and the reduced
pixel count to the global one; its report line says so."""

import pytest
import torch

from mpeg_tpu_torch.parallel import multihost

GOLDEN = "golden 0xea6d7fcb1340ba3f on all"


def test_two_process_gloo_decode_golden(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    reports = multihost.launch(num_processes=2, local_devices=2,
                               device="cpu", timeout=300)
    assert len(reports) == 2
    for pid, line in enumerate(reports):
        assert line.startswith(f"OK process {pid}/2: 2 local streams of "
                               "4 global"), line
        assert GOLDEN in line, line


def test_backend_and_device_are_explicit(monkeypatch):
    """No fallback: NCCL on the CPU fails in the worker (and launch
    raises), "cuda" without a card raises before any process starts, and
    the default backend is gloo off the card."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert multihost.default_backend(2, 1, "cpu") == "gloo"
    with pytest.raises(RuntimeError, match="needs device='cuda'"):
        multihost.launch(num_processes=1, local_devices=1, device="cpu",
                         backend="nccl", timeout=300)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.launch(num_processes=1, local_devices=1)
