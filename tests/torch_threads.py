"""One intra-op thread for the port's CPU tests: an autouse fixture that
the tests/test_torch_*.py modules import.

The plain versions run on small tensors, which gain nothing from torch's
intra-op threads, while the suite's worker processes share the machine's
cores: with the default thread count each worker spins on all of them
(about four times the CPU time for the same wall, measured on
tests/test_torch_interactive.py), and every worker slows down."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
