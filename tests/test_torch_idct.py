"""The port's exact integer IDCT against the JAX package's Pallas IDCT
(interpret mode) on the same numpy-seeded blocks.  Tolerance: exact
equality — the transform is int32 arithmetic with arithmetic shifts."""

import numpy as np
import pytest
import torch

from mpeg_tpu.ops import video_recon as vr
from mpeg_tpu.ops.pallas_kernels import idct_batch_pallas
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.ops import video_recon as tvr
from mpeg_tpu_torch.testing import random_blocks
from torch_threads import one_torch_thread  # noqa: F401


def _port_idct(coeffs, nblocks):
    return cuda_kernels.idct_batch(torch.from_numpy(coeffs),
                                   torch.from_numpy(nblocks)).numpy()


@pytest.mark.parametrize("n", [0, 1, 2, 5, 9, 10, 33, 64])
def test_idct_matches_pallas(n):
    coeffs, nblocks = random_blocks(np.random.default_rng(100 + n), [n], 40)
    want = np.asarray(idct_batch_pallas(coeffs, nblocks, interpret=True))
    np.testing.assert_array_equal(_port_idct(coeffs, nblocks), want)


def test_idct_variant_select_on_dense_blocks():
    """Every block carries coefficients at all 64 positions, so the
    result shows which variant each count selects (n <= 0 and n < 10
    sparse, n == 1 DC, else full) — the plain version, the wrapper's CPU
    path and the numpy oracle agree with the Pallas kernel."""
    rng = np.random.default_rng(5)
    coeffs = rng.integers(-2047 * 32, 2047 * 32, (512, 64)).astype(np.int32)
    nblocks = rng.integers(-2, 65, 512).astype(np.int32)
    want = np.asarray(idct_batch_pallas(coeffs, nblocks, interpret=True))
    np.testing.assert_array_equal(_port_idct(coeffs, nblocks), want)
    np.testing.assert_array_equal(vr.idct_batch(coeffs, nblocks, np), want)
    plain = tvr.idct_batch(torch.from_numpy(coeffs.reshape(8, 64, 64)),
                           torch.from_numpy(nblocks.reshape(8, 64)))
    np.testing.assert_array_equal(plain.numpy().reshape(512, 64), want)


def test_idct_wrapper_counts_no_cpu_launch():
    """On CPU tensors the wrapper runs the plain version: no kernel
    launch is counted."""
    cuda_kernels.reset_launches()
    coeffs, nblocks = random_blocks(np.random.default_rng(1), [1, 64], 4)
    _port_idct(coeffs, nblocks)
    assert cuda_kernels.idct_batch.launches == 0
