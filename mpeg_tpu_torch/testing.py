"""Seeded adversarial inputs for holding the kernels against their plain
versions (used by `chip_smoke.py` on the card and by the CPU tests).

The recipes are the JAX package's own test recipes, so the same seed gives
the same numpy arrays here and there: `random_plan` is
tests/test_pallas.py `_random_plan`, `random_block` draws like
tests/test_video_kernels.py `random_block`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tables as T
from .video import _PicturePlan


def random_plan(geom, rng: np.random.Generator, ptype: int) -> _PicturePlan:
    """Adversarial picture plan: every MC mode, src_sel 0/1/2, sparse, full
    and DC IDCT classes, intra/predicted mixes, and a few junk motion
    vectors of up to +-3000 that read far outside the frame."""
    mb = geom.mb_size
    p = _PicturePlan(mb)
    p.coeffs[:] = rng.integers(-2047 * 32, 2047 * 32, (mb, 6, 64))
    p.nblocks[:] = rng.integers(0, 65, (mb, 6))
    if ptype == 1:
        p.intra_blk[:] = rng.integers(0, 2, (mb, 6))
    p.src_sel[:] = rng.integers(0, 3, mb)
    p.mv_h[:] = rng.integers(-40, 41, mb)
    p.mv_v[:] = rng.integers(-40, 41, mb)
    junk = rng.integers(0, mb, max(2, mb // 16))
    p.mv_h[junk] = rng.integers(-3000, 3000, junk.size)
    p.mv_v[junk] = rng.integers(-3000, 3000, junk.size)
    return p


def random_block(rng: np.random.Generator, n: int) -> np.ndarray:
    """One int64 [64] block with nonzero coefficients only at zig-zag scan
    positions < n (the last one always nonzero)."""
    block = np.zeros(64, np.int64)
    for scan in range(n):
        if scan == n - 1 or rng.random() < 0.5:
            block[T.ZIG_ZAG[scan]] = int(rng.integers(-2048 * 62, 2048 * 62))
    return block


def random_blocks(rng: np.random.Generator, ns, per_n: int):
    """(coeffs int32 [len(ns)*per_n, 64], nblocks int32 [...]): `per_n`
    random blocks for each coefficient count in `ns`."""
    blocks, counts = [], []
    for n in ns:
        for _ in range(per_n):
            blocks.append(random_block(rng, n))
            counts.append(n)
    return (np.stack(blocks).astype(np.int32),
            np.asarray(counts, np.int32))


def plan_args(plan: _PicturePlan, device) -> tuple:
    """A plan's arrays as the reconstruct's int32 tensor arguments
    (coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v) on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                 .to(device)
                 for a in (plan.coeffs, plan.nblocks, plan.intra_blk,
                           plan.src_sel, plan.mv_h, plan.mv_v))
