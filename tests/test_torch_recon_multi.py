"""The port's multi-launch reconstruct (plain version of K3) against the
JAX package's `reconstruct_picture_pallas_multi` in interpret mode, with
the Pallas IDCT and with XLA's, on the same adversarial numpy-seeded plans
(every MC mode, src_sel 0/1/2, junk motion vectors, forward aliasing
backward).  272x64 has mb_width 17, which the reference pads to its
128-lane macroblock groups.  Tolerance: exact equality (all integer
arithmetic)."""

import numpy as np
import pytest
import torch

from mpeg_tpu.ops import video_recon as vr
from mpeg_tpu.ops.pallas_kernels import reconstruct_picture_pallas_multi
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.ops import video_recon as tvr
from mpeg_tpu_torch.testing import plan_args, random_plan
from torch_threads import one_torch_thread  # noqa: F401


def _frames(rng, geom):
    return [rng.integers(0, 256, geom.total_size).astype(np.uint8)
            for _ in range(3)]


@pytest.mark.parametrize("pallas_idct", [True, False])
@pytest.mark.parametrize("size", [(80, 48), (272, 64), (160, 120)])
def test_reconstruct_multi_matches_pallas(size, pallas_idct):
    rng = np.random.default_rng(23 + size[0])
    geom = vr.FrameGeometry.for_size(*size)
    cur, fwd, bwd = _frames(rng, geom)
    # P plans at 80x48 and 160x120, B at 272x64; the pallas_idct=False
    # case makes its reference picture's forward alias its backward.
    p = random_plan(geom, rng, 1 + (size[0] == 272))
    if not pallas_idct:
        fwd = bwd
    want = np.asarray(reconstruct_picture_pallas_multi(
        cur, fwd, bwd, p.coeffs, p.nblocks, p.intra_blk, p.src_sel, p.mv_h,
        p.mv_v, geom, interpret=True, pallas_idct=pallas_idct))
    tc, tf, tb = (torch.from_numpy(f) for f in (cur, fwd, bwd))
    if fwd is bwd:
        tf = tb
    args = plan_args(p, "cpu")
    cuda_kernels.reset_launches()
    got = cuda_kernels.reconstruct_picture_multi(
        tc, tf, tb, *args, geom, pallas_idct=pallas_idct)
    assert cuda_kernels.reconstruct_picture_multi.launches == 0   # CPU
    assert np.array_equal(got.numpy(), want), \
        f"{size}: {np.flatnonzero(got.numpy() != want)[:8]}"
    # K3's bytes are K1's bytes.
    assert torch.equal(got, tvr.reconstruct_picture(tc, tf, tb, *args, geom))


def test_reconstruct_multi_int16_motion_vectors_match_oracle():
    """Motion vectors over the whole int16 range: the per-macroblock
    window starts' floor division and each pixel row's own clamp hold
    against the numpy oracle."""
    rng = np.random.default_rng(5)
    geom = vr.FrameGeometry.for_size(160, 120)
    frames = _frames(rng, geom)
    p = random_plan(geom, rng, 2)
    p.mv_h[:] = rng.integers(-32768, 32768, geom.mb_size)
    p.mv_v[:] = rng.integers(-32768, 32768, geom.mb_size)
    p.src_sel[:] = rng.integers(1, 3, geom.mb_size)
    want = vr.reconstruct_picture(*frames, p.coeffs, p.nblocks, p.intra_blk,
                                  p.src_sel, p.mv_h, p.mv_v, geom, np)
    got = tvr.reconstruct_picture_multi(
        *(torch.from_numpy(f) for f in frames), *plan_args(p, "cpu"), geom)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reconstruct_pictures_steps_streams_in_place():
    """The stream-batched reconstruct (K1's plain version over a frame
    pool): each table row writes its stream's picture into its out slot,
    equal to a single-picture reconstruct of its slots; a row with a
    negative picture index leaves the pool as it was."""
    rng = np.random.default_rng(9)
    geom = vr.FrameGeometry.for_size(80, 48)
    n = 3
    pool = torch.from_numpy(
        rng.integers(0, 256, (4 * n, geom.total_size)).astype(np.uint8))
    plans = [plan_args(random_plan(geom, rng, 1 + s % 2), "cpu")
             for s in range(n)]
    stacked = [torch.stack(a) for a in zip(*plans)]
    # stream 0: P step; stream 1: reference step (fwd aliases bwd);
    # stream 2: no-op.
    table = torch.tensor([[0, 1, 2, 3, 1], [4, 6, 6, 7, 0],
                          [8, 9, 10, 11, -1]], dtype=torch.int32)
    before = pool.clone()
    cuda_kernels.reset_launches()
    got = cuda_kernels.reconstruct_pictures(pool, table, *stacked, geom)
    assert got is pool
    assert cuda_kernels.reconstruct_picture.launches == 0   # CPU: plain
    for cur, fwd, bwd, out, pic in table.tolist():
        if pic < 0:
            assert torch.equal(pool[out], before[out])
            continue
        want = tvr.reconstruct_picture(before[cur], before[fwd],
                                       before[bwd], *plans[pic], geom)
        assert torch.equal(pool[out], want)
    untouched = [s for s in range(4 * n) if s not in (3, 7)]
    assert torch.equal(pool[untouched], before[untouched])
