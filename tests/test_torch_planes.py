"""K3's plain split: `video_recon.reconstruct_planes` (the plain version of
the two plane launches, given a residual) against the JAX package's
`reconstruct_picture_pallas_multi` in interpret mode on the same
numpy-seeded plans, the CPU path of the K3 wrappers, and the K3 path's
byte floor.  Tolerance: exact equality (all integer arithmetic)."""

import pathlib

import numpy as np
import pytest
import torch

from mpeg_tpu.ops import video_recon as vr
from mpeg_tpu.ops.pallas_kernels import reconstruct_picture_pallas_multi
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.ops import video_recon as tvr
from mpeg_tpu_torch.testing import plan_args, random_plan
from torch_threads import one_torch_thread  # noqa: F401

TESTDATA = pathlib.Path(__file__).parent / "testdata"


def _junk_plan(geom, rng):
    """An adversarial P plan with more junk motion vectors (every eighth
    macroblock, up to +-3000) and uncoded blocks (nblocks <= 0, some
    negative) that keep nonzero junk coefficients."""
    p = random_plan(geom, rng, 1)
    junk = rng.integers(0, geom.mb_size, max(2, geom.mb_size // 8))
    p.mv_h[junk] = rng.integers(-3000, 3000, junk.size)
    p.mv_v[junk] = rng.integers(-3000, 3000, junk.size)
    uncoded = rng.random(p.nblocks.shape) < 0.5
    p.nblocks[uncoded] = rng.integers(-3, 1, int(uncoded.sum()))
    return p


@pytest.mark.parametrize("aliased", [False, True])
@pytest.mark.parametrize("size", [(80, 48), (160, 120)])
def test_planes_match_pallas_multi(size, aliased):
    """reconstruct_planes(idct_batch(coeffs), ...) byte-equal to the
    reference's multi-launch Pallas reconstruct; `aliased` makes fwd
    alias bwd (a reference picture)."""
    rng = np.random.default_rng([*size, aliased])
    geom = vr.FrameGeometry.for_size(*size)
    cur, fwd, bwd = (rng.integers(0, 256, geom.total_size).astype(np.uint8)
                     for _ in range(3))
    if aliased:
        fwd = bwd
    p = _junk_plan(geom, rng)
    assert (p.nblocks <= 0).any() and (p.coeffs[p.nblocks <= 0] != 0).any()
    want = np.asarray(reconstruct_picture_pallas_multi(
        cur, fwd, bwd, p.coeffs, p.nblocks, p.intra_blk, p.src_sel, p.mv_h,
        p.mv_v, geom, interpret=True))
    tc, tb = torch.from_numpy(cur), torch.from_numpy(bwd)
    tf = tb if aliased else torch.from_numpy(fwd)
    args = plan_args(p, "cpu")
    got = tvr.reconstruct_planes(tc, tf, tb, tvr.idct_batch(*args[:2]),
                                 *args[1:], geom)
    assert np.array_equal(got.numpy(), want), \
        f"{size}: {np.flatnonzero(got.numpy() != want)[:8]}"


@pytest.mark.parametrize("pallas_idct", [True, False])
def test_k3_wrappers_cpu_path_same_bytes_no_launch(pallas_idct):
    """On the CPU the K3 wrappers run the plain versions: the multi
    wrapper gives the bytes it gave before the split (the fused plain
    reconstruct's), the planes wrapper the same from the residual, and
    neither K2 nor a plane launch is counted."""
    rng = np.random.default_rng(31)
    geom = vr.FrameGeometry.for_size(160, 120)
    frames = [torch.from_numpy(rng.integers(0, 256, geom.total_size)
                               .astype(np.uint8)) for _ in range(3)]
    args = plan_args(_junk_plan(geom, rng), "cpu")
    cuda_kernels.reset_launches()
    got = cuda_kernels.reconstruct_picture_multi(*frames, *args, geom,
                                                 pallas_idct=pallas_idct)
    planes = cuda_kernels.reconstruct_planes(
        *frames, tvr.idct_batch(*args[:2]), *args[1:], geom)
    assert (cuda_kernels.reconstruct_picture_multi.launches,
            cuda_kernels.idct_batch.launches,
            cuda_kernels.reconstruct_picture.launches) == (0, 0, 0)
    want = tvr.reconstruct_picture(*frames, *args, geom)
    assert torch.equal(got, want)
    assert torch.equal(planes, want)
    assert torch.equal(got[geom.frame_size:], frames[0][geom.frame_size:])


def test_planes_never_read_uncoded_residual():
    """The residual of an uncoded block is junk that compose never reads:
    any values there give the same frame."""
    rng = np.random.default_rng(32)
    geom = vr.FrameGeometry.for_size(80, 48)
    frames = [torch.from_numpy(rng.integers(0, 256, geom.total_size)
                               .astype(np.uint8)) for _ in range(3)]
    args = plan_args(_junk_plan(geom, rng), "cpu")
    res = tvr.idct_batch(*args[:2])
    junk = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, tuple(res.shape),
                                         dtype=np.int64).astype(np.int32))
    res_junk = torch.where((args[1] > 0)[..., None], res, junk)
    assert not torch.equal(res_junk, res)
    assert torch.equal(
        tvr.reconstruct_planes(*frames, res_junk, *args[1:], geom),
        tvr.reconstruct_planes(*frames, res, *args[1:], geom))


@pytest.mark.parametrize("picture", ["I", "P"])
def test_k3_path_bound_on_fixture_pictures(picture):
    """The K3 path's floor on the 1080p fixture's first I and first P
    picture: the plane launches' bytes (K1's count, residual in place of
    coefficients) plus K2's 516 B for each of the 48,960 blocks."""
    from mpeg_tpu_torch.native import NativeVideoParser

    parser = NativeVideoParser((TESTDATA / "test1080.m1v").read_bytes())
    geom = parser.geom()
    plans = [parser.parse_next_plan() for _ in range(2)]
    plan, ptype = plans["IP".index(picture)]
    assert ptype == 1 + "IP".index(picture)
    nb, ib = torch.from_numpy(plan.nblocks), torch.from_numpy(plan.intra_blk)
    planes = cuda_kernels.reconstruct_bound(nb, ib, geom)
    path = cuda_kernels.reconstruct_bound(nb, ib, geom, separate_idct=True)
    assert path["bytes"] == planes["bytes"] + 516 * 48960 == \
        planes["bytes"] + 25263360
    assert path["us"] == path["bytes"] / 3.35e12 * 1e6
    if picture == "I":
        assert path["bytes"] == 16218240 + 25263360
        assert 12.38 < path["us"] < 12.39
    else:
        assert 2.0 < planes["us"] < 2.5 and 9.5 < path["us"] < 10.0
    assert path["us"] > planes["us"]
