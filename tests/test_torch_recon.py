"""The port's picture reconstruct against the JAX package's fused Pallas
reconstruct (interpret mode) on the same adversarial numpy-seeded plans:
every MC mode, src_sel 0/1/2, sparse/full/DC IDCT classes and junk
motion vectors far outside the frame.  Tolerance: exact equality (all
integer arithmetic)."""

import numpy as np
import pytest
import torch

from mpeg_tpu.ops import video_recon as vr
from mpeg_tpu.ops.pallas_kernels import reconstruct_picture_pallas
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.ops import video_recon as tvr
from mpeg_tpu_torch.testing import plan_args, random_plan
from tests.test_pallas import _random_plan
from torch_threads import one_torch_thread  # noqa: F401


def _port(cur, fwd, bwd, plan, geom):
    frames = [torch.from_numpy(np.array(f)) for f in (cur, fwd, bwd)]
    if fwd is bwd:
        frames[1] = frames[2]
    return cuda_kernels.reconstruct_picture(
        *frames, *plan_args(plan, "cpu"), geom).numpy()


@pytest.mark.parametrize("size", [(80, 48), (272, 64), (160, 120)])
def test_reconstruct_matches_pallas(size):
    rng = np.random.default_rng(11)
    geom = vr.FrameGeometry.for_size(*size)
    cur, fwd, bwd = (rng.integers(0, 256, geom.total_size).astype(np.uint8)
                     for _ in range(3))
    for trial in range(4):
        p = _random_plan(geom, rng, ptype=1 + (trial % 2))
        if trial == 3:
            fwd = bwd            # a reference picture: forward aliases
        want = np.asarray(reconstruct_picture_pallas(
            cur, fwd, bwd, p.coeffs, p.nblocks, p.intra_blk, p.src_sel,
            p.mv_h, p.mv_v, geom, interpret=True))
        got = _port(cur, fwd, bwd, p, geom)
        assert np.array_equal(got, want), \
            f"{size} trial {trial}: {np.flatnonzero(got != want)[:8]}"
        cur, fwd, bwd = got, bwd, cur   # evolve state across trials


def test_reconstruct_int16_motion_vectors_match_oracle():
    """Motion vectors over the whole int16 range the blob can carry: the
    flat address's floor division and the row clamp hold against the
    numpy oracle's CLIP gather."""
    rng = np.random.default_rng(3)
    geom = vr.FrameGeometry.for_size(160, 120)
    frames = [rng.integers(0, 256, geom.total_size).astype(np.uint8)
              for _ in range(3)]
    p = _random_plan(geom, rng, ptype=2)
    p.mv_h[:] = rng.integers(-32768, 32768, geom.mb_size)
    p.mv_v[:] = rng.integers(-32768, 32768, geom.mb_size)
    p.src_sel[:] = rng.integers(1, 3, geom.mb_size)
    want = vr.reconstruct_picture(*frames, p.coeffs, p.nblocks, p.intra_blk,
                                  p.src_sel, p.mv_h, p.mv_v, geom, np)
    np.testing.assert_array_equal(_port(*frames, p, geom), want)


def test_random_plan_recipe_matches_tests():
    """The port's plan generator (used on the card) draws exactly the JAX
    package's test plan from the same seed."""
    geom = vr.FrameGeometry.for_size(272, 64)
    for ptype in (1, 2):
        a = random_plan(geom, np.random.default_rng(ptype), ptype)
        b = _random_plan(geom, np.random.default_rng(ptype), ptype)
        for name in ("coeffs", "nblocks", "intra_blk", "src_sel", "mv_h",
                     "mv_v"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)


def test_reconstruct_wrapper_cpu_path_counts_no_launch():
    """The wrapper hands CPU tensors to the plain version: the result is
    the plain version's and no kernel launch is counted."""
    rng = np.random.default_rng(2)
    geom = vr.FrameGeometry.for_size(80, 48)
    frames = [torch.from_numpy(rng.integers(0, 256, geom.total_size)
                               .astype(np.uint8)) for _ in range(3)]
    args = plan_args(random_plan(geom, rng, 1), "cpu")
    cuda_kernels.reset_launches()
    got = cuda_kernels.reconstruct_picture(*frames, *args, geom)
    assert cuda_kernels.reconstruct_picture.launches == 0
    want = tvr.reconstruct_picture(*frames, *args, geom)
    assert torch.equal(got, want)


def test_reconstruct_bound_on_fixture_pictures():
    """`reconstruct_bound` on the 1080p fixture's first I and P picture:
    256 B a coded block, 64 B a block not coded intra, 60 B of plan a
    macroblock, the written frame and its pad read, at 3.35 TB/s."""
    import pathlib

    from mpeg_tpu_torch.native import NativeVideoParser

    data = (pathlib.Path(__file__).parent / "testdata" /
            "test1080.m1v").read_bytes()
    parser = NativeVideoParser(data)
    geom = parser.geom()
    (i_plan, i_type), (p_plan, p_type) = (parser.parse_next_plan()
                                          for _ in range(2))
    assert (i_type, p_type) == (1, 2)
    frame = geom.total_size + (geom.total_size - geom.frame_size)
    assert (geom.mb_size, geom.total_size, frame) == (8160, 3164160, 3194880)

    def bound(plan):
        return cuda_kernels.reconstruct_bound(
            torch.from_numpy(plan.nblocks), torch.from_numpy(plan.intra_blk),
            geom)

    # The I picture codes every block intra: no prediction is read.
    assert (i_plan.nblocks > 0).all() and (i_plan.intra_blk > 0).all()
    assert bound(i_plan) == {"bytes": 256 * 48960 + 60 * 8160 + frame,
                             "us": 16218240 / 3.35e12 * 1e6}
    coded = int((p_plan.nblocks > 0).sum())
    coded_intra = int(((p_plan.nblocks > 0) & (p_plan.intra_blk > 0)).sum())
    assert 2458 <= coded <= 4130
    want = 256 * coded + 64 * (48960 - coded_intra) + 60 * 8160 + frame
    assert bound(p_plan)["bytes"] == want
    assert 2.0 < bound(p_plan)["us"] < 2.5
    # Leading axes sum over pictures.
    both = cuda_kernels.reconstruct_bound(
        torch.from_numpy(np.stack([i_plan.nblocks, p_plan.nblocks])),
        torch.from_numpy(np.stack([i_plan.intra_blk, p_plan.intra_blk])),
        geom)
    assert both["bytes"] == 16218240 + want
