"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, byte for byte.  Marked `cuda`: each test skips inside its body
when no CUDA device is present (run them on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py -q`: the suite's
conftest sets up jax, which the card's machine need not have)."""

import pathlib

import numpy as np
import pytest
import torch

from mpeg_tpu.ops.video_recon import FrameGeometry
from mpeg_tpu.utils import Fnv1a64
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.ops import video_recon as tvr
from mpeg_tpu_torch.testing import plan_args, random_blocks, random_plan

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def test_idct_kernel_matches_plain():
    dev = _card()
    coeffs, nblocks = random_blocks(np.random.default_rng(4),
                                    [0, 1, 2, 5, 9, 10, 33, 64], 301)
    c, n = torch.from_numpy(coeffs).to(dev), torch.from_numpy(nblocks).to(dev)
    before = cuda_kernels.idct_batch.launches
    got = cuda_kernels.idct_batch(c, n)
    torch.cuda.synchronize()
    assert cuda_kernels.idct_batch.launches == before + 1
    assert torch.equal(got, tvr.idct_batch(c, n))


@pytest.mark.parametrize("size", [(80, 48), (272, 64), (1920, 1080)])
def test_reconstruct_kernel_matches_plain(size):
    dev = _card()
    rng = np.random.default_rng(11)
    geom = FrameGeometry.for_size(*size)
    cur, fwd, bwd = (torch.from_numpy(rng.integers(0, 256, geom.total_size)
                                      .astype(np.uint8)).to(dev)
                     for _ in range(3))
    for trial in range(4):
        args = plan_args(random_plan(geom, rng, 1 + trial % 2), dev)
        if trial == 3:
            fwd = bwd
        got = cuda_kernels.reconstruct_picture(cur, fwd, bwd, *args, geom)
        want = tvr.reconstruct_picture(cur, fwd, bwd, *args, geom)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{size} trial {trial}"
        cur, fwd, bwd = got, bwd, cur


@pytest.mark.parametrize("size", [(80, 48), (272, 64), (1920, 1080)])
def test_reconstruct_multi_kernel_matches_plain(size):
    """K3 (K2, then the luma and the Cb|Cr plane launches) byte-equal to
    its plain version, with K2's residual and with the plain IDCT's."""
    dev = _card()
    rng = np.random.default_rng(12)
    geom = FrameGeometry.for_size(*size)
    cur, fwd, bwd = (torch.from_numpy(rng.integers(0, 256, geom.total_size)
                                      .astype(np.uint8)).to(dev)
                     for _ in range(3))
    for trial in range(4):
        args = plan_args(random_plan(geom, rng, 1 + trial % 2), dev)
        if trial == 3:
            fwd = bwd
        want = tvr.reconstruct_picture_multi(cur, fwd, bwd, *args, geom)
        for pallas_idct in (True, False):
            cuda_kernels.reset_launches()
            got = cuda_kernels.reconstruct_picture_multi(
                cur, fwd, bwd, *args, geom, pallas_idct=pallas_idct)
            torch.cuda.synchronize()
            assert cuda_kernels.reconstruct_picture_multi.launches == 2
            assert cuda_kernels.idct_batch.launches == int(pallas_idct)
            assert torch.equal(got, want), f"{size} trial {trial}"
        cur, fwd, bwd = want, bwd, cur


def test_stream_batched_reconstruct_matches_single_launches():
    """One K1 launch over S streams of a frame pool equals S
    single-picture launches: P, B and reference steps, a no-op stream,
    picture indices out of stream order."""
    dev = _card()
    rng = np.random.default_rng(13)
    geom = FrameGeometry.for_size(272, 64)
    s_n = 6
    pool = torch.from_numpy(rng.integers(0, 256, (4 * s_n, geom.total_size))
                            .astype(np.uint8)).to(dev)
    plans = [plan_args(random_plan(geom, rng, 1 + s % 2), dev)
             for s in range(s_n)]
    stacked = [torch.stack(a) for a in zip(*plans)]
    rows = []
    for s in range(s_n):
        c, f, b, o = 4 * s, 4 * s + 1, 4 * s + 2, 4 * s + 3
        rows.append([c, b if s % 3 == 0 else f, b, o,
                     -1 if s == 4 else s_n - 1 - s])
    table = torch.tensor(rows, dtype=torch.int32, device=dev)
    before = pool.clone()
    cuda_kernels.reset_launches()
    cuda_kernels.reconstruct_pictures(pool, table, *stacked, geom)
    torch.cuda.synchronize()
    assert cuda_kernels.reconstruct_picture.launches == 1
    for c, f, b, o, pic in rows:
        if pic < 0:
            assert torch.equal(pool[o], before[o])
            continue
        want = cuda_kernels.reconstruct_picture(before[c], before[f],
                                                before[b], *plans[pic],
                                                geom)
        assert torch.equal(pool[o], want), f"stream of picture {pic}"
    want_pool = tvr.reconstruct_pictures(before.clone(), table, *stacked,
                                         geom)
    assert torch.equal(pool, want_pool)


def test_wrappers_refuse_bad_inputs():
    dev = _card()
    geom = FrameGeometry.for_size(80, 48)
    frame = torch.zeros(geom.total_size, dtype=torch.uint8, device=dev)
    args = list(plan_args(random_plan(geom, np.random.default_rng(0), 1),
                          dev))
    with pytest.raises(ValueError):
        cuda_kernels.reconstruct_picture(frame, frame, frame[:-1], *args,
                                         geom)
    with pytest.raises(ValueError):
        cuda_kernels.reconstruct_picture_multi(frame, frame.cpu(), frame,
                                               *args, geom)
    bad = list(args)
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(ValueError):
        cuda_kernels.reconstruct_picture(frame, frame, frame, *bad, geom)
    with pytest.raises(ValueError):
        cuda_kernels.reconstruct_picture_multi(frame, frame, frame, *bad,
                                               geom)
    c = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cuda_kernels.idct_batch(c, torch.zeros(4, dtype=torch.int32))
    # The stream-batched K1: pool, slot table, leading picture axis.
    pool = torch.zeros((4, geom.total_size), dtype=torch.uint8, device=dev)
    plan = [a[None] for a in args]
    table = torch.tensor([[0, 1, 2, 3, 0]], dtype=torch.int32, device=dev)
    for bad_table in (table.to(torch.int64), table.cpu(), table[:, :4],
                      table[0], table[:0],
                      table.repeat_interleave(2, dim=1)[:, ::2]):
        with pytest.raises(ValueError):
            cuda_kernels.reconstruct_pictures(pool, bad_table, *plan, geom)
    with pytest.raises(ValueError):
        cuda_kernels.reconstruct_pictures(pool[:, :-1], table, *plan, geom)
    with pytest.raises(ValueError):
        cuda_kernels.reconstruct_pictures(pool, table, *args, geom)
    assert cuda_kernels.reconstruct_pictures(pool, table, *plan, geom) \
        is pool


def test_multistream_on_card_matches_cpu():
    """Four streams at window 4 on the card (stream-batched K1, two
    chunks) equal the port's CPU decode frame for frame."""
    from mpeg_tpu_torch.parallel import MultiStreamVideoDecoder

    _card()
    root = pathlib.Path(__file__).parent / "testdata"
    es = (root / "test.mpeg1video").read_bytes()
    ps = (root / "test.mpg").read_bytes()
    sources = [es, ps, es[:len(es) // 3], es[:len(es) // 2]]
    want = MultiStreamVideoDecoder(sources, window=4, chunks=2,
                                   device="cpu").decode_all()
    cuda_kernels.reset_launches()
    ms = MultiStreamVideoDecoder(sources, window=4, chunks=2, device="cuda")
    got = ms.decode_all()
    assert 0 < cuda_kernels.reconstruct_picture.launches
    for s in range(4):
        assert len(got[s]) == len(want[s]) > 0
        for i, (a, b) in enumerate(zip(got[s], want[s])):
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), b), (s, i)


def test_decoder_golden_on_card():
    from mpeg_tpu_torch.parallel import BatchVideoDecoder

    _card()
    data = (pathlib.Path(__file__).parent / "testdata" /
            "test.mpeg1video").read_bytes()
    dec = BatchVideoDecoder(data, window=16, device="cuda")
    cuda_kernels.reset_launches()
    frames = dec.decode_all()
    h = Fnv1a64()
    for f in frames:
        assert f.device.type == "cuda"
        h.write(f[:dec.geom.frame_size].cpu().numpy().tobytes())
    assert len(frames) == 260
    assert h.sum64() == 0xEA6D7FCB1340BA3F
    assert cuda_kernels.reconstruct_picture.launches == len(dec._types)
