"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, byte for byte.  Marked `cuda`: each test skips inside its body
when no CUDA device is present (run them on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py -q`: the suite's
conftest sets up jax, which the card's machine need not have)."""

import pathlib

import numpy as np
import pytest
import torch

from mpeg_tpu_torch.native import NativeVideoParser
from mpeg_tpu_torch.ops import cuda_kernels
from mpeg_tpu_torch.ops import video_recon as tvr
from mpeg_tpu_torch.ops.video_recon import FrameGeometry
from mpeg_tpu_torch.tables import PICTURE_TYPE_B
from mpeg_tpu_torch.testing import plan_args, random_blocks, random_plan
from mpeg_tpu_torch.utils import Fnv1a64

TESTDATA = pathlib.Path(__file__).parent / "testdata"

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


@pytest.mark.parametrize("s_n, noop", [(6, (4,)), (64, (0, 9, 33, 63))])
def test_stream_batched_reconstruct_matches_single_launches(s_n, noop):
    """One K1 launch over S streams of a frame pool equals S
    single-picture launches: P, B and reference steps, no-op streams
    (first and last among them), picture indices out of stream order."""
    dev = _card()
    rng = np.random.default_rng(13)
    geom = FrameGeometry.for_size(272, 64)
    pool = torch.from_numpy(rng.integers(0, 256, (4 * s_n, geom.total_size))
                            .astype(np.uint8)).to(dev)
    plans = [plan_args(random_plan(geom, rng, 1 + s % 2), dev)
             for s in range(s_n)]
    stacked = [torch.stack(a) for a in zip(*plans)]
    rows = []
    for s in range(s_n):
        c, f, b, o = 4 * s, 4 * s + 1, 4 * s + 2, 4 * s + 3
        rows.append([c, b if s % 3 == 0 else f, b, o,
                     -1 if s in noop else s_n - 1 - s])
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


def _fixture_pictures(dev):
    """The 1080p fixture's 32 pictures in decode order, with the frames
    the plain reconstruct gives each: [(cur, fwd, bwd, plan args)]."""
    parser = NativeVideoParser((TESTDATA / "test1080.m1v").read_bytes())
    geom = parser.geom()
    cur, fwd, bwd = (torch.zeros(geom.total_size, dtype=torch.uint8,
                                 device=dev) for _ in range(3))
    pics = []
    while (item := parser.parse_next_plan()) is not None:
        plan, ptype = item
        args = plan_args(plan, dev)
        is_ref = ptype != PICTURE_TYPE_B
        fwd_eff = bwd if is_ref else fwd
        pics.append((cur, fwd_eff, bwd, args))
        new = tvr.reconstruct_picture(cur, fwd_eff, bwd, *args, geom)
        if is_ref:
            cur, fwd, bwd = fwd, bwd, new
        else:
            cur = new
    return geom, pics


def test_k1_fixture_pictures_match_plain():
    """K1 on the 1080p fixture's 32 real pictures (3 I, 29 P that code
    5-8% of their blocks), byte-equal to the plain version."""
    dev = _card()
    geom, pics = _fixture_pictures(dev)
    assert len(pics) == 32
    for i, (c, f, b, a) in enumerate(pics):
        got = cuda_kernels.reconstruct_picture(c, f, b, *a, geom)
        torch.cuda.synchronize()
        assert torch.equal(got, tvr.reconstruct_picture(c, f, b, *a, geom)), i


@pytest.mark.parametrize("size", [(272, 64), (1920, 1080)])
def test_k1_skips_uncoded_blocks_with_junk(size):
    """Uncoded blocks (nblocks <= 0, some negative) keep nonzero junk
    coefficients, and uncoded intra flags are set: K1 must read neither."""
    dev = _card()
    rng = np.random.default_rng(21)
    geom = FrameGeometry.for_size(*size)
    cur, fwd, bwd = (torch.from_numpy(rng.integers(0, 256, geom.total_size)
                                      .astype(np.uint8)).to(dev)
                     for _ in range(3))
    for trial in range(3):
        plan = random_plan(geom, rng, 1)
        uncoded = rng.random(plan.nblocks.shape) < 0.6
        plan.nblocks[uncoded] = rng.integers(-3, 1, int(uncoded.sum()))
        plan.intra_blk[:] = rng.integers(0, 2, plan.intra_blk.shape)
        if trial == 2:
            plan.src_sel[:] = 0
        args = plan_args(plan, dev)
        got = cuda_kernels.reconstruct_picture(cur, fwd, bwd, *args, geom)
        want = tvr.reconstruct_picture(cur, fwd, bwd, *args, geom)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{size} trial {trial}"


def _edge_plan(geom, rng, edge: str, plane: str = "luma"):
    """A plan whose every macroblock's window in `plane` starts at a
    chosen flat place: past the end of a row ("row_end": the taps
    continue into the next row), in the last rows of the [fwd | bwd]
    stack ("bottom": rows clamp to rows2 - 2 and the c/d taps and the row
    ends reach past 2 * total, where they read 0) or above the first row
    ("top": rows clamp to 0).  Half-pel bits and src_sel vary.  For
    "luma" the chroma windows follow from the halved vectors; for
    "chroma" the vectors are twice the chroma ones, so the Cr window
    (Cb for "top") lands there and the luma windows follow."""
    from mpeg_tpu_torch.video import _PicturePlan

    mb = geom.mb_size
    luma = plane == "luma"
    stride = geom.luma_width if luma else geom.chroma_width
    bw = 16 if luma else 8
    rows2 = 2 * geom.total_size // stride
    base = 0 if luma else geom.luma_size + (
        geom.chroma_size if edge != "top" else 0)
    p = _PicturePlan(mb)
    p.coeffs[:] = rng.integers(-2047 * 32, 2047 * 32, (mb, 6, 64))
    p.nblocks[:] = rng.integers(0, 12, (mb, 6))
    p.src_sel[:] = rng.integers(1, 3, mb)
    for m in range(mb):
        mby, mbx = divmod(m, geom.mb_width)
        row0 = base // stride + mby * bw + (
            geom.total_size // stride if p.src_sel[m] == 2 else 0)
        if edge == "row_end":
            dh = stride - mbx * bw - int(rng.integers(1, bw + 1))
            dv = int(rng.integers(-2, 3))
        elif edge == "bottom":
            dh = int(rng.integers(-mbx * bw, stride - mbx * bw))
            dv = rows2 - 1 - int(rng.integers(0, 20)) - row0
        else:
            dh = int(rng.integers(-mbx * bw, stride - mbx * bw))
            dv = -row0 - int(rng.integers(-4, 30))
        mv = (2 * dh + int(rng.integers(0, 2)),
              2 * dv + int(rng.integers(0, 2)))
        p.mv_h[m], p.mv_v[m] = mv if luma else (2 * mv[0], 2 * mv[1])
    return p


@pytest.mark.parametrize("size", [(80, 48), (272, 64), (1920, 1080)])
@pytest.mark.parametrize("edge", ["row_end", "bottom", "top"])
def test_k1_windows_at_the_edges(size, edge):
    """MC windows that cross row ends, clamp rows (which then repeat)
    and reach past 2 * total: K1 byte-equal to the plain version (the
    chroma stride of 272x64 is 8 modulo 16, so its rows start off the
    16-byte granule)."""
    dev = _card()
    rng = np.random.default_rng(
        [*size, ("row_end", "bottom", "top").index(edge)])
    geom = FrameGeometry.for_size(*size)
    cur, fwd, bwd = (torch.from_numpy(rng.integers(0, 256, geom.total_size)
                                      .astype(np.uint8)).to(dev)
                     for _ in range(3))
    for trial in range(2):
        args = plan_args(_edge_plan(geom, rng, edge), dev)
        f = bwd if trial else fwd        # a reference step: fwd aliases bwd
        got = cuda_kernels.reconstruct_picture(cur, f, bwd, *args, geom)
        want = tvr.reconstruct_picture(cur, f, bwd, *args, geom)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{size} {edge} trial {trial}"


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
    # K1 copies 16-byte granules: a frame that starts off 16 bytes is
    # refused, as are block counts off 8 bytes.
    shifted = torch.zeros(geom.total_size + 8, dtype=torch.uint8,
                          device=dev)[8:]
    with pytest.raises(ValueError, match="aligned"):
        cuda_kernels.reconstruct_picture(frame, shifted, frame, *args, geom)
    odd = list(args)
    odd[1] = torch.zeros(args[1].numel() + 1, dtype=torch.int32,
                         device=dev)[1:].view(args[1].shape)
    with pytest.raises(ValueError, match="aligned"):
        cuda_kernels.reconstruct_picture(frame, frame, frame, *odd, geom)
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
    es = (TESTDATA / "test.mpeg1video").read_bytes()
    ps = (TESTDATA / "test.mpg").read_bytes()
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
    data = (TESTDATA / "test.mpeg1video").read_bytes()
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


def _k3_both(cur, fwd, bwd, args, geom):
    """K3 twice (the whole path, then the plane launches on the plain
    residual), each with its launch counts, against the plain version;
    the pad bytes equal cur's."""
    want = tvr.reconstruct_planes(cur, fwd, bwd, tvr.idct_batch(*args[:2]),
                                  *args[1:], geom)
    cuda_kernels.reset_launches()
    got = cuda_kernels.reconstruct_picture_multi(cur, fwd, bwd, *args, geom)
    torch.cuda.synchronize()
    assert (cuda_kernels.reconstruct_picture_multi.launches,
            cuda_kernels.idct_batch.launches,
            cuda_kernels.reconstruct_picture.launches) == (2, 1, 0)
    assert torch.equal(got, want)
    res = tvr.idct_batch(*args[:2])
    planes = cuda_kernels.reconstruct_planes(cur, fwd, bwd, res, *args[1:],
                                             geom)
    torch.cuda.synchronize()
    assert cuda_kernels.reconstruct_picture_multi.launches == 4
    assert torch.equal(planes, want)
    assert torch.equal(got[geom.frame_size:], cur[geom.frame_size:])
    return got


def test_k3_fixture_pictures_match_plain():
    """K3 on the 1080p fixture's 32 real pictures (3 I, 29 P), byte-equal
    to the plain version, 2 plane launches and 1 K2 a picture."""
    dev = _card()
    geom, pics = _fixture_pictures(dev)
    assert len(pics) == 32
    for c, f, b, a in pics:
        _k3_both(c, f, b, a, geom)


@pytest.mark.parametrize("size", [(80, 48), (272, 64), (1920, 1080)])
def test_k3_skips_uncoded_blocks_with_junk(size):
    """Uncoded blocks (nblocks <= 0, some negative) keep nonzero junk
    coefficients, so K2 gives them a junk residual, and their intra flags
    are set; the plane launches given an all-junk residual there too: K3
    must read none of it."""
    dev = _card()
    rng = np.random.default_rng(22)
    geom = FrameGeometry.for_size(*size)
    cur, fwd, bwd = (torch.from_numpy(rng.integers(0, 256, geom.total_size)
                                      .astype(np.uint8)).to(dev)
                     for _ in range(3))
    for trial in range(3):
        plan = random_plan(geom, rng, 1)
        uncoded = rng.random(plan.nblocks.shape) < 0.6
        plan.nblocks[uncoded] = rng.integers(-3, 1, int(uncoded.sum()))
        plan.intra_blk[:] = rng.integers(0, 2, plan.intra_blk.shape)
        if trial == 2:
            plan.src_sel[:] = 0
        args = plan_args(plan, dev)
        _k3_both(cur, fwd, bwd, args, geom)
        res = torch.where((args[1] > 0)[..., None],
                          tvr.idct_batch(*args[:2]),
                          torch.from_numpy(rng.integers(
                              -2 ** 31, 2 ** 31, (geom.mb_size, 6, 64),
                              dtype=np.int64).astype(np.int32)).to(dev))
        got = cuda_kernels.reconstruct_planes(cur, fwd, bwd, res, *args[1:],
                                              geom)
        torch.cuda.synchronize()
        assert torch.equal(got, tvr.reconstruct_picture(cur, fwd, bwd, *args,
                                                        geom))


@pytest.mark.parametrize("size", [(80, 48), (272, 64), (1920, 1080)])
@pytest.mark.parametrize("edge", ["row_end", "bottom", "top"])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_k3_windows_at_the_edges(size, edge, plane):
    """MC windows that cross row ends, clamp rows and reach past
    2 * total, aimed at the luma launch's and at the Cb|Cr launch's
    windows: K3 byte-equal to the plain version, and K1 (which shares
    the staging) too.  80x48 and 272x64 have an odd mb_width."""
    dev = _card()
    rng = np.random.default_rng(
        [*size, ("row_end", "bottom", "top").index(edge), plane == "luma"])
    geom = FrameGeometry.for_size(*size)
    cur, fwd, bwd = (torch.from_numpy(rng.integers(0, 256, geom.total_size)
                                      .astype(np.uint8)).to(dev)
                     for _ in range(3))
    for trial in range(2):
        args = plan_args(_edge_plan(geom, rng, edge, plane), dev)
        f = bwd if trial else fwd        # a reference step: fwd aliases bwd
        got = _k3_both(cur, f, bwd, args, geom)
        k1 = cuda_kernels.reconstruct_picture(cur, f, bwd, *args, geom)
        torch.cuda.synchronize()
        assert torch.equal(k1, got), f"{size} {edge} {plane} trial {trial}"


def test_k3_refuses_misaligned_inputs():
    """The plane launches copy 16-byte granules: frames and residual that
    start off 16 bytes are refused, as are block counts off 8 bytes."""
    dev = _card()
    geom = FrameGeometry.for_size(80, 48)
    frame = torch.zeros(geom.total_size, dtype=torch.uint8, device=dev)
    args = list(plan_args(random_plan(geom, np.random.default_rng(1), 1),
                          dev))
    res = tvr.idct_batch(*args[:2])
    shifted = torch.zeros(geom.total_size + 8, dtype=torch.uint8,
                          device=dev)[8:]
    cuda_kernels.reset_launches()
    for frames in ((shifted, frame, frame), (frame, shifted, frame),
                   (frame, frame, shifted)):
        with pytest.raises(ValueError, match="aligned"):
            cuda_kernels.reconstruct_planes(*frames, res, *args[1:], geom)
        with pytest.raises(ValueError, match="aligned"):
            cuda_kernels.reconstruct_picture_multi(*frames, *args, geom)
    res_off = torch.zeros(res.numel() + 2, dtype=torch.int32,
                          device=dev)[2:].view(res.shape)
    with pytest.raises(ValueError, match="aligned"):
        cuda_kernels.reconstruct_planes(frame, frame, frame, res_off,
                                        *args[1:], geom)
    odd = torch.zeros(args[1].numel() + 1, dtype=torch.int32,
                      device=dev)[1:].view(args[1].shape)
    with pytest.raises(ValueError, match="aligned"):
        cuda_kernels.reconstruct_planes(frame, frame, frame, res, odd,
                                        *args[2:], geom)
    with pytest.raises(ValueError):
        cuda_kernels.reconstruct_planes(frame, frame, frame, res.cpu(),
                                        *args[1:], geom)
    assert cuda_kernels.reconstruct_picture_multi.launches == 0


# -- the reference-shaped API on the card ------------------------------------

GOLDEN_AUDIO = (355, 0xF1B76CDF8E6CDEA5)      # test.mp2; test.mpg's audio
GOLDEN_VIDEO = (260, 0xEA6D7FCB1340BA3F)      # test.mpeg1video
GOLDEN_PS_VIDEO = (278, 0xD00818EDCAFDC702)   # test.mpg


def _pictures(name: str) -> int:
    """The pictures of a fixture, counted by the C++ parser."""
    from mpeg_tpu_torch.native import NativePipeline

    data = (TESTDATA / name).read_bytes()
    parser = NativePipeline(data) if data[:4] == b"\x00\x00\x01\xBA" \
        else NativeVideoParser(data)
    n = 0
    while parser.parse_next_plan() is not None:
        n += 1
    return n


def _buffer(name: str):
    from mpeg_tpu_torch import Buffer

    buf = Buffer(open(TESTDATA / name, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    return buf


@pytest.mark.parametrize("parser", ["native", "python"])
def test_audio_golden_on_card(parser):
    """The MP2 synthesis on CUDA gives the no-FMA golden bit for bit."""
    from mpeg_tpu_torch import Audio

    _card()
    audio = Audio(_buffer("test.mp2"), parser=parser, device="cuda")
    assert audio._v.device.type == "cuda"
    h, n = Fnv1a64(), 0
    while (s := audio.decode()) is not None:
        h.write(s.interleaved.astype("<f4").tobytes())
        n += 1
    assert (n, h.sum64()) == GOLDEN_AUDIO, f"{n} {h.sum64():#018x}"


def test_batch_audio_on_card_matches_cpu():
    """BatchAudioDecoder on CUDA, f32 and s16, host and out_device
    results, equal to the CPU's."""
    from mpeg_tpu_torch.parallel import BatchAudioDecoder

    _card()
    data = (TESTDATA / "test.mp2").read_bytes()
    for fmt in ("f32", "s16"):
        want = BatchAudioDecoder(data, window=32, out_format=fmt,
                                 device="cpu").decode_all()
        got = BatchAudioDecoder(data, window=32, out_format=fmt,
                                device="cuda").decode_all()
        np.testing.assert_array_equal(got, want, err_msg=fmt)
        dev = BatchAudioDecoder(data, window=32, out_format=fmt,
                                out_device=True, device="cuda").decode_all()
        assert dev.device.type == "cuda"
        np.testing.assert_array_equal(dev.cpu().numpy(), want, err_msg=fmt)


@pytest.mark.parametrize("parser", ["native", "python"])
def test_video_golden_on_card(parser):
    """Video(device="cuda"): the golden, K1 launched once a picture (261
    pictures give 260 frames and the end-of-stream flush)."""
    from mpeg_tpu_torch import Video

    _card()
    video = Video(_buffer("test.mpeg1video"), parser=parser, device="cuda")
    cuda_kernels.reset_launches()
    h, n = Fnv1a64(), 0
    while (f := video.decode()) is not None:
        assert f.flat.device.type == "cuda"
        h.write(f.flat[:video.geom.frame_size].cpu().numpy().tobytes())
        n += 1
    assert (n, h.sum64()) == GOLDEN_VIDEO
    assert cuda_kernels.reconstruct_picture.launches == \
        _pictures("test.mpeg1video")


def test_mpeg_digests_on_card():
    """MPEG(test.mpg, device="cuda"): decode_video and decode_audio on
    the goldens; seek(3.0, True) fires the video callback once."""
    from mpeg_tpu_torch import MPEG

    _card()
    m = MPEG(open(TESTDATA / "test.mpg", "rb"), device="cuda")
    m.set_audio_enabled(False)
    h, n = Fnv1a64(), 0
    cuda_kernels.reset_launches()
    while (f := m.decode_video()) is not None:
        h.write(f.y.tobytes())
        h.write(f.cb.tobytes())
        h.write(f.cr.tobytes())
        n += 1
    assert (n, h.sum64()) == GOLDEN_PS_VIDEO
    assert cuda_kernels.reconstruct_picture.launches == _pictures("test.mpg")
    m = MPEG(open(TESTDATA / "test.mpg", "rb"), device="cuda")
    m.set_video_enabled(False)
    h, n = Fnv1a64(), 0
    while (s := m.decode_audio()) is not None:
        h.write(s.interleaved.astype("<f4").tobytes())
        n += 1
    assert (n, h.sum64()) == GOLDEN_AUDIO
    m = MPEG(open(TESTDATA / "test.mpg", "rb"), device="cuda")
    count = [0]
    m.set_video_callback(lambda mp, f: count.__setitem__(0, count[0] + 1))
    m.set_audio_callback(lambda mp, s: None)
    assert m.seek(3.0, True) and count[0] == 1
