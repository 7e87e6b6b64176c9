"""K5 (csrc/densify.cu, `ops.cuda_kernels.densify_unpack`) against its
plain version on the card: every coded block's coefficients and every
metadata tensor of `parallel.batch.densify_unpack`, bit for bit, on native
fixture blobs at windows 4 and 16, a stack of three streams, the
hop-record blob, the malformed chains (clamped, and wrapping between two
record tiles and inside one), `_edge_blob`'s partition edges and a call
of one sorted and one wrapping stream; K5's outputs start on memory left
full of junk.  Also its refusals, its scratch size and its
launches on the decoders' paths, with neither plain function run on a
CUDA tensor.  Marked `cuda`: each test skips inside its body without a
card (`python -m pytest --noconftest tests/test_torch_k5_cuda.py -q -m
cuda`).  This module imports only the port, so that it runs where JAX is
not installed; tests/test_torch_k5.py shares its helpers."""

import io
import pathlib

import numpy as np
import pytest
import torch

from mpeg_tpu_torch.ops import cuda_kernels as ck
from mpeg_tpu_torch.ops.video_recon import FrameGeometry
from mpeg_tpu_torch.parallel import batch as tb
from mpeg_tpu_torch.tables import PREMULTIPLIER_MATRIX
from torch_threads import one_torch_thread  # noqa: F401


ES = pathlib.Path(__file__).parent / "testdata" / "test.mpeg1video"
PREMULT = torch.tensor(PREMULTIPLIER_MATRIX, dtype=torch.int32)
NB_CLASS_REP = torch.tensor(tb._NB_CLASS_REP, dtype=torch.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_streams(got, wants, coded_only=False):
    """`densify_unpack`'s (coeffs, meta) against one (coeffs, meta) a
    stream, stacked stream-major; with `coded_only` the coefficients of
    coded blocks (nblocks > 0) only, as K5 writes them."""
    coeffs, meta = (got[0].cpu().numpy(),
                    {k: v.cpu().numpy() for k, v in got[1].items()})
    want_c = np.concatenate([c for c, _ in wants])
    want_m = {k: np.concatenate([m[k] for _, m in wants]) for k in wants[0][1]}
    assert set(meta) == set(want_m)
    for k, v in want_m.items():
        assert meta[k].dtype == np.int32, k
        np.testing.assert_array_equal(meta[k], v, err_msg=k)
    assert coeffs.shape == want_c.shape and coeffs.dtype == np.int32
    if coded_only:
        coded = want_m["nblocks"] > 0
        np.testing.assert_array_equal(coeffs[coded], want_c[coded])
    else:
        np.testing.assert_array_equal(coeffs, want_c)


def _native_blobs(path, window, n):
    """The first `n` native window blobs of a stream: (geom, [(blob, km,
    ke, fill)])."""
    dec = tb.BatchVideoDecoder(open(path, "rb").read(), window=window,
                              device="cpu")
    out = []
    for _ in range(n):
        blob, types, fill = dec._native_window_blob()
        assert len(types) == window
        out.append((np.asarray(blob).copy(), dec._km, dec._ke, fill))
    return dec.geom, out


def _common_stack(blobs, geom, window):
    """Blobs of one geometry re-laid to common buckets: (stack uint8 [S,
    bytes], km, ke)."""
    km = max(b[1] for b in blobs)
    ke = max(b[2] for b in blobs)
    total = tb.blob_layout(geom, window, km, ke)[1]
    stack = np.zeros((len(blobs), total), np.uint8)
    for s, (blob, bkm, bke) in enumerate(blobs):
        src = tb.blob_views(blob, geom, window, bkm, bke)
        dst = tb.blob_views(stack[s], geom, window, km, ke)
        for k in src:
            dst[k][:src[k].size] = src[k]
    return stack, km, ke


def _malformed_blob(km, first=0xFFFF):
    """64x48 at window 2: every main record a 0xFFFF delta of quotient 3
    (the first one's delta `first`), every escape a 0xFFFF delta of value
    7; the metadata all zero."""
    geom = FrameGeometry.for_size(64, 48)
    window, ke = 2, 64
    _, total = tb.blob_layout(geom, window, km, ke)
    blob = np.zeros(total, np.uint8)
    v = tb.blob_views(blob, geom, window, km, ke)
    v["main_rec"][0::2] = 0xFFFF
    v["main_rec"][0] = first
    v["main_rec"].view(np.int16)[1::2] = 3
    v["esc_didx"][:] = 0xFFFF
    v["esc_val"][:] = 7
    return geom, window, ke, blob


def _split(blob, geom, window, km, ke, kt=None):
    split = tb.blob_split(geom, window, km, ke)
    return (_t(blob[:split]),
            _t(blob[split:split + 4 * (km if kt is None else kt)]))


def _hop_plans(geom):
    """Sparse pictures whose index gaps within and across pictures exceed
    64K (tests/test_torch_densify.py's, with the port's plan type)."""
    from mpeg_tpu_torch.tables import (PICTURE_TYPE_INTRA,
                                       PICTURE_TYPE_PREDICTIVE)
    from mpeg_tpu_torch.video import _PicturePlan

    mb = geom.mb_size
    rng = np.random.default_rng(9)
    plans = []
    for ptype in (PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE):
        p = _PicturePlan(mb)
        for m, b, pos in [(0, 0, 0), (mb // 3, 2, 17), (mb - 1, 5, 63)]:
            p.coeffs[m, b, pos] = int(rng.integers(2, 60)) * 32
            p.nblocks[m, b] = pos + 1
            p.intra_blk[m, b] = 1 if ptype == PICTURE_TYPE_INTRA else 0
        plans.append((p, ptype))
    plans[1][0].coeffs[0, 0, 0] = 0
    plans[1][0].nblocks[0, 0] = 0
    return plans


def _edge_plans(geom):
    """An I and a P picture built so that K5's partition meets its edge
    cases.  In the I picture macroblocks 0 and 2-12 are dense (every
    coefficient a main record) and macroblock 1 between them has none;
    block 0 of macroblock 0 stops at 37 coefficients, so that main record
    4,096 (a record tile's first) falls at position 27 of block 5 of
    macroblock 11; block 3 of macroblock 5 holds only escapes (values with
    no exact int16 quotient).  The P picture has three sparse blocks whose
    index gaps need hop records."""
    from mpeg_tpu_torch.tables import (PICTURE_TYPE_INTRA,
                                       PICTURE_TYPE_PREDICTIVE)
    from mpeg_tpu_torch.video import _PicturePlan

    mb = geom.mb_size
    premult = np.asarray(PREMULTIPLIER_MATRIX, np.int32)
    rng = np.random.default_rng(21)
    i_pic, p_pic = _PicturePlan(mb), _PicturePlan(mb)
    for m in [0, *range(2, 13)]:
        q = rng.integers(1, 50, (6, 64)) * rng.choice([-1, 1], (6, 64))
        i_pic.coeffs[m] = q * premult
        i_pic.nblocks[m] = 64
        i_pic.intra_blk[m] = 1
    i_pic.coeffs[0, 0, 37:] = 0
    i_pic.nblocks[0, 0] = 37
    i_pic.coeffs[5, 3] = premult * rng.integers(1, 50, 64) + 1
    for m, b, pos in [(mb // 2, 1, 0), (mb // 2, 1, 63), (mb - 1, 5, 10)]:
        p_pic.coeffs[m, b, pos] = int(rng.integers(2, 60)) * premult[pos]
        p_pic.nblocks[m, b] = pos + 1
    return [(i_pic, PICTURE_TYPE_INTRA), (p_pic, PICTURE_TYPE_PREDICTIVE)]


def _edge_blob():
    """`_edge_plans` at 320x240, window 2, in buckets of 8,192 main and
    128 escape records (both lanes end in pads): (geom, window, km, ke,
    blob)."""
    geom = FrameGeometry.for_size(320, 240)
    window, km, ke = 2, 8192, 128
    return geom, window, km, ke, tb.pack_plans_blob(_edge_plans(geom), geom,
                                                    window, km, ke)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _poisoned_empty(dev, nbytes):
    """Leave junk in the caching allocator's free memory, so that K5's
    `torch.empty` outputs start on it."""
    junk = torch.full((nbytes // 4 + 1,), -0x2A2A2A2B, dtype=torch.int32,
                      device=dev)
    del junk


def _k5_against_plain(dev, meta, main, geom, window, km, ke):
    premult, rep = PREMULT.to(dev), NB_CLASS_REP.to(dev)
    meta, main = meta.to(dev), main.to(dev)
    want = tb.densify_unpack_plain(meta, main, geom, window, km, ke, premult,
                                   rep)
    _poisoned_empty(dev, want[0].numel() * 4)
    before = ck.densify_unpack.launches
    got = tb.densify_unpack(meta, main, geom, window, km, ke, premult, rep)
    torch.cuda.synchronize()
    assert ck.densify_unpack.launches == before + ck.DENSIFY_LAUNCHES
    _check_streams(got, [(want[0].cpu().numpy(),
                          {k: v.cpu().numpy() for k, v in want[1].items()})],
                   coded_only=True)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4, 16])
def test_k5_matches_plain_on_fixture_blobs_on_card(window):
    dev = _card()
    geom, blobs = _native_blobs(ES, window, 3)
    for blob, km, ke, fill in blobs:
        kt = min(tb.pool_bucket(max(fill[0], 1), 4096), km)
        _k5_against_plain(dev, *_split(blob, geom, window, km, ke, kt),
                          geom, window, km, ke)


@pytest.mark.cuda
def test_k5_matches_plain_on_a_stack_on_card():
    dev = _card()
    window = 4
    geom, native = _native_blobs(ES, window, 3)
    stack, km, ke = _common_stack([b[:3] for b in native], geom, window)
    split = tb.blob_split(geom, window, km, ke)
    tstack = _t(stack).to(dev)
    _k5_against_plain(dev, tstack[:, :split], tstack[:, split:], geom, window,
                      km, ke)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hops", "malformed_4096",
                                  "malformed_65536", "malformed_straddle",
                                  "edges", "edges_without_pads"])
def test_k5_matches_plain_on_edge_chains_on_card(case):
    """The hop chain, the malformed chains (one clamped onto the span's
    last entry; two wrapping, past 2^31 between two record tiles and
    inside one) and `_edge_blob` (a record tile's start inside a block, a
    macroblock without records between two with some, a coded block of
    escapes only), with its pads and cut to its fill."""
    dev = _card()
    kt = None
    if case == "hops":
        geom = FrameGeometry.for_size(640, 480)
        window, km, ke = 2, 4096, 64
        blob = tb.pack_plans_blob(_hop_plans(geom), geom, window, km, ke)
    elif case.startswith("edges"):
        geom, window, km, ke, blob = _edge_blob()
        if case == "edges_without_pads":
            rec = tb.blob_views(blob, geom, window, km, ke)["main_rec"]
            kt = int(np.flatnonzero(rec[1::2])[-1]) + 1
    elif case == "malformed_straddle":
        km = 65536
        geom, window, ke, blob = _malformed_blob(km, first=0x7FFF)
    else:
        km = int(case.split("_")[1])
        geom, window, ke, blob = _malformed_blob(km)
    _k5_against_plain(dev, *_split(blob, geom, window, km, ke, kt), geom,
                      window, km, ke)


@pytest.mark.cuda
def test_k5_matches_plain_on_a_sorted_and_a_wrapping_stream_on_card():
    """One call of two streams at 65,536 main records: `_edge_plans`, and
    a blob whose main chain wraps (every delta 0xFFFF, quotient 3) over
    coded blocks, so that launch C takes each stream's own path."""
    dev = _card()
    geom = FrameGeometry.for_size(320, 240)
    window, km, ke = 2, 65536, 128
    stack = np.stack([tb.pack_plans_blob(_edge_plans(geom), geom, window,
                                         km, ke),
                      np.zeros(tb.blob_layout(geom, window, km, ke)[1],
                               np.uint8)])
    v = tb.blob_views(stack[1], geom, window, km, ke)
    v["main_rec"][0::2] = 0xFFFF
    v["main_rec"].view(np.int16)[1::2] = 3
    v["nbcls"][:] = 0x0FFF                     # every block coded
    split = tb.blob_split(geom, window, km, ke)
    tstack = _t(stack).to(dev)
    _k5_against_plain(dev, tstack[:, :split], tstack[:, split:], geom, window,
                      km, ke)


@pytest.mark.cuda
def test_k5_scratch_is_one_word_a_tile_on_card():
    """The library's record tile and granule are the mirror's
    (tests/test_torch_k5.py).  Its scratch holds, a stream: four words a
    lane (the wrap flag and the tail), four a 4,096-record tile of each
    lane (launch A's entry), and two a row of each lane, one a granule of
    4 macroblocks and one more."""
    _card()
    from mpeg_tpu_torch.ops import _build

    lib = _build.load("densify")
    assert lib.mt_densify_scratch_words(1, 2, 3, 4096, 64) == \
        8 + 4 * (1 + 1) + 4 * (2 + 1)
    assert lib.mt_densify_scratch_words(3, 16, 8160, 4097, 8192) == \
        3 * (8 + 4 * (2 + 2) + 4 * (32640 + 1))
    assert lib.mt_densify_scratch_words(2, 1, 1, 0, 0) == 2 * (8 + 4 * 2)
    assert lib.mt_densify_granule_mbs() == 4


@pytest.mark.cuda
def test_k5_refuses_what_it_does_not_take_on_card():
    dev = _card()
    geom = FrameGeometry.for_size(64, 48)
    window, km, ke = 2, 4096, 64
    offs = tb.blob_layout(geom, window, km, ke)[0]
    split = offs["main_rec"][0]
    blob = torch.zeros(split + 4 * km + 8, dtype=torch.uint8, device=dev)
    premult, rep = PREMULT.to(dev), NB_CLASS_REP.to(dev)
    args = (geom, window, offs, premult, rep)
    with pytest.raises(ValueError, match="aligned"):
        ck.densify_unpack(blob[2:split + 2], blob[split + 4:split + 8],
                          *args)
    with pytest.raises(ValueError, match="whole 4-byte records"):
        ck.densify_unpack(blob[:split], blob[split:split + 6], *args)
    with pytest.raises(ValueError, match="prefix"):
        ck.densify_unpack(blob[:split - 4], blob[split:], *args)
    with pytest.raises(ValueError, match="uint8"):
        ck.densify_unpack(blob[:split].view(torch.int8), blob[split:], *args)
    with pytest.raises(ValueError, match="premult"):
        ck.densify_unpack(blob[:split], blob[split:split + 4 * km], geom,
                          window, offs, premult[:32], rep)


@pytest.mark.cuda
def test_decoders_run_k5_and_never_the_plain_pair_on_card(monkeypatch):
    """BatchVideoDecoder, MultiStreamVideoDecoder, the sharded decoder and
    Video launch K5 (`DENSIFY_LAUNCHES` launches) once a window, round,
    shard or picture, and call neither plain function on a CUDA
    tensor."""
    dev = _card()
    from mpeg_tpu_torch import Buffer, Video
    from mpeg_tpu_torch.parallel import (BatchVideoDecoder,
                                         MultiStreamVideoDecoder)
    from mpeg_tpu_torch.parallel import sharding as sh

    on_card = []

    def guard(fn):
        def run(t, *a, **k):
            if t.device.type == "cuda":
                on_card.append(fn.__name__)
            return fn(t, *a, **k)
        return run

    monkeypatch.setattr(tb, "densify_split", guard(tb.densify_split))
    monkeypatch.setattr(tb, "unpack_blob_meta", guard(tb.unpack_blob_meta))
    es = open(ES, "rb").read()

    ck.reset_launches()
    dec = BatchVideoDecoder(es, window=16, device="cuda")
    dec.decode_all()
    calls = ck.DENSIFY_LAUNCHES
    assert ck.densify_unpack.launches == calls * -(-len(dec._types) // 16)

    ck.reset_launches()
    ms = MultiStreamVideoDecoder([es[:60000], es], window=4, device="cuda")
    ms.decode_all()
    assert ck.densify_unpack.launches == calls * -(-len(dec._types) // 4)

    geom, blobs = _native_blobs(ES, 4, 2)
    stack, km, ke = _common_stack([b[:3] for b in blobs] * 2, geom, 4)
    ck.reset_launches()
    shards = 0
    for devices in (None, ["cuda:0", "cuda:0"]):
        mesh = sh.make_mesh(devices)
        decode = sh.make_sharded_blob_decoder(geom, mesh, 4, km, ke)
        decode(sh.zero_carry(geom, 4, mesh), stack)
        shards += len(mesh.devices)
    torch.cuda.synchronize()
    assert ck.densify_unpack.launches == calls * shards

    buf = Buffer(io.BytesIO(es[:60000]))
    buf.set_load_callback(buf.load_reader_callback)
    video = Video(buf, device=str(dev))
    ck.reset_launches()
    n = 0
    while video.decode() is not None:
        n += 1
    assert n and ck.densify_unpack.launches == \
        calls * ck.reconstruct_picture.launches
    assert not on_card, on_card
