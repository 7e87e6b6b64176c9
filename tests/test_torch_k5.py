"""K5, the window densify and metadata unpack (`parallel.batch.densify_unpack`,
`ops.cuda_kernels.densify_unpack`, csrc/densify.cu).

On the CPU `densify_unpack` runs the plain pair a stream at a time; it is
held to the JAX package's `densify_split_jax` + `unpack_blob_meta`, stream
by stream, on native fixture blobs at windows 4 and 16, a [3, bytes] stack
of blobs with different fills, the hop-record blob and the malformed
chains that wrap.  Tolerance: exact equality.

K5's tiling (csrc/densify.cu) is mirrored in numpy: the tile sums of
launch A, each tile's prefix over the tiles before it, the warps' 16
rounds of 32-lane scans, the clamp, the `+ n` fix-up and the drop.  The
mirror's indices equal the wrapping `np.cumsum(..., dtype=np.int32)` at
every tile boundary and across wraps inside a tile, and its dense output
equals the plain `densify_split`; a mirror whose tile prefix leaves out a
tile disagrees.

tests/test_torch_k5_cuda.py holds K5 to the plain version on the card."""

import numpy as np
import pytest
import torch

from mpeg_tpu.ops.video_recon import FrameGeometry
from mpeg_tpu.parallel import batch as jb
from mpeg_tpu.tables import PREMULTIPLIER_MATRIX
from mpeg_tpu_torch.ops import cuda_kernels as ck
from mpeg_tpu_torch.parallel import batch as tb
from torch_threads import one_torch_thread  # noqa: F401
from test_torch_k5_cuda import (
    NB_CLASS_REP, PREMULT, _check_streams, _common_stack, _hop_plans,
    _malformed_blob, _native_blobs, _split, _t,
)


def _jax_pair(blob, geom, window, km, ke, kt=None):
    """The JAX package's pair on one blob: (coeffs [window, mb, 6, 64],
    meta), the main lane cut to `kt` records (default: all of it)."""
    split = jb.blob_split(geom, window, km, ke)
    main = blob[split:split + 4 * (km if kt is None else kt)]
    dense = np.asarray(jb.densify_split_jax(blob[:split], main, geom,
                                            window, ke))
    meta = jb.unpack_blob_meta(blob[:split], geom, window, km, ke)
    return (dense.reshape(window, geom.mb_size, 6, 64),
            {k: np.asarray(v) for k, v in meta.items()})



# ---------------------------------------------------------------------------
# densify_unpack on the CPU against the JAX pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [4, 16])
def test_densify_unpack_matches_jax_on_fixture_blobs(window, mpeg1video_path):
    """Native window blobs, each on a bucket of its filled records as the
    decoder ships it."""
    geom, blobs = _native_blobs(mpeg1video_path, window, 3)
    for blob, km, ke, fill in blobs:
        kt = min(jb.pool_bucket(max(fill[0], 1), 4096), km)
        got = tb.densify_unpack(*_split(blob, geom, window, km, ke, kt),
                                geom, window, km, ke, PREMULT, NB_CLASS_REP)
        assert got[0].shape == (window, geom.mb_size, 6, 64)
        _check_streams(got, [_jax_pair(blob, geom, window, km, ke, kt)])


def test_densify_unpack_stack_of_three_streams(mpeg1video_path):
    """A [3, bytes] stack of blobs with different fills (an I-heavy
    window, a later window and one of two pictures and two padding
    steps), each stream on its own chains, against the JAX pair a
    stream."""
    import mpeg_tpu as mpeg

    window = 4
    geom, native = _native_blobs(mpeg1video_path, window, 3)
    buf = mpeg.Buffer(open(mpeg1video_path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    video = mpeg.Video(buf, backend="plan")
    plans = [video.parse_next_plan() for _ in range(2)]
    nm, ne = jb.count_pool_records(plans)
    km, ke = jb.pool_bucket(nm, 4096), jb.pool_bucket(max(ne, 1), 64)
    packed = jb.pack_plans_blob(plans, geom, window, km, ke)
    stack, km, ke = _common_stack(
        [native[0][:3], native[2][:3], (packed, km, ke)], geom, window)
    fills = [int((jb.blob_views(b, geom, window, km, ke)["main_rec"][0::2]
                  != 0).sum()) for b in stack]
    assert len(set(fills)) == 3, fills
    split = jb.blob_split(geom, window, km, ke)
    tstack = _t(stack)
    got = tb.densify_unpack(tstack[:, :split], tstack[:, split:], geom,
                            window, km, ke, PREMULT, NB_CLASS_REP)
    assert got[0].shape == (3 * window, geom.mb_size, 6, 64)
    _check_streams(got, [_jax_pair(b, geom, window, km, ke) for b in stack])


def test_densify_unpack_hop_record_blob():
    geom = FrameGeometry.for_size(640, 480)
    window, km, ke = 2, 4096, 64
    blob = jb.pack_plans_blob(_hop_plans(geom), geom, window, km, ke)
    got = tb.densify_unpack(*_split(blob, geom, window, km, ke), geom,
                            window, km, ke, PREMULT, NB_CLASS_REP)
    _check_streams(got, [_jax_pair(blob, geom, window, km, ke)])


@pytest.mark.parametrize("km", [4096, 65536])
def test_densify_unpack_malformed_chains(km):
    """Chains past the span clamp to its last slot; at km=65536 the main
    chain wraps negative and the indices still out of range are dropped."""
    geom, window, ke, blob = _malformed_blob(km)
    got = tb.densify_unpack(*_split(blob, geom, window, km, ke), geom,
                            window, km, ke, PREMULT, NB_CLASS_REP)
    _check_streams(got, [_jax_pair(blob, geom, window, km, ke)])
    assert got[0].view(-1)[-1] != 0


def test_densify_unpack_refuses_other_devices():
    geom = FrameGeometry.for_size(64, 48)
    meta = torch.zeros(8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.densify_unpack(meta, meta, geom, 1, 4096, 64, PREMULT,
                          NB_CLASS_REP)


def test_k5_wrapper_takes_cuda_tensors_only():
    """The CPU's plain version is `batch.densify_unpack`'s; the kernel's
    wrapper refuses CPU tensors instead of running it."""
    geom = FrameGeometry.for_size(64, 48)
    offs = jb.blob_layout(geom, 1, 4096, 64)[0]
    meta = torch.zeros(offs["main_rec"][0], dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ck.densify_unpack(meta, torch.zeros(16, dtype=torch.uint8), geom, 1,
                          offs, PREMULT, NB_CLASS_REP)


# ---------------------------------------------------------------------------
# K5's bound
# ---------------------------------------------------------------------------

def test_densify_bound_counts_a_window():
    """Two pictures of 3 macroblocks, 5 coded blocks, 100 main and 64
    escape records, counted by hand."""
    nblocks = torch.zeros((2, 3, 6), dtype=torch.int32)
    nblocks[0, 0, :4] = 10
    nblocks[1, 2, 5] = 1
    b = ck.densify_bound(nblocks, records=100, escapes=64)
    assert b["bytes"] == 400 + 384 + 2 * 12 + 6 * 67 + 5 * 256 == 2490
    assert b["us"] == pytest.approx(2490 / 3.35e12 * 1e6)
    # A 1080p window of 16 pictures with no coded block and no records:
    # the metadata alone.
    mb = 120 * 68
    empty = torch.zeros((16, mb, 6), dtype=torch.int32)
    assert ck.densify_bound(empty, 0, 0)["bytes"] == 16 * 12 + 16 * mb * 67


# ---------------------------------------------------------------------------
# K5's tiling (csrc/densify.cu), mirrored in numpy
# ---------------------------------------------------------------------------

TILE, WARPS, ROUNDS, LANES = 4096, 8, 16, 32
U32 = 2 ** 32


def _tile_prefix(sums: np.ndarray, tile: int) -> int:
    """Launch B: the sum (uint32, wrapping) of the lane's tiles before
    `tile`."""
    return int(sums[:tile].sum(dtype=np.uint64) % U32)


def _mirror_indices(deltas: np.ndarray, prefix=_tile_prefix) -> np.ndarray:
    """One lane's int32 indices through K5's tiling: launch A's tile sums,
    then in launch B each tile's prefix over the tiles before it, each
    warp's start from the warp totals before it, and 16 rounds of an
    inclusive 32-lane scan, lane l of warp w holding records w * 512 +
    i * 32 + l of its tile."""
    count = deltas.size
    n_tiles = -(-count // TILE)
    recs = np.zeros(n_tiles * TILE, np.uint64)
    recs[:count] = deltas
    recs = recs.reshape(n_tiles, WARPS, ROUNDS, LANES)
    sums = recs.sum(axis=(1, 2, 3)) % U32                      # launch A
    idx = np.empty_like(recs)
    for tile in range(n_tiles):
        run = prefix(sums, tile)
        warp_total = recs[tile].sum(axis=(1, 2)) % U32
        for w in range(WARPS):
            start = (run + int(warp_total[:w].sum())) % U32
            for i in range(ROUNDS):
                inc = np.cumsum(recs[tile, w, i])              # the scan
                idx[tile, w, i] = (start + inc) % U32
                start = (start + int(inc[-1])) % U32
    return idx.reshape(-1)[:count].astype(np.uint32).view(np.int32)


def _mirror_dense(deltas, values, n, premult=None, prefix=_tile_prefix):
    """A lane's contribution to the span: the clamp, the premultiply (main
    lane) from the clamped index, the `+ n` fix-up, the drop of what is
    still negative and of zero values, then int32 adds."""
    idx = np.minimum(_mirror_indices(deltas, prefix), n - 1)
    if premult is not None:
        val = (values.astype(np.int64) * premult[idx & 63]).astype(np.int32)
    else:
        val = values.astype(np.int32)
    idx = np.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (val != 0)
    acc = np.zeros(n, np.int64)
    np.add.at(acc, idx[keep], val[keep])
    return (acc & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _chains():
    rng = np.random.default_rng(55)
    return {
        # ends just before, at and after tile boundaries
        "short": rng.integers(0, 64, 4095),
        "one_tile": rng.integers(0, 64, 4096),
        "ragged": rng.integers(0, 300, 3 * 4096 + 5),
        # 0xFFFF deltas first pass 2^31 at record 32,768, a tile's start
        "hops": np.full(36_000, 0xFFFF),
        # wraps negative inside tile 8, and back through 0 inside tile 16
        "wraps": np.full(70_000, 0xFFF0),
        "random": rng.integers(0, 0x10000, 140_000),
    }


@pytest.mark.parametrize("name", sorted(_chains()))
def test_k5_tiling_indices_equal_the_wrapping_cumsum(name):
    deltas = _chains()[name].astype(np.uint16)
    want = np.cumsum(deltas.astype(np.int32), dtype=np.int32)
    np.testing.assert_array_equal(_mirror_indices(deltas), want)
    if name in ("wraps", "random"):
        neg = np.flatnonzero(want < 0)
        assert neg.size and neg[0] % TILE != 0, "must wrap inside a tile"


def test_k5_tiling_mutated_prefix_disagrees():
    """A tile prefix that leaves out the tile just before disagrees with
    the cumsum (the mirror holds the prefix, not only the scans)."""
    deltas = _chains()["ragged"].astype(np.uint16)
    want = np.cumsum(deltas.astype(np.int32), dtype=np.int32)

    def short_prefix(sums, tile):
        return _tile_prefix(sums, max(tile - 1, 0))

    assert not np.array_equal(_mirror_indices(deltas, short_prefix), want)
    assert np.array_equal(_mirror_indices(deltas[:TILE]), want[:TILE])


def _lanes(blob, geom, window, km, ke, kt):
    """A blob's two lanes as K5 reads them: (main deltas, quotients),
    (escape deltas, values)."""
    v = jb.blob_views(blob, geom, window, km, ke)
    rec = v["main_rec"][:2 * kt].view(np.int32)
    return ((rec & 0xFFFF).astype(np.uint16), rec >> 16), \
        (v["esc_didx"], v["esc_val"])


@pytest.mark.parametrize("case", ["fixture_16", "malformed_4096",
                                  "malformed_65536"])
def test_k5_tiling_dense_equals_plain(case, mpeg1video_path):
    """The mirror's two lanes summed into the span equal the plain
    `densify_split` of the same blob, entry for entry."""
    if case == "fixture_16":
        window = 16
        geom, ((blob, km, ke, fill),) = _native_blobs(mpeg1video_path,
                                                      window, 1)
        kt = min(jb.pool_bucket(max(fill[0], 1), 4096), km)
    else:
        km = int(case.split("_")[1])
        geom, window, ke, blob = _malformed_blob(km)
        kt = km
    n = window * geom.mb_size * 6 * 64
    (md, mq), (ed, ev) = _lanes(blob, geom, window, km, ke, kt)
    premult = np.asarray(PREMULTIPLIER_MATRIX, np.int64)
    got = ((_mirror_dense(md, mq, n, premult).astype(np.int64)
            + _mirror_dense(ed, ev, n)) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32)
    meta, main = _split(blob, geom, window, km, ke, kt)
    want = tb.densify_split(meta, main, geom, window, ke, PREMULT).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(want)
