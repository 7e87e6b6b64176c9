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

K5's partition is mirrored too: launch A's tile entries (sums and last
nonzero records), launch B's wrap flag, lane end, tail and rows (the first
record of each granule of 4 macroblocks and the chain before it, each row
written once, tile by tile from the table alone, or taken from the tail),
and launch C's warps, each rescanning a granule's records from the stored
chain; a wrapping lane's tiles are skipped, added at once or scanned from
launch A's entries.  Its rows equal ones found by a search of the sorted
indices, every granule's records land in its own macroblocks, each record
below the end is rescanned once and none past it, and the accumulators
equal the plain `densify_split` entry for entry; a mirror with a row one
record short, or with a range that ignores the lane's end, disagrees.

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
    NB_CLASS_REP, PREMULT, _check_streams, _common_stack, _edge_blob,
    _hop_plans, _malformed_blob, _native_blobs, _split, _t,
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


# ---------------------------------------------------------------------------
# K5's partition (csrc/densify.cu launches A, B and C), mirrored in numpy
# ---------------------------------------------------------------------------

MB_WORDS, GRANULE = 384, 4                # densify.cu kGranule


def _tile_table(deltas, values):
    """Launch A over one lane: each 4,096-record tile's delta sum and the
    offset of its last record whose value is not 0, or -1."""
    n_tiles = -(-deltas.size // TILE)
    pad = n_tiles * TILE - deltas.size
    d = np.concatenate([deltas.astype(np.int64), np.zeros(pad, np.int64)])
    nz = np.concatenate([values != 0, np.zeros(pad, bool)])
    d, nz = d.reshape(n_tiles, TILE), nz.reshape(n_tiles, TILE)
    last = np.where(nz.any(axis=1), TILE - 1 - np.argmax(nz[:, ::-1], axis=1),
                    -1)
    return d.sum(axis=1), last


def _granules(total_mb):
    return -(-total_mb // GRANULE)


def _mirror_rows(deltas, values, total_mb, mutate=None):
    """Launch B over one lane: (wraps, end, rows int64 [granules + 1, 2]),
    rows[g] = (the first record of macroblock g * 4 or later, the chain
    before it; the last row at the span's end), written tile by tile from
    launch A's table alone up to the lane's tail, the tail's rows from the
    lane's descriptor (None when the lane wraps).  `mutate`: "short"
    writes each row one record short, "no_end" takes the lane's record
    count for its end."""
    sums, last = _tile_table(deltas, values)
    if int(sums.sum()) >= 2 ** 31:
        return True, None, None
    nz_tiles = np.flatnonzero(last >= 0)
    end = int(nz_tiles[-1] * TILE + last[nz_tiles[-1]] + 1) \
        if nz_tiles.size else 0
    if mutate == "no_end":
        end = deltas.size
    n = total_mb * MB_WORDS
    rows = np.zeros((_granules(total_mb) + 1, 2), np.int64)
    writes = np.zeros(len(rows), np.int64)
    tail = (0, 0, 0)                          # first granule, end, chain
    for tile in range(-(-end // TILE)):
        t0 = tile * TILE
        seg = deltas[t0:min(t0 + TILE, end)].astype(np.int64)
        through = int(sums[:tile].sum()) + np.cumsum(seg)
        prev = through - seg
        r = np.arange(t0, t0 + seg.size)
        lo = np.where(r == 0, 0,
                      np.minimum(prev, n - 1) // MB_WORDS // GRANULE + 1)
        hi = np.minimum(through, n - 1) // MB_WORDS // GRANULE
        for k in np.flatnonzero(hi >= lo):
            rows[lo[k]:hi[k] + 1] = (r[k] - (mutate == "short"), prev[k])
            writes[lo[k]:hi[k] + 1] += 1
        if end - 1 < t0 + TILE:
            tail = (hi[-1] + 1, end, through[-1])
    rows[tail[0]:] = tail[1:]                 # launch C's row_at
    writes[tail[0]:] += 1
    assert (writes == 1).all(), "every row is written once"
    return False, end, rows


def _lane_values(idx, values, premult):
    """A lane's values at its clamped indices (the main lane's quotient
    times premult[idx & 63], wrapping)."""
    if premult is None:
        return values.astype(np.int64)
    return (values.astype(np.int64) * premult[idx & 63]).astype(np.int32) \
        .astype(np.int64)


def _mirror_partition(lanes, total_mb, mutate=None):
    """Launches A-C over one stream's lanes [(deltas, values, premult or
    None)]: (dense int32 [n], [(wraps, end, rows)] a lane, records
    rescanned a lane, every sorted granule's records inside it).  A warp
    assembles each granule of 4 macroblocks, rescanning its records from
    its row."""
    n = total_mb * MB_WORDS
    parts = [_mirror_rows(d, v, total_mb, mutate) for d, v, _ in lanes]
    dense = np.zeros(n, np.int64)
    rescanned = [0] * len(lanes)
    seen = [0] * len(lanes)                   # wrapping records scanned
    own = True

    def row(rows, m):
        return rows[_granules(total_mb) if m == total_mb else m // GRANULE]

    for g in range(_granules(total_mb)):
        m0 = g * GRANULE
        here = min(GRANULE, total_mb - m0)
        base, span = m0 * MB_WORDS, here * MB_WORDS
        acc = np.zeros(span, np.int64)
        for k, ((deltas, values, premult), (wraps, _end, rows)) in \
                enumerate(zip(lanes, parts)):
            if wraps:
                seen[k] += _mirror_wrapping(deltas, values, premult, acc,
                                            base, span, n)
                continue
            (r0, c0), r1 = row(rows, m0), row(rows, m0 + here)[0]
            seg = deltas[r0:r1].astype(np.int64)
            rescanned[k] += seg.size
            idx = np.minimum(c0 + np.cumsum(seg), n - 1)
            own &= bool(((idx >= base) & (idx < base + span)).all())
            val = _lane_values(idx, values[r0:r1], premult)
            keep = (val != 0) & (idx >= base) & (idx < base + span)
            np.add.at(acc, idx[keep] - base, val[keep])
        dense[base:base + span] = acc
    dense = (dense & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    _mirror_partition.wrapping_scanned = seen
    return dense, parts, rescanned, own


def _final_index(chain, n):
    """A record's index from its 64-bit chain: the int32, clamped to
    n - 1, then + n below 0 (still below 0: dropped)."""
    idx = min(int(np.int64(chain).astype(np.uint32).view(np.int32)), n - 1)
    return idx + n if idx < 0 else idx


def _mirror_wrapping(deltas, values, premult, acc, base, span, n):
    """Launch C on a wrapping lane for one granule's span: each tile from
    launch A's entry (its delta sum, value sum and first delta) skipped
    when its indices all miss the span (split where its chain passes a
    multiple of 2^31), added at once when they all land on one index in
    it, else scanned record by record.  Returns the records scanned."""
    count = deltas.size
    scanned, before = 0, 0
    for t0 in range(0, count, TILE):
        d = deltas[t0:t0 + TILE].astype(np.int64)
        v = values[t0:t0 + TILE].astype(np.int64)
        lo, hi = before + int(d[0]), before + int(d.sum())
        f_lo, f_hi = _final_index(lo, n), _final_index(hi, n)
        cut = ((lo >> 31) + 1) << 31
        piece = hi < cut

        def misses(a, b):
            return _final_index(b, n) < base or \
                _final_index(a, n) >= base + span

        miss = misses(lo, hi) if piece else \
            misses(lo, cut - 1) and misses(cut, hi)
        if piece and f_lo == f_hi and f_lo >= 0:
            if base <= f_lo < base + span:
                clamped = min(int(np.int64(lo).astype(np.uint32)
                                  .view(np.int32)), n - 1)
                p = 1 if premult is None else int(premult[clamped & 63])
                acc[f_lo - base] += (int(v.sum()) * p) & 0xFFFFFFFF
        elif not miss:
            scanned += d.size
            chain = before + np.cumsum(d)
            for c, x in zip(chain, v):
                clamped = min(int(np.int64(c).astype(np.uint32)
                                  .view(np.int32)), n - 1)
                val = x if premult is None else \
                    int(np.int64(x * premult[clamped & 63]).astype(np.int32))
                idx = clamped + n if clamped < 0 else clamped
                if val and idx >= 0 and base <= idx < base + span:
                    acc[idx - base] += val
        before = hi
    return scanned


def _expected_rows(deltas, values, total_mb):
    """rows of a sorted lane by a search: at each granule's first
    macroblock (and the span's end), the first record below the lane's
    end whose clamped index reaches it, and the chain before that
    record."""
    chain = np.cumsum(deltas.astype(np.int64))
    nz = np.flatnonzero(values != 0)
    end = int(nz[-1]) + 1 if nz.size else 0
    idx = np.minimum(chain[:end], total_mb * MB_WORDS - 1)
    starts = np.minimum(np.arange(_granules(total_mb) + 1) * GRANULE,
                        total_mb) * MB_WORDS
    r = np.searchsorted(idx, starts)
    return end, np.stack([r, np.where(r > 0, chain[r - 1], 0)], 1)


def _partition_case(case, mpeg1video_path):
    """[(blob, geom, window, km, ke, kt)] a stream of a mirror case."""
    if case == "fixture_16":
        geom, ((blob, km, ke, fill),) = _native_blobs(mpeg1video_path, 16, 1)
        kt = min(jb.pool_bucket(max(fill[0], 1), 4096), km)
        return [(blob, geom, 16, km, ke, kt)]
    if case == "stack_3":
        geom, native = _native_blobs(mpeg1video_path, 4, 3)
        stack, km, ke = _common_stack([b[:3] for b in native], geom, 4)
        return [(b, geom, 4, km, ke, km) for b in stack]
    if case == "hops":
        geom = FrameGeometry.for_size(640, 480)
        blob = jb.pack_plans_blob(_hop_plans(geom), geom, 2, 4096, 64)
        return [(blob, geom, 2, 4096, 64, 4096)]
    if case == "malformed_straddle":
        geom, window, ke, blob = _malformed_blob(65536, first=0x7FFF)
        return [(blob, geom, window, 65536, ke, 65536)]
    if case.startswith("malformed"):
        km = int(case.split("_")[1])
        geom, window, ke, blob = _malformed_blob(km)
        return [(blob, geom, window, km, ke, km)]
    geom, window, km, ke, blob = _edge_blob()
    return [(blob, geom, window, km, ke, km)]


def _stream_lanes(blob, geom, window, km, ke, kt):
    (md, mq), (ed, ev) = _lanes(blob, geom, window, km, ke, kt)
    return [(md, mq, np.asarray(PREMULTIPLIER_MATRIX, np.int64)),
            (ed, ev, None)]


PARTITION_CASES = ["fixture_16", "stack_3", "hops", "zero_tail",
                   "tile_boundary", "escape_only", "empty_mb",
                   "malformed_4096", "malformed_65536", "malformed_straddle"]


@pytest.mark.parametrize("case", PARTITION_CASES)
def test_k5_partition_equals_plain(case, mpeg1video_path):
    """The mirror of launches A-C on each stream of the case: its rows
    equal the searched ones, its warps rescan each record below the end
    once and only their own macroblocks' records, and its accumulators
    equal the plain `densify_split` entry for entry."""
    for blob, geom, window, km, ke, kt in _partition_case(case,
                                                          mpeg1video_path):
        total_mb = window * geom.mb_size
        lanes = _stream_lanes(blob, geom, window, km, ke, kt)
        dense, parts, rescanned, own = _mirror_partition(lanes, total_mb)
        meta, main = _split(blob, geom, window, km, ke, kt)
        want = tb.densify_split(meta, main, geom, window, ke, PREMULT).numpy()
        np.testing.assert_array_equal(dense, want)
        assert np.count_nonzero(want) and own
        for (deltas, values, _), (wraps, end, rows), seen in \
                zip(lanes, parts, rescanned):
            assert wraps == (case in ("malformed_65536",
                                      "malformed_straddle") and
                             deltas.size == kt), case
            if wraps:
                continue
            want_end, want_rows = _expected_rows(deltas, values, total_mb)
            assert end == want_end and seen == end
            np.testing.assert_array_equal(rows, want_rows)
    (md, mq, _), (ed, ev, _) = lanes
    (_, main_end, rows), (_, esc_end, esc_rows) = parts
    if case == "zero_tail":
        assert main_end < md.size and esc_end < ed.size
    if case == "tile_boundary":
        mb_of = np.cumsum(md.astype(np.int64)) // 64      # a block's index
        assert mb_of[TILE - 1] == mb_of[TILE]             # inside a block
        assert np.cumsum(md.astype(np.int64))[TILE] % 64 != 0
    if case == "escape_only":
        esc_blocks = set(np.cumsum(ed.astype(np.int64))[ev != 0] // 64)
        main_blocks = set(np.cumsum(md.astype(np.int64))[mq != 0] // 64)
        assert esc_blocks and not esc_blocks & main_blocks
    if case.startswith("malformed_"):
        # Launch A's entries spare the wrapping lane's tiles: those before
        # the chain passes 2^31 clamp onto the span's last entry (added at
        # once), those after it are dropped; only a tile inside which the
        # chain passes 2^31 is scanned, by the granule of that last entry.
        assert _mirror_partition.wrapping_scanned[0] == \
            {"malformed_65536": 0, "malformed_straddle": TILE}.get(case, 0)
    if case == "empty_mb":                     # in granule 0
        idx = np.cumsum(md.astype(np.int64))[mq != 0] // MB_WORDS
        assert 0 in idx and 1 not in idx and 2 in idx


@pytest.mark.parametrize("mutate", ["short", "no_end"])
def test_k5_partition_mutated_disagrees(mutate):
    """A row one record short loses a record and misplaces the warps'
    chains (the accumulators differ); a range that ignores the lane's end
    hands the last macroblock the bucket's pad records (the rows differ
    from the searched ones and records past the end are rescanned)."""
    geom, window, km, ke, blob = _edge_blob()
    total_mb = window * geom.mb_size
    lanes = _stream_lanes(blob, geom, window, km, ke, km)
    dense, parts, rescanned, _own = _mirror_partition(lanes, total_mb,
                                                      mutate)
    meta, main = _split(blob, geom, window, km, ke)
    want = tb.densify_split(meta, main, geom, window, ke, PREMULT).numpy()
    want_end, want_rows = _expected_rows(*lanes[0][:2], total_mb)
    rows_equal = np.array_equal(parts[0][2], want_rows)
    if mutate == "short":
        assert not np.array_equal(dense, want) and not rows_equal
    else:
        np.testing.assert_array_equal(dense, want)   # pads add nothing
        assert not rows_equal and rescanned[0] > want_end
