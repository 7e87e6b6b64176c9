"""The port's window-blob densify and metadata unpack against the JAX
package's `densify_split_jax` / `unpack_blob_meta` on the same blob
bytes: native-parser fixture blobs, Python-packed blobs, a blob whose
delta chain needs HOP records, and malformed chains that overshoot (and
wrap) the window's dense span.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from mpeg_tpu.ops.video_recon import FrameGeometry
from mpeg_tpu.parallel import batch as jb
from mpeg_tpu.tables import PREMULTIPLIER_MATRIX
from mpeg_tpu_torch.parallel import batch as tb
from torch_threads import one_torch_thread  # noqa: F401


PREMULT = torch.tensor(PREMULTIPLIER_MATRIX, dtype=torch.int32)
NB_CLASS_REP = torch.tensor(tb._NB_CLASS_REP, dtype=torch.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_blob(geom, window, km, ke, blob, nm=None):
    """Both unpack stages of one blob, JAX vs port, on the transferred
    prefix (meta+escape, then a bucket of the filled main records)."""
    split = jb.blob_split(geom, window, km, ke)
    kt = min(jb.pool_bucket(max(km if nm is None else nm, 1), 4096), km)
    meta, main = blob[:split], blob[split:split + 4 * kt]

    want = np.asarray(jb.densify_split_jax(meta, main, geom, window, ke))
    got = tb.densify_split(_t(meta), _t(main), geom, window, ke, PREMULT)
    np.testing.assert_array_equal(got.numpy(), want)

    want_meta = jb.unpack_blob_meta(meta, geom, window, km, ke)
    got_meta = tb.unpack_blob_meta(_t(meta), geom, window, km, ke,
                                   NB_CLASS_REP)
    assert set(got_meta) == set(want_meta)
    for k, v in want_meta.items():
        assert got_meta[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got_meta[k].numpy(), np.asarray(v),
                                      err_msg=k)
    return got


@pytest.mark.parametrize("window", [4, 16])
def test_densify_native_fixture_blobs(window, mpeg1video_path):
    dec = jb.BatchVideoDecoder(open(mpeg1video_path, "rb").read(),
                               window=window)
    for _ in range(3):
        blob, types, fill = dec._native_window_blob()
        assert len(types) == window
        dense = _check_blob(dec.geom, window, dec._km, dec._ke, blob,
                            nm=fill[0])
        assert dense.abs().sum() > 0


def test_densify_python_packed_blob(mpeg1video_path):
    import mpeg_tpu as mpeg

    buf = mpeg.Buffer(open(mpeg1video_path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    video = mpeg.Video(buf, backend="plan")
    plans = [video.parse_next_plan() for _ in range(6)]
    window = 8                        # two padding steps
    nm, ne = jb.count_pool_records(plans)
    km, ke = jb.pool_bucket(nm, 4096), jb.pool_bucket(max(ne, 1), 64)
    blob = jb.pack_plans_blob(plans, video.geom, window, km, ke)
    _check_blob(video.geom, window, km, ke, blob)


def _hop_plans(geom):
    """Sparse pictures whose index gaps within and across pictures exceed
    64K (the construction of tests/test_batch.py's hop-record test)."""
    from mpeg_tpu.tables import PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE
    from mpeg_tpu.video import _PicturePlan

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


def test_densify_hop_record_blob():
    import jax.numpy as jnp

    geom = FrameGeometry.for_size(640, 480)
    window, km, ke = 2, 4096, 64
    plans = _hop_plans(geom)
    blob = jb.pack_plans_blob(plans, geom, window, km, ke)
    rec = jb.blob_views(blob, geom, window, km, ke)["main_rec"]
    assert (rec[0::2] == 0xFFFF).sum() >= 8, "must exercise hop records"
    _check_blob(geom, window, km, ke, blob)

    # The whole window through the port's decode module equals the JAX
    # package's blob scan.
    carry = tuple(jnp.zeros(geom.total_size, jnp.uint8) for _ in range(3))
    _, want = jb.make_blob_scan_decoder(geom, window, km, ke)(carry, blob)
    split = jb.blob_split(geom, window, km, ke)
    flags = jb.blob_views(blob, geom, window, km, ke)["flags"].copy()
    tcarry = tuple(torch.zeros(geom.total_size, dtype=torch.uint8)
                   for _ in range(3))
    _, got = tb.WindowDecoder(geom, window, km, ke)(
        tcarry, _t(blob[:split]), _t(blob[split:]), flags)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("km", [4096, 65536])
def test_densify_malformed_chain(km):
    """Chains that run past the window's dense span clamp onto the last
    slot; at km=65536 the int32 cumsum also wraps negative, and both
    packages drop the indices still out of range after counting from
    the end."""
    geom = FrameGeometry.for_size(64, 48)
    window, ke = 2, 64
    _, total = jb.blob_layout(geom, window, km, ke)
    blob = np.zeros(total, np.uint8)
    v = jb.blob_views(blob, geom, window, km, ke)
    v["main_rec"][0::2] = 0xFFFF
    v["main_rec"].view(np.int16)[1::2] = 3
    v["esc_didx"][:] = 0xFFFF
    v["esc_val"][:] = 7
    dense = _check_blob(geom, window, km, ke, blob)
    assert dense.shape == (window * geom.mb_size * 6 * 64,)
    assert dense[-1] != 0


def test_densify_span_guard():
    """A window whose dense span overflows int32 indices is refused with
    ValueError, before any work."""
    geom = FrameGeometry.for_size(1920, 1080)
    empty = torch.zeros(0, dtype=torch.uint8)
    with pytest.raises(ValueError, match="overflows int32"):
        tb.densify_split(empty, empty, geom, 1100, 64, PREMULT)
