"""Batched video decode on a torch device: one window blob per transfer.

Port of `mpeg_tpu/parallel/batch.py`.  The host half is the port's own
copy of the JAX package's: the window-blob ABI (`blob_layout`,
`pack_plans_blob`, `delta_encode`, `split_views`, ...), and in
`BatchVideoDecoder` the native and Python parse, the blob free list,
prefetch, streaming `feed` and `at_time`.  Per window the device runs:

1-2. `densify_unpack`: the blob's delta-coded coefficient records become
   the dense int32 [window, mb, 6, 64] coefficients (cumsum of the u16
   deltas, times the position's premultiplier, an integer scatter-add —
   order-independent, so deterministic on the card too), and its prefix
   the motion vectors, IDCT classes, intra bits and src_sel.  On the card
   that is K5 (`ops.cuda_kernels.densify_unpack`, three launches, only the
   coded blocks written); on the CPU the plain pair `densify_split` +
   `unpack_blob_meta`;
3. one reconstruct per picture (`ops.cuda_kernels.reconstruct_picture`:
   the fused CUDA kernel for CUDA tensors, the plain version on the CPU);
4. frame rotation.  The host knows every picture's type from the blob's
   flags, so the (current, forward, backward) carry rotates by swapping
   tensor references instead of the JAX scan's three full-frame selects;
5. with `emit_rgba`, each displayed frame converts to RGBA
   (`ops.color.flat_frame_to_rgba`).

The blob transport is the reference's: a window ships its fixed
metadata+escape prefix and a power-of-two bucket of its filled main
records (reference: mpeg_tpu/parallel/batch.py module docstring), in
flight as the reference keeps it: from a pinned host blob, copied
asynchronously on the device's copy stream, the kernels waiting on the
copy's event and the host blob recycled once that event has completed
(`host_blob`, `device_put`, `HostRing`; `BatchVideoDecoder._reap_blobs`).
The dense transport (`stack_plans` + `DenseWindowDecoder`, which
`make_dense_scan_decoder` builds) ships the stacked plan arrays as they
are (~13.0 MB a 1080p picture), in flight the same way from a ring of at
most `_DENSE_RING` pinned stacks (`BatchVideoDecoder` stacks each window
straight into one), and skips steps 1-2; it is the readable oracle, fed
by the Python parse.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import explicit_device, resolve_device
from ..ops import cuda_kernels
from ..ops.color import flat_frame_to_rgba
from ..ops.video_recon import FrameGeometry
from ..tables import (
    PICTURE_TYPE_B, PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE,
    PREMULTIPLIER_MATRIX,
)
from ..utils import profiling
from ..video import Video
from ._runahead import RunAhead

_PREMULT = np.asarray(PREMULTIPLIER_MATRIX, np.int32)

# Representative nblocks value per 2-bit variant class; preserves every
# branch idct_batch takes (0 = uncoded, 1 = DC-only, <10 = sparse, full).
_NB_CLASS_REP = (0, 1, 2, 10)
# Per-picture reconstruct inputs from unpack_blob_meta, in argument order.
_PLAN_FIELDS = ("nblocks", "intra_blk", "src_sel", "mv_h", "mv_v")


# A dense window stack's fields in `stack_plans`'s order, each with its
# per-picture shape after the macroblock axis (None: one value a picture).
# The six `DenseWindowDecoder` reads come first; the flags stay last.
_STACK_FIELDS = (("coeffs", (6, 64)), ("nblocks", (6,)), ("intra_blk", (6,)),
                 ("src_sel", ()), ("mv_h", ()), ("mv_v", ()),
                 ("is_ref", None), ("is_noop", None))


def stack_layout(geom: FrameGeometry, window: int):
    """The dense window stack in one host buffer: ({field: (byte offset,
    shape)}, total bytes).  Every field is int32 [window, ...] and starts
    16-byte aligned (K1 reads coefficients 16 bytes and block counts 8
    bytes at a time)."""
    mb = geom.mb_size
    offs, pos = {}, 0
    for name, tail in _STACK_FIELDS:
        shape = (window,) if tail is None else (window, mb, *tail)
        offs[name] = (pos, shape)
        pos += 4 * int(np.prod(shape))
        pos = (pos + 15) & ~15
    return offs, pos


def stack_views(buf, geom: FrameGeometry, window: int) -> dict:
    """The typed int32 fields of a dense window stack laid out in `buf`
    (`stack_layout`): numpy views of a uint8 array, or, for a uint8
    tensor (the stack on the device), tensor views.  They share its
    memory."""
    offs, total = stack_layout(geom, window)
    if isinstance(buf, torch.Tensor):
        uint8, int32 = buf.dtype == torch.uint8, torch.int32
    else:
        buf = np.asarray(buf)
        uint8, int32 = buf.dtype == np.uint8, np.int32
    if not uint8 or buf.ndim != 1 or buf.shape[0] < total:
        raise ValueError(f"a stack of {window} pictures needs uint8 "
                         f"[{total}], got {buf.dtype} {tuple(buf.shape)}")
    return {k: buf[o:o + 4 * int(np.prod(shape))].view(int32)
            .reshape(shape) for k, (o, shape) in offs.items()}


def stack_plans(plans, geom: FrameGeometry, window: int,
                out: np.ndarray = None):
    """Stack (plan, picture_type) pairs into dense scan inputs, padding
    with no-op steps (a no-op leaves the carry untouched).

    Without `out`, a dict of fresh int32 arrays, as the reference returns
    it.  `out`, a uint8 array of at least `stack_layout`'s total bytes (a
    `host_blob`'s view, say), is written in place and the dict holds
    views of it (`stack_views`): the stack then needs no staging copy
    before its transfer.  Padding steps are written as the reference
    writes them (zeros, is_noop 1, is_ref 0), so a reused buffer holds
    the same bytes as a fresh one."""
    n = len(plans)
    if n > window:
        raise ValueError(f"{n} plans do not fit a window of {window}")
    if out is None:
        offs, _ = stack_layout(geom, window)
        out = {k: np.zeros(shape, np.int32) for k, (_o, shape) in offs.items()}
        out["is_noop"][:] = 1
    else:
        out = stack_views(out, geom, window)
        for name, _tail in _STACK_FIELDS:
            out[name][n:] = 1 if name == "is_noop" else 0
    for i, (plan, ptype) in enumerate(plans):
        out["coeffs"][i] = plan.coeffs
        out["nblocks"][i] = plan.nblocks
        out["intra_blk"][i] = plan.intra_blk
        out["src_sel"][i] = plan.src_sel
        out["mv_h"][i] = plan.mv_h
        out["mv_v"][i] = plan.mv_v
        out["is_ref"][i] = 1 if ptype in (PICTURE_TYPE_INTRA,
                                          PICTURE_TYPE_PREDICTIVE) else 0
        out["is_noop"][i] = 0
    return out


# --------------------------------------------------------------------------
# Window blob: one contiguous byte buffer per window
# (reference: mpeg_tpu/parallel/batch.py:103-375)
# --------------------------------------------------------------------------

def _extract_sequence_header(es: bytes) -> bytes:
    """Slice the MPEG-1 sequence header (+ any extension/user data)
    from the head of a video elementary stream: from 00 00 01 B3 up to
    the first GOP/picture start code."""
    start = es.find(b"\x00\x00\x01\xB3")
    if start < 0:
        return b""
    pos = start + 4
    while True:
        nxt = es.find(b"\x00\x00\x01", pos)
        if nxt < 0:
            return b""   # header truncated
        if nxt + 3 < len(es) and es[nxt + 3] in (0x00, 0xB8):
            return es[start:nxt]
        pos = nxt + 3


def _pes_packet(stream_id: int, payload: bytes) -> bytes:
    """Minimal MPEG-1 PES packet (no PTS) around `payload`."""
    return (b"\x00\x00\x01" + bytes([stream_id]) +
            (len(payload) + 1).to_bytes(2, "big") + b"\x0F" + payload)


_MIN_KM = 4096    # minimum main-pool bucket (records)
_MIN_KE = 64      # minimum escape-pool bucket (records; escapes are
                  # junk-stream-only, near zero on spec streams)


def pool_bucket(n: int, floor: int) -> int:
    """Power-of-two capacity bucket covering n records."""
    k = max(floor, 1)   # floor 0 would never double
    while k < n:
        k *= 2
    return k


def blob_layout(geom: FrameGeometry, window: int, km: int, ke: int):
    """Field byte offsets within one window blob.

    flags     int32[window]      bit0 = is_ref, bit1 = valid step
    mv_h/mv_v int16[window*mb]   motion vector actually used
    nbcls     uint16[window*mb]  2-bit IDCT variant class per block
    mbmisc    uint8[window*mb]   bits0-5 per-block intra, bits6-7 src_sel
    esc_didx  uint16[ke]         escape records: delta chain (see below),
    esc_val   int32[ke]          full int32 coefficient value
    main_rec  uint16[2*km]       interleaved (didx, val) pairs: [2k] is
                                 the delta of flat index
                                 ((w*mb+m)*6+b)*64+pos from the previous
                                 record (chain starts at 0; 0xFFFF with
                                 value 0 may be a HOP covering part of a
                                 larger gap), [2k+1] the int16 quotient
                                 value / premultiplier[pos] (exact)

    The main lane sits LAST and its fill is a byte PREFIX: the dispatch
    transfers only meta+esc plus a power-of-two bucket of the filled
    records (the tail [fill, km) is all zeros by the pad/high-water-mark
    contract), so sparse windows ship a fraction of the sticky layout —
    pad slack was 72% of the bytes at window=2 on 1080p GOP content.

    Pads in all record lanes are zeros (a value-0 add at the chain's
    current index): constant, sorted-safe, recycled-buffer-friendly.
    """
    mb = geom.mb_size
    # The device decodes indices with an int32 cumsum.
    assert window * mb * 6 * 64 < 2 ** 31, "window dense span overflows int32"
    fields = [
        ("flags", 4 * window),
        ("mv_h", 2 * window * mb), ("mv_v", 2 * window * mb),
        ("nbcls", 2 * window * mb), ("mbmisc", window * mb),
        ("esc_didx", 2 * ke), ("esc_val", 4 * ke),
        ("main_rec", 4 * km),
    ]
    offs = {}
    pos = 0
    for name, size in fields:
        pos = (pos + 3) & ~3   # 4-byte align every field
        offs[name] = (pos, size)
        pos += size
    return offs, (pos + 3) & ~3


def blob_split(geom: FrameGeometry, window: int, km: int, ke: int) -> int:
    """Byte offset where the main record lane starts — everything before
    it (meta + escape lanes) is the fixed-size transfer unit; the main
    lane transfers as a bucketed prefix of its fill."""
    offs, _ = blob_layout(geom, window, km, ke)
    return offs["main_rec"][0]


def plan_pool_records(plan):
    """Split one plan's nonzero coefficients into (main, escape) records.

    main: (idx int64[], quot int16[]) where coeff == quot * premult[pos];
    escape: (idx int64[], val int32[]) for values with no exact int16
    quotient.  idx is the flat position within the picture (block*64+pos).
    """
    flat = plan.coeffs.reshape(-1)
    idx = np.flatnonzero(flat)
    v = flat[idx].astype(np.int64)
    p = _PREMULT[idx & 63].astype(np.int64)
    q = v // p
    main = (q * p == v) & (q >= -32768) & (q <= 32767)
    return (idx[main], q[main].astype(np.int16),
            idx[~main], v[~main].astype(np.int32))


_HOP = 0xFFFF


def delta_encode(idx: np.ndarray, prev: int = 0):
    """Delta-encode an ascending absolute index array into the blob's
    uint16 chain form: returns (didx uint16[n_out], pos int64[n]) where
    pos[k] is the output slot of input record k (the other slots are
    value-0 HOP records of delta 0xFFFF covering gaps over 64K)."""
    d = np.empty(idx.size, np.int64)
    if idx.size:
        d[0] = idx[0] - prev
        np.subtract(idx[1:], idx[:-1], out=d[1:])
    nh = np.maximum(d - 1, 0) // _HOP        # hop records before record k
    pos = np.arange(idx.size, dtype=np.int64) + np.cumsum(nh)
    didx = np.full(pos[-1] + 1 if idx.size else 0, _HOP, np.uint16)
    didx[pos] = (d - nh * _HOP).astype(np.uint16)
    return didx, pos


def _window_records(plans, mb: int, records=None):
    """Concatenate a window's (main, escape) records in window-absolute
    ascending index order: ((midx, mval), (eidx, eval))."""
    mi_l, mv_l, ei_l, ev_l = [], [], [], []
    for w, (plan, _ptype) in enumerate(plans):
        mi, mv, ei, ev = records[w] if records is not None \
            else plan_pool_records(plan)
        base = w * mb * 6 * 64
        mi_l.append(mi + base)
        mv_l.append(mv)
        ei_l.append(ei + base)
        ev_l.append(ev)
    cat = lambda parts, dt: (np.concatenate(parts) if parts
                             else np.zeros(0, dt))
    return ((cat(mi_l, np.int64), cat(mv_l, np.int16)),
            (cat(ei_l, np.int64), cat(ev_l, np.int32)))


def count_pool_records(plans) -> tuple[int, int]:
    """Exact (main, escape) encoded record counts — including hop
    records — for a window of plans packed by pack_plans_blob.  The
    macroblock count (which fixes the per-picture index bases and so
    the hop records) comes from the plans themselves."""
    if not plans:
        return 0, 0
    mb = plans[0][0].mv_h.shape[0]
    (mi, _), (ei, _) = _window_records(plans, mb)
    nm = delta_encode(mi)[0].size
    ne = delta_encode(ei)[0].size
    return nm, ne


def _nb_classes(nblocks) -> np.ndarray:
    """[mb, 6] coefficient counts -> packed uint16 of 2-bit classes."""
    n = nblocks
    cls = np.where(n <= 0, 0, np.where(n == 1, 1, np.where(n < 10, 2, 3)))
    return (cls << (2 * np.arange(6, dtype=np.int32))).sum(
        axis=1).astype(np.uint16)


def blob_views(blob, geom: FrameGeometry, window: int,
               km: int, ke: int) -> dict:
    """Typed field views into one window blob (single source of truth
    for the Python-side layout; parser.cpp writes the same fields).
    `blob` is a uint8 numpy array or a host tensor (a `host_blob`): the
    views share its memory."""
    blob = np.asarray(blob)
    offs, total = blob_layout(geom, window, km, ke)
    assert blob.size == total and blob.dtype == np.uint8
    mb = geom.mb_size

    def view(name, dtype, n):
        off, size = offs[name]
        assert np.dtype(dtype).itemsize * n <= size
        return blob[off:off + np.dtype(dtype).itemsize * n].view(dtype)

    return {
        "flags": view("flags", np.int32, window),
        "mv_h": view("mv_h", np.int16, window * mb),
        "mv_v": view("mv_v", np.int16, window * mb),
        "nbcls": view("nbcls", np.uint16, window * mb),
        "mbmisc": view("mbmisc", np.uint8, window * mb),
        "esc_didx": view("esc_didx", np.uint16, ke),
        "esc_val": view("esc_val", np.int32, ke),
        "main_rec": view("main_rec", np.uint16, 2 * km),
    }


def split_views(meta_esc: np.ndarray, main_buf: np.ndarray,
                geom: FrameGeometry, window: int, km: int, ke: int) -> dict:
    """blob_views over a SPLIT window blob: `meta_esc` holds the fixed
    prefix (metadata + escape lanes, blob_split bytes), `main_buf` the
    main record lane (4*km bytes).  Callers that transfer the two parts
    separately (bucketed main prefix) fill through these views; the
    native window call takes the same pointers either way."""
    offs, _ = blob_layout(geom, window, km, ke)
    split = offs["main_rec"][0]
    assert meta_esc.size == split and main_buf.size == 4 * km
    mb = geom.mb_size

    def view(name, dtype, n):
        off, size = offs[name]
        assert np.dtype(dtype).itemsize * n <= size
        return meta_esc[off:off + np.dtype(dtype).itemsize * n].view(dtype)

    return {
        "flags": view("flags", np.int32, window),
        "mv_h": view("mv_h", np.int16, window * mb),
        "mv_v": view("mv_v", np.int16, window * mb),
        "nbcls": view("nbcls", np.uint16, window * mb),
        "mbmisc": view("mbmisc", np.uint8, window * mb),
        "esc_didx": view("esc_didx", np.uint16, ke),
        "esc_val": view("esc_val", np.int32, ke),
        "main_rec": main_buf.view(np.uint16),
    }


def pack_plans_blob(plans, geom: FrameGeometry, window: int,
                    km: int, ke: int, records=None,
                    out: np.ndarray = None) -> np.ndarray:
    """Pack a window of (plan, picture_type) pairs into one uint8 blob.

    `records` optionally carries precomputed plan_pool_records results
    (one per plan) so callers that sized the buckets from the same
    records don't recompute them.  `out`, a uint8 array of at least the
    blob's size (a `host_blob`'s view), is packed in place and its prefix
    returned: the blob then needs no staging copy before its transfer."""
    _, total = blob_layout(geom, window, km, ke)
    mb = geom.mb_size
    if out is None:
        blob = np.zeros(total, np.uint8)
    else:
        blob = out[:total]
        blob[:] = 0
    v = blob_views(blob, geom, window, km, ke)
    flags = v["flags"]
    mvh = v["mv_h"].reshape(window, mb)
    mvv = v["mv_v"].reshape(window, mb)
    nbcls = v["nbcls"].reshape(window, mb)
    misc = v["mbmisc"].reshape(window, mb)

    (mi, mv), (ei, ev) = _window_records(plans, mb, records)
    mdidx, mpos = delta_encode(mi)
    edidx, epos = delta_encode(ei)
    if mdidx.size > km or edidx.size > ke:
        raise ValueError(
            f"pool capacity exceeded: main {mdidx.size}/{km}, "
            f"esc {edidx.size}/{ke}")
    rec = v["main_rec"]
    rec[0:2 * mdidx.size:2] = mdidx
    rec.view(np.int16)[1::2][mpos] = mv
    v["esc_didx"][:edidx.size] = edidx
    v["esc_val"][epos] = ev
    # Pad records in both lanes are zeros (np.zeros blob): a value-0 add
    # at the chain's final index — the cumsum-decoded pools stay
    # nondecreasing end to end (device scatter ABI: indices_are_sorted;
    # plan_pool_records emits ascending flat indices per picture and
    # window bases grow, so the real records are already sorted).
    for w, (plan, ptype) in enumerate(plans):
        mvh[w] = plan.mv_h.astype(np.int16)
        mvv[w] = plan.mv_v.astype(np.int16)
        nbcls[w] = _nb_classes(plan.nblocks)
        misc[w] = ((plan.intra_blk.astype(np.uint8)
                    << np.arange(6, dtype=np.uint8)).sum(axis=1)
                   | (plan.src_sel.astype(np.uint8) << 6))
        is_ref = ptype in (PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE)
        flags[w] = (1 if is_ref else 0) | 2
    return blob



# --------------------------------------------------------------------------
# Device half
# --------------------------------------------------------------------------

def _blob_field(blob: torch.Tensor, offs: dict, name: str,
                dtype: torch.dtype, n: int) -> torch.Tensor:
    """One typed field of a device blob (a uint8 tensor): slice + view."""
    off, _size = offs[name]
    width = torch.empty(0, dtype=dtype).element_size()
    return blob[off:off + n * width].view(dtype)


def _scatter_index(idx: torch.Tensor, val: torch.Tensor, n: int):
    """Indices as the reference's scatter-add reads them: negative ones
    count from the end and ones still out of range add nothing.  Only a
    malformed chain whose int32 cumsum wraps reaches this."""
    idx = torch.where(idx < 0, idx + n, idx)
    keep = idx >= 0
    return torch.where(keep, idx, 0), torch.where(keep, val, 0)


def densify_split(meta_esc: torch.Tensor, main_rec_bytes: torch.Tensor,
                  geom: FrameGeometry, window: int, ke: int,
                  premult: torch.Tensor) -> torch.Tensor:
    """Scatter-add the blob's coefficient pools into the FLAT dense tensor
    int32[window*mb*6*64] (reference: batch.py densify_split_jax).

    `meta_esc` is the blob's fixed prefix (metadata + escape lanes);
    `main_rec_bytes` any bucketed prefix of the main record lane (the tail
    beyond the fill is zero records, which add nothing).  Each main record
    is one little-endian int32: the low 16 bits the index delta, the high
    16 the int16 quotient.  Decoded indices clamp to the last slot, as in
    the reference (insurance against malformed chains).  `premult` is
    `PREMULTIPLIER_MATRIX` as int32 on the blob's device.  With
    `unpack_blob_meta` this is the plain version of K5: `densify_unpack`
    runs the pair for CPU tensors only."""
    n = window * geom.mb_size * 6 * 64
    if n >= 2 ** 31:
        raise ValueError(f"window dense span {n} overflows int32")
    dev = meta_esc.device
    offs, _ = blob_layout(geom, window, 1, ke)   # escape offsets: km-free
    kt = main_rec_bytes.shape[0] // 4
    rec = main_rec_bytes[:4 * kt].view(torch.int32)
    midx = torch.cumsum(rec & 0xFFFF, 0, dtype=torch.int32).clamp(max=n - 1)
    contrib = (rec >> 16) * premult[(midx & 63).long()]
    eidx = torch.cumsum(
        _blob_field(meta_esc, offs, "esc_didx", torch.int16, ke)
        .to(torch.int32) & 0xFFFF, 0, dtype=torch.int32).clamp(max=n - 1)
    eval_ = _blob_field(meta_esc, offs, "esc_val", torch.int32, ke)
    dense = torch.zeros(n, dtype=torch.int32, device=dev)
    dense.index_add_(0, *_scatter_index(midx, contrib, n))
    dense.index_add_(0, *_scatter_index(eidx, eval_, n))
    return dense


def unpack_blob_meta(blob: torch.Tensor, geom: FrameGeometry, window: int,
                     km: int, ke: int, nb_class_rep: torch.Tensor) -> dict:
    """Every per-picture input except the dense coefficients, from a
    device blob's fixed prefix (reference: batch.py unpack_blob_meta).
    `nb_class_rep` is `_NB_CLASS_REP` as int32 on the blob's device."""
    offs, _ = blob_layout(geom, window, km, ke)
    mb = geom.mb_size

    def get(name, dtype, count):
        return _blob_field(blob, offs, name, dtype, count).to(torch.int32)

    flags = get("flags", torch.int32, window)
    mv_h = get("mv_h", torch.int16, window * mb).reshape(window, mb)
    mv_v = get("mv_v", torch.int16, window * mb).reshape(window, mb)
    nbcls = (get("nbcls", torch.int16, window * mb) & 0xFFFF) \
        .reshape(window, mb)
    shifts = 2 * torch.arange(6, dtype=torch.int32, device=blob.device)
    cls = (nbcls[:, :, None] >> shifts) & 3
    misc = get("mbmisc", torch.uint8, window * mb).reshape(window, mb)
    bits = torch.arange(6, dtype=torch.int32, device=blob.device)
    return {
        "nblocks": nb_class_rep[cls.long()],
        "intra_blk": (misc[:, :, None] >> bits) & 1,
        "src_sel": misc >> 6,
        "mv_h": mv_h,
        "mv_v": mv_v,
        "is_ref": flags & 1,
        "is_noop": 1 - ((flags >> 1) & 1),
    }


def densify_unpack_plain(meta_esc: torch.Tensor, main_rec: torch.Tensor,
                         geom: FrameGeometry, window: int, km: int, ke: int,
                         premult: torch.Tensor, nb_class_rep: torch.Tensor):
    """`densify_unpack` by the plain pair, a stream at a time, on any
    device: every block of the coefficients is written (the span is
    zero-filled)."""
    stack = meta_esc.dim() == 2
    parts = []
    for meta, main in zip(meta_esc if stack else [meta_esc],
                          main_rec if stack else [main_rec]):
        coeffs = densify_split(meta, main, geom, window, ke, premult)
        parts.append((coeffs.view(window, geom.mb_size, 6, 64),
                      unpack_blob_meta(meta, geom, window, km, ke,
                                       nb_class_rep)))
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([c for c, _ in parts]),
            {k: torch.cat([m[k] for _, m in parts]) for k in parts[0][1]})


def densify_unpack(meta_esc: torch.Tensor, main_rec: torch.Tensor,
                   geom: FrameGeometry, window: int, km: int, ke: int,
                   premult: torch.Tensor, nb_class_rep: torch.Tensor):
    """A window's plan tensors from its blob, or from S streams' blobs:
    (coeffs int32 [P, mb, 6, 64], meta), meta as `unpack_blob_meta`
    gives it, P = S * window pictures, stream s's at [s * window,
    (s + 1) * window).

    meta_esc: uint8 [split], one blob's fixed prefix, or [S, split], S
    streams' prefixes (e.g. `blobs[:, :split]` of a [S, bytes] stack);
    main_rec: uint8 [4 kt] or [S, 4 kt], each stream's main records (a
    bucketed prefix of its lane: the tail is zero records).  Each
    stream's delta chains start at 0.  For CPU tensors this is the plain
    pair (`densify_unpack_plain`); for CUDA tensors it launches K5
    (`cuda_kernels.densify_unpack`) or raises, and only the coded blocks
    (nblocks > 0) of coeffs are written: K1 and K3 read no others."""
    if cuda_kernels._device_kind(meta_esc) == "cpu":
        return densify_unpack_plain(meta_esc, main_rec, geom, window, km, ke,
                                    premult, nb_class_rep)
    return cuda_kernels.densify_unpack(
        meta_esc, main_rec, geom, window, blob_layout(geom, window, km, ke)[0],
        premult, nb_class_rep)


class WindowDecoder(nn.Module):
    """Decode one window blob (reference: batch.py make_blob_scan_decoder
    with make_scan_step): (carry, meta_esc, main_part, flags) ->
    (carry, displays).

    carry = (current, forward, backward) flat uint8 [total_size] frames;
    displays uint8 [window, total_size] (RGBA: [window, H, W, 4]), row t
    the frame the reference's Decode() returns after picture t.  `flags`
    are the blob's per-step flags as the host packed them (bit0 reference
    picture, bit1 valid).  The carry's tensors are never written: each
    picture's reconstruct allocates its output, and rotation swaps
    references.

    `recon` is the per-picture reconstruct, a function with the signature
    of `cuda_kernels.reconstruct_picture` (the reference's `make_scan_step`
    `recon`): K1 by default, `cuda_kernels.reconstruct_picture_multi` to
    run K3 in its place.
    """

    def __init__(self, geom: FrameGeometry, window: int, km: int, ke: int,
                 emit_rgba: bool = False,
                 recon=cuda_kernels.reconstruct_picture):
        super().__init__()
        self.geom, self.window, self.km, self.ke = geom, window, km, ke
        self.emit_rgba, self.recon = emit_rgba, recon
        self.register_buffer("premult", torch.tensor(
            PREMULTIPLIER_MATRIX, dtype=torch.int32), persistent=False)
        self.register_buffer("nb_class_rep", torch.tensor(
            _NB_CLASS_REP, dtype=torch.int32), persistent=False)

    def forward(self, carry, meta_esc, main_part, flags):
        coeffs, meta = densify_unpack(meta_esc, main_part, self.geom,
                                      self.window, self.km, self.ke,
                                      self.premult, self.nb_class_rep)
        plan = [coeffs, *(meta[k] for k in _PLAN_FIELDS)]
        return _run_window_steps(carry, plan, flags, self.geom, self.recon,
                                self.emit_rgba)


def _run_window_steps(carry, plan, flags, geom: FrameGeometry, recon,
                     emit_rgba: bool = False):
    """One stream's window of picture steps (the reference's `make_scan_step`
    scanned over the window), shared by the blob and dense decoders.

    `plan` holds the window's (coeffs, nblocks, intra_blk, src_sel, mv_h,
    mv_v) tensors, each with a leading step axis; `flags` the host's
    per-step flags (bit0 reference picture, bit1 valid).  A valid step is
    one `recon` call; a padding step launches nothing and keeps the carry.
    Returns ((cur, fwd, bwd), displays)."""
    cur, fwd, bwd = carry
    shape = (geom.height, geom.width, 4) if emit_rgba else (geom.total_size,)
    disps = torch.empty((len(flags), *shape), dtype=torch.uint8,
                        device=cur.device)
    for t in range(len(flags)):
        is_ref, run = flags[t] & 1, flags[t] & 2
        if run:                      # a reference's forward aliases backward
            new = recon(cur, bwd if is_ref else fwd, bwd,
                        *(p[t] for p in plan), geom)
        else:                        # padding step: the carry stays
            new = cur
        disp = bwd if is_ref else new
        disps[t].copy_(flat_frame_to_rgba(disp, geom) if emit_rgba else disp)
        if is_ref and run:
            cur, fwd, bwd = fwd, bwd, new
        else:
            cur = new
    return (cur, fwd, bwd), disps


class DenseWindowDecoder(nn.Module):
    """Decode one window of stacked dense plans (reference: batch.py
    make_dense_scan_decoder): (carry, stack_plans(...)) -> (carry,
    displays), as `WindowDecoder` does for a blob.  The stack goes to the
    carry's device in one asynchronous copy from a pinned buffer of this
    module's `HostRing` (at most `_DENSE_RING` window stacks), then one
    `recon` launch a valid step, none for the no-op steps.  Displays are
    uint8 [window, total_size] (RGBA: [window, H, W, 4])."""

    def __init__(self, geom: FrameGeometry, emit_rgba: bool = False,
                 recon=cuda_kernels.reconstruct_picture):
        super().__init__()
        self.geom, self.emit_rgba, self.recon = geom, emit_rgba, recon
        self._ring = None

    def ring(self, device) -> "HostRing":
        """The module's host buffers for stacks bound for `device`."""
        device = explicit_device(device)     # "cuda" is "cuda:<current>"
        if self._ring is None or self._ring.device != device:
            self._ring = HostRing(device, cap=_DENSE_RING)
        return self._ring

    def forward(self, carry, plans, host: torch.Tensor = None):
        """`plans` as `stack_plans` gives them.  `host`: the buffer
        `ring(device).take` returned last, which `plans` were stacked
        into (`stack_plans(..., out=host.numpy())`), sent as it is;
        without it the arrays are staged into a buffer of the ring.
        Either way the caller may write its arrays again once the call
        returns, and the call waits for no device."""
        dev = carry[0].device
        ring = self.ring(dev)
        window = np.asarray(plans["is_noop"]).shape[0]
        flags = _dense_flags(plans)
        if host is None:
            fields, = put_stacks(ring, [plans], self.geom)
        else:
            dev_stack, = ring.send([host])
            fields = stack_views(dev_stack, self.geom, window)
        plan = [fields[k] for k in ("coeffs", *_PLAN_FIELDS)]
        return _run_window_steps(carry, plan, flags, self.geom, self.recon,
                                self.emit_rgba)


def _dense_flags(plans) -> np.ndarray:
    """The host's per-step flags of stacked dense plans (any leading
    axes), as a blob carries them: bit0 reference picture, bit1 valid."""
    is_ref = np.asarray(plans["is_ref"], np.int32)
    run = 1 - np.asarray(plans["is_noop"], np.int32)
    return (is_ref & 1) | ((run & 1) << 1)


def make_dense_scan_decoder(geom: FrameGeometry, emit_rgba: bool = False, *,
                            device="cuda"):
    """The dense window decode on `device` ("cuda", the default, raises
    without a card; "cpu" runs the plain versions):
    (carry, stack_plans(...)) -> (carry, displays).  carry is three flat
    uint8 [total_size] frames on `device`.  The stacked arrays are staged
    into the decoder's pinned ring and copied asynchronously: the call
    waits for no card, and the caller may reuse its arrays as soon as it
    returns."""
    dev = explicit_device(device)
    dec = DenseWindowDecoder(geom, emit_rgba).to(dev)

    def scan_decode(carry, plans):
        if any(f.device != dev for f in carry):
            raise ValueError(f"carry: expected frames on {dev}")
        return dec(carry, plans)

    return scan_decode


# The reference's name for the dense decoder (mpeg_tpu/parallel/batch.py).
make_scan_decoder = make_dense_scan_decoder


class PictureBlobRecon(nn.Module):
    """One picture from a one-picture window blob (reference: batch.py
    make_picture_blob_recon): the interactive decode's transport (`Video`,
    `MPEG`).  The caller packs the blob in place into a buffer of its
    `HostRing` (`take`; pinned for the card, two in rotation); its fixed
    prefix and a power-of-two bucket of its filled main records go to the
    device in one asynchronous copy (`send`), then `densify_unpack` (K5's
    three launches on the card) and one K1 launch
    (`cuda_kernels.reconstruct_picture`; the plain versions on the CPU):
    (cur, fwd, bwd, blob, ring, fill) -> a new flat frame.  A 1080p
    picture ships ~0.1 MB instead of the 12.5 MB dense coefficient
    tensor."""

    def __init__(self, geom: FrameGeometry, km: int, ke: int):
        super().__init__()
        self.geom, self.km, self.ke = geom, km, ke
        self.split = blob_split(geom, 1, km, ke)
        self.register_buffer("premult", torch.tensor(
            PREMULTIPLIER_MATRIX, dtype=torch.int32), persistent=False)
        self.register_buffer("nb_class_rep", torch.tensor(
            _NB_CLASS_REP, dtype=torch.int32), persistent=False)

    def forward(self, cur, fwd, bwd, blob: torch.Tensor, ring: "HostRing",
                fill: int = None):
        """`blob`: the host buffer `ring.take` returned last, packed."""
        geom = self.geom
        # [fill, km) of the main lane is zero records by the pad contract.
        nm = self.km if fill is None else fill
        kt = min(pool_bucket(max(nm, 1), _MIN_KM), self.km)
        dev_blob, = ring.send([blob[:self.split + 4 * kt]])
        coeffs, meta = densify_unpack(
            dev_blob[:self.split], dev_blob[self.split:], geom, 1, self.km,
            self.ke, self.premult, self.nb_class_rep)
        return cuda_kernels.reconstruct_picture(
            cur, fwd, bwd, coeffs[0], *(meta[k][0] for k in _PLAN_FIELDS),
            geom)


def carry_from_numpy(frames, device="cuda") -> tuple:
    """The port's carry from three flat uint8 frames — e.g. the JAX
    decoder's carry, `[np.asarray(f) for f in dec._carry]`."""
    dev = resolve_device(device)
    frames = [np.asarray(f) for f in frames]
    if len(frames) != 3 or any(f.dtype != np.uint8 or f.ndim != 1 or
                               f.size != frames[0].size for f in frames):
        raise ValueError("carry: expected 3 flat uint8 frames of one size")
    # np.array copies: the source may be read-only (a jax array's view).
    return tuple(torch.from_numpy(np.array(f)).to(dev) for f in frames)


# ---------------------------------------------------------------------------
# Host-to-device transport (reference: each window blob's `jax.device_put`,
# its host buffer kept in flight until a device gate says the device has
# read it: BatchVideoDecoder._blob_inflight / _reap_blobs, the
# multistream slots' `gate`, the sharded decode's asynchronous put)
# ---------------------------------------------------------------------------

def host_blob(nbytes: int, device) -> torch.Tensor:
    """A host buffer for blobs bound for `device`: uint8 [nbytes], pinned
    (page-locked) when `device` is a CUDA device, so that `device_put`
    copies it asynchronously at the link's pinned rate; plain memory for
    the CPU.  Its owner allocates it once and recycles it (a pinned
    allocation costs far more than a pageable one); the native parser
    writes into its `.numpy()` view (`blob_views`).  A pinned allocation
    that fails raises."""
    profiling.count("host_blob_allocs")
    profiling.count("host_blob_bytes", nbytes)
    with profiling.span("mpeg.alloc.pinned"):
        return torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=torch.device(device).type == "cuda")


# One copy stream a CUDA device, for the process (device index -> stream):
# every decoder's copies to a card queue on it, in order, beside the
# kernels on the card's current stream.
_COPY_STREAMS: dict = {}


def copy_stream(device) -> "torch.cuda.Stream":
    """The side stream on which `device_put` copies to a CUDA device."""
    dev = explicit_device(device)
    stream = _COPY_STREAMS.get(dev.index)
    if stream is None:
        stream = _COPY_STREAMS.setdefault(dev.index, torch.cuda.Stream(dev))
    return stream


def device_put(parts, device, current_stream: bool = False):
    """Copy host tensors (uint8 slices of a `host_blob`, or typed views
    of one) to `device`; returns (device tensors, gate).

    On a CUDA device every part must be pinned (a `host_blob` or a slice
    of one: a pageable part raises, and nothing copies in its place).
    The copies are enqueued with `non_blocking=True` on the device's
    `copy_stream`, the gate, a CUDA event, is recorded after them, and the
    device's current stream, where K5 and K1 run, waits on the gate before
    the work enqueued after this call.  The device tensors are allocated
    on the copy stream and marked as used on the current one
    (`record_stream`), so the caching allocator hands their memory out
    again only after the kernels that read them.  The host parts may be
    written again once `gate.query()` is true: a completed event after the
    asynchronous copy proves the bytes were read.  The call never waits
    for the device.

    With `current_stream` the copies go on the device's current stream
    and the gate is None: for a caller that waits on that stream before
    it writes its parts again (`Audio`, which waits for each frame's
    PCM), for whom the side stream's switch, event and `record_stream`
    cost more host time than the copy itself (`chip_smoke.py`'s `audio`
    phase times both).

    On the CPU the parts are cloned (the plain synchronous copy) and the
    gate is None: the copy is done when the call returns.  Each call adds
    its copies to `transport_counts`."""
    dev = explicit_device(device)
    if dev.type != "cuda":
        outs, gate = [p.clone() for p in parts], None
    else:
        for p in parts:
            if p.device.type != "cpu" or not p.is_pinned():
                raise ValueError(
                    f"device_put to {dev}: a host part of "
                    f"{p.numel() * p.element_size()} bytes is not pinned "
                    "(copy it into a host_blob)")
        if current_stream:
            outs, gate = [p.to(dev, non_blocking=True) for p in parts], None
        else:
            compute = torch.cuda.current_stream(dev)
            side = copy_stream(dev)
            with torch.cuda.stream(side):
                outs = [p.to(dev, non_blocking=True) for p in parts]
                gate = torch.cuda.Event()
                gate.record(side)
            for out in outs:
                out.record_stream(compute)
            compute.wait_event(gate)
        transport_counts.pinned_copies += len(parts)
    transport_counts.copies += len(parts)
    transport_counts.bytes += sum(p.numel() * p.element_size() for p in parts)
    return outs, gate


class TransportCounts:
    """What `device_put` copied since the last `reset_transport_counts`:
    the copies, those made from pinned memory, and their bytes."""

    copies = pinned_copies = bytes = 0


transport_counts = TransportCounts()


def reset_transport_counts() -> None:
    """Set `transport_counts` to 0."""
    transport_counts.copies = transport_counts.pinned_copies = 0
    transport_counts.bytes = 0


def _gate_done(gate) -> bool:
    """Whether the copy behind `gate` has read its host buffer (None: a
    plain copy, done when it returned)."""
    return gate is None or gate.query()


def _stage(part: torch.Tensor, a: np.ndarray) -> None:
    """Copy the contiguous numpy array `a` into the host tensor `part`,
    with torch's copy, which spreads a large copy over the intra-op
    threads (numpy's copy runs on one thread, several times slower for
    the sharded decoder's blob stacks); with numpy's for a read-only
    `a`, which torch would not wrap."""
    src = a.reshape(-1).view(np.uint8)
    if src.flags.writeable:
        part.copy_(torch.from_numpy(src))
    else:
        part.numpy()[:] = src


# At most this many staging buffers a HostRing: past it, `put` waits for
# the oldest copy instead of pinning more memory.
_MAX_RING = 8
# At most this many window stacks in a dense decoder's ring, a device: a
# 1080p stack of 16 pictures pins 268 MB (208 MB rounded up).
_DENSE_RING = 3


class HostRing:
    """Staging buffers for host arrays that the caller keeps (the sharded
    decoder's blobs, the interactive picture's packed blob, a round's K1
    step tables, MP2 samples, dense window stacks): `put` copies the
    arrays into a `host_blob` of the ring and from there to the device
    through `device_put`.  A buffer is written again only once the gate of
    the copy that last read it has completed; the ring starts with two
    buffers in rotation and adds one (up to `cap`, then waits for the
    oldest) only when every buffer is still being read.  A buffer is
    allocated at a power-of-two bucket of the bytes asked for (torch's
    pinned host allocator rounds to one anyway).  The caller may reuse
    its arrays as soon as `put` returns.  On the CPU the buffers are
    plain memory and `device_put` clones them, the same steps."""

    def __init__(self, device, cap: int = _MAX_RING):
        self.device = explicit_device(device)
        self.cap = max(cap, 1)
        self._bufs = [[None, None] for _ in range(min(2, self.cap))]
        self._next = 0
        self._taken = None   # the entry `take` handed out last

    def _take(self, nbytes: int) -> list:
        """The next [buffer, gate] whose last copy has completed, its
        buffer at least `nbytes` long."""
        n = len(self._bufs)
        order = [(self._next + k) % n for k in range(n)]
        free = [i for i in order if _gate_done(self._bufs[i][1])]
        if free:
            i = free[0]
        elif n < self.cap:
            i = self._next
            self._bufs.insert(i, [None, None])
            n += 1
        else:
            i = self._next
            profiling.count("blocks")
            with profiling.span("mpeg.block"):
                self._bufs[i][1].synchronize()
        self._next = (i + 1) % n
        entry = self._bufs[i]
        entry[1] = None
        if entry[0] is None or entry[0].numel() < nbytes:
            entry[0] = host_blob(pool_bucket(nbytes, 4096), self.device)
        return entry

    def take(self, nbytes: int) -> torch.Tensor:
        """A buffer of the ring, `nbytes` long, free to write: for a caller
        that packs in place and then ships it with `send`."""
        self._taken = self._take(nbytes)
        return self._taken[0][:nbytes]

    def send(self, parts) -> list:
        """`device_put` of `parts`, slices of the buffer `take` returned
        last; that buffer is written again only once their gate has
        completed."""
        outs, self._taken[1] = device_put(parts, self.device)
        return outs

    def put(self, arrays) -> list:
        """Device tensors holding the numpy `arrays` (their dtypes and
        shapes)."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        buf = self.take(sum(a.nbytes for a in arrays))
        parts, off = [], 0
        for a in arrays:
            part = buf[off:off + a.nbytes]
            _stage(part, a)
            parts.append(part)
            off += a.nbytes
        outs = self.send(parts)
        return [o.view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
                .view(a.shape) for o, a in zip(outs, arrays)]


def put_stacks(ring: HostRing, stacks, geom: FrameGeometry) -> list:
    """Dense window stacks on the ring's device, in one `device_put`.

    Each of `stacks` is a dict of stacked plan arrays as `stack_plans`
    gives them, its leading axes (one window, or [S, T] streams by steps,
    stream-major) its pictures; each is staged into the stack layout of P
    pictures (`stack_layout`) in one buffer of `ring` and copied as one
    part.  Returns each stack's device fields (`stack_views`), every
    field with a leading axis of its P pictures."""
    laid = []
    for st in stacks:
        p = int(np.asarray(st["is_noop"]).size)
        laid.append((p, *stack_layout(geom, p)))
    buf = ring.take(sum(total for _p, _offs, total in laid))
    parts, off = [], 0
    for st, (p, offs, total) in zip(stacks, laid):
        part = buf[off:off + total]
        for name, (o, shape) in offs.items():
            a = np.ascontiguousarray(st[name], np.int32)
            if a.size != int(np.prod(shape)):
                raise ValueError(f"{name}: {a.shape} does not hold "
                                 f"{shape[0]} pictures of {geom.mb_size} "
                                 "macroblocks")
            _stage(part[o:o + a.nbytes], a)
        parts.append(part)
        off += total
    return [stack_views(d, geom, p)
            for d, (p, _offs, _total) in zip(ring.send(parts), laid)]


class BatchVideoDecoder:
    """Throughput decoder: host parse feeding windowed decodes on a torch
    device.  Same output sequence as `mpeg_tpu.parallel.BatchVideoDecoder`
    (the reference delay, the end-of-stream flush, open-GOP B drops after
    `at_time`); displayed frames are flat uint8 [total_size] tensors on
    `device`.

    `device` is "cuda" (the default; it raises when no CUDA device is
    present) or "cpu".  On "cuda" each picture is one launch of the fused
    reconstruct kernel; on "cpu" the plain PyTorch version runs.  With
    `emit_rgba=True` displayed frames are [H, W, 4] uint8 RGBA tensors on
    `device`.  `transport="dense"` ships stacked dense plans
    (`stack_plans`, into a pinned buffer of a ring of at most
    `_DENSE_RING`) instead of window blobs and needs the Python parse
    (`use_native=False`).
    """

    # The per-picture reconstruct `WindowDecoder` runs (internal: K3's
    # smoke run sets cuda_kernels.reconstruct_picture_multi here).
    _recon = staticmethod(cuda_kernels.reconstruct_picture)

    def __init__(self, buf, window: int = None, transport: str = None,
                 use_native: bool = None, stats=None, config=None,
                 emit_rgba: bool = False, streaming: bool = False,
                 pool_buckets: tuple = None, prefetch: bool = False, *,
                 device="cuda"):
        """`buf` is a Buffer (Python parse) or bytes (native parse).

        use_native: parse with the C++ parser (requires the blob
        transport); default: native when available and the input is
        bytes.
        stats: an optional utils.profiling.DecodeStats populated per
        window (parse/dispatch timing, bytes transferred).
        emit_rgba: displayed frames come back as [H, W, 4] uint8 RGBA
        instead of flat YCbCr buffers.
        streaming: the input arrives incrementally via feed(); call
        signal_end() when the source is exhausted (decode_window returns
        whatever whole pictures are buffered in the meantime).  The
        Python-parse path streams via a push-fed Buffer instead.
        pool_buckets: optional (km, ke) initial pool capacities — size
        them from a discovery sweep to avoid mid-decode bucket growth.
        prefetch: parse/pack the next window on a background thread
        while the device consumes the current one (the native parser
        releases the GIL; the Python-parse path gains little).  Output
        order and values are identical.  Not available with
        streaming=True (feed() drives the parse there).
        Unset arguments fall back to `config` (default config.DEFAULT).
        """
        self._key = profiling.new_key()
        from ..config import DEFAULT
        self.device = resolve_device(device)
        cfg = config if config is not None else DEFAULT
        window = window if window is not None else cfg.window
        transport = transport if transport is not None else cfg.transport
        if transport not in ("blob", "dense"):
            raise ValueError(f"unknown transport {transport!r} "
                             "(expected 'blob' or 'dense')")
        from .. import native as native_mod
        if use_native is None:
            use_native = isinstance(buf, (bytes, bytearray)) and \
                native_mod.available()
        self.native = None
        self.video = None
        self._native_mod = native_mod
        self._streaming = streaming
        self._ended = not streaming
        self._use_native = use_native
        self._prefix = b""   # bytes held back until the container is known
        with profiling.span("mpeg.open", self._key):
            if use_native:
                if transport != "blob":
                    raise ValueError("transport='dense' needs the Python plan "
                                     "parse (use_native=False): the native "
                                     "parse emits blob records")
                with profiling.span("mpeg.open.copy", self._key):
                    data = bytes(buf if isinstance(buf, (bytes, bytearray))
                                 else buf.bytes())
                if data or not streaming:
                    self._make_native(data)
            else:
                if isinstance(buf, (bytes, bytearray)):
                    import io
                    from ..buffer import Buffer
                    if bytes(buf[:4]) == b"\x00\x00\x01\xBA":
                        raise ValueError(
                            "MPEG-PS input needs the native pipeline "
                            "(use_native=True); the Python plan parser "
                            "consumes elementary streams only")
                    if streaming:
                        # Push-fed buffer: a reader-backed one would report
                        # has_ended as soon as the initial bytes drained.
                        b = Buffer(None)
                        if buf:
                            b.write(bytes(buf))
                    else:
                        b = Buffer(io.BytesIO(bytes(buf)))
                        b.set_load_callback(b.load_reader_callback)
                    buf = b
                self.video = Video(buf, backend="plan")
        self.window = window
        self.transport = transport
        self.stats = stats
        self.emit_rgba = emit_rgba
        self._scan = None
        self._scan_caps = None
        self._carry = None
        self._has_reference_frame = False
        self._types: list[int] = []
        self._refs_parsed = 0
        self._drop_leading_b = False   # set by at_time (open-GOP cut)
        # Sticky pool capacity buckets (monotone growth: the first
        # I-heavy window sets the high-water mark).
        self._km = _MIN_KM
        self._ke = _MIN_KE
        if pool_buckets is not None:
            km, ke = pool_buckets
            self._km = pool_bucket(km, _MIN_KM)
            self._ke = pool_bucket(max(ke, 1), _MIN_KE)
        if prefetch and streaming:
            raise ValueError("prefetch=True requires streaming=False "
                             "(feed() drives the parse in streaming mode)")
        # The run-ahead parse (None: inline; dropped at end of stream).
        self._runahead = RunAhead(
            self, lambda dec: dec._parse_stage(), lambda item: not item[2],
            2) if prefetch else None
        self._closed = False
        self._cached_geom = None
        # Window-blob recycling: each window's host blob (a pinned
        # `host_blob` on the card) stays in _blob_inflight with the gate
        # of its asynchronous copy (`device_put`) until the gate has
        # completed, then returns through _blob_free carrying the pool
        # high-water marks of its last fill, so the native tail pad is
        # O(live records) instead of O(pool capacity) (see
        # NativeVideoParser.blob_window).  TWO producers append to
        # _blob_free — the dispatch thread (via _reap_blobs) and the
        # parse/prefetch thread (the zero-picture early return in
        # _native_window_blob hands its untouched buffer straight back) —
        # and only the parse thread pops.  CPython deque append/pop are
        # GIL-atomic, so this needs no lock; the free-list cap in
        # _reap_blobs is best-effort (the dual producer can exceed it by
        # one).
        self._blob_inflight = collections.deque()
        self._blob_free = collections.deque()

    @classmethod
    def at_time(cls, data: bytes, seek_time: float, **kwargs):
        """Random-access clip decode: a fresh decoder positioned at the
        intra frame at/before `seek_time` of an MPEG-PS byte buffer
        (serving-style clip extraction without decoding the prefix).

        Returns (decoder, packet_pts) or None when no intra packet is
        found.  The scan is seeded by the demuxer's byte-rate estimate
        (demux.py get_duration / seek's own anchor), so deep targets
        read O(scan window) bytes, not O(stream): jump a margin before
        the target, scan deterministically forward, and widen the
        margin backwards only when the jump overshot every intra at or
        before the target; the stream-head linear scan remains as the
        final fallback (and the clamp-to-first-intra path for too-early
        targets).  The clip is the PS pack+system headers plus the
        stream from the intra packet on — the same tune-in contract as
        the reference's intra seek (streams carry per-GOP sequence
        headers).  The decoder's `_seek_scan_bytes` records the bytes
        examined (asserted O(window) by the soak test).
        """
        import io
        from ..buffer import Buffer
        from ..demux import (
            Demux, PACKET_INVALID_TS, PACKET_VIDEO_1, REORDER_WINDOW,
            payload_has_intra,
        )

        if bytes(data[:4]) != b"\x00\x00\x01\xBA":
            raise ValueError("at_time needs an MPEG-PS byte buffer")
        buf = Buffer(io.BytesIO(bytes(data)))
        buf.set_load_callback(buf.load_reader_callback)
        dmx = Demux(buf)
        header_end = buf.tell()   # absolute position after pack+system
        dmx.get_start_time(PACKET_VIDEO_1)
        # Anchor on the raw first PTS (the reference demuxer's own seek
        # anchor, demux.go:216-254): GOP boundaries sit at
        # first_pts + k*gop, so targets like t=6.0 pick the intended GOP.
        anchor = dmx.first_pts.get(PACKET_VIDEO_1, 0.0)
        target = anchor + max(0.0, seek_time)

        # Leading video ES bytes (hold the sequence header): bounded
        # packet reads from the stream head.
        dmx._buffer_seek(header_end)
        es_head = b""
        while len(es_head) < 4096 and \
                buf.find_start_code(PACKET_VIDEO_1) != -1:
            packet = dmx._decode_packet(PACKET_VIDEO_1)
            if packet is None:
                break
            es_head += bytes(packet.data)

        # Byte-rate estimate for the jump (duration's tail scan is
        # itself O(tail windows), demux.py:get_duration).
        import math
        dmx.get_duration(PACKET_VIDEO_1)
        span = dmx.last_pts.get(PACKET_VIDEO_1, PACKET_INVALID_TS) - anchor
        byte_rate = (len(data) / span) if span > 0 else float("nan")

        scan_bytes = len(es_head)
        best_off = -1
        best_pts = PACKET_INVALID_TS
        margin = 2.0
        for _attempt in range(8):
            from_head = (not math.isfinite(byte_rate)) or \
                target - margin <= anchor
            if from_head:
                jump = header_end
            else:
                jump = min(int((target - margin - anchor) * byte_rate),
                           max(len(data) - 256, header_end))
            dmx._buffer_seek(jump)
            while buf.find_start_code(PACKET_VIDEO_1) != -1:
                packet_start = buf.tell() - 4   # the 00 00 01 E0 itself
                packet = dmx._decode_packet(PACKET_VIDEO_1)
                if packet is None:
                    break
                if packet.pts == PACKET_INVALID_TS:
                    continue
                if payload_has_intra(packet.data, packet.length) and \
                        (best_off < 0 or
                         best_pts <= packet.pts <= target) and \
                        (from_head or packet.pts <= target):
                    # latest intra at/before the target; from the stream
                    # head, a too-early target clamps to the stream's
                    # first intra (mid-stream jumps must not clamp to a
                    # LATER intra — they widen backwards instead)
                    best_off, best_pts = packet_start, packet.pts
                if best_off >= 0 and packet.pts > target + REORDER_WINDOW:
                    # past the reorder window with an intra in hand:
                    # nothing better ahead (without one, keep scanning —
                    # the first intra may come long after the first PTS)
                    break
            scan_bytes += buf.tell() - jump
            if best_off >= 0 or from_head:
                break
            margin *= 4   # overshot every intra <= target: widen back

        if best_off < 0:
            return None
        # Seed the clip with the sequence header: mid-stream tune-in
        # needs it, and this framework supports streams that carry it
        # only at the start (the MPEG class keeps it across rewind —
        # video.go:195-201 — so its seek doesn't need this).
        seq = _pes_packet(PACKET_VIDEO_1, _extract_sequence_header(es_head))
        clip = bytes(data[:header_end]) + seq + bytes(data[best_off:])
        dec = cls(clip, **kwargs)
        dec._drop_leading_b = True
        dec._seek_scan_bytes = scan_bytes
        return dec, best_pts

    def _make_native(self, data: bytes):
        """Choose the container (PS pipeline vs raw ES parser) from the
        first bytes and create the native parser; in streaming mode the
        choice waits until 4 bytes have arrived."""
        if self._streaming:
            self._prefix += data
            if len(self._prefix) < 4:
                return
            data, self._prefix = self._prefix, b""
        with profiling.span("mpeg.open.parser", self._key):
            if data[:4] == b"\x00\x00\x01\xBA":
                # MPEG-PS container: the fully-native pipeline (demux +
                # ES parse in C++) exposes the same blob contract.
                self.native = self._native_mod.NativePipeline()
            else:
                self.native = self._native_mod.NativeVideoParser()
            self.native.feed(data)
            if not self._streaming:
                self.native.signal_end()

    def feed(self, data: bytes) -> None:
        """Streaming mode: push more source bytes (ES or PS)."""
        assert self._streaming, "construct with streaming=True to feed"
        if self.video is not None:
            self.video.buf.write(data)
        elif self.native is None:
            self._make_native(bytes(data))
        else:
            self.native.feed(data)

    def signal_end(self) -> None:
        """Streaming mode: the source is exhausted (enables the final
        partial-picture parse and the end-of-stream flush frame)."""
        self._ended = True
        if self.video is not None:
            self.video.buf.signal_end()
        elif self.native is not None:
            self.native.signal_end()

    @property
    def needs_input(self) -> bool:
        """Streaming mode: True while feed() can still unblock decode —
        disambiguates decode_window() returning [] ('need more bytes')
        from end of stream after signal_end."""
        return self._streaming and not self._ended

    @property
    def geom(self) -> FrameGeometry:
        if self.native is None and self.video is None:
            if self._cached_geom is not None:
                return self._cached_geom
            raise RuntimeError("decoder closed" if self._closed
                               else "decoder has no parser")
        return self.native.geom() if self.native is not None \
            else self.video.geom

    def _has_header(self) -> bool:
        if self.video is not None:
            return self.video.has_header()
        return self.native is not None and self.native.has_header()

    def _stream_ended(self) -> bool:
        if self.native is not None:
            return self._ended
        # Push-fed buffers can't infer EOS after compaction (total_size
        # vs shrunken data), so the streaming flag is authoritative.
        return self._ended or self.video.buf.has_ended()

    def _ensure_device_state(self, caps=None):
        if caps is None and self.transport == "blob":
            caps = (self._km, self._ke)
        if self._scan is not None and self._scan_caps == caps and \
                self._carry is not None:
            return
        profiling.count("state_builds")
        with profiling.span("mpeg.state", self._key):
            if self._scan is None or self._scan_caps != caps:
                if self.transport == "blob":
                    self._scan = WindowDecoder(self.geom, self.window, *caps,
                                               emit_rgba=self.emit_rgba,
                                               recon=self._recon)
                else:
                    self._scan = DenseWindowDecoder(self.geom,
                                                    self.emit_rgba,
                                                    recon=self._recon)
                self._scan = self._scan.to(self.device)
                self._scan_caps = caps
            if self._carry is None:
                # Three distinct buffers, as the reference's carry.
                self._carry = tuple(
                    torch.zeros(self.geom.total_size, dtype=torch.uint8,
                                device=self.device) for _ in range(3))

    def load_carry(self, frames, types=()) -> None:
        """Continue a stream whose earlier pictures another decoder (the
        JAX one, say) already decoded: `frames` is its (current, forward,
        backward) carry, `types` the picture types it decoded, in order.
        This decoder's input must then start at the next picture (with
        the sequence header in front)."""
        carry = carry_from_numpy(frames, self.device)
        if carry[0].numel() != self.geom.total_size:
            raise ValueError(f"carry frames hold {carry[0].numel()} bytes; "
                             f"this stream needs {self.geom.total_size}")
        self._carry = carry
        self._types = [int(t) for t in types]
        self._refs_parsed = sum(t != PICTURE_TYPE_B for t in self._types)
        self._has_reference_frame = self._refs_parsed > 0

    def _decode_window_once(self):
        """One window; returns (displays, pictures_parsed)."""
        if not self._has_header():
            return [], 0

        blob, plans, types, caps, t_parse, fill = self._next_parsed()

        if not types:
            # End of stream: flush the pending reference frame.
            self._ensure_device_state()
            if self._has_reference_frame and self._stream_ended() \
                    and self._types and self._types[-1] != PICTURE_TYPE_B:
                self._has_reference_frame = False
                flush = self._carry[2]   # backward
                return [flat_frame_to_rgba(flush, self.geom)
                        if self.emit_rgba else flush.clone()], 0
            return [], 0

        self._ensure_device_state(caps)
        t0 = time.perf_counter()
        enqueue = profiling.span("mpeg.enqueue", self._key)
        if self.transport == "blob":
            # One transfer: the fixed meta+escape prefix and a power-of-two
            # bucket of the filled main records (the tail is zero records).
            split = blob_split(self.geom, self.window, *caps)
            nm = caps[0] if fill is None else fill[0]
            kt = min(pool_bucket(max(nm, 1), _MIN_KM), caps[0])
            nbytes = split + 4 * kt
            with enqueue:
                flags = blob_views(blob, self.geom, self.window,
                                   *caps)["flags"].copy()
                with profiling.span("mpeg.h2d", self._key):
                    (dev_blob,), gate = device_put([blob[:nbytes]],
                                                   self.device)
                with profiling.span("mpeg.launch", self._key):
                    self._carry, disps = self._scan(
                        self._carry, dev_blob[:split], dev_blob[split:],
                        flags)
            # The blob is recycled once its COPY's gate has completed: a
            # completed event after the asynchronous copy proves that the
            # card has read the host bytes.  (The reference gates on the
            # window's output instead, because XLA:CPU reads device_put
            # host buffers lazily from inside the jit.)  A Python-parse
            # blob was staged whole, so its marks are the full buckets.
            self._reap_blobs()
            self._blob_inflight.append(
                (gate, blob, caps, fill if fill is not None else caps))
        else:
            # Stacked straight into a pinned buffer of the module's ring
            # (no staging copy), written again only once its gate has
            # completed.
            nbytes = stack_layout(self.geom, self.window)[1]
            with enqueue:
                host = self._scan.ring(self.device).take(nbytes)
                stacked = stack_plans(plans, self.geom, self.window,
                                      out=host.numpy())
                with profiling.span("mpeg.launch", self._key):
                    self._carry, disps = self._scan(self._carry, stacked,
                                                    host=host)
        t_disp = time.perf_counter() - t0

        if self.stats is not None:
            self.stats.record_window(len(types), nbytes, t_parse, t_disp)

        out = []
        for i, ptype in enumerate(types):
            self._types.append(ptype)
            if ptype != PICTURE_TYPE_B:
                self._refs_parsed += 1
            if ptype == PICTURE_TYPE_B:
                # After an at_time cut, B pictures before the second
                # reference predict from a frame the clip lacks: drop them.
                if not (self._drop_leading_b and self._refs_parsed < 2):
                    out.append(disps[i])
            elif self._has_reference_frame:
                out.append(disps[i])
            else:
                self._has_reference_frame = True
        return out, len(types)

    def parse_window(self):
        """Parse up to `window` picture plans from the stream."""
        plans = []
        while len(plans) < self.window:
            item = self.video.parse_next_plan()
            if item is None:
                break
            plans.append(item)
        return plans

    def _alloc_window_blob(self):
        """Allocate (a `host_blob`: pinned for the card) or recycle a
        window blob for the current pool buckets; returns (blob, field
        views, (hw_nm, hw_ne) pool high-water marks).  Fresh buffers are
        uninitialized with full high-water marks — the native window call
        writes every field byte itself; recycled buffers skip re-padding
        the tail beyond their previous fill (blob_window_impl zeroes
        record tails and unused picture slots off the GIL either way)."""
        key = (self._km, self._ke)
        while True:
            try:
                blob, bkey, hwm = self._blob_free.pop()
            except IndexError:
                break
            if bkey == key:
                return blob, blob_views(blob, self.geom, self.window,
                                        self._km, self._ke), hwm
            # stale capacity bucket: drop the buffer
        _, total = blob_layout(self.geom, self.window, self._km, self._ke)
        blob = host_blob(total, self.device)
        return blob, blob_views(blob, self.geom, self.window,
                                self._km, self._ke), key

    def _reap_blobs(self):
        """Move in-flight blobs whose copy has completed (its gate) onto
        the free list (dispatch thread only).  The reap is `query()`, so it
        never blocks: blobs whose copy is pending stay in flight, the
        oldest dropped past 4, so a stalled card cannot grow host memory
        without bound (a dropped pinned blob is not recycled; torch's host
        allocator holds its memory until its copy has completed)."""
        dq = self._blob_inflight
        while dq:
            gate, blob, bkey, hwm = dq[0]
            if not _gate_done(gate):
                if len(dq) > 4:
                    dq.popleft()   # drop the reference, no recycling
                    continue
                break
            dq.popleft()
            if len(self._blob_free) < 3:
                self._blob_free.append((blob, bkey, hwm))

    def _native_window_blob(self):
        """Parse up to `window` pictures in one native call per window
        (plus one per pool-bucket growth); returns
        (blob | None, types, (nm, ne) fill level)."""
        w = self.window
        types = np.zeros(w, np.int32)
        blob, v, hwm = self._alloc_window_blob()
        w_done = nm = ne = 0
        prev_m = prev_e = 0   # delta-chain tails, carried across growth
        # Worst-case hop-record count for the whole window: total index
        # gap <= the window's dense span, one hop per 0xFFFF of gap.
        # Growth sizes buckets with this slack so the native call's
        # conservative per-picture capacity bound always fits after one
        # growth (blob_window_impl checks records + a prev-aware bound).
        hop_slack = (w * self.geom.mb_size * 6 * 64 >> 16) + w + 2
        while True:
            n, nm, ne, pending, prev_m, prev_e = self.native.blob_window(
                w_done, w, self._km, self._ke, nm, ne,
                v["main_rec"], v["esc_didx"], v["esc_val"],
                v["mv_h"], v["mv_v"], v["nbcls"], v["mbmisc"],
                v["flags"], types, hw_nm=hwm[0], hw_ne=hwm[1],
                prev_m=prev_m, prev_e=prev_e)
            w_done += n
            if pending == 0 or w_done >= w:
                break
            # Grow the sticky buckets to fit the pending picture, carry
            # the partially-filled window into the new layout.
            profiling.count("pool_growths")
            cm, ce = self.native.blob_counts()
            old_km, old_ke = self._km, self._ke
            self._km = pool_bucket(nm + cm + hop_slack, self._km)
            self._ke = pool_bucket(max(ne + ce + hop_slack, 1), self._ke)
            old = v
            blob, v, hwm = self._alloc_window_blob()
            for k in old:
                v[k][:old[k].size] = old[k]
            # The copied prefix (a self-contained delta chain) ends in
            # the old pools' zero pad tails — the pad record (delta 0,
            # value 0) is layout-independent — so pads hold up to the
            # old capacities; past them, only the allocated buffer's own
            # mark is guaranteed — the max of the two bounds the
            # unpadded gap.
            hwm = (max(old_km, hwm[0]), max(old_ke, hwm[1]))
        if w_done == 0:
            # Hand the buffer straight back: the 0-picture call still
            # padded [0, hwm) (records start at 0), so the pad promise
            # holds at the same mark — without this, streaming polls
            # with no buffered bytes would drain the free list.
            self._blob_free.append((blob, (self._km, self._ke), hwm))
            return None, [], None
        return blob, [int(t) for t in types[:w_done]], (nm, ne)

    def decode_window(self) -> list[Optional[np.ndarray]]:
        """Parse + reconstruct one window; returns the displayed frames
        (flat uint8 device arrays).  An empty list means end of stream
        (or, in streaming mode, that more bytes are needed) — windows
        whose displays are all absorbed by the reference delay or the
        open-GOP B-drop advance to the next window internally so callers
        can keep treating [] as 'no more output now'."""
        with profiling.span("mpeg.window", self._key):
            while True:
                out, parsed = self._decode_window_once()
                if out or not parsed:
                    return out

    def _parse_stage(self):
        """Parse + pack one window (runs on the prefetch thread when
        enabled).  Returns (blob, plans, types, caps, t_parse, fill);
        caps pins the pool buckets the blob was packed with, so the
        consumer compiles against the right layout even if a later
        window has already grown the sticky buckets; fill is the
        (nm, ne) pool fill level for blob recycling (None when the
        window came from the Python parse path); the dense transport packs
        nothing (blob and caps None)."""
        t0 = time.perf_counter()
        fill = None
        with profiling.span("mpeg.parse", self._key):
            if self.native is not None:
                blob, types, fill = self._native_window_blob()
                plans = None
            else:
                plans = self.parse_window()
                types = [t for _, t in plans]
                blob = None
                if plans and self.transport == "blob":
                    records = [plan_pool_records(p) for p, _ in plans]
                    (mi, _), (ei, _) = _window_records(
                        plans, self.geom.mb_size, records)
                    nm = delta_encode(mi)[0].size
                    ne = delta_encode(ei)[0].size
                    caps = (self._km, self._ke)
                    self._km = max(self._km, pool_bucket(nm, _MIN_KM))
                    self._ke = max(self._ke, pool_bucket(ne, _MIN_KE))
                    if (self._km, self._ke) != caps:
                        profiling.count("pool_growths")
                    blob = self._alloc_window_blob()[0]
                    pack_plans_blob(plans, self.geom, self.window, self._km,
                                    self._ke, records=records,
                                    out=blob.numpy())
        caps = (self._km, self._ke) if self.transport == "blob" else None
        return blob, plans, types, caps, time.perf_counter() - t0, fill

    def _next_parsed(self):
        """The next parsed window: from the run-ahead parse, or parsed
        inline."""
        with profiling.span("mpeg.parse.wait", self._key):
            if self._runahead is None:
                return self._parse_stage()
            try:
                item = self._runahead.get()
            except BaseException:
                # The windows parsed ahead of the error are lost: resuming
                # inline would skip pictures against a stale carry.
                self._poison()
                raise
        if self._runahead.done:
            # End of stream: the flush and any later polling parse inline.
            self._runahead = None
        return item

    def close(self) -> None:
        """Abandon the decoder: stop the run-ahead parse and end the
        stream.  The run-ahead parse may be up to 3 windows ahead, so
        decode cannot transparently continue past a close() — further
        decode_window() calls return [] instead of silently skipping
        the discarded windows.  A decoder read to end of stream shuts
        its thread down by itself; close() is for early exits."""
        if self._runahead is not None:
            self._runahead.close()
            self._poison()
        self._blob_inflight.clear()   # dropped, as in _poison

    def _poison(self) -> None:
        """Parsed-ahead windows were discarded; poison further decode
        rather than resume with frame gaps + a stale carry.  Geometry is
        cached first so metadata stays readable on a closed decoder."""
        if self.native is not None or self.video is not None:
            try:
                self._cached_geom = self.geom
            except Exception:   # header never arrived
                pass
        self._types = self._types or [0]
        self._has_reference_frame = False
        self.native = None
        self.video = None
        self._closed = True
        self._runahead = None
        # Dropped, not waited on: torch's host allocator keeps a pinned
        # blob's memory until the copy that reads it has completed.
        self._blob_inflight.clear()
        self._blob_free.clear()

    def decode_all(self) -> list:
        """Decode the whole stream; returns flat frame buffers in display
        order."""
        frames = []
        while True:
            got = self.decode_window()
            if not got:
                break
            frames.extend(got)
        return frames
