"""Batched video decode on a torch device: one window blob per transfer.

Port of the device half of `mpeg_tpu/parallel/batch.py`.  The host half —
the native and Python parsers, the window-blob layout, the blob ring,
prefetch, streaming `feed` and `at_time` — is the JAX package's own,
inherited by `BatchVideoDecoder` below.  Per window the device runs:

1. `densify_split`: the blob's delta-coded coefficient records become the
   dense int32 [window*mb*6*64] tensor (cumsum of the u16 deltas, times
   the position's premultiplier, integer `index_add_` — order-independent,
   so deterministic on the card too);
2. `unpack_blob_meta`: motion vectors, IDCT classes, intra bits, src_sel;
3. one reconstruct per picture (`ops.cuda_kernels.reconstruct_picture`:
   the fused CUDA kernel for CUDA tensors, the plain version on the CPU);
4. frame rotation.  The host knows every picture's type from the blob's
   flags, so the (current, forward, backward) carry rotates by swapping
   tensor references instead of the JAX scan's three full-frame selects;
5. with `emit_rgba`, each displayed frame converts to RGBA
   (`ops.color.flat_frame_to_rgba`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from mpeg_tpu.ops.video_recon import FrameGeometry
from mpeg_tpu.parallel import batch as _ref
from mpeg_tpu.parallel.batch import (
    blob_layout, blob_split, blob_views, pool_bucket,
)
from mpeg_tpu.tables import PICTURE_TYPE_B, PREMULTIPLIER_MATRIX

from ..device import resolve_device
from ..ops import cuda_kernels
from ..ops.color import flat_frame_to_rgba

_NB_CLASS_REP = _ref._NB_CLASS_REP
_MIN_KM = _ref._MIN_KM
# Per-picture reconstruct inputs from unpack_blob_meta, in argument order.
_PLAN_FIELDS = ("nblocks", "intra_blk", "src_sel", "mv_h", "mv_v")


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
    `PREMULTIPLIER_MATRIX` as int32 on the blob's device."""
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
        geom, window, mb = self.geom, self.window, self.geom.mb_size
        coeffs = densify_split(meta_esc, main_part, geom, window, self.ke,
                               self.premult).view(window, mb, 6, 64)
        meta = unpack_blob_meta(meta_esc, geom, window, self.km, self.ke,
                                self.nb_class_rep)
        cur, fwd, bwd = carry
        shape = (geom.height, geom.width, 4) if self.emit_rgba \
            else (geom.total_size,)
        disps = torch.empty((window, *shape), dtype=torch.uint8,
                            device=cur.device)
        for t in range(window):
            is_ref, run = flags[t] & 1, flags[t] & 2
            if run:                  # a reference's forward aliases backward
                new = self.recon(
                    cur, bwd if is_ref else fwd, bwd, coeffs[t],
                    *(meta[k][t] for k in _PLAN_FIELDS), geom)
            else:                    # padding step: the carry stays
                new = cur
            disp = bwd if is_ref else new
            disps[t].copy_(flat_frame_to_rgba(disp, geom) if self.emit_rgba
                           else disp)
            if is_ref and run:
                cur, fwd, bwd = fwd, bwd, new
            else:
                cur = new
        return (cur, fwd, bwd), disps


def carry_from_numpy(frames, device) -> tuple:
    """The port's carry from three flat uint8 frames — e.g. the JAX
    decoder's carry, `[np.asarray(f) for f in dec._carry]`."""
    dev = resolve_device(device)
    frames = [np.asarray(f) for f in frames]
    if len(frames) != 3 or any(f.dtype != np.uint8 or f.ndim != 1 or
                               f.size != frames[0].size for f in frames):
        raise ValueError("carry: expected 3 flat uint8 frames of one size")
    # np.array copies: the source may be read-only (a jax array's view).
    return tuple(torch.from_numpy(np.array(f)).to(dev) for f in frames)


class BatchVideoDecoder(_ref.BatchVideoDecoder):
    """Throughput decoder: host parse feeding windowed decodes on a torch
    device.  Same output sequence as `mpeg_tpu.parallel.BatchVideoDecoder`
    (the reference delay, the end-of-stream flush, open-GOP B drops after
    `at_time`); displayed frames are flat uint8 [total_size] tensors on
    `device`.

    `device` is required ("cuda" or "cpu").  On "cuda" each picture is one
    launch of the fused reconstruct kernel; on "cpu" the plain PyTorch
    version runs.  With `emit_rgba=True` displayed frames are [H, W, 4]
    uint8 RGBA tensors on `device`.  The other arguments are the
    reference decoder's.
    """

    # The per-picture reconstruct `WindowDecoder` runs (internal: K3's
    # smoke run sets cuda_kernels.reconstruct_picture_multi here).
    _recon = staticmethod(cuda_kernels.reconstruct_picture)

    def __init__(self, buf, window: int = None, *, device, **kwargs):
        self.device = resolve_device(device)
        if kwargs.get("transport") in (None, "blob"):
            super().__init__(buf, window, **kwargs)
        if getattr(self, "transport", None) != "blob":
            raise NotImplementedError(
                "transport='dense' is still to port (ROADMAP, 'Still to "
                "port': the dense transport); the port decodes the blob "
                "transport")

    def _ensure_device_state(self, caps=None):
        if caps is None:
            caps = (self._km, self._ke)
        if self._scan is None or self._scan_caps != caps:
            self._scan = WindowDecoder(self.geom, self.window, *caps,
                                       emit_rgba=self.emit_rgba,
                                       recon=self._recon).to(self.device)
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

        blob, _plans, types, caps, t_parse, fill = self._next_parsed()

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
        # One transfer: the fixed meta+escape prefix and a power-of-two
        # bucket of the filled main records (the tail is zero records).
        split = blob_split(self.geom, self.window, *caps)
        nm = caps[0] if fill is None else fill[0]
        kt = min(pool_bucket(max(nm, 1), _MIN_KM), caps[0])
        nbytes = split + 4 * kt
        flags = blob_views(blob, self.geom, self.window, *caps)["flags"] \
            .copy()
        dev_blob = torch.from_numpy(blob[:nbytes]).to(self.device, copy=True)
        if fill is not None and len(self._blob_free) < 3:
            # The copy above is blocking (pageable host memory), so the
            # host blob is free again as soon as it returns.
            self._blob_free.append((blob, caps, fill))
        self._carry, disps = self._scan(self._carry, dev_blob[:split],
                                        dev_blob[split:], flags)
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
