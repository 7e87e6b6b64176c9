"""Plain PyTorch versions of the picture reconstruct (IDCT + motion
compensation + residual compose).

Port of `mpeg_tpu.ops.video_recon` (its numpy/XLA formulation).  These run
on any torch device; the CPU path of the port uses them, and the CUDA
kernels in `cuda_kernels` are held against them byte for byte.  All
arithmetic is int32 with arithmetic shifts, as in the reference, so every
result is exact.

The frame layout is the reference's shared flat buffer (`FrameGeometry`):
luma, Cb and Cr planes back to back, then 16 luma rows of padding, so a
half-pel read past a plane edge lands in the next plane's bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["FrameGeometry", "idct_batch", "mb_window_starts",
           "reconstruct_picture", "reconstruct_picture_multi",
           "reconstruct_pictures", "reconstruct_plane",
           "reconstruct_planes"]


@dataclass(frozen=True)
class FrameGeometry:
    """Static per-sequence layout (reference: mpeg_tpu/ops/video_recon.py
    FrameGeometry; parity: video.go:314-326, 333-372)."""

    width: int
    height: int
    mb_width: int
    mb_height: int

    @property
    def mb_size(self) -> int:
        return self.mb_width * self.mb_height

    @property
    def luma_width(self) -> int:
        return self.mb_width << 4

    @property
    def luma_height(self) -> int:
        return self.mb_height << 4

    @property
    def chroma_width(self) -> int:
        return self.mb_width << 3

    @property
    def chroma_height(self) -> int:
        return self.mb_height << 3

    @property
    def luma_size(self) -> int:
        return self.luma_width * self.luma_height

    @property
    def chroma_size(self) -> int:
        return self.chroma_width * self.chroma_height

    @property
    def frame_size(self) -> int:
        return self.luma_size + 2 * self.chroma_size

    @property
    def total_size(self) -> int:
        # Shared padded buffer: 16 extra luma rows for edge overreads
        # (video.go:338-340).
        return self.frame_size + self.luma_width * 16

    @classmethod
    def for_size(cls, width: int, height: int) -> "FrameGeometry":
        return cls(width, height, (width + 15) >> 4, (height + 15) >> 4)


# --------------------------------------------------------------------------
# Integer 8x8 IDCT (reference: mpeg_tpu/ops/video_recon.py:117-195)
# --------------------------------------------------------------------------

def _butterfly(b1, b3, b4, tmp1, tmp2, b6, m0, x2, final_shift):
    """Shared 8-point core; x2 is the precomputed variant-specific term."""
    b7 = tmp1 + tmp2
    x4 = ((b6 * 473 - b4 * 196 + 128) >> 8) - b7
    x0 = x4 - (((tmp1 - tmp2) * 362 + 128) >> 8)
    x1 = m0 - b1
    x3 = m0 + b1
    y3 = x1 + x2
    y4 = x3 + b3
    y5 = x1 - x2
    y6 = x3 - b3
    y7 = -x0 - ((b4 * 473 + b6 * 196 + 128) >> 8)
    outs = (b7 + y4, x4 + y3, y5 - x0, y6 - y7,
            y6 + y7, x0 + y5, y3 - x4, y4 - b7)
    if final_shift:
        outs = tuple((o + 128) >> 8 for o in outs)
    return outs


def _pass_full(x, final_shift):
    """Full 8-point transform; x is a tuple of 8 tensors."""
    b1 = x[4]
    b3 = x[2] + x[6]
    b4 = x[5] - x[3]
    tmp1 = x[1] + x[7]
    tmp2 = x[3] + x[5]
    b6 = x[1] - x[7]
    m0 = x[0]
    x2 = (((x[2] - x[6]) * 362 + 128) >> 8) - b3
    return _butterfly(b1, b3, b4, tmp1, tmp2, b6, m0, x2, final_shift)


def _pass_sparse(x, final_shift):
    """Sparse variant: inputs 4..7 taken as zero (video.go:807-866)."""
    b3 = x[2]
    b4 = -x[3]
    tmp1 = x[1]
    tmp2 = x[3]
    b6 = x[1]
    m0 = x[0]
    x2 = ((x[2] * 362 + 128) >> 8) - b3
    return _butterfly(0, b3, b4, tmp1, tmp2, b6, m0, x2, final_shift)


def _trunc_div2(v):
    """Go-style integer division by 2, truncating toward zero."""
    return (v + ((v >> 31) & 1)) >> 1

def _idct2d(blocks: torch.Tensor, sparse: bool) -> torch.Tensor:
    """2-D IDCT over [..., 8, 8] int32 blocks, one exact variant."""
    line_pass = _pass_sparse if sparse else _pass_full
    # The sparse variant reads columns 0..3 only (its inputs 4..7 are
    # taken as zero), so the column pass covers just those.
    ncols = 4 if sparse else 8
    rows = tuple(blocks[..., r, :ncols] for r in range(8))
    mid = line_pass(rows, final_shift=False)          # 8 x [..., ncols]
    cols = tuple(torch.stack([mid[r][..., c] for r in range(8)], dim=-1)
                 for c in range(ncols))               # ncols x [..., 8]
    return torch.stack(line_pass(cols, final_shift=True), dim=-1)


def idct_batch(coeffs: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Exact-variant IDCT over a batch of blocks.

    coeffs: int32 [..., 64]; nblocks: int32 [...]; returns int32 [..., 64].
    Variant per block: n == 1 is a DC replicate, n < 10 sparse, else full.
    """
    blocks = coeffs.reshape(coeffs.shape[:-1] + (8, 8))
    full = _idct2d(blocks, sparse=False).reshape(coeffs.shape)
    sparse = _idct2d(blocks, sparse=True).reshape(coeffs.shape)
    dc = ((coeffs[..., 0:1] + 128) >> 8).expand(coeffs.shape)
    n = nblocks[..., None]
    return torch.where(n == 1, dc, torch.where(n < 10, sparse, full))


# --------------------------------------------------------------------------
# Motion compensation + reconstruction
# (reference: mpeg_tpu/ops/video_recon.py:234-385)
# --------------------------------------------------------------------------

def _window_pred(src_flat, ys, xs, oh_s, ov_s, bw: int, stride: int):
    """Half-pel prediction of `bw`-pixel row segments from the flat
    [fwd | bwd] stack.  ys, xs: int32 [...] window starts (row, column;
    the row is clamped here to [0, rows2 - 2] as the reference's clipped
    gather does); oh_s, ov_s: int32 [..., 1].  The window reads the flat
    buffer directly: taps past the end of a row continue into the next
    row's first bytes, and taps past the end of the stack read 0 — the
    reference's 32 extension columns, in flat terms.
    Blend: (a + b*oh + c*ov + d*oh*ov + bias) >> (oh + ov)."""
    rows2 = src_flat.shape[0] // stride
    ys = ys.clamp(0, rows2 - 2)
    start = (ys * stride + xs).long()[..., None]
    padded = torch.cat([src_flat, src_flat.new_zeros(stride + 32)])
    taps = torch.arange(bw + 1, device=src_flat.device)
    top = padded[start + taps].to(torch.int32)               # [..., bw+1]
    bot = padded[start + stride + taps].to(torch.int32)
    a, b = top[..., :bw], top[..., 1:]
    c, d = bot[..., :bw], bot[..., 1:]
    sh = oh_s + ov_s
    bias = (1 << sh) >> 1
    return (a + b * oh_s + c * ov_s + d * (oh_s & ov_s) + bias) >> sh


def _mc_plane(src_flat, sel, hp, vp, oh, ov, sel_bwd, base: int,
              stride: int, bw: int, plane_h: int, geom: FrameGeometry,
              cur_plane):
    """Motion-compensate one plane from the stacked [fwd | bwd] buffer.

    Each (pixel row, macroblock) window starts at a flat byte address; its
    row is the floor quotient by `stride` and its column the floor
    remainder (`_window_pred` reads the window)."""
    dev = src_flat.device
    n = src_flat.shape[0]
    mbw = geom.mb_width
    shift = 4 if bw == 16 else 3
    y = torch.arange(plane_h, dtype=torch.int32, device=dev)[:, None]
    c = torch.arange(mbw, dtype=torch.int32, device=dev)[None, :]
    rowmb = ((y >> shift) * mbw + c).long()                  # [h, mbw]
    off = torch.where(sel_bwd, n // 2, 0).to(torch.int32)

    flat = base + (y + vp[rowmb]) * stride + c * bw + hp[rowmb] + off[rowmb]
    ys = torch.div(flat, stride, rounding_mode="floor")
    pred = _window_pred(src_flat, ys, flat - ys * stride,
                        oh[rowmb][..., None], ov[rowmb][..., None], bw,
                        stride).reshape(plane_h, mbw * bw)
    sel_px = sel[rowmb].repeat_interleave(bw, dim=1)
    return torch.where(sel_px > 0, pred, cur_plane.to(torch.int32))


def _luma_blocks_to_plane(vals, geom: FrameGeometry):
    """[mb, 4, 64] block layout -> [lumaH, lumaW] plane."""
    mh, mw = geom.mb_height, geom.mb_width
    return vals.reshape(mh, mw, 2, 2, 8, 8).permute(0, 2, 4, 1, 3, 5) \
        .reshape(geom.luma_height, geom.luma_width)


def _chroma_blocks_to_plane(vals, geom: FrameGeometry):
    """[mb, 64] block layout -> [chromaH, chromaW] plane."""
    mh, mw = geom.mb_height, geom.mb_width
    return vals.reshape(mh, mw, 8, 8).permute(0, 2, 1, 3) \
        .reshape(geom.chroma_height, geom.chroma_width)


def _per_px_luma(a, geom: FrameGeometry):
    """Per-block values [mb, 4] -> per-pixel luma plane."""
    return _luma_blocks_to_plane(
        a[:, :, None].expand(geom.mb_size, 4, 64), geom)


def _per_px_chroma(a, geom: FrameGeometry):
    """Per-macroblock values [mb] -> per-pixel chroma plane."""
    return _chroma_blocks_to_plane(a[:, None].expand(geom.mb_size, 64), geom)


def reconstruct_picture(cur_flat, fwd_flat, bwd_flat, coeffs, nblocks,
                        intra_blk, src_sel, mv_h, mv_v,
                        geom: FrameGeometry) -> torch.Tensor:
    """Reconstruct one picture into a new flat frame buffer.

    cur/fwd/bwd_flat: uint8 [total_size]; coeffs int32 [mb, 6, 64];
    nblocks, intra_blk int32 [mb, 6]; src_sel, mv_h, mv_v int32 [mb].
    Returns the new current buffer, uint8 [total_size].
    """
    src_stack = torch.cat([fwd_flat, bwd_flat])

    hp, vp, oh, ov = mv_h >> 1, mv_v >> 1, mv_h & 1, mv_v & 1
    cm_h, cm_v = _trunc_div2(mv_h), _trunc_div2(mv_v)
    chp, cvp, coh, cov = cm_h >> 1, cm_v >> 1, cm_h & 1, cm_v & 1
    sel_bwd = src_sel == 2

    lw, cw = geom.luma_width, geom.chroma_width
    cb0 = geom.luma_size
    cr0 = geom.luma_size + geom.chroma_size
    cur_y = cur_flat[:cb0].reshape(geom.luma_height, lw)
    cur_cb = cur_flat[cb0:cr0].reshape(geom.chroma_height, cw)
    cur_cr = cur_flat[cr0:geom.frame_size].reshape(geom.chroma_height, cw)

    pred_y = _mc_plane(src_stack, src_sel, hp, vp, oh, ov, sel_bwd,
                       0, lw, 16, geom.luma_height, geom, cur_y)
    pred_cb = _mc_plane(src_stack, src_sel, chp, cvp, coh, cov, sel_bwd,
                        cb0, cw, 8, geom.chroma_height, geom, cur_cb)
    pred_cr = _mc_plane(src_stack, src_sel, chp, cvp, coh, cov, sel_bwd,
                        cr0, cw, 8, geom.chroma_height, geom, cur_cr)

    vals = idct_batch(coeffs, nblocks)                       # [mb, 6, 64]
    coded = (nblocks > 0).to(torch.int32)

    def compose(pred, res, coded_px, intra_px):
        # coded blocks: clamp((intra ? 0 : pred) + residual); else pred
        base = torch.where(intra_px > 0, 0, pred)
        out = torch.where(coded_px > 0, (base + res).clamp(0, 255), pred)
        return out.to(torch.uint8).reshape(-1)

    out_y = compose(pred_y, _luma_blocks_to_plane(vals[:, :4], geom),
                    _per_px_luma(coded[:, :4], geom),
                    _per_px_luma(intra_blk[:, :4], geom))
    out_cb = compose(pred_cb, _chroma_blocks_to_plane(vals[:, 4], geom),
                     _per_px_chroma(coded[:, 4], geom),
                     _per_px_chroma(intra_blk[:, 4], geom))
    out_cr = compose(pred_cr, _chroma_blocks_to_plane(vals[:, 5], geom),
                     _per_px_chroma(coded[:, 5], geom),
                     _per_px_chroma(intra_blk[:, 5], geom))
    return torch.cat([out_y, out_cb, out_cr, cur_flat[geom.frame_size:]])


def reconstruct_pictures(pool, table, coeffs, nblocks, intra_blk, src_sel,
                         mv_h, mv_v, geom: FrameGeometry) -> torch.Tensor:
    """One picture-step of S streams over a frame pool, in place.

    pool: uint8 [P, total_size] frames; table: int32 [S, 5], row s the
    stream's (cur, fwd, bwd, out) pool slots and its picture index into
    coeffs int32 [G, mb, 6, 64], nblocks / intra_blk int32 [G, mb, 6] and
    src_sel / mv_h / mv_v int32 [G, mb].  Each row with a picture index
    >= 0 writes `reconstruct_picture` of its slots into pool[out]; a row
    with a negative index is a no-op.  An out slot is never a slot the
    step reads.  Returns `pool`, updated in place (the pool holds every
    stream's frames, so the step allocates none)."""
    for cur, fwd, bwd, out, pic in table.tolist():
        if pic < 0:
            continue
        pool[out] = reconstruct_picture(
            pool[cur], pool[fwd], pool[bwd], coeffs[pic], nblocks[pic],
            intra_blk[pic], src_sel[pic], mv_h[pic], mv_v[pic], geom)
    return pool


# --------------------------------------------------------------------------
# Multi-launch reconstruct: per-plane passes fed by a separate IDCT
# (reference: mpeg_tpu/ops/pallas_kernels.py _mb_window_starts,
# _plane_pallas, reconstruct_picture_pallas_multi)
# --------------------------------------------------------------------------

def mb_window_starts(sel_bwd, hp, vp, base: int, stride: int, bw: int,
                     geom: FrameGeometry, src_len: int):
    """Per-macroblock window starts (ys0, xs), int32 [mbh, mbw]: the floor
    quotient and remainder of the flat address of the macroblock's pixel
    row 0.  Pixel row r starts r rows lower, at the same column."""
    mbh, mbw = geom.mb_height, geom.mb_width
    dev = hp.device
    row0 = torch.arange(mbh, dtype=torch.int32, device=dev)[:, None] * bw
    col0 = torch.arange(mbw, dtype=torch.int32, device=dev)[None, :] * bw
    g = lambda a: a.reshape(mbh, mbw)                        # noqa: E731
    off = torch.where(sel_bwd, src_len // 2, 0).to(torch.int32)
    flat0 = base + (row0 + g(vp)) * stride + col0 + g(hp) + g(off)
    ys0 = torch.div(flat0, stride, rounding_mode="floor")
    return ys0, flat0 - ys0 * stride


def reconstruct_plane(src_stack, cur_plane, res_plane, coded_px, intra_px,
                      ys0, xs, oh, ov, sel, bw: int, stride: int):
    """MC, residual add and clamp over a plane stack of macroblock rows
    (the counterpart of `_plane_pallas`; Cb and Cr stack into one call,
    their bases folded into the window starts).

    src_stack: flat uint8 [fwd | bwd]; ys0, xs, oh, ov, sel: int32
    [mb_rows, mbw] per macroblock; cur_plane uint8 and res_plane,
    coded_px, intra_px int32 [mb_rows * bw, mbw * bw].  Each pixel row's
    window start ys0 + r is clamped on its own.  Returns uint8
    [mb_rows * bw, mbw * bw]."""
    mb_rows, mbw = ys0.shape
    h = mb_rows * bw
    y = torch.arange(h, dtype=torch.int32, device=ys0.device)
    row = (y // bw).long()                  # each pixel row's MB row
    ys = ys0[row] + (y % bw)[:, None]                        # [h, mbw]
    pred = _window_pred(src_stack, ys, xs[row], oh[row][..., None],
                        ov[row][..., None], bw, stride).reshape(h, mbw * bw)
    sel_px = sel.repeat_interleave(bw, 0).repeat_interleave(bw, 1)
    pred = torch.where(sel_px > 0, pred, cur_plane.to(torch.int32))
    base = torch.where(intra_px > 0, 0, pred)
    out = torch.where(coded_px > 0, (base + res_plane).clamp(0, 255), pred)
    return out.to(torch.uint8)


def reconstruct_picture_multi(cur_flat, fwd_flat, bwd_flat, coeffs,
                              nblocks, intra_blk, src_sel, mv_h, mv_v,
                              geom: FrameGeometry,
                              pallas_idct: bool = True) -> torch.Tensor:
    """The bytes of `reconstruct_picture` in three passes: the batched
    IDCT, then `reconstruct_planes` (one luma plane pass and one fused
    Cb|Cr pass).  `pallas_idct` names the IDCT the reference takes (its
    Pallas kernel or XLA's); both are this module's `idct_batch` here."""
    del pallas_idct
    return reconstruct_planes(cur_flat, fwd_flat, bwd_flat,
                              idct_batch(coeffs, nblocks), nblocks,
                              intra_blk, src_sel, mv_h, mv_v, geom)


def reconstruct_planes(cur_flat, fwd_flat, bwd_flat, res, nblocks,
                       intra_blk, src_sel, mv_h, mv_v,
                       geom: FrameGeometry) -> torch.Tensor:
    """MC, residual add and clamp of one picture from its residual (the
    plain version of K3's two plane launches): res int32 [mb, 6, 64], the
    IDCT of the coefficients (an uncoded block's residual is never read);
    the other arguments as `reconstruct_picture`.  Returns the whole flat
    frame, uint8 [total_size], its pad bytes [frame_size, total_size)
    carried over from cur_flat."""
    src_stack = torch.cat([fwd_flat, bwd_flat])
    src_len = src_stack.shape[0]

    hp, vp, oh, ov = mv_h >> 1, mv_v >> 1, mv_h & 1, mv_v & 1
    cm_h, cm_v = _trunc_div2(mv_h), _trunc_div2(mv_v)
    chp, cvp, coh, cov = cm_h >> 1, cm_v >> 1, cm_h & 1, cm_v & 1
    sel_bwd = src_sel == 2
    coded = (nblocks > 0).to(torch.int32)

    lw, cw = geom.luma_width, geom.chroma_width
    cb0 = geom.luma_size
    cr0 = geom.luma_size + geom.chroma_size
    cur_y = cur_flat[:cb0].reshape(geom.luma_height, lw)
    cur_cb = cur_flat[cb0:cr0].reshape(geom.chroma_height, cw)
    cur_cr = cur_flat[cr0:geom.frame_size].reshape(geom.chroma_height, cw)
    g = lambda a: a.reshape(geom.mb_height, geom.mb_width)   # noqa: E731

    ys_y, xs_y = mb_window_starts(sel_bwd, hp, vp, 0, lw, 16, geom, src_len)
    out_y = reconstruct_plane(
        src_stack, cur_y, _luma_blocks_to_plane(res[:, :4], geom),
        _per_px_luma(coded[:, :4], geom),
        _per_px_luma(intra_blk[:, :4], geom),
        ys_y, xs_y, g(oh), g(ov), g(src_sel), 16, lw)

    # Cb and Cr in one pass: same stride and motion terms, the bases
    # folded into the window starts, the planes stacked along rows.
    ys_cb, xs_cb = mb_window_starts(sel_bwd, chp, cvp, cb0, cw, 8, geom,
                                    src_len)
    ys_cr, xs_cr = mb_window_starts(sel_bwd, chp, cvp, cr0, cw, 8, geom,
                                    src_len)
    cat = lambda a, b: torch.cat([a, b])                     # noqa: E731
    out_c = reconstruct_plane(
        src_stack, cat(cur_cb, cur_cr),
        cat(_chroma_blocks_to_plane(res[:, 4], geom),
            _chroma_blocks_to_plane(res[:, 5], geom)),
        cat(_per_px_chroma(coded[:, 4], geom),
            _per_px_chroma(coded[:, 5], geom)),
        cat(_per_px_chroma(intra_blk[:, 4], geom),
            _per_px_chroma(intra_blk[:, 5], geom)),
        cat(ys_cb, ys_cr), cat(xs_cb, xs_cr), cat(g(coh), g(coh)),
        cat(g(cov), g(cov)), cat(g(src_sel), g(src_sel)), 8, cw)
    return torch.cat([out_y.reshape(-1), out_c.reshape(-1),
                      cur_flat[geom.frame_size:]])
