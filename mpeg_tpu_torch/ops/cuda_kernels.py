"""Wrappers of the hand-written CUDA kernels (csrc/recon.cu, csrc/synth.cu,
csrc/densify.cu).

Port of `mpeg_tpu/ops/pallas_kernels.py`.  Each wrapper takes the plain
PyTorch version (`video_recon`) for tensors on the CPU; for CUDA tensors it
launches its kernel or raises — there is no fallback.  Each kernel counts
its launches in the `launches` attribute of the wrapper named after it, so
a run can show that its main path went through the kernel.

- `reconstruct_picture` (K1): one launch per picture — motion
  compensation, the exact IDCT, residual add and clamp for all three
  planes.  Replaces `reconstruct_picture_pallas` and the XLA IDCT that fed
  it.  `reconstruct_pictures` launches the same kernel over one
  picture-step of many streams in a frame pool (the many-stream decode's
  stream axis); its launches count in `reconstruct_picture.launches`.
  K1 copies frames and coefficients in 16-byte granules: the wrappers
  refuse frames and coefficients that do not start 16-byte aligned
  (every tensor torch allocates does) and block counts and intra flags
  that do not start 8-byte aligned.  `reconstruct_bound` gives the least
  bytes and time a K1 call needs for its plans.
- `idct_batch` (K2): the standalone batched IDCT.  Replaces
  `idct_batch_pallas`; K1 runs the same device function fused.
- `reconstruct_picture_multi` (K3): K2, then `reconstruct_planes`: two
  plane launches, one for luma and one for Cb|Cr (which also writes the
  pad bytes).  Replaces `reconstruct_picture_pallas_multi`
  (`_plane_pallas`); its count is the plane launches.  The plane
  launches share K1's staging and copy granules too: `reconstruct_planes`
  refuses frames and residual that do not start 16-byte aligned, and
  block counts and intra flags that do not start 8-byte aligned.
  `reconstruct_bound(..., separate_idct=True)` gives the K3 path's floor.
- `synthesize` (K4, csrc/synth.cu, a library of its own): the MP2
  synthesis filterbank of S streams in one launch, from the last 15 DCT
  blocks (`hist`), with the raw window outputs, the normalized f32 or the
  S16 PCM out.  `synthesize_ring` launches it from a V ring and its
  position (`Audio`'s state).  Replaces the jitted JAX programs
  `make_synthesize_frame_jax`, `make_synthesize_parallel_jax`, its S16
  form and `make_finalize_jax` (none is a `pallas_call`), bit-exact with
  the plain version (`filterbank`); both count in `synthesize.launches`.
  Unlike the wrappers above, these check their inputs before taking the
  plain version, so a CPU call refuses what a CUDA call refuses; on the
  card they also refuse samples and a ring or hist that do not start
  16-byte aligned (K4 copies in 16-byte pieces; every tensor torch
  allocates does).  `synth_bound` gives the least bytes, operations and
  time of a call.
- `densify_unpack` (K5, csrc/densify.cu, a library of its own): S streams'
  window blobs to their plan tensors in `DENSIFY_LAUNCHES` (three)
  launches: the coefficients of every coded block (the blob's delta-coded
  records: prefix sum, premultiply, scatter-add), each assembled on chip
  and written once, and the seven metadata tensors.  Replaces the
  jitted `densify_split_jax` and `unpack_blob_meta` (not `pallas_call`s).
  It takes CUDA tensors only: `parallel.batch.densify_unpack` runs the
  plain pair for CPU tensors.  Uncoded blocks of its coefficients are left
  as `torch.empty` leaves them.  `densify_bound` gives the least bytes and
  time of a call.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import filterbank, video_recon
from ..tables import D_WINDOW
from .video_recon import FrameGeometry

_TABLE_COLS = 5         # cur, fwd, bwd, out slot; picture index
_MAX_STREAMS = 65535
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: expected contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_int32(name, t, shape, device):
    _check(name, t, torch.int32, shape, device)


def _check_plan(geom, dev, coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v,
                lead=(), blocks="coeffs"):
    """The plan tensors of `lead` pictures (() for one picture); `blocks`
    names the first (coefficients, or K3's residual)."""
    mb = geom.mb_size
    _check_int32(blocks, coeffs, (*lead, mb, 6, 64), dev)
    _check_int32("nblocks", nblocks, (*lead, mb, 6), dev)
    _check_int32("intra_blk", intra_blk, (*lead, mb, 6), dev)
    for name, t in (("src_sel", src_sel), ("mv_h", mv_h), ("mv_v", mv_v)):
        _check_int32(name, t, (*lead, mb), dev)


def _check_aligned(kernel, name, t, align: int):
    if t.data_ptr() % align:
        raise ValueError(f"{name}: {kernel} needs its data {align}-byte "
                         f"aligned (data_ptr {t.data_ptr():#x})")


def _check_alignment(kernel, frames: dict, blocks: dict, nblocks,
                     intra_blk):
    """K1 and K3 copy frames and blocks (coefficients or residual) in
    16-byte granules and read block counts and intra flags 8 bytes at a
    time."""
    for name, t in (*frames.items(), *blocks.items()):
        _check_aligned(kernel, name, t, 16)
    _check_aligned(kernel, "nblocks", nblocks, 8)
    _check_aligned(kernel, "intra_blk", intra_blk, 8)


def reconstruct_bound(nblocks, intra_blk, geom: FrameGeometry,
                      separate_idct: bool = False) -> dict:
    """The least device-memory traffic of reconstructing the pictures of
    these plans (any leading axes before [mb, 6]), each input byte read
    once and each output byte written once: 256 B of coefficients (K1)
    or residual (K3's plane launches) for each coded block (nblocks > 0),
    64 B of prediction for each block that is not coded intra (from the
    current frame where src_sel is 0, else from a reference: src_sel
    picks the frame, not the byte count), 60 B of plan a macroblock
    (nblocks, intra_blk, src_sel, mv_h, mv_v), and a written frame of
    total_size bytes with its pad of total_size - frame_size bytes read
    from the current frame.  `separate_idct` gives the K3 path's floor:
    it adds K2, which reads every block's 256 B of coefficients and 4 B
    count and writes its 256 B of residual (516 B a block), so it is
    never below K1's.  Returns {"bytes", "us"}, "us" the bytes over
    `HBM_BYTES_PER_S`; the integer work (~600 ops an IDCT block) is far
    below the card's rate, so bytes bound it."""
    coded = nblocks > 0
    n_coded = int(coded.sum())
    n_predicted = int((~(coded & (intra_blk > 0))).sum())
    pictures = nblocks.numel() // (6 * geom.mb_size)
    frame = geom.total_size + (geom.total_size - geom.frame_size)
    nbytes = (256 * n_coded + 64 * n_predicted
              + pictures * (60 * geom.mb_size + frame))
    if separate_idct:
        nbytes += 516 * nblocks.numel()
    return {"bytes": nbytes, "us": nbytes / HBM_BYTES_PER_S * 1e6}


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def idct_batch(coeffs: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Exact-variant IDCT: int32 [N, 64], int32 [N] -> int32 [N, 64]."""
    if _device_kind(coeffs) == "cpu":
        return video_recon.idct_batch(coeffs, nblocks)
    from . import _build

    n = coeffs.shape[0]
    _check_int32("coeffs", coeffs, (n, 64), coeffs.device)
    _check_int32("nblocks", nblocks, (n,), coeffs.device)
    out = torch.empty_like(coeffs)
    if n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(coeffs.device):
        code = lib.mt_idct_batch(coeffs.data_ptr(), nblocks.data_ptr(),
                                 out.data_ptr(), n, _stream(coeffs.device))
    idct_batch.launches += 1
    _build.check(code, "idct_batch")
    return out


idct_batch.launches = 0


def _check_frames(geom, dev, **frames):
    for name, t in frames.items():
        _check(name, t, torch.uint8, (geom.total_size,), dev)


def _plan_ptrs(coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v):
    return (coeffs.data_ptr(), nblocks.data_ptr(), intra_blk.data_ptr(),
            src_sel.data_ptr(), mv_h.data_ptr(), mv_v.data_ptr())


def reconstruct_picture(cur_flat, fwd_flat, bwd_flat, coeffs, nblocks,
                        intra_blk, src_sel, mv_h, mv_v,
                        geom: FrameGeometry) -> torch.Tensor:
    """One picture into a new flat frame buffer (signature and semantics
    of `video_recon.reconstruct_picture`).  fwd and bwd may be the same
    tensor; the output never aliases an input."""
    plan = (coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v)
    if _device_kind(cur_flat) == "cpu":
        return video_recon.reconstruct_picture(
            cur_flat, fwd_flat, bwd_flat, *plan, geom)
    from . import _build

    dev = cur_flat.device
    _check_frames(geom, dev, cur=cur_flat, fwd=fwd_flat, bwd=bwd_flat)
    _check_plan(geom, dev, *plan)
    out = torch.empty_like(cur_flat)
    _check_alignment("K1", {"cur": cur_flat, "fwd": fwd_flat,
                            "bwd": bwd_flat, "out": out},
                     {"coeffs": coeffs}, nblocks, intra_blk)
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.mt_reconstruct_pictures(
            cur_flat.data_ptr(), fwd_flat.data_ptr(), bwd_flat.data_ptr(),
            out.data_ptr(), None, 1, *_plan_ptrs(*plan), geom.mb_width,
            geom.mb_height, _stream(dev))
    reconstruct_picture.launches += 1
    _build.check(code, "reconstruct_picture")
    return out


reconstruct_picture.launches = 0


def reconstruct_pictures(pool, table, coeffs, nblocks, intra_blk, src_sel,
                         mv_h, mv_v, geom: FrameGeometry) -> torch.Tensor:
    """One picture-step of S streams in ONE launch of K1, in place
    (signature and semantics of `video_recon.reconstruct_pictures`).

    pool: uint8 [P, total_size]; table: int32 [S, 5] on the pool's device,
    row s = (cur, fwd, bwd, out slot, picture index; < 0 skips the
    stream); the plan tensors have a leading picture axis.  The caller
    keeps the table's slots in [0, P) and its picture indices below the
    plan's length, and never names a read slot as an out slot: the
    kernel trusts them.  Returns `pool`."""
    plan = (coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v)
    if _device_kind(pool) == "cpu":
        return video_recon.reconstruct_pictures(pool, table, *plan, geom)
    from . import _build

    dev = pool.device
    _check("pool", pool, torch.uint8, (pool.shape[0], geom.total_size), dev)
    n = table.shape[0] if table.dim() == 2 else 0
    _check_int32("table", table, (n, _TABLE_COLS), dev)
    if not 0 < n <= _MAX_STREAMS:
        raise ValueError(f"table: 1 to {_MAX_STREAMS} streams, got {n}")
    _check_plan(geom, dev, *plan, lead=(coeffs.shape[0],))
    _check_alignment("K1", {"pool": pool}, {"coeffs": coeffs}, nblocks,
                     intra_blk)
    lib = _build.load()
    with torch.cuda.device(dev):
        p = pool.data_ptr()
        code = lib.mt_reconstruct_pictures(
            p, p, p, p, table.data_ptr(), n, *_plan_ptrs(*plan),
            geom.mb_width, geom.mb_height, _stream(dev))
    reconstruct_picture.launches += 1    # K1's count
    _build.check(code, "reconstruct_pictures")
    return pool


def reconstruct_picture_multi(cur_flat, fwd_flat, bwd_flat, coeffs, nblocks,
                              intra_blk, src_sel, mv_h, mv_v,
                              geom: FrameGeometry,
                              pallas_idct: bool = True) -> torch.Tensor:
    """The bytes of `reconstruct_picture` through K3 (signature and
    semantics of `video_recon.reconstruct_picture_multi`): the residual
    from K2 (`pallas_idct=True`, as the reference's default) or from the
    plain IDCT (False, where the reference takes XLA's), then
    `reconstruct_planes`."""
    plan = (coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v)
    if _device_kind(cur_flat) == "cpu":
        return video_recon.reconstruct_picture_multi(
            cur_flat, fwd_flat, bwd_flat, *plan, geom,
            pallas_idct=pallas_idct)
    dev = cur_flat.device
    _check_frames(geom, dev, cur=cur_flat, fwd=fwd_flat, bwd=bwd_flat)
    _check_plan(geom, dev, *plan)
    blocks, counts = coeffs.view(-1, 64), nblocks.view(-1)
    res = idct_batch(blocks, counts) if pallas_idct \
        else video_recon.idct_batch(blocks, counts)
    return reconstruct_planes(cur_flat, fwd_flat, bwd_flat,
                              res.view(coeffs.shape), *plan[1:], geom)


def reconstruct_planes(cur_flat, fwd_flat, bwd_flat, res, nblocks,
                       intra_blk, src_sel, mv_h, mv_v,
                       geom: FrameGeometry) -> torch.Tensor:
    """K3's two plane launches (signature and semantics of
    `video_recon.reconstruct_planes`): one picture from its residual
    int32 [mb, 6, 64] into a new flat frame, the luma launch and the
    Cb|Cr launch, which also writes the pad bytes from cur.  fwd and bwd
    may be the same tensor; the output never aliases an input.  Both
    launches count in `reconstruct_picture_multi.launches`."""
    plan = (res, nblocks, intra_blk, src_sel, mv_h, mv_v)
    if _device_kind(cur_flat) == "cpu":
        return video_recon.reconstruct_planes(
            cur_flat, fwd_flat, bwd_flat, *plan, geom)
    from . import _build

    dev = cur_flat.device
    _check_frames(geom, dev, cur=cur_flat, fwd=fwd_flat, bwd=bwd_flat)
    _check_plan(geom, dev, *plan, blocks="res")
    out = torch.empty_like(cur_flat)
    _check_alignment("K3", {"cur": cur_flat, "fwd": fwd_flat,
                            "bwd": bwd_flat, "out": out},
                     {"res": res}, nblocks, intra_blk)
    lib = _build.load()
    with torch.cuda.device(dev):
        for chroma in (0, 1):
            code = lib.mt_reconstruct_plane(
                cur_flat.data_ptr(), fwd_flat.data_ptr(),
                bwd_flat.data_ptr(), res.data_ptr(), nblocks.data_ptr(),
                intra_blk.data_ptr(), src_sel.data_ptr(), mv_h.data_ptr(),
                mv_v.data_ptr(), out.data_ptr(), geom.mb_width,
                geom.mb_height, chroma, _stream(dev))
            reconstruct_picture_multi.launches += 1
            _build.check(code, "reconstruct_planes")
    return out


reconstruct_picture_multi.launches = 0


# K4's output forms, as csrc/synth.cu numbers them.
_SYNTH_FORMS = {"u": 0, "f32": 1, "s16": 2}
_DCT_FLOPS = 304        # dct32: 257 butterfly ops, 47 sign multiplies


@functools.lru_cache(maxsize=None)
def _synth_tables(device: torch.device) -> torch.Tensor:
    """K4's constants on `device`: float32 [1056], the butterfly's 31 then
    the D window's 1024, the very values of the plain version, and one
    zero, so that K4 copies them in whole 16-byte pieces."""
    return torch.from_numpy(np.concatenate(
        [filterbank._C, D_WINDOW, [0.0]]).astype(np.float32)).to(device)


def _check_synth(samples, state, name, shape, out):
    """Samples int32 [S, T, 2, 32] and the state [S, *shape] on one
    device; returns (S, T)."""
    if samples.dim() != 4:
        raise ValueError(f"samples: expected [S, T, 2, 32], got "
                         f"{tuple(samples.shape)}")
    _device_kind(samples)
    s_n, steps = samples.shape[:2]
    _check_int32("samples", samples, (s_n, steps, 2, 32), samples.device)
    _check(name, state, torch.float32, (s_n, *shape), samples.device)
    if out not in _SYNTH_FORMS:
        raise ValueError(f"out: one of {sorted(_SYNTH_FORMS)}, got {out!r}")
    if s_n > _MAX_STREAMS:
        raise ValueError(f"samples: at most {_MAX_STREAMS} streams, got "
                         f"{s_n}")
    return s_n, steps


def _plain_form(u: torch.Tensor, out: str) -> torch.Tensor:
    if out == "f32":
        return filterbank.finalize(u)
    return filterbank.s16_from_u(u) if out == "s16" else u


def _synth_outputs(samples, state, out: str):
    """New (output, state) tensors of a K4 call, uninitialized."""
    s_n, steps = samples.shape[:2]
    return (torch.empty((s_n, steps, 2, 32) if out == "u" else
                        (s_n, steps * 64),
                        dtype=torch.int16 if out == "s16" else torch.float32,
                        device=samples.device),
            torch.empty_like(state))


def _launch_synth(samples, hist, ring, v_pos: int, out: str):
    """One K4 launch into new tensors: (output, new hist or ring)."""
    from . import _build

    dev = samples.device
    s_n, steps = samples.shape[:2]
    _check_aligned("K4", "samples", samples, 16)
    if ring is None:
        _check_aligned("K4", "hist", hist, 16)
    else:
        _check_aligned("K4", "ring", ring, 16)
    pcm, state = _synth_outputs(samples, hist if ring is None else ring, out)
    if s_n == 0:
        return pcm, state
    lib = _build.load("synth")
    with torch.cuda.device(dev):
        code = lib.mt_synthesize(
            samples.data_ptr(), None if hist is None else hist.data_ptr(),
            None if ring is None else ring.data_ptr(), v_pos,
            _synth_tables(dev).data_ptr(), s_n, steps, _SYNTH_FORMS[out],
            pcm.data_ptr(), state.data_ptr(), _stream(dev))
    synthesize.launches += 1
    _build.check(code, "synthesize", "synth")
    return pcm, state


def synthesize(samples: torch.Tensor, hist: torch.Tensor, out: str = "u"):
    """K4 over S streams' windows (`make_synthesize_parallel_jax` over a
    stream axis, as the JAX package vmaps it, with the S16 form and the
    finalize).

    samples: int32 [S, T, 2, 32], T a multiple of 16 with the V write
    position 0 on entry (4n whole frames); hist: float32 [S, 15, 2, 64],
    each stream's previous 15 DCT blocks, newest first, on the same
    device.  out: "u", the window outputs float32 [S, T, 2, 32]; "f32",
    `filterbank.finalize` of them, [S, T * 64]; "s16",
    `filterbank.s16_from_u`, int16 [S, T * 64].  Returns (output,
    hist'); hist is not written."""
    s_n, steps = _check_synth(samples, hist, "hist", (15, 2, 64), out)
    if steps == 0 or steps % 16:
        raise ValueError(f"{steps} steps: a window covers 4n whole frames")
    if _device_kind(samples) == "cuda":
        return _launch_synth(samples, hist, None, 0, out)
    if s_n == 0:
        return _synth_outputs(samples, hist, out)
    per = [filterbank.synthesize_window(x, h) for x, h in zip(samples, hist)]
    return (_plain_form(torch.stack([u for u, _ in per]), out),
            torch.stack([h for _, h in per]))


synthesize.launches = 0


def synthesize_ring(samples: torch.Tensor, ring: torch.Tensor, v_pos: int,
                    out: str = "f32"):
    """K4 from V rings (`make_synthesize_frame_jax`, over a stream axis).

    samples: int32 [S, T, 2, 32] with T >= 16 (36 a frame; fewer steps
    are refused on every device: the new ring must hold only this call's
    blocks); ring: float32 [S, 2, 1024] on the same device, whose last
    write position is v_pos, a multiple of 64.  out as in `synthesize`.
    Returns (output, ring', v_pos'); ring is not written.  Counts in
    `synthesize.launches`."""
    s_n, steps = _check_synth(samples, ring, "ring", (2, 1024), out)
    filterbank._check_v_pos(v_pos)
    if steps < 16:
        raise ValueError(f"{steps} steps: the ring form takes at least 16")
    new_pos = (v_pos - 64 * steps) & 1023
    if _device_kind(samples) == "cuda":
        return _launch_synth(samples, None, ring, v_pos, out) + (new_pos,)
    if s_n == 0:
        return _synth_outputs(samples, ring, out) + (new_pos,)
    per = [filterbank.synthesize_frame(x, v, v_pos)
           for x, v in zip(samples, ring)]
    return (_plain_form(torch.stack([u for u, _, _ in per]), out),
            torch.stack([v for _, v, _ in per]), new_pos)


def synth_bound(s_n: int, steps: int, out: str = "u",
                ring: bool = False) -> dict:
    """The least work of one K4 call over S streams of T steps, each input
    byte read once and each output byte written once: the samples (256 B
    a step) and the 15 previous DCT blocks (7,680 B a stream, from the
    ring or the hist) in; the output (256 B a step, 128 as s16) and the
    new state (a ring of 8 KiB or a hist of 7,680 B a stream) out.  The
    butterfly and window constants are not counted: the JAX programs
    carry them in the program.  Operations: a DCT (304 float ops) and 32
    16-tap MACs (1,024) a step and channel, and one divide or multiply an
    output sample.  Returns {"bytes", "flops", "us", "bound_by"}: "us" the
    larger of bytes over `HBM_BYTES_PER_S` and operations over
    `F32_FLOPS_PER_S`."""
    hist = 15 * 2 * 64 * 4
    nbytes = s_n * (steps * (256 + (128 if out == "s16" else 256))
                    + hist + (2 * 1024 * 4 if ring else hist))
    flops = s_n * steps * (2 * (_DCT_FLOPS + 32 * 32)
                           + (0 if out == "u" else 64))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    by_ops = flops / F32_FLOPS_PER_S * 1e6
    return {"bytes": nbytes, "flops": flops, "us": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


# parallel/batch.py unpack_blob_meta's tensors: (name, trailing shape).
_META_SHAPES = (("nblocks", (6,)), ("intra_blk", (6,)), ("src_sel", ()),
                ("mv_h", ()), ("mv_v", ()))
_META_PICTURE = ("is_ref", "is_noop")
_DENSIFY_FIELDS = ("flags", "mv_h", "mv_v", "nbcls", "mbmisc", "esc_didx",
                   "esc_val")


def _blob_rows(name, t, dev):
    """A blob part as [S, bytes] rows: uint8 on `dev`, each row contiguous
    and 4-byte aligned; returns (rows, row stride in bytes)."""
    if t.dtype != torch.uint8 or t.dim() not in (1, 2) or t.device != dev:
        raise ValueError(f"{name}: expected uint8 [bytes] or [S, bytes] on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    rows = t if t.dim() == 2 else t[None]
    if rows.shape[1] and rows.stride(1) != 1:
        raise ValueError(f"{name}: each row must be contiguous")
    stride = rows.stride(0) if rows.shape[0] > 1 else 0
    if stride % 4:
        raise ValueError(f"{name}: K5 needs rows 4-byte apart (row stride "
                         f"{stride})")
    _check_aligned("K5", name, rows, 4)
    return rows, stride


# K5's launches a call (csrc/densify.cu: A, the tile sums; B, the rows;
# C, the assembly), whatever the call's shape.
DENSIFY_LAUNCHES = 3


def densify_unpack(meta_esc: torch.Tensor, main_rec: torch.Tensor,
                   geom: FrameGeometry, window: int, offs: dict,
                   premult: torch.Tensor, nb_class_rep: torch.Tensor):
    """K5 over S streams' window blobs on the card (the function of
    `parallel.batch.densify_split` + `unpack_blob_meta` a stream).

    meta_esc: uint8 [split] (one blob's fixed prefix) or [S, split] (S
    prefixes, rows 4-byte apart, e.g. a view of a [S, bytes] stack);
    main_rec: uint8 [4 kt] or [S, 4 kt], each stream's main records (any
    bucketed prefix of its lane); `offs` the blob's `blob_layout` offsets;
    premult int32 [64] and nb_class_rep int32 [4] on the same device.
    Each stream's chains start at 0.  Returns (coeffs int32 [S * window,
    mb, 6, 64], meta): meta as `unpack_blob_meta` gives it, with S *
    window pictures, stream s's at [s * window, (s + 1) * window).  Only
    coded blocks (nblocks > 0) of coeffs are written.  `DENSIFY_LAUNCHES`
    launches; `densify_unpack.launches` adds the number that the library
    says it enqueued."""
    from . import _build

    dev = meta_esc.device
    if dev.type != "cuda":
        raise ValueError(f"K5 takes CUDA tensors, got {dev} (the plain "
                         f"version is parallel.batch.densify_unpack's)")
    lib = _build.load("densify")
    launched = ctypes.c_int(0)
    code, coeffs, meta = _densify_call(
        lambda args, stream: lib.mt_densify_unpack(args, stream,
                                                   ctypes.byref(launched)),
        lib.mt_densify_scratch_words, meta_esc, main_rec, geom, window,
        offs, premult, nb_class_rep)
    densify_unpack.launches += launched.value
    _build.check(code, "densify_unpack", "densify")
    return coeffs, meta


def _densify_call(unpack, scratch_words, meta_esc, main_rec, geom, window,
                  offs, premult, nb_class_rep):
    """`densify_unpack`'s checks, outputs and one call `unpack(args,
    stream)` of a densify.cu library's `mt_densify_unpack` (this one, or an
    earlier copy timed against it), its scratch `scratch_words(S, window,
    mb, kt, ke)` int32; returns (error code, coeffs, meta)."""
    from . import _build

    dev = meta_esc.device
    metas, meta_stride = _blob_rows("meta_esc", meta_esc, dev)
    mains, main_stride = _blob_rows("main_rec", main_rec, dev)
    s_n, mb = metas.shape[0], geom.mb_size
    if mains.shape[0] != s_n or main_rec.dim() != meta_esc.dim():
        raise ValueError(f"meta_esc {tuple(meta_esc.shape)} and main_rec "
                         f"{tuple(main_rec.shape)} hold different streams")
    if not 0 < s_n <= _MAX_STREAMS:
        raise ValueError(f"1 to {_MAX_STREAMS} streams, got {s_n}")
    if metas.shape[1] != offs["main_rec"][0]:
        raise ValueError(f"meta_esc: rows of {offs['main_rec'][0]} bytes "
                         f"(the blob's prefix), got {metas.shape[1]}")
    if mains.shape[1] % 4:
        raise ValueError(f"main_rec: whole 4-byte records, got "
                         f"{mains.shape[1]} bytes")
    n = window * mb * 6 * 64
    if n >= 2 ** 31:
        raise ValueError(f"window dense span {n} overflows int32")
    _check_int32("premult", premult, (64,), dev)
    _check_int32("nb_class_rep", nb_class_rep, (4,), dev)
    pics = s_n * window
    coeffs = torch.empty((pics, mb, 6, 64), dtype=torch.int32, device=dev)
    meta = {name: torch.empty((pics, mb, *shape), dtype=torch.int32,
                              device=dev) for name, shape in _META_SHAPES}
    meta.update({name: torch.empty(pics, dtype=torch.int32, device=dev)
                 for name in _META_PICTURE})
    kt, ke = mains.shape[1] // 4, offs["esc_val"][1] // 4
    scratch = torch.empty(max(scratch_words(s_n, window, mb, kt, ke), 1),
                          dtype=torch.int32, device=dev)
    args = _build.DensifyArgs(
        meta=metas.data_ptr(), main=mains.data_ptr(),
        meta_stride=meta_stride, main_stride=main_stride,
        premult=premult.data_ptr(), nb_class_rep=nb_class_rep.data_ptr(),
        coeffs=coeffs.data_ptr(), scratch=scratch.data_ptr(), streams=s_n,
        window=window, mb=mb, kt=kt, ke=ke,
        **{name: t.data_ptr() for name, t in meta.items()},
        **{f"off_{name}": offs[name][0] for name in _DENSIFY_FIELDS})
    with torch.cuda.device(dev):
        code = unpack(args, _stream(dev))
    return code, coeffs, meta


densify_unpack.launches = 0


def densify_bound(nblocks: torch.Tensor, records: int, escapes: int) -> dict:
    """The least device-memory traffic of one K5 call, each input byte
    read once and each output byte written once: `records` main records
    (4 B each) and `escapes` escape records (6 B: a uint16 delta and an
    int32 value) read over all streams; the blob's metadata read (4 B of
    flags a picture; mv_h, mv_v, nbcls and mbmisc, 7 B a macroblock); the
    unpacked metadata written (8 B a picture: is_ref, is_noop; 60 B a
    macroblock: nblocks, intra_blk, src_sel, mv_h, mv_v); and 256 B of
    coefficients a coded block (nblocks > 0), which K5 writes once.
    `nblocks` is the call's int32 [P, mb, 6] over all its
    pictures.  A few integer operations a byte: bytes bound it.  Returns
    {"bytes", "us"}, "us" the bytes over `HBM_BYTES_PER_S`."""
    pictures, mb = nblocks.shape[0], nblocks.shape[1]
    nbytes = (4 * records + 6 * escapes + pictures * (4 + 8)
              + pictures * mb * (7 + 60) + 256 * int((nblocks > 0).sum()))
    return {"bytes": nbytes, "us": nbytes / HBM_BYTES_PER_S * 1e6}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    densify_unpack.launches = 0
    idct_batch.launches = 0
    reconstruct_picture.launches = 0
    reconstruct_picture_multi.launches = 0
    synthesize.launches = 0
