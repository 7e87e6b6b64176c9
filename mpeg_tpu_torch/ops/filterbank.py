"""MP2 synthesis filterbank in torch: 32-band matrixing DCT + 512-tap
D-window MAC.

Port of `mpeg_tpu/ops/filterbank.py`.  The host parser emits the
dequantized subband samples as int32 [36, 2, 32] per MP2 frame (36
sub-block steps x 2 channels x 32 subbands); this module turns them into
1152 stereo PCM samples, on whatever device its inputs are on.  It is
the plain version of K4 (`csrc/synth.cu`, through
`cuda_kernels.synthesize` and `synthesize_ring`): the decoders call those
wrappers, which run this module for CPU tensors only; on the card it is
what K4 is held against.

Numeric contract: bit-exact float32 against the reference's scalar Go
code (audio.go:377-424,492-772) in the no-FMA regime.  Every multiply and
add below is its own eager torch op, so it rounds on its own, on the CPU
and on CUDA alike, in the reference's statement order (vectorized over
steps, channels and taps: each output element sees the same op
sequence).  Hence:

- no `torch.compile`, no `addcmul`, `matmul`, `einsum`, `bmm` or
  `baddbmm` anywhere here: each may fuse or reorder the products;
- the constants are float32 tensors on the input's device, never Python
  floats, and the divisor of `finalize` is a device tensor: CUDA torch
  turns a division by a CPU scalar into a multiply by its reciprocal,
  which is not the IEEE quotient;
- the windowed MAC adds its 16 products one at a time in
  `window_offsets` order, starting from +0.0.

The per-frame synthesis (`synthesize_frame`, the counterpart of
`make_synthesize_frame_jax`) and the window synthesis
(`synthesize_window`, of `make_synthesize_parallel_jax`) are one
formulation: all DCTs of the frame or window at once, then each step's
16 taps gathered from the 15 blocks before it and the new ones.  The taps
and their order depend on the step's V write position, which cycles with
period 16 (`_residue_taps`); the JAX parallel form fixes the position at
0 on entry, this one takes any multiple of 64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import D_WINDOW

__all__ = ["OUT_SCALE", "dct32", "div_out_scale_exact", "finalize",
           "hist_from_v", "s16_from_u", "synthesize_frame",
           "synthesize_window", "synthesize_window_s16", "v_from_hist",
           "window_offsets"]

# The 32->64 matrixing butterfly constants, f32-rounded exactly as Go
# rounds its untyped float constants.
_C = np.array([
    0.500602998235, 0.505470959898, 0.515447309923, 0.53104259109,
    0.553103896034, 0.582934968206, 0.622504123036, 0.674808341455,
    0.744536271002, 0.839349645416, 0.972568237862, 1.16943993343,
    1.48416461631, 2.05778100995, 3.40760841847, 10.1900081235,
    0.502419286188, 0.52249861494, 0.566944034816, 0.64682178336,
    0.788154623451, 1.06067768599, 1.72244709824, 5.10114861869,
    0.509795579104, 0.601344886935, 0.899976223136, 2.56291544774,
    0.541196100146, 1.30656296488, 0.707106781187,
], np.float32)

# Output normalization divisor (audio.go:390); -(65 << 24).
OUT_SCALE = np.float32(-1090519040.0)
assert int(-OUT_SCALE) == 65 << 24

# Sign of each V-block entry of the DCT output (audio.go:708-772): entry
# 16 is the zero, 17-63 the negated values.  Multiplying by -1.0 is exact.
_V_SIGN = np.array([1.0] * 17 + [-1.0] * 47, np.float32)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device) -> dict:
    """The float32 constants as tensors on `device`."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return {"c": t(_C), "sign": t(_V_SIGN), "out_scale": t(OUT_SCALE),
            "s16": t([0x8000, 0x7FFF])}


def dct32(x: torch.Tensor) -> torch.Tensor:
    """Matrixing DCT: subband samples -> one 64-float V-buffer block.

    x: int32 (..., 32); returns float32 (..., 64) laid out exactly as the
    reference writes d[dp+0..dp+63] (the reference's fully unrolled
    `idct36` butterfly, audio.go:492-772, statement for statement)."""
    c = _constants(x.device)["c"]
    s = x.unbind(-1)

    def f(a):
        return a.to(torch.float32)

    def mul(a, i):
        return a * c[i]

    t01 = f(s[0] + s[31])
    t02 = mul(f(s[0] - s[31]), 0)
    t03 = f(s[1] + s[30])
    t04 = mul(f(s[1] - s[30]), 1)
    t05 = f(s[2] + s[29])
    t06 = mul(f(s[2] - s[29]), 2)
    t07 = f(s[3] + s[28])
    t08 = mul(f(s[3] - s[28]), 3)
    t09 = f(s[4] + s[27])
    t10 = mul(f(s[4] - s[27]), 4)
    t11 = f(s[5] + s[26])
    t12 = mul(f(s[5] - s[26]), 5)
    t13 = f(s[6] + s[25])
    t14 = mul(f(s[6] - s[25]), 6)
    t15 = f(s[7] + s[24])
    t16 = mul(f(s[7] - s[24]), 7)
    t17 = f(s[8] + s[23])
    t18 = mul(f(s[8] - s[23]), 8)
    t19 = f(s[9] + s[22])
    t20 = mul(f(s[9] - s[22]), 9)
    t21 = f(s[10] + s[21])
    t22 = mul(f(s[10] - s[21]), 10)
    t23 = f(s[11] + s[20])
    t24 = mul(f(s[11] - s[20]), 11)
    t25 = f(s[12] + s[19])
    t26 = mul(f(s[12] - s[19]), 12)
    t27 = f(s[13] + s[18])
    t28 = mul(f(s[13] - s[18]), 13)
    t29 = f(s[14] + s[17])
    t30 = mul(f(s[14] - s[17]), 14)
    t31 = f(s[15] + s[16])
    t32 = mul(f(s[15] - s[16]), 15)

    t33 = t01 + t31
    t31 = mul((t01 - t31), 16)
    t01 = t03 + t29
    t29 = mul((t03 - t29), 17)
    t03 = t05 + t27
    t27 = mul((t05 - t27), 18)
    t05 = t07 + t25
    t25 = mul((t07 - t25), 19)
    t07 = t09 + t23
    t23 = mul((t09 - t23), 20)
    t09 = t11 + t21
    t21 = mul((t11 - t21), 21)
    t11 = t13 + t19
    t19 = mul((t13 - t19), 22)
    t13 = t15 + t17
    t17 = mul((t15 - t17), 23)
    t15 = t33 + t13
    t13 = mul((t33 - t13), 24)
    t33 = t01 + t11
    t01 = mul((t01 - t11), 25)
    t11 = t03 + t09
    t09 = mul((t03 - t09), 26)
    t03 = t05 + t07
    t07 = mul((t05 - t07), 27)
    t05 = t15 + t03
    t15 = mul((t15 - t03), 28)
    t03 = t33 + t11
    t11 = mul((t33 - t11), 29)
    t33 = t05 + t03
    t05 = mul((t05 - t03), 30)
    t03 = t15 + t11
    t15 = mul((t15 - t11), 30)
    t03 = t03 + t15
    t11 = t13 + t07
    t13 = mul((t13 - t07), 28)
    t07 = t01 + t09
    t09 = mul((t01 - t09), 29)
    t01 = t11 + t07
    t07 = mul((t11 - t07), 30)
    t11 = t13 + t09
    t13 = mul((t13 - t09), 30)
    t11 = t11 + t13
    t01 = t01 + t11
    t11 = t11 + t07
    t07 = t07 + t13
    t09 = t31 + t17
    t31 = mul((t31 - t17), 24)
    t17 = t29 + t19
    t29 = mul((t29 - t19), 25)
    t19 = t27 + t21
    t21 = mul((t27 - t21), 26)
    t27 = t25 + t23
    t23 = mul((t25 - t23), 27)
    t25 = t09 + t27
    t09 = mul((t09 - t27), 28)
    t27 = t17 + t19
    t19 = mul((t17 - t19), 29)
    t17 = t25 + t27
    t27 = mul((t25 - t27), 30)
    t25 = t09 + t19
    t19 = mul((t09 - t19), 30)
    t25 = t25 + t19
    t09 = t31 + t23
    t31 = mul((t31 - t23), 28)
    t23 = t29 + t21
    t21 = mul((t29 - t21), 29)
    t29 = t09 + t23
    t23 = mul((t09 - t23), 30)
    t09 = t31 + t21
    t31 = mul((t31 - t21), 30)
    t09 = t09 + t31
    t29 = t29 + t09
    t09 = t09 + t23
    t23 = t23 + t31
    t17 = t17 + t29
    t29 = t29 + t25
    t25 = t25 + t09
    t09 = t09 + t27
    t27 = t27 + t23
    t23 = t23 + t19
    t19 = t19 + t31
    t21 = t02 + t32
    t02 = mul((t02 - t32), 16)
    t32 = t04 + t30
    t04 = mul((t04 - t30), 17)
    t30 = t06 + t28
    t28 = mul((t06 - t28), 18)
    t06 = t08 + t26
    t08 = mul((t08 - t26), 19)
    t26 = t10 + t24
    t10 = mul((t10 - t24), 20)
    t24 = t12 + t22
    t22 = mul((t12 - t22), 21)
    t12 = t14 + t20
    t20 = mul((t14 - t20), 22)
    t14 = t16 + t18
    t16 = mul((t16 - t18), 23)
    t18 = t21 + t14
    t14 = mul((t21 - t14), 24)
    t21 = t32 + t12
    t32 = mul((t32 - t12), 25)
    t12 = t30 + t24
    t24 = mul((t30 - t24), 26)
    t30 = t06 + t26
    t26 = mul((t06 - t26), 27)
    t06 = t18 + t30
    t18 = mul((t18 - t30), 28)
    t30 = t21 + t12
    t12 = mul((t21 - t12), 29)
    t21 = t06 + t30
    t30 = mul((t06 - t30), 30)
    t06 = t18 + t12
    t12 = mul((t18 - t12), 30)
    t06 = t06 + t12
    t18 = t14 + t26
    t26 = mul((t14 - t26), 28)
    t14 = t32 + t24
    t24 = mul((t32 - t24), 29)
    t32 = t18 + t14
    t14 = mul((t18 - t14), 30)
    t18 = t26 + t24
    t24 = mul((t26 - t24), 30)
    t18 = t18 + t24
    t32 = t32 + t18
    t18 = t18 + t14
    t26 = t14 + t24
    t14 = t02 + t16
    t02 = mul((t02 - t16), 24)
    t16 = t04 + t20
    t04 = mul((t04 - t20), 25)
    t20 = t28 + t22
    t22 = mul((t28 - t22), 26)
    t28 = t08 + t10
    t10 = mul((t08 - t10), 27)
    t08 = t14 + t28
    t14 = mul((t14 - t28), 28)
    t28 = t16 + t20
    t20 = mul((t16 - t20), 29)
    t16 = t08 + t28
    t28 = mul((t08 - t28), 30)
    t08 = t14 + t20
    t20 = mul((t14 - t20), 30)
    t08 = t08 + t20
    t14 = t02 + t10
    t02 = mul((t02 - t10), 28)
    t10 = t04 + t22
    t22 = mul((t04 - t22), 29)
    t04 = t14 + t10
    t10 = mul((t14 - t10), 30)
    t14 = t02 + t22
    t02 = mul((t02 - t22), 30)
    t14 = t14 + t02
    t04 = t04 + t14
    t14 = t14 + t10
    t10 = t10 + t02
    t16 = t16 + t04
    t04 = t04 + t08
    t08 = t08 + t14
    t14 = t14 + t28
    t28 = t28 + t10
    t10 = t10 + t20
    t20 = t20 + t02
    t21 = t21 + t16
    t16 = t16 + t32
    t32 = t32 + t04
    t04 = t04 + t06
    t06 = t06 + t08
    t08 = t08 + t18
    t18 = t18 + t14
    t14 = t14 + t30
    t30 = t30 + t28
    t28 = t28 + t26
    t26 = t26 + t10
    t10 = t10 + t12
    t12 = t12 + t20
    t20 = t20 + t24
    t24 = t24 + t02

    # V-buffer block layout (audio.go:708-772): d[dp+j] for j = 0..63,
    # entries 17-63 negated through _V_SIGN.
    out = [
        t05, t30, t27, t28, t07, t26, t23, t10,
        t15, t12, t19, t20, t13, t24, t31, t02,
        torch.zeros_like(t01),
        t02, t31, t24, t13, t20, t19, t12, t15,
        t10, t23, t26, t07, t28, t27, t30, t05,
        t14, t09, t18, t11, t08, t25, t06, t03,
        t04, t29, t32, t01, t16, t17, t21, t33,
        t21, t17, t16, t01, t32, t29, t04, t03,
        t06, t25, t08, t11, t18, t09, t14,
    ]
    return torch.stack(out, dim=-1) * _constants(x.device)["sign"]


def window_offsets(v_pos: int):
    """The 16 (d_index, v_index) block starts for one windowed MAC.

    Derived from the two-pass loop structure of the reference synthWindow
    (audio_noasm.go:8-38); the accumulation order of the 16 32-float tap
    blocks is part of the numeric contract."""
    offs = []
    d_index = 512 - (v_pos >> 1)
    v_index = (v_pos % 128) >> 1
    while v_index < 1024:
        offs.append((d_index, v_index))
        v_index += 128
        d_index += 64
    d_index -= 512 - 32
    v_index = (128 - 32 + 1024) - v_index
    while v_index < 1024:
        offs.append((d_index, v_index))
        v_index += 128
        d_index += 64
    return offs


def _residue_taps():
    """Tap tables per step residue m: the step that writes its DCT block
    at V position (-64 (m + 1)) & 1023 reads 16 (d_slice, blocks-ago j,
    offset-in-block) taps, in the reference's accumulation order.  The V
    position cycles with period 16, so these 16 lists cover every step."""
    taps = []
    for m in range(16):
        v_pos = (-64 * (m + 1)) & 1023
        lst = []
        for d_idx, v_idx in window_offsets(v_pos):
            j, off = divmod((v_idx - v_pos) % 1024, 64)
            assert off in (0, 32) and 0 <= j < 16
            lst.append((d_idx, j, off))
        taps.append(lst)
    return taps


@functools.lru_cache(maxsize=None)
def _tap_tables(phase: int, steps: int):
    """Gather tables of `steps` steps whose V write position on entry is
    64 * phase: idx int32 [16, steps, 2, 32], each tap's flat index into
    the [15 + steps, 2, 64] block sequence (the 15 blocks before the
    first step, oldest first, then one a step), and d float32
    [16, steps, 1, 32], each tap's D-window slice.  Step t writes at
    64 * (phase - t - 1) mod 1024, residue (t - phase) mod 16."""
    taps = _residue_taps()
    idx = np.empty((16, steps, 2, 32), np.int32)
    d = np.empty((16, steps, 1, 32), np.float32)
    lane = np.arange(32) + 64 * np.arange(2)[:, None]
    for t in range(steps):
        for k, (d_idx, j, off) in enumerate(taps[(t - phase) % 16]):
            idx[k, t] = 128 * (15 + t - j) + off + lane
            d[k, t, 0] = D_WINDOW[d_idx:d_idx + 32]
    return idx, d


@functools.lru_cache(maxsize=None)
def _device_tap_tables(phase: int, steps: int, device: torch.device):
    idx, d = _tap_tables(phase, steps)
    return (torch.from_numpy(idx).reshape(-1).to(device),
            torch.from_numpy(d).to(device))


def _windowed_mac(cat: torch.Tensor, phase: int) -> torch.Tensor:
    """Window outputs u float32 [steps, 2, 32] of the steps whose blocks
    are cat[15:] (cat: float32 [15 + steps, 2, 64], oldest first), the
    first step's V write position on entry being 64 * phase."""
    steps = cat.shape[0] - 15
    idx, d = _device_tap_tables(phase, steps, cat.device)
    taps = cat.reshape(-1).index_select(0, idx).view(16, steps, 2, 32)
    prods = d * taps                    # each product rounds on its own
    u = torch.zeros((steps, 2, 32), dtype=torch.float32, device=cat.device)
    for k in range(16):                 # the reference's tap order
        u = u + prods[k]
    return u


def hist_from_v(v: torch.Tensor, v_pos: int) -> torch.Tensor:
    """The last-15-blocks history [15, 2, 64] from a V ring [2, 1024]:
    hist[j-1] is the block at ring position (v_pos + 64*j) & 1023
    (j = 1..15).  v_pos is a multiple of 64."""
    _check_v_pos(v_pos)
    return v.reshape(-1, 16, 64).roll(-((v_pos >> 6) + 1), 1)[:, :15] \
        .transpose(0, 1)


def v_from_hist(blocks: torch.Tensor, v_pos: int) -> torch.Tensor:
    """Rebuild the V ring [2, 1024] from the last 16 blocks [16, 2, 64]
    (blocks[0] = newest, at v_pos, a multiple of 64)."""
    _check_v_pos(v_pos)
    return blocks.transpose(0, 1).roll(v_pos >> 6, 1) \
        .reshape(blocks.shape[1], 1024)


def _check_v_pos(v_pos: int) -> None:
    if v_pos % 64 or not 0 <= v_pos < 1024:
        raise ValueError(f"v_pos {v_pos}: expected a multiple of 64 in "
                         "[0, 1024)")


def synthesize_frame(samples: torch.Tensor, v: torch.Tensor, v_pos: int):
    """Synthesis of one MP2 frame (the counterpart of
    `make_synthesize_frame_jax` and `synthesize_frame_np`).

    samples: int32 [steps, 2, 32] (36 a frame); v: float32 [2, 1024], the
    V ring on the same device; v_pos: the ring's last write position, a
    multiple of 64.  Returns (u float32 [steps, 2, 32], the unnormalized
    window outputs; the new ring; the new v_pos).  v is not written."""
    steps = samples.shape[0]
    blocks = dct32(samples)                               # [steps, 2, 64]
    # The 15 blocks before the first step, newest first: the newest sits
    # at v_pos, the next write position being v_pos - 64.
    hist = hist_from_v(v, (v_pos - 64) & 1023)
    cat = torch.cat([hist.flip(0), blocks])
    u = _windowed_mac(cat, v_pos >> 6)
    v_pos = (v_pos - 64 * steps) & 1023
    return u, v_from_hist(cat[-16:].flip(0), v_pos), v_pos


def synthesize_window(samples: torch.Tensor, hist: torch.Tensor):
    """Window synthesis (the counterpart of `make_synthesize_parallel_jax`).

    samples: int32 [T, 2, 32] with T a multiple of 16 and the V write
    position 0 on entry (true for windows of 4n whole frames: 36 steps a
    frame, 4 frames = 144 steps = 9 ring periods); hist: float32
    [15, 2, 64], the previous 15 DCT blocks, newest first.  Returns
    (u [T, 2, 32], hist')."""
    t_len = samples.shape[0]
    if t_len % 16:
        raise ValueError(f"{t_len} steps: a window covers 4n whole frames")
    blocks = dct32(samples)                               # [T, 2, 64]
    u = _windowed_mac(torch.cat([hist.flip(0), blocks]), 0)
    return u, blocks[-15:].flip(0)


def synthesize_window_s16(samples: torch.Tensor, hist: torch.Tensor):
    """The window synthesis with S16 quantization on its device
    (`make_synthesize_parallel_s16_jax`): (s16 int16 [T * 64], hist')."""
    u, hist = synthesize_window(samples, hist)
    return s16_from_u(u), hist


def _interleave(x: torch.Tensor) -> torch.Tensor:
    """[..., steps, 2, 32] -> [..., steps * 64], L/R interleaved."""
    return x.transpose(-1, -2).reshape(*x.shape[:-3], -1)


def finalize(u: torch.Tensor) -> torch.Tensor:
    """Normalize and interleave window outputs (`finalize_np`):
    [..., steps, 2, 32] -> [..., steps * 64], the IEEE f32 quotient
    u / OUT_SCALE (the divisor a tensor on u's device, see the module
    docstring)."""
    return _interleave(u / _constants(u.device)["out_scale"])


def div_out_scale_exact(u: torch.Tensor) -> torch.Tensor:
    """Bit-exact f32 `u / OUT_SCALE` via integer mantissa division.

    For normal results this reproduces the IEEE round-to-nearest-even
    quotient exactly (ties cannot occur: 65 is odd, so the true quotient
    is never halfway between representables).  Inputs whose quotient
    would be subnormal (|u| < 65 * 2^-103) flush to signed zero — callers
    quantizing to S16 never see the difference (|s| < 2^-15 truncates to
    0 either way).  All int32: M << 7 < 2^31."""
    bits = u.contiguous().view(torch.int32)
    su = (bits >> 31) & 1
    e = (bits >> 23) & 0xFF
    m = (bits & 0x7FFFFF) | 0x800000

    # M/65 in [2^16.98, 2^17.98): shift 6 when M/65 >= 2^17 else shift 7
    # puts the quotient in [2^23, 2^24) — a 24-bit mantissa.
    big = m >= (65 << 17)
    t = torch.where(big, m << 6, m << 7)
    q = t // 65
    r = t - q * 65
    mant = q + (r >= 33).to(torch.int32)   # round to nearest (no ties)
    e_out = e - 31 + big.to(torch.int32)   # E - 30 where big, else E - 31

    # (E_out << 23) + mant - 2^23 carries into the exponent when rounding
    # overflowed mant to 2^24 — exactly the renormalization.
    out_bits = (e_out << 23) + (mant - 0x800000)
    # OUT_SCALE < 0 flips the sign; zero/subnormal input or subnormal
    # result flushes to signed zero.
    sign = (1 - su) << 31
    out_bits = torch.where((e == 0) | (e_out <= 0), 0, out_bits) | sign
    return out_bits.to(torch.int32).view(torch.float32)


def s16_from_u(u: torch.Tensor) -> torch.Tensor:
    """Window outputs -> interleaved S16, exactly the reference's AudioS16
    lane (audio.go:401-407): s = u / -1090519040.0 (exact IEEE f32
    quotient), then trunc(s * 0x8000) when s < 0 else trunc(s * 0x7FFF),
    narrowed to int16 with wraparound (the host Samples.s16 semantics).
    u: (..., steps, 2, 32); returns (..., steps * 64) int16."""
    s = div_out_scale_exact(u)
    k = _constants(u.device)["s16"]
    scaled = torch.where(s < 0, s * k[0], s * k[1])
    # float -> int32 truncates toward zero; int32 -> int16 wraps.
    return _interleave(scaled.to(torch.int32).to(torch.int16))
