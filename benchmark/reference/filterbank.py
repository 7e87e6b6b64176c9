"""MP2 synthesis filterbank: 32-band matrixing DCT + 512-tap D-window MAC.

This is the device half of the audio decoder.  The host parser emits the
dequantized subband samples as an int32 array of shape [36, 2, 32]
(36 sequential sub-block steps per MP2 frame x 2 channels x 32 subbands);
this module turns them into 1152 stereo PCM samples.

Numeric contract: bit-exact float32 against the reference's scalar Go code
(/root/reference/audio.go:377-424,492-772) in the no-FMA regime — every
multiply and add below is a separate f32 op in the same order as the
reference's statement sequence, vectorized over channels/streams (safe:
elementwise op order per sample is unchanged).

`dct32` is the reference's fully unrolled `idct36` butterfly
(audio.go:492-772) expressed once over an array namespace, so the numpy
oracle and the JAX/TPU path share one transcription.
"""

from __future__ import annotations

import numpy as np

# The 32->64 matrixing butterfly constants, f32-rounded exactly as Go rounds
# its untyped float constants.
_C = [np.float32(c) for c in (
    0.500602998235, 0.505470959898, 0.515447309923, 0.53104259109,
    0.553103896034, 0.582934968206, 0.622504123036, 0.674808341455,
    0.744536271002, 0.839349645416, 0.972568237862, 1.16943993343,
    1.48416461631, 2.05778100995, 3.40760841847, 10.1900081235,
    0.502419286188, 0.52249861494, 0.566944034816, 0.64682178336,
    0.788154623451, 1.06067768599, 1.72244709824, 5.10114861869,
    0.509795579104, 0.601344886935, 0.899976223136, 2.56291544774,
    0.541196100146, 1.30656296488, 0.707106781187,
)]

# Output normalization divisor (audio.go:390).
OUT_SCALE = np.float32(-1090519040.0)


def dct32(x, xp, mul=None):
    """Matrixing DCT: subband samples -> one 64-float V-buffer block.

    x: int (..., 32) array; returns float32 (..., 64) laid out exactly as the
    reference writes d[dp+0..dp+63].  `xp` is numpy or jax.numpy.

    `mul` is the multiply hook (default plain `a * c`), kept so callers can
    instrument or guard the products.

    Bit-exactness caveat: TPU compiles this to separate VPU mul/add ops
    (verified exact on v5e); XLA:CPU's LLVM backend contracts mul+add chains
    into FMAs on FMA-capable hosts, breaking no-FMA parity — run CPU with
    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 (see utils/bitexact.py) when the
    golden contract matters there.
    """
    f32 = np.float32
    s = [x[..., i] for i in range(32)]

    if mul is None:
        def mul(a, c):
            return a * c

    def f(a):
        return xp.asarray(a).astype(f32)

    t01 = f(s[0] + s[31])
    t02 = mul(f(s[0] - s[31]), _C[0])
    t03 = f(s[1] + s[30])
    t04 = mul(f(s[1] - s[30]), _C[1])
    t05 = f(s[2] + s[29])
    t06 = mul(f(s[2] - s[29]), _C[2])
    t07 = f(s[3] + s[28])
    t08 = mul(f(s[3] - s[28]), _C[3])
    t09 = f(s[4] + s[27])
    t10 = mul(f(s[4] - s[27]), _C[4])
    t11 = f(s[5] + s[26])
    t12 = mul(f(s[5] - s[26]), _C[5])
    t13 = f(s[6] + s[25])
    t14 = mul(f(s[6] - s[25]), _C[6])
    t15 = f(s[7] + s[24])
    t16 = mul(f(s[7] - s[24]), _C[7])
    t17 = f(s[8] + s[23])
    t18 = mul(f(s[8] - s[23]), _C[8])
    t19 = f(s[9] + s[22])
    t20 = mul(f(s[9] - s[22]), _C[9])
    t21 = f(s[10] + s[21])
    t22 = mul(f(s[10] - s[21]), _C[10])
    t23 = f(s[11] + s[20])
    t24 = mul(f(s[11] - s[20]), _C[11])
    t25 = f(s[12] + s[19])
    t26 = mul(f(s[12] - s[19]), _C[12])
    t27 = f(s[13] + s[18])
    t28 = mul(f(s[13] - s[18]), _C[13])
    t29 = f(s[14] + s[17])
    t30 = mul(f(s[14] - s[17]), _C[14])
    t31 = f(s[15] + s[16])
    t32 = mul(f(s[15] - s[16]), _C[15])

    t33 = t01 + t31
    t31 = mul((t01 - t31), _C[16])
    t01 = t03 + t29
    t29 = mul((t03 - t29), _C[17])
    t03 = t05 + t27
    t27 = mul((t05 - t27), _C[18])
    t05 = t07 + t25
    t25 = mul((t07 - t25), _C[19])
    t07 = t09 + t23
    t23 = mul((t09 - t23), _C[20])
    t09 = t11 + t21
    t21 = mul((t11 - t21), _C[21])
    t11 = t13 + t19
    t19 = mul((t13 - t19), _C[22])
    t13 = t15 + t17
    t17 = mul((t15 - t17), _C[23])
    t15 = t33 + t13
    t13 = mul((t33 - t13), _C[24])
    t33 = t01 + t11
    t01 = mul((t01 - t11), _C[25])
    t11 = t03 + t09
    t09 = mul((t03 - t09), _C[26])
    t03 = t05 + t07
    t07 = mul((t05 - t07), _C[27])
    t05 = t15 + t03
    t15 = mul((t15 - t03), _C[28])
    t03 = t33 + t11
    t11 = mul((t33 - t11), _C[29])
    t33 = t05 + t03
    t05 = mul((t05 - t03), _C[30])
    t03 = t15 + t11
    t15 = mul((t15 - t11), _C[30])
    t03 = t03 + t15
    t11 = t13 + t07
    t13 = mul((t13 - t07), _C[28])
    t07 = t01 + t09
    t09 = mul((t01 - t09), _C[29])
    t01 = t11 + t07
    t07 = mul((t11 - t07), _C[30])
    t11 = t13 + t09
    t13 = mul((t13 - t09), _C[30])
    t11 = t11 + t13
    t01 = t01 + t11
    t11 = t11 + t07
    t07 = t07 + t13
    t09 = t31 + t17
    t31 = mul((t31 - t17), _C[24])
    t17 = t29 + t19
    t29 = mul((t29 - t19), _C[25])
    t19 = t27 + t21
    t21 = mul((t27 - t21), _C[26])
    t27 = t25 + t23
    t23 = mul((t25 - t23), _C[27])
    t25 = t09 + t27
    t09 = mul((t09 - t27), _C[28])
    t27 = t17 + t19
    t19 = mul((t17 - t19), _C[29])
    t17 = t25 + t27
    t27 = mul((t25 - t27), _C[30])
    t25 = t09 + t19
    t19 = mul((t09 - t19), _C[30])
    t25 = t25 + t19
    t09 = t31 + t23
    t31 = mul((t31 - t23), _C[28])
    t23 = t29 + t21
    t21 = mul((t29 - t21), _C[29])
    t29 = t09 + t23
    t23 = mul((t09 - t23), _C[30])
    t09 = t31 + t21
    t31 = mul((t31 - t21), _C[30])
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
    t02 = mul((t02 - t32), _C[16])
    t32 = t04 + t30
    t04 = mul((t04 - t30), _C[17])
    t30 = t06 + t28
    t28 = mul((t06 - t28), _C[18])
    t06 = t08 + t26
    t08 = mul((t08 - t26), _C[19])
    t26 = t10 + t24
    t10 = mul((t10 - t24), _C[20])
    t24 = t12 + t22
    t22 = mul((t12 - t22), _C[21])
    t12 = t14 + t20
    t20 = mul((t14 - t20), _C[22])
    t14 = t16 + t18
    t16 = mul((t16 - t18), _C[23])
    t18 = t21 + t14
    t14 = mul((t21 - t14), _C[24])
    t21 = t32 + t12
    t32 = mul((t32 - t12), _C[25])
    t12 = t30 + t24
    t24 = mul((t30 - t24), _C[26])
    t30 = t06 + t26
    t26 = mul((t06 - t26), _C[27])
    t06 = t18 + t30
    t18 = mul((t18 - t30), _C[28])
    t30 = t21 + t12
    t12 = mul((t21 - t12), _C[29])
    t21 = t06 + t30
    t30 = mul((t06 - t30), _C[30])
    t06 = t18 + t12
    t12 = mul((t18 - t12), _C[30])
    t06 = t06 + t12
    t18 = t14 + t26
    t26 = mul((t14 - t26), _C[28])
    t14 = t32 + t24
    t24 = mul((t32 - t24), _C[29])
    t32 = t18 + t14
    t14 = mul((t18 - t14), _C[30])
    t18 = t26 + t24
    t24 = mul((t26 - t24), _C[30])
    t18 = t18 + t24
    t32 = t32 + t18
    t18 = t18 + t14
    t26 = t14 + t24
    t14 = t02 + t16
    t02 = mul((t02 - t16), _C[24])
    t16 = t04 + t20
    t04 = mul((t04 - t20), _C[25])
    t20 = t28 + t22
    t22 = mul((t28 - t22), _C[26])
    t28 = t08 + t10
    t10 = mul((t08 - t10), _C[27])
    t08 = t14 + t28
    t14 = mul((t14 - t28), _C[28])
    t28 = t16 + t20
    t20 = mul((t16 - t20), _C[29])
    t16 = t08 + t28
    t28 = mul((t08 - t28), _C[30])
    t08 = t14 + t20
    t20 = mul((t14 - t20), _C[30])
    t08 = t08 + t20
    t14 = t02 + t10
    t02 = mul((t02 - t10), _C[28])
    t10 = t04 + t22
    t22 = mul((t04 - t22), _C[29])
    t04 = t14 + t10
    t10 = mul((t14 - t10), _C[30])
    t14 = t02 + t22
    t02 = mul((t02 - t22), _C[30])
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

    zero = xp.zeros_like(t01)
    # V-buffer block layout (audio.go:708-772): d[dp+j] for j = 0..63.
    out = [
        t05, t30, t27, t28, t07, t26, t23, t10,
        t15, t12, t19, t20, t13, t24, t31, t02,
        zero,
        -t02, -t31, -t24, -t13, -t20, -t19, -t12, -t15,
        -t10, -t23, -t26, -t07, -t28, -t27, -t30, -t05,
        -t14, -t09, -t18, -t11, -t08, -t25, -t06, -t03,
        -t04, -t29, -t32, -t01, -t16, -t17, -t21, -t33,
        -t21, -t17, -t16, -t01, -t32, -t29, -t04, -t03,
        -t06, -t25, -t08, -t11, -t18, -t09, -t14,
    ]
    return xp.stack(out, axis=-1)


def window_offsets(v_pos: int):
    """The 16 (d_index, v_index) block starts for one windowed MAC.

    Derived from the two-pass loop structure of the reference synthWindow
    (/root/reference/audio_noasm.go:8-38); the accumulation order of the 16
    32-float tap blocks is part of the numeric contract.
    """
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


# --------------------------------------------------------------------------
# numpy oracle
# --------------------------------------------------------------------------

def synthesize_frame_np(samples: np.ndarray, v: np.ndarray, v_pos: int):
    """Scalar-oracle synthesis of one MP2 frame.

    samples: int32 [36, 2, 32]; v: float32 [2, 1024] ring state (mutated);
    returns (u float32 [36, 2, 32] — unnormalized window outputs, v, v_pos).
    """
    d = _d_window_np()
    out = np.empty((36, 2, 32), np.float32)
    for t in range(36):
        v_pos = (v_pos - 64) & 1023
        for ch in range(2):
            block = dct32(samples[t, ch].astype(np.int64), np)
            v[ch, v_pos:v_pos + 64] = block
            u = np.zeros(32, np.float32)
            for d_index, v_index in window_offsets(v_pos):
                u = u + d[d_index:d_index + 32] * v[ch, v_index:v_index + 32]
            out[t, ch] = u
    return out, v, v_pos


def finalize_np(u: np.ndarray) -> np.ndarray:
    """Normalize and interleave window outputs: [.., 36, 2, 32] -> [.., 2304].

    Runs on host: TPU lowers f32 division to a reciprocal approximation
    (observed 1-ulp deviations), while the golden contract needs the exact
    IEEE quotient of audio.go:390.
    """
    shape = u.shape[:-3] + (-1,)
    return np.swapaxes(u / OUT_SCALE, -1, -2).reshape(shape)


_D_NP = None


def _d_window_np():
    global _D_NP
    if _D_NP is None:
        from .tables import D_WINDOW
        _D_NP = D_WINDOW
    return _D_NP


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 value (round to nearest even), as
    float32: the benchmark's lower-precision control."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)
