"""Constant tables for MPEG-1 video and MP2 audio decode.

All data here is ISO/IEC 11172 spec material (quantization matrices, scan
order, rate tables, Huffman codes, filterbank window).  Huffman tables are
stored canonically in `_spec_tables` as (codeword, length, value) triples and
compiled at import time into *flat lookup tables*: peek `maxlen` bits, one
list index, done — unlike the reference's 1-bit/step tree walk
(/root/reference/buffer.go:352-376), which is the wrong shape for a fast
host parser.

Reference parity notes cite /root/reference/<file>:<line>.
"""

from __future__ import annotations

import numpy as np

from . import _spec_tables as _spec

# --------------------------------------------------------------------------
# Video tables (ISO 11172-2; parity: /root/reference/video.go:1034-1086)
# --------------------------------------------------------------------------

# Picture rate code -> frames per second (table at video.go:1034-1037).
PICTURE_RATE = (
    0.000, 23.976, 24.000, 25.000, 29.970, 30.000, 50.000, 59.940,
    60.000, 0.000, 0.000, 0.000, 0.000, 0.000, 0.000, 0.000,
)

# Pel aspect ratio code -> ratio (table at video.go:1039-1042).
ASPECT_RATIO = (
    0.0000, 1.0000, 0.6735, 0.7031, 0.7615, 0.8055, 0.8437, 0.8935,
    0.9375, 0.9815, 1.0255, 1.0695, 1.1250, 1.1575, 1.2015, 0.0000,
)


def _zigzag() -> list[int]:
    """Zig-zag scan position -> raster index, derived from the scan walk."""
    out = []
    x = y = 0
    up = True
    for _ in range(64):
        out.append(y * 8 + x)
        if up:
            if x == 7:
                y += 1
                up = False
            elif y == 0:
                x += 1
                up = False
            else:
                x += 1
                y -= 1
        else:
            if y == 7:
                x += 1
                up = True
            elif x == 0:
                y += 1
                up = True
            else:
                x -= 1
                y += 1
    return out


# Scan position -> raster index (parity: video.go:1044-1053).
ZIG_ZAG = _zigzag()
assert ZIG_ZAG[:8] == [0, 1, 8, 16, 9, 2, 3, 10]

# Default intra quantization matrix, raster order (ISO 11172-2 §2.4.3.2;
# parity: video.go:1055-1064).
INTRA_QUANT_MATRIX = (
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
)

# Default non-intra matrix: flat 16 (ISO 11172-2; parity: video.go:1066-1075).
NON_INTRA_QUANT_MATRIX = (16,) * 64

# IDCT premultiplier: the fixed-point AAN-style scale factors folded into the
# dequantized coefficients (parity: video.go:1077-1086).
PREMULTIPLIER_MATRIX = (
    32, 44, 42, 38, 32, 25, 17, 9,
    44, 62, 58, 52, 44, 35, 24, 12,
    42, 58, 55, 49, 42, 33, 23, 12,
    38, 52, 49, 44, 38, 30, 20, 10,
    32, 44, 42, 38, 32, 25, 17, 9,
    25, 35, 33, 30, 25, 20, 14, 7,
    17, 24, 23, 20, 17, 14, 9, 5,
    9, 12, 12, 10, 9, 7, 5, 2,
)

# Picture types (video.go:930-933).
PICTURE_TYPE_INTRA = 1
PICTURE_TYPE_PREDICTIVE = 2
PICTURE_TYPE_B = 3

# Start codes (video.go:935-941).
START_PICTURE = 0x00
START_SLICE_FIRST = 0x01
START_SLICE_LAST = 0xAF
START_USER_DATA = 0xB2
START_SEQUENCE = 0xB3
START_EXTENSION = 0xB5


# --------------------------------------------------------------------------
# Flat VLC lookup tables
# --------------------------------------------------------------------------

class FlatVlc:
    """Flat Huffman decode table: peek `maxlen` bits, index, advance `length`.

    values[bits] is the decoded value, lengths[bits] the codeword length
    (0 marks an invalid prefix).  Both are plain Python lists — fastest for
    scalar indexing from the interpreter.
    """

    __slots__ = ("values", "lengths", "maxlen")

    def __init__(self, codes):
        maxlen = max(length for _, length, _ in codes)
        size = 1 << maxlen
        values = [0] * size
        lengths = [0] * size
        for code, length, value in codes:
            base = code << (maxlen - length)
            span = 1 << (maxlen - length)
            for i in range(base, base + span):
                values[i] = value
                lengths[i] = length
        self.values = values
        self.lengths = lengths
        self.maxlen = maxlen


MACROBLOCK_ADDRESS_INCREMENT = FlatVlc(_spec.MACROBLOCK_ADDRESS_INCREMENT)
# Special values in the address-increment table (video.go:467-475).
MB_STUFFING = 34
MB_ESCAPE = 35

MACROBLOCK_TYPE = {
    PICTURE_TYPE_INTRA: FlatVlc(_spec.MACROBLOCK_TYPE_INTRA),
    PICTURE_TYPE_PREDICTIVE: FlatVlc(_spec.MACROBLOCK_TYPE_PREDICTIVE),
    PICTURE_TYPE_B: FlatVlc(_spec.MACROBLOCK_TYPE_B),
}
CODED_BLOCK_PATTERN = FlatVlc(_spec.CODED_BLOCK_PATTERN)
MOTION = FlatVlc(_spec.MOTION)
DCT_SIZE = (
    FlatVlc(_spec.DCT_SIZE_LUMINANCE),
    FlatVlc(_spec.DCT_SIZE_CHROMINANCE),
    FlatVlc(_spec.DCT_SIZE_CHROMINANCE),
)
# Packed run<<8|level; 0xFFFF = escape, 0x0001 doubles as EOB (video.go:1300-1306).
DCT_COEFF = FlatVlc(_spec.DCT_COEFF)


# --------------------------------------------------------------------------
# Audio tables (ISO 11172-3; parity: /root/reference/audio.go:774-973)
# --------------------------------------------------------------------------

FRAME_SYNC = 0x7FF

MPEG_2_5 = 0x0
MPEG_2 = 0x2
MPEG_1 = 0x3

LAYER_III = 0x1
LAYER_II = 0x2
LAYER_I = 0x3

MODE_STEREO = 0x0
MODE_JOINT_STEREO = 0x1
MODE_DUAL_CHANNEL = 0x2
MODE_MONO = 0x3

SAMPLES_PER_FRAME = 1152

# Samplerate index -> Hz (audio.go:798-801).
SAMPLE_RATE = (44100, 48000, 32000, 0, 22050, 24000, 16000, 0)

# Bitrate index -> kbit/s (audio.go:803-806).
BIT_RATE = (
    32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384,   # MPEG-1
    8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160,        # MPEG-2
)

# Scalefactor base values (audio.go:808-811).
SCALEFACTOR_BASE = (0x02000000, 0x01965FEA, 0x01428A30)

# Quantizer lookup cascade (ISO 11172-3 Tables 3-B.2*; audio.go:901-953).
QUANT_LUT_STEP_1 = (
    (0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2),   # mono
    (0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 2),   # stereo
)

_QUANT_TAB_A = 27 | 64   # Table 3-B.2a: high-rate, sblimit = 27
_QUANT_TAB_B = 30 | 64   # Table 3-B.2b: high-rate, sblimit = 30
_QUANT_TAB_C = 8         # Table 3-B.2c:  low-rate, sblimit =  8
_QUANT_TAB_D = 12        # Table 3-B.2d:  low-rate, sblimit = 12

QUANT_LUT_STEP_2 = (
    # 44.1 kHz,     48 kHz,       32 kHz
    (_QUANT_TAB_C, _QUANT_TAB_C, _QUANT_TAB_D),   # 32 - 48 kbit/s/ch
    (_QUANT_TAB_A, _QUANT_TAB_A, _QUANT_TAB_A),   # 56 - 80 kbit/s/ch
    (_QUANT_TAB_B, _QUANT_TAB_A, _QUANT_TAB_B),   # 96+  kbit/s/ch
)

# Per-subband nbal (upper nibble) and step-4 row (lower nibble).
QUANT_LUT_STEP_3 = (
    # Low-rate (3-B.2c/d)
    (0x44, 0x44,
     0x34, 0x34, 0x34, 0x34, 0x34, 0x34, 0x34, 0x34, 0x34, 0x34),
    # High-rate (3-B.2a/b)
    (0x43, 0x43, 0x43,
     0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42, 0x42,
     0x31, 0x31, 0x31, 0x31, 0x31, 0x31, 0x31, 0x31, 0x31, 0x31, 0x31, 0x31,
     0x20, 0x20, 0x20, 0x20, 0x20, 0x20, 0x20),
    # MPEG-2 LSR (ISO 13818-3 B.2)
    (0x45, 0x45, 0x45, 0x45,
     0x34, 0x34, 0x34, 0x34, 0x34, 0x34, 0x34,
     0x24, 0x24, 0x24, 0x24, 0x24, 0x24, 0x24, 0x24, 0x24, 0x24,
     0x24, 0x24, 0x24, 0x24, 0x24, 0x24, 0x24, 0x24, 0x24),
)

QUANT_LUT_STEP_4 = (
    (0, 1, 2, 17),
    (0, 1, 2, 3, 4, 5, 6, 17),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 17),
    (0, 1, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17),
    (0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
)

# Quantizer specs: (levels, group, bits) (audio.go:955-973).
QUANT_TAB = (
    (3, 1, 5), (5, 1, 7), (7, 0, 3), (9, 1, 10), (15, 0, 4),
    (31, 0, 5), (63, 0, 6), (127, 0, 7), (255, 0, 8), (511, 0, 9),
    (1023, 0, 10), (2047, 0, 11), (4095, 0, 12), (8191, 0, 13),
    (16383, 0, 14), (32767, 0, 15), (65535, 0, 16),
)

# MP2 synthesis D window, 512 taps (ISO 11172-3 Table 3-B.3 scaling as used
# by the reference; audio.go:812-899).  The decoder mirrors it into a
# 1024-float table d[i] = d[i+512] = window[i] (audio.go:95-99).
SYNTHESIS_WINDOW = np.asarray(_spec.SYNTHESIS_WINDOW, dtype=np.float32)
assert SYNTHESIS_WINDOW.shape == (512,)

# d table as used by the windowing kernels: the window duplicated end to end.
D_WINDOW = np.concatenate([SYNTHESIS_WINDOW, SYNTHESIS_WINDOW])
