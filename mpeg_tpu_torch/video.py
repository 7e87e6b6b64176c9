"""MPEG-1 video parse in Python: the picture plans the decoders pack.

The port's copy of the parse side of `mpeg_tpu/video.py`: sequence,
picture and slice headers, macroblock address/type/CBP VLCs, motion
vector decode, DC prediction and the AC run/level VLC loop with
dequantize+oddify+clip+premultiply (video.go:374-745), emitting one dense
picture plan per picture.  `BatchVideoDecoder(use_native=False)` parses
through `Video(buf, backend="plan")`; the C++ parser
(`mpeg_tpu_torch.native`) emits the same plans.

Only the "plan" backend exists here.  The reference-shaped interactive
decode (`decode()` with a device reconstruct per picture) is still to
port (ROADMAP, "Still to port" 1, the interactive API).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import tables as T
from .buffer import Buffer, CorruptStream
from .ops.video_recon import FrameGeometry


class _Motion:
    __slots__ = ("full_px", "r_size", "h", "v", "is_set")

    def __init__(self):
        self.full_px = 0
        self.r_size = 0
        self.h = 0
        self.v = 0
        self.is_set = False


class _PicturePlan:
    """Dense per-picture arrays consumed by the device reconstruction."""

    def __init__(self, mb_size: int):
        self.coeffs = np.zeros((mb_size, 6, 64), np.int32)
        self.nblocks = np.zeros((mb_size, 6), np.int32)
        # Per-block intra flag: with corrupt streams a macroblock can be
        # touched more than once per picture (slice overrun + slice
        # restart), mixing intra block stores with earlier predictions.
        self.intra_blk = np.zeros((mb_size, 6), np.int32)
        self.src_sel = np.zeros(mb_size, np.int32)
        self.mv_h = np.zeros(mb_size, np.int32)
        self.mv_v = np.zeros(mb_size, np.int32)


class Video:
    """MPEG-1 video parser: pulls an ES from `buf`, yields picture plans
    (`parse_next_plan`)."""

    def __init__(self, buf: Buffer, backend: str = "plan"):
        if backend != "plan":
            raise NotImplementedError(
                f"backend={backend!r}: the port parses plans only; the "
                "interactive decode is still to port (ROADMAP, 'Still to "
                "port' 1, the interactive API)")
        self.buf = buf
        self.backend = backend

        self.aspect_ratio = 0.0
        self.frame_rate = 0.0
        self.bit_rate = 0
        self.width = 0
        self.height = 0

        self.geom: Optional[FrameGeometry] = None

        self.start_code = -1
        self.picture_type = 0

        self.motion_forward = _Motion()
        self.motion_backward = _Motion()

        self.has_sequence_header = False

        self.quantizer_scale = 0
        self.slice_begin = False
        self.macroblock_address = 0
        self.mb_row = 0
        self.mb_col = 0
        self.macroblock_type = 0
        self.macroblock_intra = False

        self.dc_predictor = [0, 0, 0]

        self.intra_quant_matrix = list(T.INTRA_QUANT_MATRIX)
        self.non_intra_quant_matrix = list(T.NON_INTRA_QUANT_MATRIX)

        self._plan: Optional[_PicturePlan] = None
        # _decode_picture defers each picture plan into this list for
        # parse_next_plan.
        self._pending_plans: list = []

        # Persistent coefficient scratch, replicating the reference's
        # blockData field (video.go:101): it is only partially cleared
        # between blocks — the DC-only fast path zeroes just index 0
        # (video.go:777,790) and an invalid block keeps its partial
        # coefficients — so junk-tolerant decode behavior (and the golden
        # hash) depends on the leftovers leaking into subsequent blocks.
        self._block_data = [0] * 64

        # Attempt to decode the sequence header.
        self.start_code = self.buf.find_start_code(T.START_SEQUENCE)
        if self.start_code != -1:
            self._decode_sequence_header()

    def _source_ended(self) -> bool:
        """EOS for the internal parse gates: reader exhausted OR the
        owner called signal_end (push-fed streaming; buffer compaction
        defeats the reference's len==total_size inference)."""
        return self.buf.has_ended() or self.buf.end_signaled

    # -- public surface (parity: video.go:123-268) ---------------------------

    def buffer(self) -> Buffer:
        return self.buf

    def has_header(self) -> bool:
        if self.has_sequence_header:
            return True
        if self.start_code != T.START_SEQUENCE:
            self.start_code = self.buf.find_start_code(T.START_SEQUENCE)
        if self.start_code == -1:
            return False
        return self._decode_sequence_header()

    def framerate(self) -> float:
        return self.frame_rate if self.has_header() else 0

    def get_width(self) -> int:
        return self.width if self.has_header() else 0

    def get_height(self) -> int:
        return self.height if self.has_header() else 0

    def has_ended(self) -> bool:
        return self.buf.has_ended()

    # -- sequence / picture / slice parse ------------------------------------

    def _decode_sequence_header(self) -> bool:
        max_header_size = 64 + 2 * 64 * 8   # header + two quant matrices
        if not self.buf.has(max_header_size):
            return False

        buf = self.buf
        self.width = buf.read(12)
        self.height = buf.read(12)
        if self.width <= 0 or self.height <= 0:
            return False

        self.aspect_ratio = T.ASPECT_RATIO[buf.read(4)]
        self.frame_rate = T.PICTURE_RATE[buf.read(4)]
        self.bit_rate = buf.read(18)
        buf.skip(1 + 10 + 1)   # marker, vbv buffer size, constrained flag

        # Custom intra quant matrix? (stored in zig-zag order)
        if buf.read1() != 0:
            for i in range(64):
                self.intra_quant_matrix[T.ZIG_ZAG[i]] = buf.read(8)
        else:
            self.intra_quant_matrix = list(T.INTRA_QUANT_MATRIX)

        if buf.read1() != 0:
            for i in range(64):
                self.non_intra_quant_matrix[T.ZIG_ZAG[i]] = buf.read(8)
        else:
            self.non_intra_quant_matrix = list(T.NON_INTRA_QUANT_MATRIX)

        self.geom = FrameGeometry.for_size(self.width, self.height)
        self.has_sequence_header = True
        return True

    def _decode_picture(self) -> None:
        buf = self.buf
        buf.skip(10)   # temporal reference
        self.picture_type = buf.read(3)
        buf.skip(16)   # vbv_delay

        # D frames or unknown coding type
        if self.picture_type <= 0 or self.picture_type > T.PICTURE_TYPE_B:
            return

        if self.picture_type in (T.PICTURE_TYPE_PREDICTIVE,
                                 T.PICTURE_TYPE_B):
            self.motion_forward.full_px = buf.read1()
            f_code = buf.read(3)
            if f_code == 0:
                return   # ignore picture with zero fCode
            self.motion_forward.r_size = f_code - 1

        if self.picture_type == T.PICTURE_TYPE_B:
            self.motion_backward.full_px = buf.read1()
            f_code = buf.read(3)
            if f_code == 0:
                return
            self.motion_backward.r_size = f_code - 1

        # Find the first slice start code; skip extension/user data.
        while True:
            self.start_code = buf.next_start_code()
            if self.start_code not in (T.START_EXTENSION, T.START_USER_DATA):
                break

        # Parse all slices into the picture plan.
        self._plan = _PicturePlan(self.geom.mb_size)
        while T.START_SLICE_FIRST <= self.start_code <= T.START_SLICE_LAST:
            try:
                self._decode_slice(self.start_code & 0xFF)
            except (CorruptStream, IndexError):
                # IndexError: bit reads ran off a truncated final picture
                # (the reference panics there); abort the picture, keep
                # what was parsed.
                break
            if self.macroblock_address >= self.geom.mb_size - 2:
                break
            self.start_code = buf.next_start_code()

        self._pending_plans.append((self._plan, self.picture_type))

    def parse_next_plan(self):
        """Parse the next picture WITHOUT reconstructing.

        Returns (plan, picture_type) or None at end of data.  Used by the
        batched decoders, which reconstruct the plans a window at a time.
        """
        if not self.has_header():
            return None
        while True:
            if self.start_code != T.START_PICTURE:
                self.start_code = self.buf.find_start_code(T.START_PICTURE)
                if self.start_code == -1:
                    return None
            if self.buf.has_start_code(T.START_PICTURE) == -1 and \
                    not self._source_ended():
                return None
            self.buf.discard_read_bytes()
            before = len(self._pending_plans)
            self._decode_picture()
            if len(self._pending_plans) > before:
                return self._pending_plans.pop()

    def _decode_slice(self, slice_index: int) -> None:
        buf = self.buf
        self.slice_begin = True
        self.macroblock_address = (slice_index - 1) * self.geom.mb_width - 1

        # Reset motion vectors and DC predictors
        self.motion_backward.h = self.motion_forward.h = 0
        self.motion_backward.v = self.motion_forward.v = 0
        self.dc_predictor[0] = 128
        self.dc_predictor[1] = 128
        self.dc_predictor[2] = 128

        self.quantizer_scale = buf.read(5)

        # Skip extra slice info
        while buf.read1() != 0:
            buf.skip(8)

        while True:
            self._decode_macroblock()
            if self.macroblock_address >= self.geom.mb_size - 1 or \
                    not buf.peek_non_zero(23):
                break

    def _decode_macroblock(self) -> None:
        buf = self.buf
        mb_width = self.geom.mb_width
        mb_size = self.geom.mb_size

        # Address increment (with stuffing / escape)
        increment = 0
        t = buf.read_vlc(T.MACROBLOCK_ADDRESS_INCREMENT)
        while t == T.MB_STUFFING:
            t = buf.read_vlc(T.MACROBLOCK_ADDRESS_INCREMENT)
        while t == T.MB_ESCAPE:
            increment += 33
            t = buf.read_vlc(T.MACROBLOCK_ADDRESS_INCREMENT)
        increment += t

        if self.slice_begin:
            # First increment of a slice is relative to the previous row.
            self.slice_begin = False
            self.macroblock_address += increment
        else:
            if self.macroblock_address + increment >= mb_size:
                return   # invalid
            if increment > 1:
                # Skipped macroblocks reset DC predictors
                self.dc_predictor[0] = 128
                self.dc_predictor[1] = 128
                self.dc_predictor[2] = 128
                # ... and motion vectors in P-pictures
                if self.picture_type == T.PICTURE_TYPE_PREDICTIVE:
                    self.motion_forward.h = 0
                    self.motion_forward.v = 0

            # Predict skipped macroblocks
            while increment > 1:
                self.macroblock_address += 1
                self.mb_row = self.macroblock_address // mb_width
                self.mb_col = self.macroblock_address % mb_width
                self._predict_macroblock()
                increment -= 1
            self.macroblock_address += 1

        self.mb_row = self.macroblock_address // mb_width
        self.mb_col = self.macroblock_address % mb_width
        if self.mb_col >= mb_width or self.mb_row >= self.geom.mb_height:
            return   # corrupt stream

        # Macroblock type
        self.macroblock_type = buf.read_vlc(
            T.MACROBLOCK_TYPE[self.picture_type])
        self.macroblock_intra = (self.macroblock_type & 0x01) != 0
        self.motion_forward.is_set = (self.macroblock_type & 0x08) != 0
        self.motion_backward.is_set = (self.macroblock_type & 0x04) != 0

        if (self.macroblock_type & 0x10) != 0:
            self.quantizer_scale = buf.read(5)

        if self.macroblock_intra:
            # Intra macroblocks reset motion vectors
            self.motion_backward.h = self.motion_forward.h = 0
            self.motion_backward.v = self.motion_forward.v = 0
        else:
            # Non-intra macroblocks reset DC predictors
            self.dc_predictor[0] = 128
            self.dc_predictor[1] = 128
            self.dc_predictor[2] = 128
            self._decode_motion_vectors()
            self._predict_macroblock()

        # Decode blocks
        if (self.macroblock_type & 0x02) != 0:
            cbp = buf.read_vlc(T.CODED_BLOCK_PATTERN)
        elif self.macroblock_intra:
            cbp = 0x3F
        else:
            cbp = 0

        mask = 0x20
        for block in range(6):
            if (cbp & mask) != 0:
                self._decode_block(block)
            mask >>= 1

    def _decode_motion_vectors(self) -> None:
        if self.motion_forward.is_set:
            r_size = self.motion_forward.r_size
            self.motion_forward.h = self._decode_motion_vector(
                r_size, self.motion_forward.h)
            self.motion_forward.v = self._decode_motion_vector(
                r_size, self.motion_forward.v)
        elif self.picture_type == T.PICTURE_TYPE_PREDICTIVE:
            # No motion information in P-picture: reset vectors
            self.motion_forward.h = 0
            self.motion_forward.v = 0

        if self.motion_backward.is_set:
            r_size = self.motion_backward.r_size
            self.motion_backward.h = self._decode_motion_vector(
                r_size, self.motion_backward.h)
            self.motion_backward.v = self._decode_motion_vector(
                r_size, self.motion_backward.v)

    def _decode_motion_vector(self, r_size: int, motion: int) -> int:
        buf = self.buf
        fscale = 1 << r_size
        m_code = buf.read_vlc(T.MOTION)

        if m_code != 0 and fscale != 1:
            r = buf.read(r_size)
            d = ((abs(m_code) - 1) << r_size) + r + 1
            if m_code < 0:
                d = -d
        else:
            d = m_code

        motion += d
        if motion > (fscale << 4) - 1:
            motion -= fscale << 5
        elif motion < (-fscale) << 4:
            motion += fscale << 5
        return motion

    def _predict_macroblock(self) -> None:
        """Record the effective prediction source + motion for this MB.

        The reference copies forward then (for B-frames with both vectors)
        copies backward over it (video.go:626-633) — byte-for-byte that
        collapses to "backward wins".
        """
        fw_h, fw_v = self.motion_forward.h, self.motion_forward.v
        if self.motion_forward.full_px:
            fw_h <<= 1
            fw_v <<= 1

        if self.picture_type == T.PICTURE_TYPE_B:
            bw_h, bw_v = self.motion_backward.h, self.motion_backward.v
            if self.motion_backward.full_px:
                bw_h <<= 1
                bw_v <<= 1
            if self.motion_forward.is_set and not self.motion_backward.is_set:
                sel, mh, mv = 1, fw_h, fw_v
            else:
                sel, mh, mv = 2, bw_h, bw_v
        else:
            sel, mh, mv = 1, fw_h, fw_v

        mb = self.macroblock_address
        if not 0 <= mb < self.geom.mb_size:
            # Out-of-frame junk address: the reference would panic on the
            # pixel write; any non-crashing behavior is fine here.
            return
        plan = self._plan
        plan.src_sel[mb] = sel
        plan.mv_h[mb] = mh
        plan.mv_v[mb] = mv
        # Sequential-write semantics: a new prediction overwrites the whole
        # macroblock, erasing residuals/intra stores from earlier touches
        # of this MB in the same picture.
        plan.nblocks[mb] = 0
        plan.intra_blk[mb] = 0

    def _decode_block(self, block: int) -> None:
        """AC run/level VLC loop with dequantize + oddify + clip +
        premultiply (parity: video.go:639-745)."""
        buf = self.buf
        n = 0
        block_data = self._block_data

        if self.macroblock_intra:
            # DC prediction
            plane_index = block - 3 if block > 3 else 0
            predictor = self.dc_predictor[plane_index]
            dct_size = buf.read_vlc(T.DCT_SIZE[plane_index])

            if dct_size > 0:
                differential = buf.read(dct_size)
                if differential & (1 << (dct_size - 1)):
                    block_data[0] = predictor + differential
                else:
                    block_data[0] = predictor + \
                        ((-1 << dct_size) | (differential + 1))
            else:
                block_data[0] = predictor

            self.dc_predictor[plane_index] = block_data[0]
            block_data[0] <<= 3 + 5   # dequantize + premultiply
            quant_matrix = self.intra_quant_matrix
            n = 1
        else:
            quant_matrix = self.non_intra_quant_matrix

        # AC coefficients (+DC for non-intra)
        read = buf.read
        read1 = buf.read1
        read_vlc = buf.read_vlc
        dct_coeff = T.DCT_COEFF
        zig_zag = T.ZIG_ZAG
        premult = T.PREMULTIPLIER_MATRIX
        quantizer_scale = self.quantizer_scale

        while True:
            coeff = read_vlc(dct_coeff)

            if coeff == 0x0001 and n > 0 and read1() == 0:
                break   # end_of_block

            if coeff == 0xFFFF:
                # escape: 6-bit run, 8(+8)-bit level
                run = read(6)
                level = read(8)
                if level == 0:
                    level = read(8)
                elif level == 128:
                    level = read(8) - 256
                elif level > 128:
                    level -= 256
            else:
                run = coeff >> 8
                level = coeff & 0xFF
                if read1() != 0:
                    level = -level

            n += run
            if n < 0 or n >= 64:
                return   # invalid
            de_zig_zagged = zig_zag[n] & 63
            n += 1

            # Dequantize, oddify, clip
            level <<= 1
            if not self.macroblock_intra:
                level += -1 if level < 0 else 1
            level = (level * quantizer_scale * quant_matrix[de_zig_zagged]) >> 4
            if (level & 1) == 0:
                level += -1 if level > 0 else 1
            if level > 2047:
                level = 2047
            elif level < -2048:
                level = -2048

            # Save premultiplied coefficient
            block_data[de_zig_zagged] = level * premult[de_zig_zagged]

        mb = self.macroblock_address
        if 0 <= mb < self.geom.mb_size:
            self._plan.coeffs[mb, block] = block_data
            self._plan.nblocks[mb, block] = n
            self._plan.intra_blk[mb, block] = 1 if self.macroblock_intra else 0
        # Clear the scratch exactly like the reference does after the
        # store: DC-only path zeroes index 0 only (video.go:777,790),
        # the IDCT paths zero everything (video.go:781-784,794-796).
        if n == 1:
            block_data[0] = 0
        else:
            for i in range(64):
                block_data[i] = 0
