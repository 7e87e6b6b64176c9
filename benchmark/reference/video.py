"""MPEG-1 Video (mpeg1video) decoder.

Split architecture (vs. the reference's serial per-macroblock loop,
/root/reference/video.go):

- host parse (this file): sequence/picture/slice headers, macroblock
  address/type/CBP VLCs, motion vector decode, DC prediction and the AC
  run/level VLC loop with dequantize+oddify+clip+premultiply
  (video.go:374-745) — inherently serial bit work — emitting one dense
  "picture plan" (coefficients, per-MB motion/flags) per picture;
- device reconstruction (ops/video_recon.py): IDCT, motion compensation
  and residual stores for the WHOLE picture in one dispatch.

The pixel path is all-integer and bit-exact against the reference
(golden hash mpeg_test.go:227).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import tables as T
from .buffer import Buffer, CorruptStream
from .recon import FrameGeometry, reconstruct_picture


class Frame:
    """One decoded video frame.

    Planes live in a single flat padded buffer shared by Y/Cb/Cr exactly
    like the original (video.go:333-372), at macroblock-rounded sizes.
    """

    def __init__(self, geom: FrameGeometry, flat=None):
        self.geom = geom
        self.time = 0.0
        self.flat = flat if flat is not None else \
            np.zeros(geom.total_size, np.uint8)


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
    """MPEG-1 video decoder: pulls an ES from `buf`, yields Frames."""

    def __init__(self, buf: Buffer, idct=None):
        """`idct`: the IDCT `recon.reconstruct_picture` runs (None: the
        exact integer one)."""
        self.buf = buf
        self.idct = idct

        self.aspect_ratio = 0.0
        self.frame_rate = 0.0
        self.bit_rate = 0
        self.time = 0.0
        self.frames_decoded = 0
        self.width = 0
        self.height = 0

        self.geom: Optional[FrameGeometry] = None
        self._maps = None
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

        self.frame_current: Optional[Frame] = None
        self.frame_forward: Optional[Frame] = None
        self.frame_backward: Optional[Frame] = None

        self.has_reference_frame = False
        self.assume_no_b_frames = False

        self._plan: Optional[_PicturePlan] = None
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
        return self.buf.has_ended() or self.buf.end_signaled

    def has_header(self) -> bool:
        if self.has_sequence_header:
            return True
        if self.start_code != T.START_SEQUENCE:
            self.start_code = self.buf.find_start_code(T.START_SEQUENCE)
        if self.start_code == -1:
            return False
        return self._decode_sequence_header()

    def decode(self) -> Optional[Frame]:
        """Decode one frame and advance time by 1/framerate
        (parity: video.go:209-268)."""
        if not self.has_header():
            return None
        frame = None
        while True:
            if self.start_code != T.START_PICTURE:
                self.start_code = self.buf.find_start_code(T.START_PICTURE)
                if self.start_code == -1:
                    # At EOF, a pending reference frame is still due.
                    if self.has_reference_frame and \
                            not self.assume_no_b_frames and \
                            self._source_ended() and self.picture_type in (
                                T.PICTURE_TYPE_INTRA,
                                T.PICTURE_TYPE_PREDICTIVE):
                        self.has_reference_frame = False
                        frame = self.frame_backward
                        break
                    return None

            # Whole-picture-buffered check: seek the next picture start code
            # (or accept a final picture when the source has ended).
            if self.buf.has_start_code(T.START_PICTURE) == -1 and \
                    not self._source_ended():
                return None
            self.buf.discard_read_bytes()

            self._decode_picture()

            if self.assume_no_b_frames:
                frame = self.frame_backward
            elif self.picture_type == T.PICTURE_TYPE_B:
                frame = self.frame_current
            elif self.has_reference_frame:
                frame = self.frame_forward
            else:
                self.has_reference_frame = True

            if frame is not None:
                break

        frame.time = self.time
        self.frames_decoded += 1
        self.time = self.frames_decoded / self.frame_rate
        return frame

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

        self._init_geometry()
        self.has_sequence_header = True
        return True

    def _init_geometry(self) -> None:
        self.geom = FrameGeometry.for_size(self.width, self.height)
        self.frame_current = self._new_frame()
        self.frame_forward = self._new_frame()
        self.frame_backward = self._new_frame()

    def _new_frame(self) -> Frame:
        return Frame(self.geom)

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

        frame_temp = self.frame_forward
        if self.picture_type in (T.PICTURE_TYPE_INTRA,
                                 T.PICTURE_TYPE_PREDICTIVE):
            self.frame_forward = self.frame_backward

        # Find the first slice start code; skip extension/user data.
        while True:
            self.start_code = buf.next_start_code()
            if self.start_code not in (T.START_EXTENSION, T.START_USER_DATA):
                break

        # Parse all slices into the picture plan, then reconstruct the
        # whole picture in one device dispatch.
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

        self._reconstruct()

        # Rotate prediction pointers for reference pictures.
        if self.picture_type in (T.PICTURE_TYPE_INTRA,
                                 T.PICTURE_TYPE_PREDICTIVE):
            self.frame_backward = self.frame_current
            self.frame_current = frame_temp

    def _reconstruct(self) -> None:
        plan = self._plan
        cur, fwd, bwd = self.frame_current, self.frame_forward, \
            self.frame_backward
        cur.flat = reconstruct_picture(
            cur.flat, fwd.flat, bwd.flat,
            plan.coeffs, plan.nblocks, plan.intra_blk,
            plan.src_sel, plan.mv_h, plan.mv_v,
            self.geom, np, idct=self.idct)

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
