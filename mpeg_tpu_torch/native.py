"""ctypes binding of the C++ host parser (csrc/host/parser.cpp).

The port's own copy of `mpeg_tpu/native.py`: the streaming
elementary-stream parsers (`NativeVideoParser`, `NativeAudioParser`), the
host-only decoder that the tests and `chip_smoke.py` compare frames with
(`NativeHostDecoder`), the packet demuxer (`NativeDemuxer`) and the
MPEG-PS pipeline (`NativePipeline`).  The video side emits the
window-blob records the decoders ship to the device; the audio side the
subband samples the synthesis filterbank takes.

`csrc/host/parser.cpp` and `vlc_tables.h` are copies of `native/`'s
sources; a fix to one goes into both.  g++ builds the library at first
use, keyed by a digest of the sources, into `build/mpeg_tpu_torch/` at the
root of the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "mpeg_tpu_torch")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native"]

_lib = None


def build() -> str:
    """Compile parser.cpp if its digest has no library yet; returns the
    library's path."""
    src = os.path.join(SOURCE_DIR, "parser.cpp")
    hdr = os.path.join(SOURCE_DIR, "vlc_tables.h")
    with open(src, "rb") as f, open(hdr, "rb") as h:
        digest = hashlib.sha256(f.read() + h.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libhostparser-{digest}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp], check=True,
                       cwd=SOURCE_DIR, capture_output=True)
        os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Load (building if necessary) the parser library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())

    lib.vp_create.restype = ctypes.c_void_p
    lib.vp_destroy.argtypes = [ctypes.c_void_p]
    lib.vp_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_int64]
    lib.vp_signal_end.argtypes = [ctypes.c_void_p]
    lib.vp_has_header.argtypes = [ctypes.c_void_p]
    lib.vp_has_header.restype = ctypes.c_int
    lib.vp_width.argtypes = [ctypes.c_void_p]
    lib.vp_width.restype = ctypes.c_int
    lib.vp_height.argtypes = [ctypes.c_void_p]
    lib.vp_height.restype = ctypes.c_int
    lib.vp_framerate.argtypes = [ctypes.c_void_p]
    lib.vp_framerate.restype = ctypes.c_double
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.vp_parse_picture.argtypes = [ctypes.c_void_p] + [p_i32] * 6
    lib.vp_parse_picture.restype = ctypes.c_int

    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    p_u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.vp_parse_blob_prepare.argtypes = [ctypes.c_void_p]
    lib.vp_parse_blob_prepare.restype = ctypes.c_int
    lib.vp_blob_counts.argtypes = [ctypes.c_void_p, p_i64]
    lib.vp_blob_emit.argtypes = [
        ctypes.c_void_p, p_u16, p_u16, p_i32,
        p_i16, p_i16, p_u16, p_u8, ctypes.c_int64, p_i64]
    lib.vp_blob_emit.restype = ctypes.c_int
    _window_args = [ctypes.c_void_p] + [ctypes.c_int64] * 10 + [
        p_u16, p_u16, p_i32, p_i16, p_i16, p_u16, p_u8,
        p_i32, p_i32, ctypes.c_int64, p_i64]
    lib.vp_blob_window.argtypes = _window_args
    lib.vp_blob_window.restype = ctypes.c_int64
    lib.pp_blob_window.argtypes = _window_args
    lib.pp_blob_window.restype = ctypes.c_int64

    lib.vp_rewind.argtypes = [ctypes.c_void_p]
    lib.vp_reset.argtypes = [ctypes.c_void_p]
    lib.vp_unconsumed.argtypes = [ctypes.c_void_p]
    lib.vp_unconsumed.restype = ctypes.c_int64
    lib.vp_total_size.argtypes = [ctypes.c_void_p]
    lib.vp_total_size.restype = ctypes.c_int64
    lib.vp_host_decode.argtypes = [ctypes.c_void_p, p_u8]
    lib.vp_host_decode.restype = ctypes.c_int

    lib.pp_create.restype = ctypes.c_void_p
    lib.pp_destroy.argtypes = [ctypes.c_void_p]
    lib.pp_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_int64]
    lib.pp_signal_end.argtypes = [ctypes.c_void_p]
    for name in ("pp_has_headers", "pp_num_video_streams",
                 "pp_num_audio_streams", "pp_video_has_header",
                 "pp_width", "pp_height", "pp_audio_has_header",
                 "pp_samplerate", "pp_channels",
                 "pp_video_blob_prepare"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.pp_framerate.argtypes = [ctypes.c_void_p]
    lib.pp_framerate.restype = ctypes.c_double
    lib.pp_set_audio_stream.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pp_parse_picture.argtypes = [ctypes.c_void_p] + [p_i32] * 6
    lib.pp_parse_picture.restype = ctypes.c_int
    lib.pp_reset.argtypes = [ctypes.c_void_p]
    lib.pp_set_video_enabled.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pp_set_audio_enabled.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pp_audio_set_drop.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.pp_audio_kept_pts.argtypes = [ctypes.c_void_p]
    lib.pp_audio_kept_pts.restype = ctypes.c_double
    lib.pp_occupancy.argtypes = [ctypes.c_void_p]
    lib.pp_occupancy.restype = ctypes.c_int64
    lib.pp_demux_backlog.argtypes = [ctypes.c_void_p]
    lib.pp_demux_backlog.restype = ctypes.c_int64
    lib.pp_video_blob_counts.argtypes = [ctypes.c_void_p, p_i64]
    lib.pp_video_blob_emit.argtypes = lib.vp_blob_emit.argtypes
    lib.pp_video_blob_emit.restype = ctypes.c_int
    lib.pp_audio_parse_frame.argtypes = [ctypes.c_void_p, p_i32]
    lib.pp_audio_parse_frame.restype = ctypes.c_int

    lib.dx_create.restype = ctypes.c_void_p
    lib.dx_destroy.argtypes = [ctypes.c_void_p]
    lib.dx_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_int64]
    lib.dx_signal_end.argtypes = [ctypes.c_void_p]
    for name in ("dx_has_headers", "dx_num_video_streams",
                 "dx_num_audio_streams"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.dx_system_clock_ref.argtypes = [ctypes.c_void_p]
    lib.dx_system_clock_ref.restype = ctypes.c_double
    lib.dx_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
    lib.dx_decode.restype = ctypes.c_int
    lib.dx_payload.argtypes = [ctypes.c_void_p]
    lib.dx_payload.restype = ctypes.POINTER(ctypes.c_uint8)

    lib.ap_create.restype = ctypes.c_void_p
    lib.ap_destroy.argtypes = [ctypes.c_void_p]
    lib.ap_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_int64]
    lib.ap_signal_end.argtypes = [ctypes.c_void_p]
    for name in ("ap_has_header", "ap_samplerate", "ap_channels"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ap_parse_frame.argtypes = [ctypes.c_void_p, p_i32]
    lib.ap_parse_frame.restype = ctypes.c_int
    lib.ap_rewind.argtypes = [ctypes.c_void_p]
    lib.ap_unconsumed.argtypes = [ctypes.c_void_p]
    lib.ap_unconsumed.restype = ctypes.c_int64

    _lib = lib
    return lib


def available() -> bool:
    """True when the parser library builds and loads here."""
    try:
        load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeVideoParser:
    """Streaming native parser: feed ES bytes, pull picture plans or emit
    window blobs.

    `parse_next_plan` mirrors `Video(backend="plan").parse_next_plan()`:
    (`_PicturePlan`, picture_type) pairs.
    """

    def __init__(self, data: Optional[bytes] = None):
        self._lib = load()
        self._h = self._lib.vp_create()
        if data is not None:
            self.feed(data)
            self.signal_end()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vp_destroy(self._h)
            self._h = None

    def feed(self, data: bytes) -> None:
        self._lib.vp_feed(self._h, bytes(data), len(data))

    def signal_end(self) -> None:
        self._lib.vp_signal_end(self._h)

    def rewind(self) -> None:
        """Clear stream state, keep the sequence header (video.go:195-201)."""
        self._lib.vp_rewind(self._h)

    def reset(self, data: Optional[bytes] = None) -> None:
        """Reset to fresh-parser state but KEEP the allocated plan/record
        buffers (a new parser re-zeroes ~25 MB at 1080p — looping sources
        reset instead of reconstructing).  Optionally feeds new bytes and
        signals end, mirroring __init__."""
        self._lib.vp_reset(self._h)
        if data is not None:
            self.feed(data)
            self.signal_end()

    def unconsumed(self) -> int:
        return int(self._lib.vp_unconsumed(self._h))

    def has_header(self) -> bool:
        return bool(self._lib.vp_has_header(self._h))

    @property
    def width(self) -> int:
        """Frame width; 0 until the sequence header is available (the
        getter parses it on demand, like the reference's lazy getters)."""
        self.has_header()
        return self._lib.vp_width(self._h)

    @property
    def height(self) -> int:
        self.has_header()
        return self._lib.vp_height(self._h)

    @property
    def framerate(self) -> float:
        self.has_header()
        return self._lib.vp_framerate(self._h)

    def geom(self):
        from .ops.video_recon import FrameGeometry
        return FrameGeometry.for_size(self.width, self.height)

    def parse_next_plan(self):
        """Parse one picture; returns (plan, picture_type) or None."""
        if not self.has_header():
            return None
        from .video import _PicturePlan
        mb = ((self.width + 15) >> 4) * ((self.height + 15) >> 4)
        plan = _PicturePlan(mb)
        ptype = self._lib.vp_parse_picture(
            self._h, plan.coeffs.reshape(-1), plan.nblocks.reshape(-1),
            plan.intra_blk.reshape(-1), plan.src_sel, plan.mv_h, plan.mv_v)
        if ptype == 0:
            return None
        return plan, ptype

    # -- direct blob emission (no dense detour) -----------------------------

    def blob_prepare(self) -> int:
        """Parse one picture into internal plan storage; returns
        picture_type, 0 at end/underflow."""
        if not self.has_header():
            return 0
        return self._lib.vp_parse_blob_prepare(self._h)

    def blob_counts(self) -> tuple[int, int]:
        """(main, escape) pool-record counts of the prepared picture."""
        out = np.zeros(2, np.int64)
        self._lib.vp_blob_counts(self._h, out)
        return int(out[0]), int(out[1])

    def blob_emit(self, main_rec, esc_didx, esc_val,
                  mvh, mvv, nbcls, misc, idx_base: int,
                  prev_m: int = 0, prev_e: int = 0):
        """Emit the prepared picture's pool records + packed metadata.

        Records are delta-encoded (uint16 index deltas continuing the
        chains at prev_m/prev_e, int16 quotients; hop records bridge
        gaps over 64K); main_rec is the interleaved uint16[2*n]
        (didx, val) lane — size it from blob_counts plus a hop bound of
        (pic_span >> 16) + 2 records.  The metadata arrays are this
        picture's [mb] slots.  Returns (flags_word, nm, ne, prev_m,
        prev_e): the emitted record counts and the new chain tails."""
        io = np.array([prev_m, prev_e, 0, 0], np.int64)
        flags = int(self._lib.vp_blob_emit(
            self._h, main_rec, esc_didx, esc_val,
            mvh, mvv, nbcls, misc, idx_base, io))
        return flags, int(io[2]), int(io[3]), int(io[0]), int(io[1])

    _window_fn = "vp_blob_window"

    def blob_window(self, start_pic: int, max_pics: int, km: int, ke: int,
                    nm0: int, ne0: int, main_rec, esc_didx,
                    esc_val, mvh, mvv, nbcls, misc, flags, types,
                    hw_nm: int = None, hw_ne: int = None,
                    prev_m: int = 0, prev_e: int = 0):
        """Parse+emit a whole window in ONE native call (the per-picture
        ctypes round trips cost more than the 1080p parse itself).

        Fills pictures [start_pic, max_pics); record offsets continue at
        (nm0, ne0) with delta chains continuing at (prev_m, prev_e) —
        thread all four through growth re-calls.  Returns
        (pictures_emitted, nm, ne, pending_type, prev_m, prev_e):
        pending_type != 0 means a prepared picture needs more pool
        capacity — size it with blob_counts plus the window hop slack,
        grow, call again.

        hw_nm/hw_ne (default: the full capacities): pool high-water
        marks — a recycled buffer whose tails [hw, cap) already hold
        the pad pattern (all-zero records) skips re-padding them, so
        the tail fill is O(live records), not O(pool capacity)."""
        out = np.zeros(5, np.int64)
        mb = self.geom().mb_size
        n = getattr(self._lib, self._window_fn)(
            self._h, start_pic, max_pics, km, ke, nm0, ne0,
            km if hw_nm is None else hw_nm,
            ke if hw_ne is None else hw_ne,
            prev_m, prev_e,
            main_rec, esc_didx, esc_val,
            mvh, mvv, nbcls, misc, flags, types, mb, out)
        return (int(n), int(out[0]), int(out[1]), int(out[2]),
                int(out[3]), int(out[4]))


class NativeHostDecoder(NativeVideoParser):
    """Full host-only (CPU) video decode in C++.

    Same plan semantics as the device path, reconstructed natively;
    yields flat shared-layout frame buffers in display order.
    """

    def decode_next(self) -> Optional[np.ndarray]:
        if not self.has_header():
            return None
        out = np.zeros(int(self._lib.vp_total_size(self._h)), np.uint8)
        if self._lib.vp_host_decode(self._h, out):
            return out
        return None


class NativeAudioParser:
    """Streaming native MP2 parser: feed ES bytes, pull subband samples
    [36, 2, 32] int32 per frame (mirrors Audio._parse_frame)."""

    def __init__(self, data: Optional[bytes] = None):
        self._lib = load()
        self._h = self._lib.ap_create()
        if data is not None:
            self.feed(data)
            self.signal_end()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ap_destroy(self._h)
            self._h = None

    def feed(self, data: bytes) -> None:
        self._lib.ap_feed(self._h, bytes(data), len(data))

    def signal_end(self) -> None:
        self._lib.ap_signal_end(self._h)

    def has_header(self) -> bool:
        return bool(self._lib.ap_has_header(self._h))

    @property
    def samplerate(self) -> int:
        return self._lib.ap_samplerate(self._h)

    @property
    def channels(self) -> int:
        return self._lib.ap_channels(self._h)

    def rewind(self) -> None:
        """Clear stream state, keep the header (audio.go:149-154)."""
        self._lib.ap_rewind(self._h)

    def unconsumed(self) -> int:
        return int(self._lib.ap_unconsumed(self._h))

    def parse_next_frame(self) -> Optional[np.ndarray]:
        out = np.zeros((36, 2, 32), np.int32)
        if self._lib.ap_parse_frame(self._h, out.reshape(-1)):
            return out
        return None


class NativeDemuxer:
    """Streaming native MPEG-PS demuxer: feed PS bytes, pull packets.

    Mirrors the Python Demux's packet hot path (demux.py decode();
    reference demux.go:478-584); seek/start-time/duration stay on the
    Python demuxer (control plane)."""

    def __init__(self, data: Optional[bytes] = None):
        self._lib = load()
        self._h = self._lib.dx_create()
        if data is not None:
            self.feed(data)
            self.signal_end()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dx_destroy(self._h)
            self._h = None

    def feed(self, data: bytes) -> None:
        self._lib.dx_feed(self._h, bytes(data), len(data))

    def signal_end(self) -> None:
        self._lib.dx_signal_end(self._h)

    def has_headers(self) -> bool:
        return bool(self._lib.dx_has_headers(self._h))

    def get_num_video_streams(self) -> int:
        self.has_headers()
        return self._lib.dx_num_video_streams(self._h)

    def get_num_audio_streams(self) -> int:
        self.has_headers()
        return self._lib.dx_num_audio_streams(self._h)

    def decode(self):
        """Next packet as (type, pts, payload bytes) or None."""
        typ = ctypes.c_int32()
        pts = ctypes.c_double()
        length = ctypes.c_int64()
        if not self._lib.dx_decode(self._h, ctypes.byref(typ),
                                   ctypes.byref(pts), ctypes.byref(length)):
            return None
        payload = ctypes.string_at(self._lib.dx_payload(self._h),
                                   length.value)
        return typ.value, pts.value, payload


class NativePipeline:
    """Fully-native PS decode pipeline: demux + both ES parsers in C++,
    zero per-packet Python work.

    Exposes the SAME two-phase blob contract as NativeVideoParser
    (blob_prepare / blob_counts / blob_emit), so BatchVideoDecoder can
    consume .mpg program streams natively end-to-end, plus the audio
    frame pull (parse_next_audio_frame)."""

    def __init__(self, data: Optional[bytes] = None):
        self._lib = load()
        self._h = self._lib.pp_create()
        if data is not None:
            self.feed(data)
            self.signal_end()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pp_destroy(self._h)
            self._h = None

    def feed(self, data: bytes) -> None:
        self._lib.pp_feed(self._h, bytes(data), len(data))

    def signal_end(self) -> None:
        self._lib.pp_signal_end(self._h)

    def has_headers(self) -> bool:
        return bool(self._lib.pp_has_headers(self._h))

    def set_audio_stream(self, idx: int) -> None:
        self._lib.pp_set_audio_stream(self._h, idx)

    def get_num_video_streams(self) -> int:
        self.has_headers()
        return self._lib.pp_num_video_streams(self._h)

    def get_num_audio_streams(self) -> int:
        self.has_headers()
        return self._lib.pp_num_audio_streams(self._h)

    # -- video side (NativeVideoParser-compatible blob contract) ----------

    def has_header(self) -> bool:
        return bool(self._lib.pp_video_has_header(self._h))

    @property
    def width(self) -> int:
        return self._lib.pp_width(self._h)

    @property
    def height(self) -> int:
        return self._lib.pp_height(self._h)

    @property
    def framerate(self) -> float:
        return self._lib.pp_framerate(self._h)

    def geom(self):
        from .ops.video_recon import FrameGeometry
        return FrameGeometry.for_size(self.width, self.height)

    def blob_prepare(self) -> int:
        return self._lib.pp_video_blob_prepare(self._h)

    def blob_counts(self) -> tuple[int, int]:
        out = np.zeros(2, np.int64)
        self._lib.pp_video_blob_counts(self._h, out)
        return int(out[0]), int(out[1])

    def blob_emit(self, main_rec, esc_didx, esc_val,
                  mvh, mvv, nbcls, misc, idx_base: int,
                  prev_m: int = 0, prev_e: int = 0):
        io = np.array([prev_m, prev_e, 0, 0], np.int64)
        flags = int(self._lib.pp_video_blob_emit(
            self._h, main_rec, esc_didx, esc_val,
            mvh, mvv, nbcls, misc, idx_base, io))
        return flags, int(io[2]), int(io[3]), int(io[0]), int(io[1])

    _window_fn = "pp_blob_window"
    blob_window = NativeVideoParser.blob_window

    def parse_next_plan(self):
        """Dense single-picture pull; returns (plan, picture_type) or
        None — same contract as NativeVideoParser.parse_next_plan,
        demuxing internally."""
        if not self.has_header():
            return None
        from .video import _PicturePlan
        mb = ((self.width + 15) >> 4) * ((self.height + 15) >> 4)
        plan = _PicturePlan(mb)
        ptype = self._lib.pp_parse_picture(
            self._h, plan.coeffs.reshape(-1), plan.nblocks.reshape(-1),
            plan.intra_blk.reshape(-1), plan.src_sel, plan.mv_h, plan.mv_v)
        if ptype == 0:
            return None
        return plan, ptype

    # -- seek / routing control (native seek protocol) ----------------------

    def reset(self) -> None:
        """Clear stream state for a mid-stream re-feed; demux header
        info, video sequence state and audio header state are kept."""
        self._lib.pp_reset(self._h)

    def set_video_enabled(self, on: bool) -> None:
        self._lib.pp_set_video_enabled(self._h, 1 if on else 0)

    def set_audio_enabled(self, on: bool) -> None:
        self._lib.pp_set_audio_enabled(self._h, 1 if on else 0)

    DROP_ALL = -1.0
    ROUTE_ALL = -2.0

    def audio_set_drop(self, mode: float) -> None:
        """-2 route all, -1 drop all, >=0 drop until a packet's pts
        exceeds the threshold (that PTS is latched for audio_kept_pts)."""
        self._lib.pp_audio_set_drop(self._h, mode)

    def audio_kept_pts(self) -> float:
        """PTS of the first audio packet routed after a >=0 drop
        threshold, or -1 while still dropping."""
        return self._lib.pp_audio_kept_pts(self._h)

    def occupancy(self) -> int:
        """Bytes buffered across demux window + both ES buffers."""
        return int(self._lib.pp_occupancy(self._h))

    def demux_backlog(self) -> int:
        """Bytes fed but not yet demux-consumed (feed offset minus this
        is the live absolute demux position)."""
        return int(self._lib.pp_demux_backlog(self._h))

    # -- audio side ---------------------------------------------------------

    def audio_has_header(self) -> bool:
        return bool(self._lib.pp_audio_has_header(self._h))

    @property
    def samplerate(self) -> int:
        return self._lib.pp_samplerate(self._h)

    @property
    def channels(self) -> int:
        return self._lib.pp_channels(self._h)

    def parse_next_audio_frame(self) -> Optional[np.ndarray]:
        out = np.zeros((36, 2, 32), np.int32)
        if self._lib.pp_audio_parse_frame(self._h, out.reshape(-1)):
            return out
        return None
