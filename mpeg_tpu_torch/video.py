"""MPEG-1 Video (mpeg1video) decoder on a torch device.

Port of `mpeg_tpu/video.py`:

- host parse (this file, or the C++ parser through `native`): sequence,
  picture and slice headers, macroblock address/type/CBP VLCs, motion
  vector decode, DC prediction and the AC run/level VLC loop with
  dequantize+oddify+clip+premultiply (video.go:374-745); the Python
  parser fills one dense picture plan per picture, the C++ parser keeps
  each picture inside itself;
- reconstruction on `device` (backend "torch", the default): each
  picture ships as a one-picture window blob, the batch decoders'
  transport (packed from the dense plan, or written by the C++ parser's
  emitter with no plan), and `parallel.batch.PictureBlobRecon` densifies
  it and launches K1 (`ops.cuda_kernels.reconstruct_picture`; on the CPU,
  its plain version) once.

Backend "plan" parses only: `parse_next_plan` hands the plans to the
batch decoders (`BatchVideoDecoder(use_native=False)`).  The JAX
package's "jax" and "numpy" backends have no counterpart here: the port
runs the kernels with device="cuda" and their plain versions with
device="cpu".  The pixel path is all-integer and bit-exact against the
reference (golden hash 0xea6d7fcb1340ba3f).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import tables as T
from .buffer import Buffer, CorruptStream
from .device import resolve_device
from .ops.color import flat_frame_to_rgba
from .ops.video_recon import FrameGeometry
from .utils import profiling


class Frame:
    """One decoded video frame.

    Planes live in a single flat padded buffer shared by Y/Cb/Cr exactly
    like the reference (video.go:333-372): `flat`, a uint8 tensor on the
    decoder's device.  `y`, `cb`, `cr`, `ycbcr()`, `rgba()` and `pixels()`
    are host numpy arrays (macroblock-rounded plane sizes, as the
    reference's plane Data slices); each access copies the frame from the
    device once.
    """

    def __init__(self, geom: FrameGeometry, flat: torch.Tensor):
        self.geom = geom
        self.time = 0.0
        self.flat = flat

    def _np_flat(self) -> np.ndarray:
        return self.flat.cpu().numpy()

    def _planes(self, flat: np.ndarray):
        g = self.geom
        cb0 = g.luma_size
        cr0 = cb0 + g.chroma_size
        return (flat[:cb0].reshape(g.luma_height, g.luma_width),
                flat[cb0:cr0].reshape(g.chroma_height, g.chroma_width),
                flat[cr0:cr0 + g.chroma_size].reshape(g.chroma_height,
                                                      g.chroma_width))

    @property
    def width(self) -> int:
        return self.geom.width

    @property
    def height(self) -> int:
        return self.geom.height

    @property
    def y(self) -> np.ndarray:
        return self._planes(self._np_flat())[0]

    @property
    def cb(self) -> np.ndarray:
        return self._planes(self._np_flat())[1]

    @property
    def cr(self) -> np.ndarray:
        return self._planes(self._np_flat())[2]

    def ycbcr(self):
        """Planar YCbCr 4:2:0, display-cropped — the Python analog of the
        reference's Frame.YCbCr() image.YCbCr wrapper (video.go:26-35):
        (Y, Cb, Cr) numpy views of one host copy of the frame, sliced to
        the display rectangle (the raw `y`/`cb`/`cr` properties keep the
        macroblock-rounded storage sizes, as the reference's plane Data
        slices do)."""
        y, cb, cr = self._planes(self._np_flat())
        ch, cw = (self.height + 1) // 2, (self.width + 1) // 2
        return y[:self.height, :self.width], cb[:ch, :cw], cr[:ch, :cw]

    def rgba(self) -> np.ndarray:
        """Display-size [height, width, 4] RGBA via the exact integer
        BT.601 conversion of Go's image/color (parity: Frame.RGBA),
        computed on the frame's device."""
        return flat_frame_to_rgba(self.flat, self.geom).cpu().numpy()

    def pixels(self) -> np.ndarray:
        return self.rgba().reshape(-1, 4)


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


def _check_backend(backend, cfg, allowed=("torch", "plan")) -> str:
    """The backend an entry point runs: `backend`, or `cfg.backend` when it
    is None.  The JAX package's "jax" and "numpy" raise, as does any name
    outside `allowed` (`MPEG` and `Audio` allow only "torch")."""
    backend = backend if backend is not None else cfg.backend
    if backend in ("jax", "numpy"):
        raise ValueError(
            f"backend={backend!r} is the JAX package's; the port has the "
            "\"torch\" backend: device=\"cuda\" runs the kernels, "
            "device=\"cpu\" their plain versions")
    if backend not in allowed:
        raise ValueError(f"unknown backend {backend!r} (expected "
                         + " or ".join(f'"{b}"' for b in allowed) + ")")
    return backend


class Video:
    """MPEG-1 video decoder: pulls an ES from `buf`, yields Frames."""

    def __init__(self, buf: Buffer, backend: str = None,
                 parser: str = None, config=None, *, device="cuda"):
        """`backend`: "torch" (reconstruct on `device`) or "plan" (parse
        only; the frames stay on the CPU).  `parser`: "python", "native"
        (C++) or "auto" (native when available, python otherwise).  Unset,
        both fall back to `config` (default config.DEFAULT).  `device`:
        "cuda" (the default; raises without a card) or "cpu".

        Transport: each picture ships as a delta-encoded pool-record blob
        — the batch decoders' transport (~0.1 MB per 1080p picture) — and
        reconstructs in one K1 launch, so the reference-shaped API runs
        the same kernel as the throughput decoders (parity with
        mpeg.go:416-433).
        """
        from .config import DEFAULT
        cfg = config if config is not None else DEFAULT
        backend = _check_backend(backend, cfg)
        parser = parser if parser is not None else cfg.parser
        self._key = profiling.new_key()
        self.buf = buf
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" \
            else torch.device("cpu")

        if backend == "plan":
            parser = "python"   # plan mode is the python-parse path
        elif parser == "auto":
            from . import native as native_mod
            parser = "native" if native_mod.available() else "python"
        self.parser = parser
        self._native = None        # lazy NativeVideoParser

        self.aspect_ratio = 0.0
        self.frame_rate = 0.0
        self.bit_rate = 0
        self.time = 0.0
        self.frames_decoded = 0
        self.width = 0
        self.height = 0

        self.geom: Optional[FrameGeometry] = None
        # Sticky pool-bucket capacities of the per-picture blob transport
        # and the reconstruct module built for them; the HostRing the
        # picture blobs are packed into.
        self._blob_km = 0
        self._blob_ke = 0
        self._recon = None
        self._blob_ring = None

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
        # backend="plan": _reconstruct defers each picture plan into this
        # list for parse_next_plan.
        self._pending_plans: list = []

        # Persistent coefficient scratch, replicating the reference's
        # blockData field (video.go:101): it is only partially cleared
        # between blocks — the DC-only fast path zeroes just index 0
        # (video.go:777,790) and an invalid block keeps its partial
        # coefficients — so junk-tolerant decode behavior (and the golden
        # hash) depends on the leftovers leaking into subsequent blocks.
        self._block_data = [0] * 64

        # Attempt to decode the sequence header.
        if self.parser == "native":
            self._native_has_header()
        else:
            self.start_code = self.buf.find_start_code(T.START_SEQUENCE)
            if self.start_code != -1:
                self._decode_sequence_header()

    # -- native-parser plumbing ----------------------------------------------

    def _native_feed(self) -> bool:
        """Move buffered bytes into the native parser; True if any moved."""
        if self._native is None:
            from . import native as native_mod
            self._native = native_mod.NativeVideoParser()
        data = self.buf.data
        if not data:
            return False
        self._native.feed(bytes(data))
        del data[:]
        self.buf.bit_index = 0
        return True

    def _source_ended(self) -> bool:
        """EOS for the internal parse gates: reader exhausted OR the
        owner called signal_end (push-fed streaming; buffer compaction
        defeats the reference's len==total_size inference)."""
        return self.buf.has_ended() or self.buf.end_signaled

    def _native_ended(self) -> bool:
        return self._source_ended()

    def _native_has_header(self) -> bool:
        self._native_feed()
        if not self._native.has_header():
            # one refill attempt through the pull model
            if self.buf.load_callback is not None:
                self.buf.load_callback(self.buf)
                self._native_feed()
            if not self._native.has_header():
                return False
        if not self.has_sequence_header:
            self.width = self._native.width
            self.height = self._native.height
            self.frame_rate = self._native.framerate
            self._init_geometry()
            self.has_sequence_header = True
        return True

    def _native_next_plan(self):
        """Parse the next picture into the native parser (`blob_prepare`:
        it stays there until `_reconstruct` emits it), refilling through
        the load callback exactly like the reference's pull model.
        Returns (None, picture_type), or None at the end of the data: the
        parser holds the picture, so there is no dense plan."""
        with profiling.span("mpeg.video.plan", self._key):
            while True:
                self._native_feed()
                ptype = self._native.blob_prepare()
                if ptype:
                    return None, ptype
                before = len(self.buf.data)
                if self.buf.load_callback is not None:
                    self.buf.load_callback(self.buf)
                if len(self.buf.data) == before:
                    if self._native_ended():
                        self._native.signal_end()
                        self._native_feed()
                        ptype = self._native.blob_prepare()
                        return (None, ptype) if ptype else None
                    return None

    # -- public surface (parity: video.go:123-268) ---------------------------

    def buffer(self) -> Buffer:
        return self.buf

    def has_header(self) -> bool:
        if self.has_sequence_header:
            return True
        if self.parser == "native":
            return self._native_has_header()
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

    def set_no_delay(self, no_delay: bool) -> None:
        """Assume no B-frames: reduces latency for streaming."""
        self.assume_no_b_frames = no_delay

    def get_time(self) -> float:
        return self.time

    def set_time(self, time: float) -> None:
        self.frames_decoded = int(self.frame_rate * time)
        self.time = time

    def rewind(self) -> None:
        self.buf.rewind()
        self.time = 0.0
        self.frames_decoded = 0
        self.has_reference_frame = False
        self.start_code = -1
        if self.parser == "native" and self._native is not None:
            self._native.rewind()   # keep sequence state, clear stream

    def has_ended(self) -> bool:
        return self.buf.has_ended()

    # -- checkpoint / resume (reference frames, clocks, stream position) ----

    def get_state(self) -> dict:
        """Snapshot the decode state (frames, clocks, stream position).

        The buffer position is included only for seekable sources; for
        push-fed buffers pair restore with your own re-feed.
        """
        return {
            "frames": [f.flat.cpu().numpy().copy() for f in
                       (self.frame_current, self.frame_forward,
                        self.frame_backward)],
            "time": self.time,
            "frames_decoded": self.frames_decoded,
            "has_reference_frame": self.has_reference_frame,
            "picture_type": self.picture_type,
            "start_code": self.start_code,
            "buf_tell": self._stream_pos() if self.buf.seekable() else None,
        }

    def _stream_pos(self) -> int:
        pos = self.buf.tell()
        if self.parser == "native" and self._native is not None:
            pos -= self._native.unconsumed()
        return pos

    def set_state(self, state: dict) -> None:
        """Resume from `get_state()` of this class or of the JAX package's
        Video (its frames are numpy or jax arrays)."""
        for frame, flat in zip((self.frame_current, self.frame_forward,
                                self.frame_backward), state["frames"]):
            frame.flat = torch.from_numpy(np.array(flat, np.uint8)).to(
                self.device)
        self.time = state["time"]
        self.frames_decoded = state["frames_decoded"]
        self.has_reference_frame = state["has_reference_frame"]
        self.picture_type = state["picture_type"]
        self.start_code = state["start_code"]
        if state["buf_tell"] is not None and self.buf.seekable():
            if self.parser == "native" and self._native is not None:
                self._native.rewind()
            self.buf.seek(state["buf_tell"])

    def decode(self) -> Optional[Frame]:
        """Decode one frame and advance time by 1/framerate
        (parity: video.go:209-268)."""
        if not self.has_header():
            return None
        if self.parser == "native":
            return self._decode_with_native()

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

    def _decode_with_native(self) -> Optional[Frame]:
        """decode() with the C++ parser preparing each picture (and
        `_reconstruct` emitting its blob); frame rotation/selection
        semantics identical to the python path."""
        is_ref_types = (T.PICTURE_TYPE_INTRA, T.PICTURE_TYPE_PREDICTIVE)
        frame = None
        while True:
            item = self._native_next_plan()
            if item is None:
                if self.has_reference_frame and \
                        not self.assume_no_b_frames and \
                        self._native_ended() and \
                        self.picture_type in is_ref_types:
                    self.has_reference_frame = False
                    frame = self.frame_backward
                    break
                return None

            plan, ptype = item
            self.picture_type = ptype
            frame_temp = self.frame_forward
            if ptype in is_ref_types:
                self.frame_forward = self.frame_backward
            self._plan = plan
            self._reconstruct()
            if ptype in is_ref_types:
                self.frame_backward = self.frame_current
                self.frame_current = frame_temp

            if self.assume_no_b_frames:
                frame = self.frame_backward
            elif ptype == T.PICTURE_TYPE_B:
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
        return Frame(self.geom, torch.zeros(
            self.geom.total_size, dtype=torch.uint8, device=self.device))

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
        # whole picture in one launch.
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

    def parse_next_plan(self):
        """Parse the next picture WITHOUT reconstructing (backend="plan").

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

    def _reconstruct(self) -> None:
        plan = self._plan
        if self.backend == "plan":
            self._pending_plans.append((plan, self.picture_type))
            return
        with profiling.span("mpeg.video.reconstruct", self._key):
            # Pool-record blob transport (the batch decoders' ABI with
            # window=1): this picture's nonzero coefficients as
            # delta-encoded records, reconstructed on the device.  Pool
            # buckets are sticky per decoder, like BatchVideoDecoder's.  The
            # blob is written in place into a host buffer of this Video's
            # ring (pinned for the card, two in rotation, each written
            # again only once its last copy has completed).
            from .parallel import batch as B
            if self._blob_ring is None:
                self._blob_ring = B.HostRing(self.device)
            if self.parser == "native":
                blob, nm = self._native_picture_blob()
            else:
                blob, nm = self._plan_picture_blob(plan)
            if self._recon is None or \
                    (self._recon.km, self._recon.ke) != (self._blob_km,
                                                         self._blob_ke):
                self._recon = B.PictureBlobRecon(
                    self.geom, self._blob_km, self._blob_ke).to(self.device)
            cur = self.frame_current
            with profiling.span("mpeg.video.launch", self._key):
                cur.flat = self._recon(cur.flat, self.frame_forward.flat,
                                       self.frame_backward.flat, blob,
                                       self._blob_ring, fill=nm)

    def _grow_blob_pools(self, nm: int, ne: int) -> None:
        """Size the sticky pool buckets to hold `nm` main and `ne` escape
        records; each growth counts in `pool_growths`."""
        from .parallel import batch as B
        km = max(self._blob_km, B.pool_bucket(nm, B._MIN_KM))
        ke = max(self._blob_ke, B.pool_bucket(max(ne, 1), B._MIN_KE))
        if (km, ke) != (self._blob_km, self._blob_ke):
            profiling.count("pool_growths")
            self._blob_km, self._blob_ke = km, ke

    def _plan_picture_blob(self, plan):
        """The Python parser's dense plan packed as a one-picture blob:
        (blob, main records filled)."""
        from .parallel import batch as B
        item = [(plan, self.picture_type)]
        # Records computed once and threaded through counting and packing
        # (each pass is a flatnonzero + divisibility sweep over the dense
        # plan).
        with profiling.span("mpeg.video.records", self._key):
            records = [B.plan_pool_records(plan)]
            (mi, _), (ei, _) = B._window_records(
                item, self.geom.mb_size, records)
            nm = B.delta_encode(mi)[0].size
            ne = B.delta_encode(ei)[0].size
            self._grow_blob_pools(nm, ne)
        km, ke = self._blob_km, self._blob_ke
        with profiling.span("mpeg.video.pack", self._key):
            blob = self._blob_ring.take(B.blob_layout(self.geom, 1, km, ke)[1])
            B.pack_plans_blob(item, self.geom, 1, km, ke, records=records,
                              out=blob.numpy())
        return blob, nm

    def _native_picture_blob(self):
        """The native parser's prepared picture (`blob_prepare`), emitted
        by its C++ emitter straight into a buffer of the ring as a
        one-picture blob, with no dense plan: (blob, main records filled).
        The emit writes every field of the blob, pads included."""
        from .parallel import batch as B
        # The emitter's capacity check allows for the hop records of a
        # whole picture's index span, so the buckets are sized with that
        # slack (as `_native_window_blob` sizes a window's) and the first
        # emit fits; a picture left pending grows them and emits again.
        hop_slack = (self.geom.mb_size * 6 * 64 >> 16) + 3
        types = np.zeros(1, np.int32)
        with profiling.span("mpeg.video.records", self._key):
            cm, ce = self._native.blob_counts()
            self._grow_blob_pools(cm + hop_slack, ce + hop_slack)
        with profiling.span("mpeg.video.pack", self._key):
            while True:
                km, ke = self._blob_km, self._blob_ke
                blob = self._blob_ring.take(
                    B.blob_layout(self.geom, 1, km, ke)[1])
                v = B.blob_views(blob, self.geom, 1, km, ke)
                n, nm, _, pending, _, _ = self._native.blob_window(
                    0, 1, km, ke, 0, 0, v["main_rec"], v["esc_didx"],
                    v["esc_val"], v["mv_h"], v["mv_v"], v["nbcls"],
                    v["mbmisc"], v["flags"], types)
                if n:
                    break
                if not pending:
                    raise RuntimeError("the native parser holds no "
                                       "prepared picture to emit")
                cm, ce = self._native.blob_counts()
                self._grow_blob_pools(cm + hop_slack, ce + hop_slack)
        profiling.count("native_picture_blobs")
        return blob, nm

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
