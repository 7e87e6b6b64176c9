"""Interactive decoders backed by the fully-native PS pipeline.

Port of `mpeg_tpu/pipeline.py`.  The reference's high-level API runs its
whole hot path in one language: starving decoders re-enter the demuxer
through load callbacks with zero marshaling (reference mpeg.go:634-669).
These classes are the equivalent for the MPEG class: demux + both ES
parsers live in ONE C++ object (native.NativePipeline); Python work on
the steady-state path is one reader chunk feed per ~128 KiB plus the
per-picture/per-frame device work — no per-packet routing, no byte
marshaling between stream buffers.

Seek follows the native re-feed protocol: the (Python) control-plane
demuxer finds the intra packet byte offset (demux.py seek — reference
contract demux.go:216-349), the pipeline is reset (keeping demux header +
video sequence + audio header state, exactly what Rewind preserves in the
reference: video.go:195-201, audio.go:149-154) and the feeder re-feeds
from that offset.  Audio resync uses a PTS gate in the C++ router
(mpeg.go:544-573 semantics): packets are dropped until one with
pts > threshold arrives; its PTS anchors the audio clock.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np

from .audio import Audio
from .buffer import Buffer
from .utils import profiling
from .video import Video


class ReaderFeeder:
    """Sequential chunk feed from a shared seekable reader into the
    native pipeline.

    The control-plane Buffer (Python demuxer: seek/start-time/duration
    estimation) shares the same file object, so the reader position is
    saved and restored around every chunk read."""

    def __init__(self, reader, chunk_size: int):
        self.reader = reader
        self.chunk_size = chunk_size
        self.pos = 0
        self.ended = False

    def feed_next(self, pipe) -> bool:
        """Feed one chunk; False when the source is exhausted (the
        pipeline's end is signaled exactly once)."""
        if self.ended:
            return False
        save = self.reader.seek(0, io.SEEK_CUR)
        self.reader.seek(self.pos, io.SEEK_SET)
        data = self.reader.read(self.chunk_size)
        self.reader.seek(save, io.SEEK_SET)
        if not data:
            self.ended = True
            pipe.signal_end()
            return False
        self.pos += len(data)
        pipe.feed(data)
        return True

    def reset(self, pos: int = 0) -> None:
        self.pos = pos
        self.ended = False


class TeeFeeder:
    """Single-pass chunk feed for NON-seekable sources (pipes, sockets,
    push-style readers): every chunk read from the reader is fed to the
    native pipeline AND — up to `control_cap` bytes — appended to the
    retained control-plane Buffer the Python demuxer uses for headers,
    probing and start-time estimation.

    This mirrors the reference's degradation for non-seekable sources
    (buffer.go:74-76: Seekable() is false; mpeg.go:137,515 document
    Probe/Seek as seekable-only): steady-state decode runs at full
    native-pipeline speed, while seek targets cannot be located and
    duration is estimated only over the buffered prefix."""

    CONTROL_CAP = 16 << 20   # control-plane window for headers/start-time

    def __init__(self, reader, control_buf, pipe, chunk_size: int,
                 control_cap: int = None):
        self.reader = reader
        self.control = control_buf
        self.pipe = pipe
        self.chunk_size = chunk_size
        self.control_cap = control_cap or self.CONTROL_CAP
        self.pos = 0
        self.ended = False

    def feed_next(self, pipe=None) -> bool:
        """Feed one chunk to the pipeline (and the control window);
        False when the source is exhausted."""
        if self.ended:
            return False
        data = self.reader.read(self.chunk_size)
        if not data:
            self.ended = True
            self.pipe.signal_end()
            self.control.signal_end()
            return False
        self.pos += len(data)
        self.pipe.feed(data)
        if self.pos <= self.control_cap:
            self.control.write(data)
        return True

    def control_refill(self, _buffer=None) -> None:
        """Load callback for the control Buffer — the refill is the tee,
        so the pipeline sees every byte exactly once, in order."""
        self.feed_next()

    def reset(self, pos: int = 0) -> None:
        """Non-seekable: the stream cannot be re-read; position state is
        left untouched (reference contract: rewind/seek need a seekable
        reader, buffer.go:74-76)."""


class PipelineVideo(Video):
    """Video surface over the native pipeline: decode() has C++ parse each
    picture (demuxing internally) and emit its blob, then reconstructs on
    the device — same rotation/flush semantics as Video."""

    def __init__(self, pipe, feeder: ReaderFeeder, backend: str = None,
                 config=None, *, device="cuda"):
        self._pipe = pipe
        self._feeder = feeder
        super().__init__(Buffer(None), backend=backend, parser="native",
                         config=config, device=device)

    # -- pipeline plumbing (replaces the push-buffer marshaling) -----------

    def _native_feed(self) -> bool:
        if self._native is None:
            self._native = self._pipe
        return False

    def _native_ended(self) -> bool:
        return self._feeder.ended

    def has_ended(self) -> bool:
        return self._feeder.ended

    def _native_has_header(self) -> bool:
        self._native_feed()
        while not self._pipe.has_header():
            if not self._feeder.feed_next(self._pipe):
                if not self._pipe.has_header():
                    return False
                break
        if not self.has_sequence_header:
            self.width = self._pipe.width
            self.height = self._pipe.height
            self.frame_rate = self._pipe.framerate
            self._init_geometry()
            self.has_sequence_header = True
        return True

    def _native_next_plan(self):
        """The next picture prepared in the pipeline's parser, demuxing
        and feeding as it needs: (None, picture_type), or None at the
        end (`Video._native_next_plan`'s contract)."""
        with profiling.span("mpeg.video.plan", self._key):
            while True:
                ptype = self._pipe.blob_prepare()
                if ptype:
                    return None, ptype
                if not self._feeder.feed_next(self._pipe):
                    ptype = self._pipe.blob_prepare()
                    return (None, ptype) if ptype else None

    def rewind(self) -> None:
        """Clock/reference reset only — the owning MPEG resets the
        pipeline itself (pp_reset keeps the sequence state, exactly like
        the reference's Video.Rewind, video.go:195-201)."""
        self.time = 0.0
        self.frames_decoded = 0
        self.has_reference_frame = False
        self.start_code = -1


class _PipelineAudioES:
    """Audio-shaped view of the pipeline for Audio's native plumbing
    (NativePipeline.has_header() is the VIDEO header)."""

    def __init__(self, pipe):
        self._pipe = pipe

    def has_header(self) -> bool:
        return self._pipe.audio_has_header()

    @property
    def samplerate(self) -> int:
        return self._pipe.samplerate

    @property
    def channels(self) -> int:
        return self._pipe.channels

    def parse_next_frame(self) -> Optional[np.ndarray]:
        return self._pipe.parse_next_audio_frame()

    def rewind(self) -> None:
        pass   # the owning MPEG resets the pipeline

    def unconsumed(self) -> int:
        return 0


class PipelineAudio(Audio):
    """Audio surface over the native pipeline; supports the post-seek
    PTS anchor latched by the C++ router."""

    def __init__(self, pipe, feeder: ReaderFeeder, backend: str = None,
                 config=None, *, device="cuda"):
        self._pipe = pipe
        self._feeder = feeder
        self._anchor_pending = False
        self._anchor_base = 0.0
        super().__init__(Buffer(None), backend=backend, parser="native",
                         config=config, device=device)

    def _native_feed(self) -> bool:
        if self._native is None:
            self._native = _PipelineAudioES(self._pipe)
        return False

    def _native_ended(self) -> bool:
        return self._feeder.ended

    def has_ended(self) -> bool:
        return self._feeder.ended

    def _native_has_header(self) -> bool:
        self._native_feed()
        while not self._native.has_header():
            if not self._feeder.feed_next(self._pipe):
                break
        self._native_sync_header()
        return self.has_header_flag

    def begin_anchor(self, start_time: float) -> None:
        """Arm the post-seek clock anchor: the first frame decoded after
        the router resumes (pts > threshold) re-bases the audio clock to
        kept_pts - start_time (reference SetTime at packet write,
        mpeg.go:560-566)."""
        self._anchor_pending = True
        self._anchor_base = start_time

    def _maybe_anchor(self) -> None:
        if not self._anchor_pending:
            return
        pts = self._pipe.audio_kept_pts()
        if pts >= 0.0:
            self.set_time(pts - self._anchor_base)
            self._anchor_pending = False

    def _native_next_frame(self):
        with profiling.span("mpeg.audio.frame", self._key):
            self._native_feed()
            while True:
                out = self._native.parse_next_frame()
                if out is None and not self._feeder.feed_next(self._pipe):
                    out = self._native.parse_next_frame()
                    if out is None:
                        return None
                if out is not None:
                    self._native_sync_header()
                    self._maybe_anchor()
                    return out

    def rewind(self) -> None:
        """Clock reset only — the owning MPEG resets the pipeline."""
        self.time = 0.0
        self.samples_decoded = 0
        self.next_frame_data_size = 0
