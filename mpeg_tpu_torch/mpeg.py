"""High-level MPEG-PS API: demuxer + video + audio with timing and sync.

Port of `mpeg_tpu/mpeg.py`; the decoders run on `device`.  Mirrors the
reference MPEG type (reference mpeg.go:48-669): one
demuxer feeding per-stream push buffers whose load callbacks re-enter the
demuxer — when a decoder starves, packets are pulled and routed until one
of the requested type arrives, transparently buffering data for the other
decoder.

Two usage styles (mpeg.go:6-16):

1. `decode(tick)` — clock-driven: advances the internal timer and fires
   the video/audio callbacks any number of times.
2. `decode_video()` / `decode_audio()` — one frame at a time; you own the
   synchronization.
"""

from __future__ import annotations

import io
from typing import Callable, Optional

from .audio import Audio, Samples
from .buffer import Buffer
from .demux import (
    Demux, InvalidHeaderError, PACKET_AUDIO_1, PACKET_VIDEO_1,
)
from .device import resolve_device
from .utils import profiling
from .video import Frame, Video, _check_backend


class InvalidMpegError(Exception):
    """The source is not a valid MPEG Program Stream (mpeg.go:55)."""


VideoCallback = Callable[["MPEG", Frame], None]
AudioCallback = Callable[["MPEG", Samples], None]


class MPEG:
    """High-level interface over an MPEG-PS source.

    With the native parser (the default when the C++ library builds) and
    a seekable source, the steady-state hot path is the fully-native
    pipeline: demux + both ES parsers in one C++ object, zero per-packet
    Python work (the reference analog is the load-callback re-entry at
    mpeg.go:634-669, which likewise never leaves Go).  The Python demuxer
    stays as the control plane: probing, start-time/duration estimation
    and the byte-rate seek search.

    `backend`: "torch" (or None: `config.backend`, "torch" by default);
    the JAX package's "jax" and "numpy" raise.  `device`: where the
    decoders reconstruct video and synthesize audio, "cuda" (the default;
    raises without a card) or "cpu"."""

    def __init__(self, reader, backend: str = None, config=None, *,
                 device="cuda"):
        self._key = profiling.new_key()
        with profiling.span("mpeg.open", self._key):
            if isinstance(reader, (bytes, bytearray)):
                with profiling.span("mpeg.open.copy", self._key):
                    reader = io.BytesIO(reader)

            from .config import DEFAULT
            self.config = config if config is not None else DEFAULT
            self.backend = _check_backend(backend, self.config, ("torch",))
            self.device = resolve_device(device)
            buf = Buffer(reader, chunk_size=self.config.buffer_size)
            self._seekable = buf.seekable()

            # Engine selection BEFORE the first read: both source classes
            # run the fully-native pipeline (demux + ES parsers in one C++
            # object, zero per-packet Python).  Seekable sources use an
            # independent sequential feeder; non-seekable sources (pipes,
            # push-style readers) are single-pass, so one TeeFeeder reads
            # each chunk exactly once and fans it out to the pipeline and
            # the control-plane window — with seek/rewind degraded exactly
            # as the reference degrades non-seekable sources
            # (buffer.go:74-76; mpeg.go:137,515).
            self._pipeline = None
            self._feeder = None
            parser = self.config.parser
            if parser == "auto":
                from . import native as native_mod
                parser = "native" if native_mod.available() else "python"
            if parser == "native":
                from . import native as native_mod
                if native_mod.available():
                    with profiling.span("mpeg.open.parser", self._key):
                        self._pipeline = native_mod.NativePipeline()
                    if self._seekable:
                        from .pipeline import ReaderFeeder
                        buf.set_load_callback(buf.load_reader_callback)
                        self._feeder = ReaderFeeder(reader,
                                                    self.config.buffer_size)
                    else:
                        from .pipeline import TeeFeeder
                        buf = Buffer(None)
                        buf.discard_read = False
                        self._feeder = TeeFeeder(reader, buf, self._pipeline,
                                                 self.config.buffer_size)
                        buf.set_load_callback(self._feeder.control_refill)
            if self._pipeline is None:
                buf.set_load_callback(buf.load_reader_callback)

            if not buf.has(32):
                raise InvalidMpegError("invalid MPEG-PS")
            if bytes(buf.bytes()[0:4]) != b"\x00\x00\x01\xBA":
                raise InvalidMpegError("invalid MPEG-PS")
            buf.rewind()

            try:
                self.demux = Demux(buf)
            except InvalidHeaderError as e:
                raise InvalidMpegError(str(e)) from e

            self.time = 0.0
            self.loop = False
            self._has_ended = False
            self.done = False
            self.has_decoders = False

            self.video_enabled = True
            self.video_packet_type = 0
            self.video_buffer: Optional[Buffer] = None
            self.video_decoder: Optional[Video] = None

            self.audio_enabled = True
            self.audio_packet_type = 0
            self.audio_stream_index = 0
            self.audio_lead_time = self.config.audio_lead_time
            self.audio_buffer: Optional[Buffer] = None
            self.audio_decoder: Optional[Audio] = None

            self.video_callback: Optional[VideoCallback] = None
            self.audio_callback: Optional[AudioCallback] = None

            self._init_decoders()

    # -- headers / probing ---------------------------------------------------

    def has_headers(self) -> bool:
        if not self.demux.has_headers():
            return False
        if not self._init_decoders():
            return False
        if (self.video_decoder is not None and
                not self.video_decoder.has_header()) or \
           (self.audio_decoder is not None and
                not self.audio_decoder.has_header()):
            return False
        return True

    def probe(self, probe_size: int) -> bool:
        """Probe for the actual number of streams (more reliable than the
        system header for e.g. VideoCD)."""
        if not self.demux.probe(probe_size):
            return False
        self.has_decoders = False
        self.video_packet_type = 0
        self.audio_packet_type = 0
        return self._init_decoders()

    # -- stream selection / config -------------------------------------------

    def video(self) -> Optional[Video]:
        return self.video_decoder

    def audio(self) -> Optional[Audio]:
        return self.audio_decoder

    def set_video_callback(self, callback: Optional[VideoCallback]) -> None:
        self.video_callback = callback

    def set_audio_callback(self, callback: Optional[AudioCallback]) -> None:
        self.audio_callback = callback

    def set_video_enabled(self, enabled: bool) -> None:
        self.video_enabled = enabled
        if self._pipeline is not None:
            self._pipeline.set_video_enabled(enabled)
        if not enabled:
            self.video_packet_type = 0
            return
        if self._init_decoders() and self.video_decoder is not None:
            self.video_packet_type = PACKET_VIDEO_1
        else:
            self.video_packet_type = 0

    def set_audio_enabled(self, enabled: bool) -> None:
        self.audio_enabled = enabled
        if self._pipeline is not None:
            self._pipeline.set_audio_enabled(enabled)
        if not enabled:
            self.audio_packet_type = 0
            return
        if self._init_decoders() and self.audio_decoder is not None:
            self.audio_packet_type = PACKET_AUDIO_1 + self.audio_stream_index
        else:
            self.audio_packet_type = 0

    def set_audio_stream(self, stream_index: int) -> None:
        """Select the audio stream, 0-3 (mpeg.go:271-279)."""
        if not 0 <= stream_index <= 3:
            return
        self.audio_stream_index = stream_index
        if self._pipeline is not None:
            self._pipeline.set_audio_stream(stream_index)
        self.set_audio_enabled(self.audio_enabled)

    def audio_format(self) -> int:
        return self.audio_decoder.format

    def set_audio_format(self, fmt: int) -> None:
        self.audio_decoder.format = fmt
        self.audio_decoder.samples.format = fmt

    def set_audio_lead_time(self, lead_time: float) -> None:
        """Seconds of audio decoded ahead of video (mpeg.go:305-310)."""
        self.audio_lead_time = lead_time

    def set_loop(self, loop: bool) -> None:
        self.loop = loop

    # -- metadata ------------------------------------------------------------

    def num_video_streams(self) -> int:
        return self.demux.get_num_video_streams()

    def num_audio_streams(self) -> int:
        return self.demux.get_num_audio_streams()

    def width(self) -> int:
        if self._init_decoders() and self.video_decoder is not None:
            return self.video_decoder.get_width()
        return 0

    def height(self) -> int:
        if self._init_decoders() and self.video_decoder is not None:
            return self.video_decoder.get_height()
        return 0

    def framerate(self) -> float:
        if self._init_decoders() and self.video_decoder is not None:
            return self.video_decoder.framerate()
        return 0

    def samplerate(self) -> int:
        if self._init_decoders() and self.audio_decoder is not None:
            return self.audio_decoder.samplerate()
        return 0

    def channels(self) -> int:
        if self._init_decoders() and self.audio_decoder is not None:
            return self.audio_decoder.get_channels()
        return 0

    def get_time(self) -> float:
        return self.time

    def duration(self) -> float:
        return self.demux.get_duration(PACKET_VIDEO_1)

    def has_ended(self) -> bool:
        return self._has_ended

    def buffer_occupancy(self) -> int:
        """Bytes currently buffered across the demux window and both
        stream buffers (bounded-memory observability)."""
        occ = len(self.demux.buf.bytes())
        if self._pipeline is not None:
            occ += self._pipeline.occupancy()
        else:
            if self.video_buffer is not None:
                occ += len(self.video_buffer.bytes())
            if self.audio_buffer is not None:
                occ += len(self.audio_buffer.bytes())
        return occ

    # -- decode --------------------------------------------------------------

    def _source_has_ended(self) -> bool:
        """End of the packet source: the feeder in pipeline mode (the
        Python demuxer never consumes there), the demuxer otherwise."""
        if self._pipeline is not None:
            return self._feeder.ended
        return self.demux.has_ended()

    def rewind(self) -> None:
        if self._pipeline is not None and not self._seekable:
            # Non-seekable sources cannot be re-read (reference
            # contract: buffer.go:74-76); reset the clock only.
            self.time = 0.0
            return
        if self.video_decoder is not None:
            self.video_decoder.rewind()
        if self.audio_decoder is not None:
            self.audio_decoder.rewind()
        if self._pipeline is not None:
            self._pipeline.reset()
            self._feeder.reset(0)
        self.demux.rewind()
        self.time = 0.0
        self._has_ended = False

    def decode(self, tick: float) -> None:
        """Advance the internal timer by `tick` seconds and decode
        everything up to that time, firing callbacks (mpeg.go:356-411)."""
        with profiling.span("mpeg.decode", self._key):
            if not self._init_decoders():
                return

            decode_video = self.video_callback is not None and \
                self.video_packet_type != 0
            decode_audio = self.audio_callback is not None and \
                self.audio_packet_type != 0
            if not decode_video and not decode_audio:
                return

            decode_video_failed = False
            decode_audio_failed = False
            video_target = self.time + tick
            audio_target = self.time + tick + self.audio_lead_time

            while True:
                did_decode = False

                if decode_video and \
                        self.video_decoder.get_time() < video_target:
                    frame = self.video_decoder.decode()
                    if frame is not None:
                        self.video_callback(self, frame)
                        did_decode = True
                    else:
                        decode_video_failed = True

                if decode_audio and \
                        self.audio_decoder.get_time() < audio_target:
                    samples = self.audio_decoder.decode()
                    if samples is not None:
                        self.audio_callback(self, samples)
                        did_decode = True
                    else:
                        decode_audio_failed = True

                if not did_decode:
                    break

            if (not decode_video or decode_video_failed) and \
                    (not decode_audio or decode_audio_failed) and \
                    self._source_has_ended():
                self._handle_end()
                return

            self.time += tick

    def decode_video(self) -> Optional[Frame]:
        """Decode and return one video frame (mpeg.go:416-433)."""
        if not self._init_decoders():
            return None
        if self.video_packet_type == 0:
            return None
        frame = self.video_decoder.decode()
        if frame is not None:
            self.time = frame.time
        elif self._source_has_ended():
            self._handle_end()
        return frame

    def decode_audio(self) -> Optional[Samples]:
        """Decode and return one audio frame (mpeg.go:438-455)."""
        if not self._init_decoders():
            return None
        if self.audio_packet_type == 0:
            return None
        samples = self.audio_decoder.decode()
        if samples is not None:
            self.time = samples.time
        elif self._source_has_ended():
            self._handle_end()
        return samples

    # -- seeking -------------------------------------------------------------

    def seek_frame(self, tm: float, seek_exact: bool) -> Optional[Frame]:
        """Seek without firing callbacks or syncing audio
        (mpeg.go:460-512)."""
        if not self._init_decoders():
            return None
        if self.video_packet_type == 0:
            return None
        if not self._seekable:
            # Seek targets cannot be located on a single-pass source
            # (reference: Seek is documented seekable-only, mpeg.go:515).
            return None

        typ = self.video_packet_type
        start_time = self.demux.get_start_time(typ)
        duration = self.demux.get_duration(typ)
        tm = max(0.0, min(tm, duration))

        if self._pipeline is not None:
            # Control-plane demuxer: sync to the live decode position
            # (feed offset minus the un-demuxed backlog) so the byte-rate
            # estimator starts from a truthful (position, PTS) anchor.
            live = self._feeder.pos - self._pipeline.demux_backlog()
            self.demux.reanchor(live, start_time + self.time)

        packet = self.demux.seek(tm, typ, force_intra=True)
        if packet is None:
            return None

        # Disable audio buffer writes while decoding video.
        prev_audio_packet_type = self.audio_packet_type
        self.audio_packet_type = 0

        if self._pipeline is not None:
            # Native seek protocol: reset the pipeline (keeps demux
            # header + sequence/header state) and re-feed from the intra
            # packet's byte offset; audio packets are dropped natively
            # while the video side decodes (mpeg.go:485-487 analog).
            self._pipeline.reset()
            self._pipeline.audio_set_drop(self._pipeline.DROP_ALL)
            self._feeder.reset(self.demux.last_seek_offset)
            self.video_decoder.rewind()
            self.video_decoder.set_time(packet.pts - start_time)
            frame = self.video_decoder.decode()
            if seek_exact:
                while frame is not None and frame.time < tm:
                    frame = self.video_decoder.decode()
            self._pipeline.audio_set_drop(self._pipeline.ROUTE_ALL)
        else:
            self.video_decoder.rewind()
            self.video_decoder.set_time(packet.pts - start_time)
            self.video_buffer.write(packet.data)
            frame = self.video_decoder.decode()

            # Exact seek: decode forward over P/B frames on the intra.
            if seek_exact:
                while frame is not None and frame.time < tm:
                    frame = self.video_decoder.decode()

        self.audio_packet_type = prev_audio_packet_type

        if frame is not None:
            self.time = frame.time
        self._has_ended = False
        return frame

    def seek(self, tm: float, seek_exact: bool) -> bool:
        """Seek, fire the video callback exactly once, and resync audio up
        to the lead time (mpeg.go:524-576)."""
        frame = self.seek_frame(tm, seek_exact)
        if frame is None:
            return False

        if self.video_callback is not None:
            self.video_callback(self, frame)

        if self.audio_packet_type == 0:
            return True

        # Sync audio: demux until the first audio packet past the current
        # time, then decode enough to satisfy the lead time.
        start_time = self.demux.get_start_time(self.video_packet_type)
        self.audio_decoder.rewind()

        if self._pipeline is not None:
            # Native resync: the C++ router drops audio packets until one
            # with pts > start_time + time arrives; its PTS re-anchors the
            # audio clock at the first decoded frame.
            self._pipeline.audio_set_drop(start_time + self.time)
            self.audio_decoder.begin_anchor(start_time)
            prev_audio_packet_type = self.audio_packet_type
            self.audio_packet_type = 0
            self.decode(0)
            self.audio_packet_type = prev_audio_packet_type
            self.decode(0)
            return True

        while True:
            packet = self.demux.decode()
            if packet is None:
                break
            if packet.type == self.video_packet_type:
                self.video_buffer.write(packet.data)
            elif packet.type == self.audio_packet_type and \
                    packet.pts - start_time > self.time:
                self.audio_decoder.set_time(packet.pts - start_time)
                self.audio_buffer.write(packet.data)

                prev_audio_packet_type = self.audio_packet_type
                self.audio_packet_type = 0
                self.decode(0)
                self.audio_packet_type = prev_audio_packet_type
                self.decode(0)
                break

        return True

    # -- internals -----------------------------------------------------------

    def _init_decoders(self) -> bool:
        if self.has_decoders:
            return True
        if not self.demux.has_headers():
            return False

        if self.demux.get_num_video_streams() > 0:
            if self.video_enabled:
                self.video_packet_type = PACKET_VIDEO_1
            if self.video_decoder is None:
                if self._pipeline is not None:
                    from .pipeline import PipelineVideo
                    self.video_decoder = PipelineVideo(
                        self._pipeline, self._feeder, self.backend,
                        self.config, device=self.device)
                else:
                    self.video_buffer = Buffer(None)
                    self.video_buffer.set_load_callback(
                        self._read_video_packet)
                    self.video_decoder = Video(self.video_buffer,
                                               backend=self.backend,
                                               parser=self.config.parser,
                                               device=self.device)

        if self.demux.get_num_audio_streams() > 0:
            if self.audio_enabled:
                self.audio_packet_type = \
                    PACKET_AUDIO_1 + self.audio_stream_index
            if self.audio_decoder is None:
                if self._pipeline is not None:
                    from .pipeline import PipelineAudio
                    self.audio_decoder = PipelineAudio(
                        self._pipeline, self._feeder, self.backend,
                        self.config, device=self.device)
                else:
                    self.audio_buffer = Buffer(None)
                    self.audio_buffer.set_load_callback(
                        self._read_audio_packet)
                    self.audio_decoder = Audio(self.audio_buffer,
                                               backend=self.backend,
                                               parser=self.config.parser,
                                               device=self.device)
                if self.config.audio_format:
                    self.set_audio_format(self.config.audio_format)

        # The clip's spans share one key, the decoders' and this MPEG's.
        for dec in (self.video_decoder, self.audio_decoder):
            if dec is not None:
                dec._key = self._key
        self.has_decoders = True
        return True

    def _handle_end(self) -> None:
        if self.loop:
            self.rewind()
        else:
            self._has_ended = True
            self.done = True

    def _read_video_packet(self, _buffer: Buffer) -> None:
        self._read_packets(self.video_packet_type)

    def _read_audio_packet(self, _buffer: Buffer) -> None:
        self._read_packets(self.audio_packet_type)

    def _read_packets(self, requested_type: int) -> None:
        """Pull demux packets, routing payloads to the stream buffers,
        until a packet of the requested type arrives (mpeg.go:642-669)."""
        while True:
            packet = self.demux.decode()
            if packet is None:
                break
            if packet.type == self.video_packet_type:
                self.video_buffer.write(packet.data)
            elif packet.type == self.audio_packet_type:
                self.audio_buffer.write(packet.data)
            if packet.type == requested_type:
                return

        if self.demux.has_ended():
            if self.video_buffer is not None:
                self.video_buffer.signal_end()
            if self.audio_buffer is not None:
                self.audio_buffer.signal_end()
