"""Batched MP2 decode: many frames of synthesis per device call.

Port of `mpeg_tpu/parallel/audio_batch.py`.  The host parse (native C++
when available) emits subband sample tensors; the device runs one window
synthesis per window (`ops.cuda_kernels.synthesize`: one K4 launch on a
CUDA device, the plain `ops.filterbank` version on the CPU), carrying the
last 15 DCT blocks.  The same launch normalizes with the exact IEEE
quotient (`out_format="f32"`) or quantizes to S16 with the integer
constant-divisor form (`"s16"`, `filterbank.s16_from_u`).  Each window's
samples are packed into a pinned host buffer of the decoder's
`parallel.batch.HostRing` and copied asynchronously (`device_put`): with
`out_device=True` no call waits for the card; otherwise the PCM's copy
back is the one wait, as the reference's `np.asarray`.

Under a `utils.profiling` collector a decoder records the batch video
decoder's spans with its own key (`mpeg.open` and `mpeg.open.parser`,
`mpeg.window`, `mpeg.parse.wait` and `mpeg.parse`, `mpeg.h2d`,
`mpeg.launch`, `mpeg.block`), `mpeg.audio.pack` around the packing of a
window's samples into the ring's buffer, and the counters
`audio_windows` and `audio_frames`.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cuda_kernels
from ..utils import profiling
from ._runahead import RunAhead
from .batch import HostRing

_FRAME_BYTES = 36 * 2 * 32 * 4   # a frame's int32 subband samples


class BatchAudioDecoder:
    """Throughput-oriented MP2 decoder: bytes in, PCM windows out."""

    def __init__(self, data: bytes, window: int = 32,
                 use_native: bool = None, streaming: bool = False,
                 stats=None, out_format: str = "f32",
                 out_device: bool = False, prefetch: bool = False, *,
                 device="cuda"):
        """streaming: bytes arrive incrementally via feed(); call
        signal_end() at source exhaustion (decode_window returns the
        frames buffered so far in the meantime).
        stats: an optional utils.profiling.DecodeStats populated per
        window (parse/synthesis timing, h2d bytes, samples).
        out_format: "f32" (normalized interleaved float32 — the golden
        contract) or "s16" (interleaved int16 quantized on the device
        with the bit-exact constant-divisor kernel, halving the d2h
        bytes — matches Samples.s16 / the reference's AudioS16 lane,
        audio.go:401-407, exactly).
        out_device: decode_window returns tensors on `device` instead of
        numpy — no d2h at all.
        window: frames per device call (rounded down to a multiple of 4,
        at least 4: the window synthesis needs 4n whole frames).
        prefetch: a producer thread parses the next window while the
        consumer synthesizes the current one.
        device: "cuda" (the default; raises without a card) or "cpu"."""
        if out_format not in ("f32", "s16"):
            raise ValueError(f"unknown out_format {out_format!r}")
        self._key = profiling.new_key()
        self.device = resolve_device(device)
        self.out_format = out_format
        self.out_device = out_device
        window = max(4, window - window % 4)   # 4n frames = 9n ring periods
        from .. import native as native_mod
        if use_native is None:
            use_native = native_mod.available()
        self.window = window
        self.native = None
        self._pipeline = None
        self._py = None
        self._native_mod = native_mod
        self._streaming = streaming
        self._use_native = use_native
        self._prefix = b""
        with profiling.span("mpeg.open", self._key):
            if use_native:
                if data or not streaming:
                    self._make_native(bytes(data))
            else:
                import io
                from ..audio import Audio
                from ..buffer import Buffer
                if streaming:
                    buf = Buffer(None)
                    if data:
                        buf.write(bytes(data))
                else:
                    buf = Buffer(io.BytesIO(bytes(data)))
                    buf.set_load_callback(buf.load_reader_callback)
                # Its parse only: the synthesis runs here, a window at a
                # time.
                self._py = Audio(buf, parser="python", device="cpu")

        self._hist = None
        self._ring = None   # HostRing of the window samples (dispatch only)
        self._ended = not streaming
        self._pending: list = []
        self.stats = stats

        # The run-ahead parse (None: inline; dropped at end of stream).
        self._runahead = None
        self._closed = False
        if prefetch:
            if streaming:
                raise ValueError("prefetch requires a complete source "
                                 "(streaming=False)")
            self._runahead = RunAhead(
                self, lambda dec: dec._parse_window(),
                lambda frames, n=window: len(frames) < n, 2)

    def close(self) -> None:
        """Stop the run-ahead parse and poison further decode (windows
        parsed ahead are discarded, so resuming would skip frames —
        decode_window returns None from now on)."""
        self._closed = True
        if self._runahead is not None:
            self._runahead.close()
            self._runahead = None

    def _make_native(self, data: bytes):
        if self._streaming:
            self._prefix += data
            if len(self._prefix) < 4:
                return
            data, self._prefix = self._prefix, b""
        with profiling.span("mpeg.open.parser", self._key):
            if data[:4] == b"\x00\x00\x01\xBA":
                # MPEG-PS container: fully-native demux + MP2 parse.
                self._pipeline = self._native_mod.NativePipeline()
                target = self._pipeline
            else:
                self.native = self._native_mod.NativeAudioParser()
                target = self.native
            target.feed(data)
            if not self._streaming:
                target.signal_end()

    def feed(self, data: bytes) -> None:
        """Streaming mode: push more source bytes (MP2 ES or PS)."""
        assert self._streaming, "construct with streaming=True to feed"
        if self._py is not None:
            self._py.buf.write(data)
        elif self.native is None and self._pipeline is None:
            self._make_native(bytes(data))
        else:
            (self._pipeline or self.native).feed(data)

    def signal_end(self) -> None:
        self._ended = True
        if self._py is not None:
            self._py.buf.signal_end()
        elif self._pipeline is not None or self.native is not None:
            (self._pipeline or self.native).signal_end()

    @property
    def needs_input(self) -> bool:
        """Streaming mode: True while feed() can still unblock decode —
        disambiguates decode_window() returning None ('need more bytes'
        vs end of stream after signal_end)."""
        return self._streaming and not self._ended

    @property
    def samplerate(self) -> int:
        if self._pipeline is not None:
            return self._pipeline.samplerate
        if self.native is not None:
            self.native.has_header()
            return self.native.samplerate
        if self._py is None:
            return 0   # streaming: container not known yet (< 4 bytes fed)
        return self._py.samplerate()

    @property
    def channels(self) -> int:
        if self._pipeline is not None:
            return self._pipeline.channels
        if self.native is not None:
            self.native.has_header()
            return self.native.channels
        if self._py is None:
            return 0   # streaming: container not known yet
        return self._py.get_channels()

    def _parse_frame(self) -> Optional[np.ndarray]:
        if self._pipeline is not None:
            return self._pipeline.parse_next_audio_frame()
        if self.native is not None:
            return self.native.parse_next_frame()
        if self._py is None:
            return None   # streaming: container not known yet
        a = self._py
        if a.next_frame_data_size == 0:
            a.next_frame_data_size = a._decode_header()
        if a.next_frame_data_size == 0 or \
                not a.buf.has(a.next_frame_data_size << 3):
            return None
        out = a._parse_frame()
        a.next_frame_data_size = 0
        return out

    def _parse_frames(self, want: int) -> list:
        """Up to `want` frames' subband samples, fewer where the source
        has no more (yet)."""
        frames = []
        with profiling.span("mpeg.parse", self._key):
            while len(frames) < want:
                f = self._parse_frame()
                if f is None:
                    break
                frames.append(f)
        return frames

    def _parse_window(self) -> list:
        """A window's frames, parsed ahead; its time goes to
        `stats.host_seconds`."""
        t0 = time.perf_counter()
        frames = self._parse_frames(self.window)
        if self.stats is not None:
            self.stats.host_seconds += time.perf_counter() - t0
        return frames

    def decode_window(self):
        """Decode up to `window` frames; returns interleaved samples
        [n_frames * 2304] (float32, or int16 with out_format="s16"; a
        numpy array, or a tensor on `device` with out_device=True), or
        None at end of stream (or, in streaming mode, when a full window
        hasn't accumulated yet — the block history advances in whole
        windows, so partial windows only flush after signal_end)."""
        with profiling.span("mpeg.window", self._key):
            return self._decode_window()

    def _decode_window(self):
        if self._closed:
            return None
        if self._runahead is not None:
            with profiling.span("mpeg.parse.wait", self._key):
                try:
                    frames = self._runahead.get()
                except BaseException:
                    # Windows parsed past the error are lost: poison like
                    # close().
                    self._closed = True
                    self._runahead = None
                    raise
            if self._runahead.done:
                self._runahead = None   # later calls parse inline: no frames
            if not frames:
                return None
        else:
            t_parse = time.perf_counter()
            with profiling.span("mpeg.parse.wait", self._key):
                self._pending += self._parse_frames(
                    self.window - len(self._pending))
            t_parse = time.perf_counter() - t_parse
            if self.stats is not None:
                self.stats.host_seconds += t_parse
            if not self._pending:
                return None
            if len(self._pending) < self.window and not self._ended:
                return None   # streaming: wait for a whole window
            frames, self._pending = self._pending, []

        if self._hist is None:   # the last 15 DCT blocks, newest first
            self._hist = torch.zeros((1, 15, 2, 64), dtype=torch.float32,
                                     device=self.device)
            self._ring = HostRing(self.device)

        t0 = time.perf_counter()
        # Packed straight into a host buffer of the ring (pinned for the
        # card, written again only once its last copy has completed), the
        # tail past n frames zeroed as the reference's np.zeros window.
        n = len(frames)
        with profiling.span("mpeg.audio.pack", self._key):
            host = self._ring.take(self.window * _FRAME_BYTES)
            samples = host.numpy().view(np.int32).reshape(self.window, 36,
                                                          2, 32)
            samples[:n] = frames
            samples[n:] = 0
        with profiling.span("mpeg.h2d", self._key):
            xs, = self._ring.send([host])
        xs = xs.view(torch.int32).view(1, -1, 2, 32)
        # Normalized (or quantized: the d2h is then int16) and interleaved
        # on the device; the window's first n frames.
        with profiling.span("mpeg.launch", self._key):
            out, self._hist = cuda_kernels.synthesize(xs, self._hist,
                                                      out=self.out_format)
        profiling.count("audio_windows")
        profiling.count("audio_frames", n)
        pcm = out[0, :n * 2304]
        if not self.out_device:
            profiling.count("blocks")
            with profiling.span("mpeg.block", self._key):
                pcm = pcm.cpu().numpy()
        if self.stats is not None:
            self.stats.samples += n * 1152
            self.stats.transfer_bytes += samples.nbytes
            self.stats.device_seconds += time.perf_counter() - t0
        return pcm

    def decode_all(self):
        """Decode the whole stream to interleaved PCM (dtype per
        out_format; a tensor on `device` when out_device=True)."""
        chunks = []
        while True:
            pcm = self.decode_window()
            if pcm is None:
                break
            chunks.append(pcm)
        if self.out_device:
            dtype = torch.int16 if self.out_format == "s16" \
                else torch.float32
            return torch.cat(chunks) if chunks \
                else torch.zeros(0, dtype=dtype, device=self.device)
        dtype = np.int16 if self.out_format == "s16" else np.float32
        return np.concatenate(chunks) if chunks else np.zeros(0, dtype)
