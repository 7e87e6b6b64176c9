"""MPEG-1 Audio Layer II (MP2) decoder on a torch device.

Port of `mpeg_tpu/audio.py`:

- host parse (this file, or the C++ parser through `native`): frame
  header, bit allocation, scale factors, grouped/direct sample reads and
  the fixed-point dequantization post-multiply, emitting one dense int32
  array [36, 2, 32] of subband samples per frame;
- synthesis: matrixing DCT + 512-tap windowed MAC over the V ring, the
  normalization and the interleave, one K4 launch a frame on a CUDA
  `device` (`ops.cuda_kernels.synthesize_ring`; the plain version
  `ops/filterbank.py` on the CPU); `Samples.interleaved` comes back as a
  host float32 array, as in the reference API.

Output is bit-exact float32 against the reference decoder (no-FMA regime,
golden hash 0xf1b76cdf8e6cdea5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import tables as T
from .buffer import Buffer
from .device import resolve_device
from .ops import cuda_kernels
from .utils import profiling
from .video import _check_backend

SAMPLES_PER_FRAME = T.SAMPLES_PER_FRAME


class AudioFormat:
    """Output sample formats (parity: audio.go:12-23)."""

    F32N = 0     # float32, normalized, interleaved
    F32NLR = 1   # float32, normalized, separate channels
    F32 = 2      # float32, full-scale
    S16 = 3      # signed 16-bit


class Samples:
    """Decoded audio samples for one frame (parity: audio.go:25-50).

    `interleaved` is always populated (normalized float32, L/R interleaved,
    a host numpy array); the other representations are derived on demand.
    """

    def __init__(self, fmt: int = AudioFormat.F32N):
        self.time = 0.0
        self.format = fmt
        self.interleaved = np.zeros(SAMPLES_PER_FRAME * 2, np.float32)

    @property
    def left(self) -> np.ndarray:
        return np.ascontiguousarray(self.interleaved[0::2])

    @property
    def right(self) -> np.ndarray:
        return np.ascontiguousarray(self.interleaved[1::2])

    @property
    def s16(self) -> np.ndarray:
        s = self.interleaved
        scaled = np.where(s < 0, s * np.float32(0x8000), s * np.float32(0x7FFF))
        return np.trunc(scaled).astype(np.int16)

    @property
    def f32(self) -> np.ndarray:
        s = self.interleaved
        return np.where(s < 0, s * np.float32(0x80000000),
                        s * np.float32(0x7FFFFFFF)).astype(np.float32)

    def bytes(self) -> bytes:
        if self.format == AudioFormat.F32N:
            return self.interleaved.tobytes()
        if self.format == AudioFormat.F32:
            return self.f32.tobytes()
        if self.format == AudioFormat.S16:
            return self.s16.tobytes()
        return b""


class Audio:
    """MP2 decoder: pulls an elementary stream from `buf`, yields Samples."""

    def __init__(self, buf: Buffer, backend: str = None,
                 parser: str = None, config=None, *, device="cuda"):
        """`backend`: "torch" (the JAX package's "jax" and "numpy" raise).
        `parser`: "python", "native" (C++) or "auto" (native when
        available).  Unset, both fall back to `config` (default
        config.DEFAULT).  `device`: where the synthesis runs, "cuda" (the
        default; raises without a card) or "cpu"."""
        from .config import DEFAULT
        cfg = config if config is not None else DEFAULT
        self._key = profiling.new_key()
        self.backend = _check_backend(backend, cfg, ("torch",))
        self.device = resolve_device(device)
        parser = parser if parser is not None else cfg.parser
        self.buf = buf
        if parser == "auto":
            from . import native as native_mod
            parser = "native" if native_mod.available() else "python"
        self.parser = parser
        self._native = None
        self.time = 0.0
        self.samples_decoded = 0
        self.samplerate_index = 3   # "0" sentinel (audio.go:87)
        self.bitrate_index = 0
        self.version = 0
        self.layer = 0
        self.mode = 0
        self.channels = 0
        self.bound = 0
        self.next_frame_data_size = 0
        self.has_header_flag = False
        self.format = AudioFormat.F32N

        # Filterbank state: the V ring on the device + its write position.
        self._v = torch.zeros((2, 1024), dtype=torch.float32,
                              device=self.device)
        self.v_pos = 0
        # A frame's samples in pinned host memory, int32 [36, 2, 32], and
        # its numpy view.
        self._staging = self._staging_np = None

        # Per-frame parse scratch.
        self.allocation = [[None] * 32 for _ in range(2)]
        self.scale_factor_info = [[0] * 32 for _ in range(2)]
        self.scale_factor = [[[0] * 3 for _ in range(32)] for _ in range(2)]
        self.sample = [[[0] * 3 for _ in range(32)] for _ in range(2)]

        self.samples = Samples(self.format)

        # Attempt to decode the first header.
        if self.parser == "native":
            self._native_has_header()
        else:
            self.next_frame_data_size = self._decode_header()

    # -- native-parser plumbing ----------------------------------------------

    def _native_feed(self) -> bool:
        if self._native is None:
            from . import native as native_mod
            self._native = native_mod.NativeAudioParser()
        data = self.buf.data
        if not data:
            return False
        self._native.feed(bytes(data))
        del data[:]
        self.buf.bit_index = 0
        return True

    def _native_ended(self) -> bool:
        return self.buf.has_ended() or self.buf.end_signaled

    def _native_sync_header(self) -> None:
        if self._native.has_header():
            self.has_header_flag = True
            sr = self._native.samplerate
            self.samplerate_index = T.SAMPLE_RATE.index(sr)
            self.channels = self._native.channels

    def _native_has_header(self) -> bool:
        self._native_feed()
        self._native_sync_header()
        if not self.has_header_flag and self.buf.load_callback is not None:
            self.buf.load_callback(self.buf)
            self._native_feed()
            self._native_sync_header()
        return self.has_header_flag

    def _native_next_frame(self):
        """Pull the next subband-sample tensor, refilling via the load
        callback exactly like the reference's pull model."""
        with profiling.span("mpeg.audio.frame", self._key):
            while True:
                self._native_feed()
                out = self._native.parse_next_frame()
                if out is not None:
                    self._native_sync_header()
                    return out
                before = len(self.buf.data)
                if self.buf.load_callback is not None:
                    self.buf.load_callback(self.buf)
                if len(self.buf.data) == before:
                    if self._native_ended():
                        self._native.signal_end()
                        self._native_feed()
                        return self._native.parse_next_frame()
                    return None

    # -- public surface (parity: audio.go:106-182) ---------------------------

    def buffer(self) -> Buffer:
        return self.buf

    def has_header(self) -> bool:
        if self.has_header_flag:
            return True
        if self.parser == "native":
            return self._native_has_header()
        self.next_frame_data_size = self._decode_header()
        return self.has_header_flag

    def samplerate(self) -> int:
        return T.SAMPLE_RATE[self.samplerate_index] if self.has_header() else 0

    def get_channels(self) -> int:
        return self.channels

    def get_time(self) -> float:
        return self.time

    def set_time(self, time: float) -> None:
        self.samples_decoded = int(time * T.SAMPLE_RATE[self.samplerate_index])
        self.time = time

    def rewind(self) -> None:
        self.buf.rewind()
        self.time = 0.0
        self.samples_decoded = 0
        self.next_frame_data_size = 0
        if self.parser == "native" and self._native is not None:
            self._native.rewind()

    def has_ended(self) -> bool:
        return self.buf.has_ended()

    # -- checkpoint / resume (V ring + clocks; the JAX package's dicts) ------

    def get_state(self) -> dict:
        return {
            "v": self._v.cpu().numpy().copy(),
            "v_pos": self.v_pos,
            "time": self.time,
            "samples_decoded": self.samples_decoded,
            "buf_tell": self._stream_pos() if self.buf.seekable() else None,
        }

    def _stream_pos(self) -> int:
        pos = self.buf.tell()
        if self.parser == "native" and self._native is not None:
            pos -= self._native.unconsumed()
        return pos

    def set_state(self, state: dict) -> None:
        """Resume from `get_state()` of this class or of the JAX package's
        Audio (its ring is a numpy or jax array)."""
        self._v = torch.from_numpy(
            np.array(state["v"], np.float32)).to(self.device)
        self.v_pos = int(state["v_pos"])
        self.time = state["time"]
        self.samples_decoded = state["samples_decoded"]
        self.next_frame_data_size = 0
        if state["buf_tell"] is not None and self.buf.seekable():
            if self.parser == "native" and self._native is not None:
                self._native.rewind()
            self.buf.seek(state["buf_tell"])

    def decode(self) -> Optional[Samples]:
        """Decode one frame (1152 samples); None if not enough data."""
        if self.parser == "native":
            if not self.has_header():
                return None
            samples_int = self._native_next_frame()
            if samples_int is None:
                return None
        else:
            if self.next_frame_data_size == 0:
                self.next_frame_data_size = self._decode_header()
            if self.next_frame_data_size == 0 or \
                    not self.buf.has(self.next_frame_data_size << 3):
                return None
            samples_int = self._parse_frame()
            self.next_frame_data_size = 0

        self._synthesize(samples_int)

        self.samples.time = self.time
        self.samples_decoded += SAMPLES_PER_FRAME
        self.time = self.samples_decoded / T.SAMPLE_RATE[self.samplerate_index]
        return self.samples

    def _synthesize(self, samples_int: np.ndarray) -> None:
        # One h2d copy from this Audio's pinned buffer on the stream K4
        # runs on, one K4 launch (the new ring is a new tensor), one d2h
        # copy of the normalized PCM, which waits for both: the buffer is
        # free again when this returns, so it needs no ring or gate.
        from .parallel.batch import device_put, host_blob
        with profiling.span("mpeg.audio.synth", self._key):
            if self._staging is None:
                self._staging = host_blob(36 * 2 * 32 * 4, self.device) \
                    .view(torch.int32).view(36, 2, 32)
                self._staging_np = self._staging.numpy()
            self._staging_np[...] = samples_int
            (x,), _ = device_put([self._staging], self.device,
                                 current_stream=True)
            pcm, ring, self.v_pos = cuda_kernels.synthesize_ring(
                x[None], self._v[None], self.v_pos, out="f32")
            self._v = ring[0]
            profiling.count("blocks")
            with profiling.span("mpeg.block", self._key):
                self.samples.interleaved = pcm[0].cpu().numpy()

    # -- host parse (parity: audio.go:184-490) -------------------------------

    def _decode_header(self) -> int:
        """Frame header: sync, version/layer, rates, mode; returns the frame
        payload size in bytes, 0 when invalid/unavailable."""
        buf = self.buf
        if not buf.has(48):
            return 0

        buf.skip_bytes(0x00)
        # Re-check after the zero skip: a zero-padded tail (push-fed mode,
        # chunk boundaries) may have consumed the lookahead.
        if not buf.has(48):
            return 0
        sync = buf.read(11)

        # Resync and re-check header consistency (audio.go:193-230).
        if sync != T.FRAME_SYNC and not buf.find_frame_sync():
            return 0

        self.version = buf.read(2)
        self.layer = buf.read(2)
        has_crc = buf.read1() == 0

        if self.version != T.MPEG_1 or self.layer != T.LAYER_II:
            return 0

        bitrate_index = buf.read(4) - 1
        if bitrate_index > 13 or bitrate_index < 0:
            return 0

        samplerate_index = buf.read(2)
        if samplerate_index == 3:
            return 0

        padding = buf.read1()
        buf.skip(1)   # private bit
        mode = buf.read(2)

        # If we already have a header, the samplerate/bitrate/mode must not
        # have changed — otherwise we missed sync.
        if self.has_header_flag and (
                self.bitrate_index != bitrate_index or
                self.samplerate_index != samplerate_index or
                self.mode != mode):
            return 0

        self.bitrate_index = bitrate_index
        self.samplerate_index = samplerate_index
        self.mode = mode
        self.has_header_flag = True

        if mode in (T.MODE_STEREO, T.MODE_JOINT_STEREO):
            self.channels = 2
        elif mode == T.MODE_MONO:
            self.channels = 1

        # mode_extension -> joint-stereo bound
        if mode == T.MODE_JOINT_STEREO:
            self.bound = (buf.read(2) + 1) << 2
        else:
            buf.skip(2)
            self.bound = 0 if mode == T.MODE_MONO else 32

        buf.skip(4)   # copyright, original, emphasis
        if has_crc:
            buf.skip(16)

        br = T.BIT_RATE[self.bitrate_index]
        sr = T.SAMPLE_RATE[self.samplerate_index]
        frame_size = (144000 * br) // sr + padding
        return frame_size - (6 if has_crc else 4)

    def _read_allocation(self, sb: int, tab3: int):
        tab4 = T.QUANT_LUT_STEP_3[tab3][sb]
        qtab = T.QUANT_LUT_STEP_4[tab4 & 15][self.buf.read(tab4 >> 4)]
        return T.QUANT_TAB[qtab - 1] if qtab != 0 else None

    def _read_samples(self, ch: int, sb: int, part: int) -> None:
        q = self.allocation[ch][sb]
        sf = self.scale_factor[ch][sb][part]
        sample = self.sample[ch][sb]

        if q is None:
            sample[0] = sample[1] = sample[2] = 0
            return

        # Resolve scale factor (audio.go:455-460)
        if sf == 63:
            sf = 0
        else:
            shift = sf // 3
            sf = (T.SCALEFACTOR_BASE[sf % 3] + ((1 << shift) >> 1)) >> shift

        levels, group, bits = q
        adj = levels
        if group != 0:
            # Grouped samples: one code word holds three values.
            val = self.buf.read(bits)
            sample[0] = val % adj
            val //= adj
            sample[1] = val % adj
            sample[2] = val // adj
        else:
            sample[0] = self.buf.read(bits)
            sample[1] = self.buf.read(bits)
            sample[2] = self.buf.read(bits)

        # Fixed-point dequantization post-multiply (audio.go:479-489)
        scale = 65536 // (adj + 1)
        adj = ((adj + 1) >> 1) - 1

        for i in range(3):
            val = (adj - sample[i]) * scale
            sample[i] = (val * (sf >> 12) + ((val * (sf & 4095) + 2048) >> 12)) >> 12

    def _parse_frame(self) -> np.ndarray:
        """Parse one frame's payload into subband samples [36, 2, 32] i32."""
        buf = self.buf

        # Quantizer table lookups (audio.go:276-289)
        tab1 = 0 if self.mode == T.MODE_MONO else 1
        tab2 = T.QUANT_LUT_STEP_1[tab1][self.bitrate_index]
        tab3 = T.QUANT_LUT_STEP_2[tab2][self.samplerate_index]
        sblimit = tab3 & 63
        tab3 >>= 6

        if self.bound > sblimit:
            self.bound = sblimit

        allocation = self.allocation
        for sb in range(self.bound):
            allocation[0][sb] = self._read_allocation(sb, tab3)
            allocation[1][sb] = self._read_allocation(sb, tab3)
        for sb in range(self.bound, sblimit):
            allocation[0][sb] = self._read_allocation(sb, tab3)
            allocation[1][sb] = allocation[0][sb]

        # Scale factor selector information
        channels = 1 if self.mode == T.MODE_MONO else 2
        sfi = self.scale_factor_info
        for sb in range(sblimit):
            for ch in range(channels):
                if allocation[ch][sb] is not None:
                    sfi[ch][sb] = buf.read(2)
            if self.mode == T.MODE_MONO:
                sfi[1][sb] = sfi[0][sb]

        # Scale factors
        sf = self.scale_factor
        for sb in range(sblimit):
            for ch in range(channels):
                if allocation[ch][sb] is not None:
                    info = sfi[ch][sb]
                    if info == 0:
                        sf[ch][sb][0] = buf.read(6)
                        sf[ch][sb][1] = buf.read(6)
                        sf[ch][sb][2] = buf.read(6)
                    elif info == 1:
                        tmp = buf.read(6)
                        sf[ch][sb][0] = tmp
                        sf[ch][sb][1] = tmp
                        sf[ch][sb][2] = buf.read(6)
                    elif info == 2:
                        tmp = buf.read(6)
                        sf[ch][sb][0] = tmp
                        sf[ch][sb][1] = tmp
                        sf[ch][sb][2] = tmp
                    else:
                        sf[ch][sb][0] = buf.read(6)
                        tmp = buf.read(6)
                        sf[ch][sb][1] = tmp
                        sf[ch][sb][2] = tmp
            if self.mode == T.MODE_MONO:
                sf[1][sb][0] = sf[0][sb][0]
                sf[1][sb][1] = sf[0][sb][1]
                sf[1][sb][2] = sf[0][sb][2]

        # Coefficient input: 3 parts x 4 granules x (read + 3 sub-block steps)
        out = np.zeros((36, 2, 32), np.int32)
        sample = self.sample
        step = 0
        for part in range(3):
            for _granule in range(4):
                for sb in range(self.bound):
                    self._read_samples(0, sb, part)
                    self._read_samples(1, sb, part)
                for sb in range(self.bound, sblimit):
                    self._read_samples(0, sb, part)
                    s0 = sample[0][sb]
                    sample[1][sb][0] = s0[0]
                    sample[1][sb][1] = s0[1]
                    sample[1][sb][2] = s0[2]
                for sb in range(sblimit, 32):
                    sample[0][sb][0] = sample[0][sb][1] = sample[0][sb][2] = 0
                    sample[1][sb][0] = sample[1][sb][1] = sample[1][sb][2] = 0

                for p in range(3):
                    for ch in range(2):
                        for sb in range(32):
                            out[step, ch, sb] = sample[ch][sb][p]
                    step += 1

        buf.align()
        return out
