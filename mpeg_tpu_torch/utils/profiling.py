"""Decode counters (the port's copy of `mpeg_tpu/utils/profiling.py`).

`DecodeStats` splits host parse from device dispatch time per window.
The reference's `device_trace` (a jax.profiler capture) has no copy here:
its torch.profiler counterpart comes with the port's bench leg
(ROADMAP); `chip_smoke.py` runs torch.profiler itself meanwhile.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class DecodeStats:
    """Accumulating decode counters; read `.summary()` at any point."""

    frames: int = 0
    pixels: int = 0
    samples: int = 0
    host_seconds: float = 0.0
    device_seconds: float = 0.0
    transfer_bytes: int = 0
    # detailed=True asks decoders to split device_seconds into
    # h2d / dispatch / d2h (costs one extra device sync per window —
    # attribution mode, not the default hot path).
    detailed: bool = False
    h2d_seconds: float = 0.0
    dispatch_seconds: float = 0.0
    d2h_seconds: float = 0.0
    _t0: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def host(self):
        t = time.time()
        try:
            yield
        finally:
            self.host_seconds += time.time() - t

    @contextlib.contextmanager
    def device(self):
        t = time.time()
        try:
            yield
        finally:
            self.device_seconds += time.time() - t

    def record_window(self, pictures: int, nbytes: int,
                      parse_seconds: float, dispatch_seconds: float):
        """One batched-decoder window: parse cost, transport bytes and
        dispatch cost (called by BatchVideoDecoder.decode_window)."""
        self.frames += pictures
        self.transfer_bytes += nbytes
        self.host_seconds += parse_seconds
        self.device_seconds += dispatch_seconds

    def summary(self) -> dict:
        wall = time.time() - self._t0
        return {
            "frames": self.frames,
            "fps": self.frames / wall if wall > 0 else 0.0,
            "mpixels_per_s": self.pixels / wall / 1e6 if wall > 0 else 0.0,
            "msamples_per_s": self.samples / wall / 1e6 if wall > 0 else 0.0,
            "host_seconds": round(self.host_seconds, 3),
            "device_seconds": round(self.device_seconds, 3),
            "transfer_mb": round(self.transfer_bytes / 1e6, 2),
            "wall_seconds": round(wall, 3),
            **({"h2d_seconds": round(self.h2d_seconds, 3),
                "dispatch_seconds": round(self.dispatch_seconds, 3),
                "d2h_seconds": round(self.d2h_seconds, 3)}
               if self.detailed else {}),
        }
