"""Decode counters and device trace capture (the port's copy of
`mpeg_tpu/utils/profiling.py`).

`DecodeStats` splits host parse from device dispatch time per window;
`device_trace` captures a torch.profiler trace of a block.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field


@dataclass
class DecodeStats:
    """Accumulating decode counters; read `.summary()` at any point.

    `host_seconds` is the host parse a decode waited for;
    `device_seconds` the time to enqueue each window's (round's) copies
    and launches: the video decoders' copies are asynchronous
    (`parallel.batch.device_put`), so it does not wait for the copy or
    the card.  `transfer_bytes` counts the bytes each window shipped."""

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


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of everything inside the block (CPU
    activity, and CUDA activity when a card is present) into `log_dir`.

    Yields a dict that is filled in when the block ends: "trace" (the
    Chrome trace file, or None), "device_recorded" (whether the trace
    holds device activity; None without a card) and "note" (why something
    is missing).  The profiler records no device activity at all in some
    sessions on the card's machine: the capture then says so in its
    result and in `log_dir/NOTE.json`, and never raises for it (an
    exception raised by the block itself passes through)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    result = {"log_dir": log_dir, "trace": None,
              "device_recorded": False if cuda else None, "note": None}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    try:
        prof.__enter__()
    except RuntimeError as e:   # the profiler could not start
        prof = None
        result["note"] = f"torch.profiler did not start: {e}"
    try:
        yield result
    finally:
        if prof is not None:
            try:
                if cuda:
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                path = os.path.join(log_dir, "trace.json")
                prof.export_chrome_trace(path)
                result["trace"] = path
                if cuda:
                    result["device_recorded"] = any(
                        k.device_type.name == "CUDA" and
                        k.device_time_total > 0
                        for k in prof.key_averages())
                    if not result["device_recorded"]:
                        result["note"] = ("torch.profiler recorded no "
                                          "device activity")
            except RuntimeError as e:
                result["note"] = f"torch.profiler failed: {e}"
        if result["note"] is not None:
            with open(os.path.join(log_dir, "NOTE.json"), "w") as f:
                json.dump(result, f)
