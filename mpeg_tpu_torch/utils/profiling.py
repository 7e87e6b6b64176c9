"""Decode counters, program spans and device trace capture (the port's
copy of `mpeg_tpu/utils/profiling.py`, with spans of its own).

`DecodeStats` counts frames, samples and bytes and splits host parse
from enqueue time per window.  `span` and `count` record the program's
own spans and counters at its layer boundaries while a collector is
active: `device_trace` starts one for its block (and puts every span in
its torch.profiler trace, beside the kernels and copies), `collect`
starts one without the profiler.  With no collector active they cost one
module-global check.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass

import torch


@dataclass
class DecodeStats:
    """Accumulating decode counters.

    `host_seconds` is the host parse a decode waited for (with prefetch,
    the parse thread's time); `device_seconds` the time to enqueue each
    window's (round's) copies and launches: the video decoders' copies
    are asynchronous (`parallel.batch.device_put`), so it does not wait
    for the copy or the card.  `transfer_bytes` counts the bytes each
    window shipped."""

    frames: int = 0
    samples: int = 0
    host_seconds: float = 0.0
    device_seconds: float = 0.0
    transfer_bytes: int = 0

    def record_window(self, pictures: int, nbytes: int,
                      parse_seconds: float, dispatch_seconds: float):
        """One batched-decoder window: parse cost, transport bytes and
        dispatch cost (called by BatchVideoDecoder.decode_window)."""
        self.frames += pictures
        self.transfer_bytes += nbytes
        self.host_seconds += parse_seconds
        self.device_seconds += dispatch_seconds


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

# The collector of the block that is running (None: spans and counters
# are off) and the last one started.
_active = None
_last = None
_NULL = contextlib.nullcontext()
_keys = itertools.count(1)
# The range around a `device_trace` block in its trace: its extent and
# thread are the capture's and the main thread's on the trace's clock.
CAPTURE = "profiling.capture"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def new_key() -> int:
    """A fresh serial for one decoder: its spans carry it as `key`."""
    return next(_keys)


def span(name: str, key: int = None):
    """A context manager recording `name` as a span of the active
    collector; the shared null context when none is active."""
    c = _active
    if c is None:
        return _NULL
    return _Span(c, name, key)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the active collector's counter `name`."""
    c = _active
    if c is not None:
        c.add(name, n)


def last_trace():
    """The last collector started (by `device_trace` or `collect`), or
    None when none has run in this process."""
    return _last


class _Span:
    __slots__ = ("c", "name", "key", "id", "parent", "stack", "rf", "t0")

    def __init__(self, c, name, key):
        self.c, self.name, self.key = c, name, key

    def __enter__(self):
        self.stack = self.c.stack()
        self.parent = self.stack[-1] if self.stack else None
        self.id = next(self.c.ids)
        self.stack.append(self.id)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.stack.pop()
        thread = threading.get_ident()
        self.c.spans.append((self.id, self.name, self.parent, self.key,
                             thread, thread == self.c.main, self.t0, t1))
        return False


def _merged(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Collector:
    """The spans and counters of one block.

    `spans` holds (id, name, parent id, key, thread, on the main thread,
    start ns, end ns) from `time.perf_counter_ns()`; the main thread is
    the one that entered the block.  `counts` holds the counters.
    `idle_by_span` (filled by `device_trace`) the device's idle seconds
    in the capture by the innermost `mpeg.*` span open on the main
    thread, None for idle under no span."""

    def __init__(self):
        self.spans = []
        self.counts = {}
        self.idle_by_span = {}
        self.main = threading.get_ident()
        self.ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def stack(self) -> list:
        """The calling thread's open spans, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def seconds(self, name: str, main_only: bool = False) -> float:
        """The merged intervals of the spans called `name` (on the main
        thread only with `main_only`), in seconds: overlapping spans on
        several threads count once."""
        return _merged((s[6], s[7]) for s in self.spans if s[1] == name
                       and (s[5] or not main_only)) * 1e-9

    def self_seconds(self, name: str) -> float:
        """The merged intervals of the spans called `name` less the
        parts their child spans cover, in seconds."""
        own = {s[0]: s for s in self.spans if s[1] == name}
        children = {}
        for s in self.spans:
            if s[2] in own:
                children.setdefault(s[2], []).append((s[6], s[7]))
        pieces = []
        for i, s in own.items():
            t = s[6]
            for a, b in sorted(children.get(i, ())):
                if a > t:
                    pieces.append((t, min(a, s[7])))
                t = max(t, b)
            if s[7] > t:
                pieces.append((t, s[7]))
        return _merged(pieces) * 1e-9

    def report(self) -> dict:
        """What `spans.json` holds: the spans, the counters, the merged
        and self seconds and the count of spans by name, `idle_by_span`."""
        names = {s[0]: s[1] for s in self.spans}
        out = {"spans": [{"name": s[1], "parent": names.get(s[2]),
                          "key": s[3], "thread": s[4], "main": s[5],
                          "start_ns": s[6], "end_ns": s[7]}
                         for s in sorted(self.spans, key=lambda s: s[6])],
               "counts": dict(self.counts), "by_name": {},
               "idle_by_span": {("null" if k is None else k): v
                                for k, v in self.idle_by_span.items()}}
        for name in sorted(set(names.values())):
            out["by_name"][name] = {
                "n": sum(1 for s in self.spans if s[1] == name),
                "seconds": self.seconds(name),
                "self_seconds": self.self_seconds(name)}
        return out


@contextlib.contextmanager
def collect():
    """Record the program's spans and counters inside the block, without
    the profiler; yields the collector (also `last_trace()`)."""
    global _active, _last
    c, prev = Collector(), _active
    _active = _last = c
    try:
        yield c
    finally:
        _active = prev


def _innermost(ranges, lo: float, hi: float) -> list:
    """(start, end, name) pieces covering [lo, hi]: the innermost of the
    nested `ranges` (start, end, name) open over each, None where none."""
    pieces, stack, t = [], [], lo

    def upto(until):
        nonlocal t
        until = min(until, hi)
        if until > t:
            pieces.append((t, until, stack[-1][1] if stack else None))
            t = until

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            upto(stack[-1][0])
            stack.pop()
        upto(a)
        stack.append((b, name))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    upto(hi)
    return pieces


def idle_by_span(trace_path: str) -> dict:
    """The device's idle seconds inside the `CAPTURE` range of a Chrome
    trace, by the innermost `mpeg.*` range open on the capture's thread
    (None: under no such range).  A trace without device activity reads
    idle throughout."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    cap = next((e for e in events if e.get("name") == CAPTURE
                and e.get("ph") == "X"), None)
    if cap is None:
        return {}
    lo = float(cap["ts"])
    hi = lo + float(cap.get("dur", 0.0))
    busy, ranges = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            busy.append((max(a, lo), min(b, hi)))
        elif e.get("cat") == "user_annotation" and \
                e.get("tid") == cap.get("tid") and \
                e.get("pid") == cap.get("pid") and \
                str(e.get("name", "")).startswith("mpeg."):
            ranges.append((a, b, e["name"]))
    gaps, t = [], lo
    for a, b in sorted(x for x in busy if x[1] > x[0]):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    out, i = {}, 0
    pieces = _innermost(ranges, lo, hi)
    for a, b in gaps:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            ov = min(b, pieces[j][1]) - max(a, pieces[j][0])
            if ov > 0:
                name = pieces[j][2]
                out[name] = out.get(name, 0.0) + ov * 1e-6
            j += 1
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of everything inside the block (CPU
    activity, and CUDA activity when a card is present) into `log_dir`,
    with a collector of the program's spans and counters active.

    Yields a dict that is filled in when the block ends: "trace" (the
    Chrome trace file, or None), "spans" (`spans.json` beside it: the
    collector's `report()`), "device_recorded" (whether the trace holds
    device activity; None without a card) and "note" (why something is
    missing).  The collector is `last_trace()`; its `idle_by_span` is
    reduced from the trace, and left empty when the card's activity was
    not recorded.  The profiler records no device activity at all in
    some sessions on the card's machine: the capture then says so in its
    result and in `log_dir/NOTE.json`, and never raises for it (an
    exception raised by the block itself passes through)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    result = {"log_dir": log_dir, "trace": None, "spans": None,
              "device_recorded": False if cuda else None, "note": None}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    try:
        prof.__enter__()
    except RuntimeError as e:   # the profiler could not start
        prof = None
        result["note"] = f"torch.profiler did not start: {e}"
    with collect() as col:
        try:
            with torch.profiler.record_function(CAPTURE):
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
            if result["trace"] is not None and \
                    result["device_recorded"] is not False:
                col.idle_by_span = idle_by_span(result["trace"])
            result["spans"] = os.path.join(log_dir, "spans.json")
            with open(result["spans"], "w") as f:
                json.dump(col.report(), f)
            if result["note"] is not None:
                with open(os.path.join(log_dir, "NOTE.json"), "w") as f:
                    json.dump(result, f)
