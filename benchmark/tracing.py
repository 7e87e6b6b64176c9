"""The device trace of a traced run: torch.profiler over the measured
window (through the port's `utils.profiling.device_trace`), reduced to
the device's busy time, the time of each kernel, the operations that
took most time and the longest idle gaps, labelled by the benchmark's
span that the host was in."""

from __future__ import annotations

import contextlib
import json

WINDOW = "benchmark.window"
# The benchmark's own device work (the copies of the check's sampled
# frames to the host) runs under this mark and is left out of the device
# time: it is not the program's.
SAMPLE = "benchmark.sample"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def window_marker(trace: bool):
    """Mark the window in the trace, so that the device's events and the
    host's spans can be put on one clock."""
    if not trace:
        yield
        return
    import torch
    with torch.profiler.record_function(WINDOW):
        yield


def merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def merged_seconds(events) -> float:
    return sum(b - a for a, b in merge((e[1], e[2]) for e in events))


def _label(a: float, b: float, spans) -> str:
    """The innermost span that covers most of [a, b]."""
    best, best_key = "outside the benchmark's spans", None
    for name, s0, s1 in spans:
        ov = min(b, s1) - max(a, s0)
        if ov <= 0:
            continue
        key = (ov >= 0.5 * (b - a), -(s1 - s0) if ov >= 0.5 * (b - a)
               else ov)
        if best_key is None or key > best_key:
            best, best_key = name, key
    return best


def _own_correlations(events) -> set:
    """The correlation ids of the CUDA calls the host made inside a
    SAMPLE mark, on the mark's own thread: the device operations with
    these ids are the benchmark's."""
    marks = {}
    for e in events:
        if e.get("name") == SAMPLE and e.get("ph") == "X":
            a = float(e["ts"])
            marks.setdefault(e.get("tid"), []).append(
                (a, a + float(e.get("dur", 0.0))))
    own = set()
    for e in events:
        if e.get("cat") != "cuda_runtime" or e.get("tid") not in marks:
            continue
        t = float(e["ts"])
        if any(a <= t <= b for a, b in marks[e["tid"]]):
            own.add(e.get("args", {}).get("correlation"))
    own.discard(None)
    return own


def summarize(traced: dict, start: float, end: float, spans) -> dict:
    """Reduce the window's trace: "events" [(name, start_s, end_s)] of
    device operations in the window (seconds from its start), "busy_s",
    "device_ops" and "idle_gaps" (ten each, [name, seconds])."""
    empty = {"events": [], "busy_s": 0.0, "device_ops": [],
             "idle_gaps": [], "note": traced.get("note")}
    if not traced or not traced.get("trace"):
        return empty
    with open(traced["trace"]) as f:
        events = json.load(f).get("traceEvents", [])
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("ph") == "X"]
    if not marks:
        empty["note"] = "no window marker in the trace"
        return empty
    w0 = float(marks[0]["ts"])
    length = end - start
    own = _own_correlations(events)
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS \
                or e.get("args", {}).get("correlation") in own:
            continue
        a = (float(e["ts"]) - w0) * 1e-6
        b = a + float(e.get("dur", 0.0)) * 1e-6
        a, b = max(a, 0.0), min(b, length)
        if b > a:
            dev.append((e.get("name", "?"), a, b))
    merged = merge((a, b) for _, a, b in dev)
    busy = sum(b - a for a, b in merged)
    by_name = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, prev = [], 0.0
    for a, b in merged + [[length, length]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    rel = [(n, s0 - start, s1 - start) for n, s0, s1 in spans]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"events": dev, "busy_s": busy,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_label(a, b, rel), b - a] for a, b in gaps],
            "note": traced.get("note")}
