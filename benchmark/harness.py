"""The benchmark's run: set-up, the measured window, the metrics, the
check against the plain reference, and the result line.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell.  Everything a cell needs is found by name:
`workloads/<cell>.json` names its configuration (`configs/<name>.json`),
its traffic mix (`traffic/<mix>.json`, read by `traffic/generator.py`
with the builder of the mix's kind, `traffic/kinds/<kind>.py`) and its
entry (`entries/<entry>.py`, the driver of one decoder entry point); `BENCHMARK.json` at the checkout's root lists the metrics each
cell reports, and each per-layer metric is read by
`metrics/<metric>.py`.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE_DIR = os.path.join(ROOT, "build", "benchmark")

# Top-level module names the measured process may not hold: the JAX
# package the port was made from, its native library, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "mpeg_tpu", "native")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime "))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# What the window records
# ---------------------------------------------------------------------------

class ClipLog:
    """One clip of the window: its frames as shown, its audio frames."""

    def __init__(self, clip):
        self.clip = clip
        self.shown = 0
        self.audio = 0
        self.done = False


class Recorder:
    """Deliveries, the sampled frames held for the check, the clips and
    (when tracing) the benchmark's own spans around calls into the
    program.

    The check's frames are a uniform sample of `samples` deliveries,
    drawn from the seed as they come (reservoir sampling), one frame of
    each.  They are copied as they are sampled, on the device's stream
    and without a wait, into a pinned host pool that `reserve` makes
    before the window, so the sample holds no device memory.  A
    recorder of 0 samples only notes the frames' size and type
    (`like`)."""

    def __init__(self, seed: int, samples: int, spans: bool,
                 keep_pcm: bool = True, pin: bool = False):
        self.rng = np.random.default_rng([seed, 7])
        self.samples = samples
        self.pin = pin
        self.like = None        # (numel, dtype) of a delivered frame
        self.pool = None        # [samples, numel] host tensor
        self.held = []          # (clip key, frame index) of each slot
        self.offered = 0        # deliveries offered to the sample
        self.clips = {}
        self.pcm = []           # (clip key, audio frame index, array)
        self.returns = []       # perf_counter of each delivery
        self.ticks = []         # seconds of each player tick
        self.frames = 0
        self.audio_frames = 0
        self.keep_pcm = keep_pcm
        self.spans = [] if spans else None

    @contextlib.contextmanager
    def span(self, name: str):
        if self.spans is None:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t, time.perf_counter()))

    def own_device_work(self):
        """Marks the benchmark's own device work in a traced run, so
        that the device's time leaves it out (`tracing.SAMPLE`)."""
        if self.spans is None:
            return contextlib.nullcontext()
        import torch
        from .tracing import SAMPLE
        return torch.profiler.record_function(SAMPLE)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Put a span around every call of obj.attr (tracing only)."""
        if self.spans is None or getattr(obj, "_bench_" + attr, False):
            return
        inner = getattr(obj, attr)

        def spanned(*a, **k):
            with self.span(name):
                return inner(*a, **k)
        setattr(obj, attr, spanned)
        setattr(obj, "_bench_" + attr, True)

    def open(self, key, clip) -> None:
        self.clips[key] = ClipLog(clip)

    def close(self, key) -> None:
        self.clips[key].done = True

    def returned(self) -> None:
        self.returns.append(time.perf_counter())

    def frames_of(self, key, frames) -> int:
        """Frames displayed by clip `key`, in order; returns the index
        of the first."""
        log = self.clips[key]
        self.frames += len(frames)
        log.shown += len(frames)
        return log.shown - len(frames)

    def reserve(self, like) -> None:
        """The pool of `samples` frames like `like` (numel, dtype)."""
        import torch
        numel, dtype = like
        self.pool = torch.empty((self.samples, numel), dtype=dtype,
                                pin_memory=self.pin)

    def sample(self, picks) -> None:
        """`picks`: (clip key, frame index, tensor) of one delivery.
        The delivery enters the sample as reservoir sampling says, and
        then one of its frames, drawn from the seed, is copied into the
        pool."""
        if not picks:
            return
        t = picks[0][2]
        self.like = (t.numel(), t.dtype)
        if self.samples == 0:
            return
        i, self.offered = self.offered, self.offered + 1
        slot = i if i < self.samples else int(self.rng.integers(i + 1))
        if slot >= self.samples:
            return
        key, k, t = picks[int(self.rng.integers(len(picks)))]
        if self.pool is None:
            self.reserve(self.like)
        with self.own_device_work():
            self.pool[slot].copy_(t.reshape(-1), non_blocking=True)
        if slot == len(self.held):
            self.held.append((key, k))
        else:
            self.held[slot] = (key, k)

    def held_frames(self):
        """(clip key, frame index, array) of each sampled frame; only
        once the device has finished the copies."""
        for slot, (key, k) in enumerate(self.held):
            yield key, k, self.pool[slot].numpy()

    def deliver(self, key, frames) -> None:
        """One return of a single stream's decode call."""
        self.returned()
        k0 = self.frames_of(key, frames)
        self.sample([(key, k0 + i, f) for i, f in enumerate(frames)])

    def audio(self, key, interleaved) -> None:
        log = self.clips[key]
        if self.keep_pcm:
            self.pcm.append((key, log.audio, np.array(interleaved)))
        log.audio += 1
        self.audio_frames += 1

    def span_seconds(self) -> dict:
        out = {}
        for name, a, b in self.spans or ():
            out[name] = out.get(name, 0.0) + (b - a)
        return out


class Context:
    """What an entry needs: the device, the cell's entry arguments and
    the decoders' `DecodeStats`."""

    def __init__(self, device, args: dict, stats):
        self.device = device
        self.args = args
        self.stats = stats


# ---------------------------------------------------------------------------
# The check against the plain reference
# ---------------------------------------------------------------------------

def pictures_decoded(log: ClipLog) -> int:
    """Pictures the decoder reconstructed for a clip: a finished clip
    shows each of its pictures once; an unfinished one has decoded one
    picture more than it showed (the reference delay)."""
    if log.done:
        return log.shown
    return min(log.shown + 1, log.clip.pictures) if log.shown else 0


def check(rec: Recorder, exp: dict) -> dict:
    """The numbers compared, each {"value", "limit"}: sampled frames not
    byte-equal to the reference's, frames or audio frames a finished
    clip showed too many or too few, and where the configuration has
    audio the PCM frames not equal to the reference's."""
    from . import refcache
    checks, wrong, bad = {}, 0, set()
    if "gop_frames" in exp:
        frame_size = exp["geom"]["frame_size"]
        for key, k, got in rec.held_frames():
            log = rec.clips[key]
            if k >= log.clip.pictures or not np.array_equal(
                    got[:frame_size],
                    refcache.clip_frame(exp, log.clip.gops, k)):
                wrong += 1
                bad.add(key)
        checks["frames_compared"] = {"value": len(rec.held), "limit": 1,
                                     "at_least": True}
        checks["frames_wrong"] = {"value": wrong, "limit": 0}
    missing = 0
    for key, log in rec.clips.items():
        if log.done:
            n = abs(log.shown - log.clip.pictures) + \
                abs(log.audio - log.clip.audio_frames)
            missing += n
            if n:
                bad.add(key)
    checks["frames_missing"] = {"value": missing, "limit": 0}
    if "pcm" in exp:
        pcm_wrong = 0
        for key, j, got in rec.pcm:
            if not np.array_equal(got, refcache.pcm_frame(exp, j)):
                pcm_wrong += 1
                bad.add(key)
        checks["pcm_compared"] = {"value": len(rec.pcm), "limit": 1,
                                  "at_least": True}
        checks["pcm_wrong"] = {"value": pcm_wrong, "limit": 0}
    checks["_bad_clips"] = len(bad)
    return checks


def passed(checks: dict) -> bool:
    ok = True
    for name, c in checks.items():
        if name.startswith("_"):
            continue
        ok &= c["value"] >= c["limit"] if c.get("at_least") \
            else c["value"] <= c["limit"]
    return bool(ok)


def check_lines(checks: dict) -> list:
    return [f"check {name} {c['value']} "
            f"{'>=' if c.get('at_least') else '<='} {c['limit']}"
            for name, c in checks.items() if not name.startswith("_")]


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, n=100, exclusive)."""
    v = sorted(values)
    if len(v) < 2:
        return v[0] if v else float("nan")
    return statistics.quantiles(v, n=100)[94]


class Reading:
    """What per-layer readers read: the window, the decoders' counters,
    the benchmark's spans, the device trace and the roofline bounds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def kernel_seconds(self, names) -> float:
        """Card time of the kernels whose names start with any of
        `names`: their merged intervals in the traced window."""
        from .tracing import merged_seconds
        if self.trace is None:
            return 0.0
        return merged_seconds([e for e in self.trace["events"]
                               if any(n in e[0] for n in names)])

    def roofline_share(self, kernel: str):
        mod = importlib.import_module(f"benchmark.rooflines.{kernel}")
        t = self.kernel_seconds(mod.KERNELS)
        bound = self.bound_s.get(kernel, 0.0)
        if t <= 0 or bound <= 0:
            return None
        return 100.0 * bound / t

    def idle_share(self):
        if self.trace is None or self.trace["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.window_s)


def roofline_bounds(rec: Recorder, exp: dict) -> dict:
    """Least seconds of K1, K5 and K4 for the work the window did: each
    picture reconstructed (K1, K5) and each audio frame synthesized (K4)."""
    from .rooflines import k1, k4, k5
    from .rooflines.peaks import HBM_BYTES_PER_S
    b1 = b5 = 0
    for log in rec.clips.values():
        n = pictures_decoded(log)
        for g in log.clip.gops:
            counts = exp["gop_counts"][g]
            for c in counts[:n]:
                b1 += k1.picture_bytes(c, exp["geom"])
                b5 += k5.picture_bytes(c, exp["geom"])
            n -= len(counts[:n])
            if n <= 0:
                break
    return {"k1": b1 / HBM_BYTES_PER_S, "k5": b5 / HBM_BYTES_PER_S,
            "k4": rec.audio_frames * k4.frame_seconds()}


def metric_specs(cell: str, bench: dict, trace: bool) -> list:
    """The metrics `cell` reports: its end-to-end ones (--trace 0) or its
    per-layer ones (--trace 1), as `BENCHMARK.json` lists them."""
    specs = bench["per_layer"] if trace else bench["end_to_end"]
    out = []
    for m in specs:
        cells = m.get("workloads")
        if cells is None and trace:
            moves = next(e for e in bench["end_to_end"]
                         if e["name"] == m["moves"])
            cells = moves.get("workloads")
        if cells is None or cell in cells:
            out.append(m)
    return out


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def setup_environment() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_entry(folder: str, name: str):
    """`<folder>/entries/<name>.py`: `run(ctx, rec, items, until)` drives
    the program's entry point; `control(rec, key, item, args, out)` lays
    out the deliveries it makes of one item with `out`'s frames."""
    return load_file_module(os.path.join(folder, "entries", f"{name}.py"),
                            f"benchmark_entry_{name}")


def cell_inputs(cell: str, seed: int, folder: str = HERE):
    """(workload, configuration, traffic, entry arguments) of `cell`,
    found by name under `folder`, its inputs built from `seed`."""
    from .traffic import generator
    wl = load_json(folder, "workloads", f"{cell}.json")
    config = load_json(folder, "configs", f"{wl['config']}.json")
    spec = load_json(folder, "traffic", f"{wl['traffic']}.json")
    traffic = generator.make(spec, generator.load_fixture(config, ROOT),
                             seed, folder)
    return wl, config, traffic, {**wl.get("entry_args", {}),
                                 **spec.get("client", {})}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float = None, folder: str = HERE,
             cache_dir: str = CACHE_DIR, log=None):
    """Run one cell; returns (result dict, stderr check lines).

    `folder` holds the cell's files (a copy with other traffic for the
    CPU tests), and `device` is the card (the CPU for the tests)."""
    import torch
    from mpeg_tpu_torch.parallel import batch as pbatch
    from mpeg_tpu_torch.utils.profiling import DecodeStats, device_trace

    from . import refcache, tracing

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t0 = time.time() if t0 is None else t0
    bench = load_json(ROOT, "BENCHMARK.json")
    wl, config, traffic, args = cell_inputs(cell, seed, folder)
    entry = load_entry(folder, wl["entry"])
    dev = torch.device(device)
    stats = DecodeStats()
    ctx = Context(dev, args, stats)

    # Warm-up: the cell's own shapes, through its own entry.
    warm = Recorder(seed, 0, False, keep_pcm=False)
    entry.run(ctx, warm, iter([(("warm", 0), traffic.warmup)]), math.inf)
    rec = Recorder(seed, wl["samples"], trace, pin=dev.type == "cuda")
    if warm.like is not None:
        rec.reserve(warm.like)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    items = ((("clip", i), traffic.items[i % len(traffic.items)])
             for i in range(10 ** 9))
    ctx.stats = stats = DecodeStats()   # the window's counters alone
    pbatch.reset_transport_counts()
    trace_dir = os.path.join(cache_dir, "trace", cell)
    prof = device_trace(trace_dir) if trace and dev.type == "cuda" \
        else contextlib.nullcontext(None)
    with prof as traced:
        start = time.perf_counter()
        setup_s = time.time() - t0
        cpu0 = time.process_time()
        with tracing.window_marker(trace):
            entry.run(ctx, rec, items, start + seconds)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        end = time.perf_counter()
        cpu1 = time.process_time()
    window_s = end - start
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    h2d_bytes = pbatch.transport_counts.bytes
    summary = None
    if trace and dev.type == "cuda":
        summary = tracing.summarize(traced, start, end, rec.spans or [])

    # The check: the sampled frames are on the host since the window's
    # last synchronize; the reference (cached a checkout) judges them.
    exp = refcache.expected(config, ROOT, cache_dir)
    checks = check(rec, exp)
    ok = passed(checks)

    frames = rec.frames
    gaps = np.diff([start] + rec.returns) * 1000.0
    reading = Reading(window_s=window_s, frames=frames, stats=stats,
                      h2d_bytes=h2d_bytes, spans=rec.span_seconds(),
                      trace=summary, bound_s=roofline_bounds(rec, exp))
    metrics = {}
    for m in metric_specs(cell, bench, trace):
        if not trace:
            value = {
                "frames_per_s": frames / window_s,
                "delivery_p95_ms": p95(gaps),
                "tick_p95_ms": p95(np.asarray(rec.ticks) * 1000.0),
                "host_cpu_ms_per_frame": (cpu1 - cpu0) * 1000.0 / frames
                if frames else None,
                "setup_s": setup_s,
            }[m["name"]]
        else:
            reader = load_file_module(
                os.path.join(folder, "metrics", f"{m['name']}.py"),
                "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(reading)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev_info["busy_s"] = summary["busy_s"] if summary else 0.0
        dev_info["window_s"] = window_s
    result = {"correct": ok, "attempted": len(rec.clips),
              "failed": checks.pop("_bad_clips"), "metrics": metrics,
              "device": dev_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    log(f"window {window_s:.3f} s, {frames} frames, "
        f"{len(rec.returns)} deliveries, {len(rec.clips)} clips, "
        f"{len(rec.held)} frames and {len(rec.pcm)} PCM frames compared")
    return result, check_lines(checks)


def main(argv=None, t0: float = None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    err = lambda *x: print(*x, file=sys.stderr, flush=True)   # noqa: E731
    if a.seed < 0:
        err("--seed must be a non-negative integer")
        return 2
    if not os.path.isfile(os.path.join(HERE, "workloads",
                                       f"{a.workload}.json")):
        err(f"no workload {a.workload!r} under benchmark/workloads/")
        return 2
    try:
        import mpeg_tpu_torch  # noqa: F401
    except ImportError as e:
        err(f"the measured package is missing: {e}")
        return 2
    import torch
    wl = load_json(HERE, "workloads", f"{a.workload}.json")
    chips = wl.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"this cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    err(f"device: {torch.cuda.get_device_name(0)}; "
        f"nvidia-smi: {power_limit()}; torch {torch.__version__}")
    result, lines = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                             t0=t0)
    bad = forbidden_modules()
    if bad:
        err(f"loaded in the measuring process: {', '.join(bad)}")
        return 3
    for line in lines:
        err(line)
    print(json.dumps(result), flush=True)
    return 0
