"""The port's spans and counters (`mpeg_tpu_torch.utils.profiling`): off
without a collector, the decodes' output unchanged under one, every span
of the layer boundaries with its parent under `device_trace` on the CPU,
and the benchmark's readers of them."""

import importlib.util
import json
import pathlib
import time
import types

import numpy as np
import pytest
import torch

import mpeg_tpu_torch as mpeg
from mpeg_tpu_torch.parallel import BatchVideoDecoder, MultiStreamVideoDecoder
from mpeg_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).parent.parent
TESTDATA = ROOT / "tests" / "testdata"
ES = (TESTDATA / "test.mpeg1video").read_bytes()
PS = (TESTDATA / "test.mpg").read_bytes()
TICKS = 12

# Each span and its parent as the decodes below open them; a parse on the
# prefetch thread has none (its thread opened nothing around it).
PARENTS = {
    "mpeg.open": None,
    "mpeg.open.copy": "mpeg.open",
    "mpeg.open.parser": "mpeg.open",
    "mpeg.window": None,
    "mpeg.parse.wait": "mpeg.window",
    "mpeg.parse": "mpeg.parse.wait",
    "mpeg.slot.wait": "mpeg.parse",
    "mpeg.state": "mpeg.window",
    "mpeg.enqueue": "mpeg.window",
    "mpeg.h2d": "mpeg.enqueue",
    "mpeg.launch": "mpeg.enqueue",
    "mpeg.alloc.pinned": "mpeg.parse",
    "mpeg.block": "mpeg.audio.synth",
    "mpeg.decode": None,
    "mpeg.video.plan": "mpeg.decode",
    "mpeg.audio.frame": "mpeg.decode",
    "mpeg.video.reconstruct": "mpeg.decode",
    "mpeg.video.records": "mpeg.video.reconstruct",
    "mpeg.video.pack": "mpeg.video.reconstruct",
    "mpeg.video.launch": "mpeg.video.reconstruct",
    "mpeg.audio.synth": "mpeg.decode",
}
COUNTERS = ("state_builds", "pool_growths", "host_blob_allocs",
            "host_blob_bytes", "blocks", "native_picture_blobs")
READERS = ("parse_block_share", "open_share", "pinned_alloc_share",
           "host_blocked_share.batch", "host_blocked_share.av",
           "av_records_share", "idle_outside_spans_share.batch",
           "idle_outside_spans_share.av")


def _batch(prefetch):
    dec = BatchVideoDecoder(ES[:40000], window=4, prefetch=prefetch,
                            device="cpu")
    return [f.numpy().tobytes() for f in dec.decode_all()]


def _multistream():
    dec = MultiStreamVideoDecoder([ES[:30000], ES[:20000]], window=2,
                                  device="cpu")
    return [[f.numpy().tobytes() for f in s] for s in dec.decode_all()]


def _player():
    m = mpeg.MPEG(PS, device="cpu")
    out = []
    m.set_video_callback(lambda _m, f: out.append(f.flat.numpy().tobytes()))
    m.set_audio_callback(
        lambda _m, s: out.append(np.asarray(s.interleaved).tobytes()))
    for _ in range(TICKS):
        m.decode(1 / 30)
    return out


DECODES = {"batch": lambda: _batch(False),
           "batch_prefetch": lambda: _batch(True),
           "multistream": _multistream, "player": _player}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Every decode under one `device_trace` on the CPU: (its result,
    its collector, the block's seconds)."""
    log_dir = tmp_path_factory.mktemp("trace")
    t0 = time.perf_counter()
    with profiling.device_trace(str(log_dir)) as result:
        for run in DECODES.values():
            run()
    return result, profiling.last_trace(), time.perf_counter() - t0


@pytest.mark.parametrize("active", [False, True])
def test_spans_are_the_null_context_without_a_collector(monkeypatch,
                                                        active):
    calls = []
    real = torch.profiler.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(profiling, "_last", None)
    if not active:
        assert profiling.span("mpeg.a") is profiling.span("mpeg.b", 3)
        with profiling.span("mpeg.a", 1):
            profiling.count("blocks")
        assert calls == [] and profiling.last_trace() is None
        return
    with profiling.collect() as col:
        with profiling.span("mpeg.a", 1):
            profiling.count("blocks", 2)
    assert calls == ["mpeg.a"] and col.counts == {"blocks": 2}
    assert profiling.last_trace() is col and profiling.span("mpeg.a") \
        is profiling.span("mpeg.b")
    (_, name, parent, key, _, main, t0, t1), = col.spans
    assert (name, parent, key, main) == ("mpeg.a", None, 1, True)
    assert t1 >= t0


@pytest.mark.parametrize("decode", sorted(DECODES))
def test_output_is_the_same_under_a_collector(decode):
    plain = DECODES[decode]()
    with profiling.collect() as col:
        spanned = DECODES[decode]()
    assert spanned == plain and len(plain) > 0
    assert col.spans


def test_every_span_appears_with_its_parent(traced):
    result, col, _ = traced
    report = json.loads(pathlib.Path(result["spans"]).read_text())
    seen = {}
    for s in report["spans"]:
        seen.setdefault(s["name"], set()).add((s["parent"], s["main"]))
    assert set(seen) == set(PARENTS)
    for name, parent in PARENTS.items():
        assert (parent, True) in seen[name], (name, seen[name])
    # Under prefetch the parse runs on its own thread and the decode waits
    # for it on the main one.
    assert (None, False) in seen["mpeg.parse"]
    assert {main for _, main in seen["mpeg.parse.wait"]} == {True}
    assert set(report["counts"]) == set(COUNTERS)
    assert all(report["counts"][c] > 0 for c in COUNTERS)
    assert report["counts"] == col.counts
    assert set(report["by_name"]) == set(PARENTS)
    for name, row in report["by_name"].items():
        assert 0 <= row["self_seconds"] <= row["seconds"] + 1e-9, name
    # The capture holds the main thread's spans beside the profiler's
    # events; the idle time (all of it: no card) split by span.
    trace = json.loads(pathlib.Path(result["trace"]).read_text())
    ranges = {e["name"] for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {n for n, ps in seen.items() if any(m for _, m in ps)} <= ranges
    idle = report["idle_by_span"]
    assert "null" in idle and set(idle) - {"null"} <= set(PARENTS)
    assert sum(idle.values()) == pytest.approx(
        sum(col.idle_by_span.values()))


def test_seconds_merge_and_self_seconds_leave_out_children():
    col = profiling.Collector()
    ms = 1_000_000
    col.spans += [(1, "mpeg.x", None, None, 1, True, 0, 10 * ms),
                  (2, "mpeg.y", 1, None, 1, True, 2 * ms, 4 * ms),
                  (3, "mpeg.x", None, None, 2, False, 5 * ms, 20 * ms),
                  (4, "mpeg.y", 3, None, 2, False, 12 * ms, 15 * ms)]
    assert col.seconds("mpeg.x") == pytest.approx(0.020)
    assert col.seconds("mpeg.x", main_only=True) == pytest.approx(0.010)
    # [0, 2] + [4, 10] from the first, [5, 12] + [15, 20] from the second
    assert col.self_seconds("mpeg.x") == pytest.approx(0.015)
    assert col.self_seconds("mpeg.y") == pytest.approx(0.005)
    assert col.seconds("mpeg.none") == col.self_seconds("mpeg.none") == 0



def test_idle_is_split_by_the_innermost_span_of_the_capture_thread(
        tmp_path):
    def x(name, ts, dur, tid=1, cat="user_annotation"):
        return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
                "ts": ts, "dur": dur}
    events = [x(profiling.CAPTURE, 0, 100), x("mpeg.window", 5, 75),
              x("mpeg.parse", 30, 15), x("mpeg.parse", 0, 100, tid=2),
              x("other", 0, 100), x("k", 10, 10, tid=9, cat="kernel"),
              x("m", 50, 10, tid=9, cat="gpu_memcpy"),
              x("mpeg.window", 40, 10, tid=9, cat="gpu_user_annotation")]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    idle = profiling.idle_by_span(str(path))
    # idle [0, 10], [20, 50], [60, 100] (us); the window open over
    # [5, 80], the parse inside it over [30, 45]
    assert set(idle) == {None, "mpeg.window", "mpeg.parse"}
    assert idle[None] == pytest.approx(25e-6)
    assert idle["mpeg.window"] == pytest.approx(40e-6)
    assert idle["mpeg.parse"] == pytest.approx(15e-6)

def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", READERS)
def test_readers_read_a_share_and_none_without_spans(monkeypatch, traced,
                                                     name):
    _, col, seconds = traced
    reading = types.SimpleNamespace(window_s=seconds)
    reader = _reader(name)
    monkeypatch.setattr(profiling, "_last", col)
    value = reader.read(reading)
    assert 0.0 <= value <= 100.0
    if name.startswith(("parse_block", "open", "pinned", "av_records")):
        assert value > 0.0
    with profiling.collect():
        assert reader.read(reading) == 0.0   # no span, no idle
    monkeypatch.setattr(profiling, "_last", None)
    assert reader.read(reading) is None
