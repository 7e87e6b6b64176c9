"""The port's spans and counters (`mpeg_tpu_torch.utils.profiling`): off
without a collector, the decodes' output unchanged under one, every span
of the layer boundaries with its parent under `device_trace` on the CPU,
and the benchmark's readers of them."""

import importlib.util
import json
import pathlib
import threading
import time
import types

import numpy as np
import pytest
import torch

import mpeg_tpu_torch as mpeg
from mpeg_tpu_torch.parallel import (BatchAudioDecoder, BatchVideoDecoder,
                                     MultiStreamVideoDecoder)
from mpeg_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).parent.parent
TESTDATA = ROOT / "tests" / "testdata"
ES = (TESTDATA / "test.mpeg1video").read_bytes()
PS = (TESTDATA / "test.mpg").read_bytes()
# 72 frames of the broadcast MP2: windows of 32, 32 and 8 frames.
MP2 = (TESTDATA / "mp2_48k_joint_256.mp2").read_bytes()[:72 * 768]
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
    "mpeg.parse.stream": "mpeg.parse",
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
            "host_blob_bytes", "blocks", "native_picture_blobs",
            "parse_workers")
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


@pytest.fixture(scope="module")
def multistream_collected():
    """A four-stream decode on three fill threads under `collect`: (the
    decoder, its collector).  The main thread holds its first stream of
    a fill until a pool thread has taken one since it last looked, so
    that the first fill and others run on more than one thread."""
    dec = MultiStreamVideoDecoder([ES[:40000], ES[:30000], ES[:20000],
                                   ES[:10000]], window=2, device="cpu")
    dec._parse_workers = 3
    parse, taken = dec._parse_stream, threading.Event()

    def held(slot, meta, parsed, worker, s):
        if worker:
            taken.set()
        elif s == 0:
            assert taken.wait(timeout=30)
            taken.clear()
        parse(slot, meta, parsed, worker, s)

    dec._parse_stream = held
    with profiling.collect() as col:
        dec.decode_all()
    dec.close()
    return dec, col


def test_multistream_records_a_parse_span_a_stream_and_fill(
        multistream_collected):
    dec, col = multistream_collected
    fills = [s for s in col.spans if s[1] == "mpeg.parse" and s[3] == dec._key]
    streams = [s for s in col.spans
               if s[1] == "mpeg.parse.stream" and s[3] == dec._key]
    assert len(fills) > 3 and len(streams) == 4 * len(fills)
    # on the main thread under the fill; on the pool's threads alone
    parents = {s[0]: s[1] for s in col.spans}
    assert {(parents.get(s[2]), s[5]) for s in streams} == \
        {("mpeg.parse", True), (None, False)}
    assert len(fills) < col.counts["parse_workers"] <= 3 * len(fills)


def test_parse_parallelism_reads_the_stream_spans(monkeypatch,
                                                  multistream_collected):
    _, col = multistream_collected
    reader = _reader("parse_parallelism")
    reading = types.SimpleNamespace(window_s=1.0)
    monkeypatch.setattr(profiling, "_last", col)
    assert 0.0 < reader.read(reading) <= 3.0 * 1.01
    with profiling.collect():
        assert reader.read(reading) is None   # no span
    monkeypatch.setattr(profiling, "_last", None)
    assert reader.read(reading) is None


# The MP2 batch decoder's spans (with the decoder's key) and their
# parents, as an inline parse opens them.
AUDIO_PARENTS = {
    "mpeg.open": None,
    "mpeg.open.parser": "mpeg.open",
    "mpeg.window": None,
    "mpeg.parse.wait": "mpeg.window",
    "mpeg.parse": "mpeg.parse.wait",
    "mpeg.audio.pack": "mpeg.window",
    "mpeg.h2d": "mpeg.window",
    "mpeg.launch": "mpeg.window",
    "mpeg.block": "mpeg.window",
}


def _batch_audio(**kw):
    dec = BatchAudioDecoder(MP2, window=32, device="cpu", **kw)
    windows = []
    while (pcm := dec.decode_window()) is not None:
        windows.append(pcm)
    dec.close()
    return dec, windows


def _keyed(col, dec):
    names = {s[0]: s[1] for s in col.spans}
    return [(s[1], names.get(s[2]), s[5]) for s in col.spans
            if s[3] == dec._key]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_batch_audio_records_its_spans_and_counters(native):
    with profiling.collect() as col:
        dec, windows = _batch_audio(use_native=native)
    spans = _keyed(col, dec)
    want = dict(AUDIO_PARENTS)
    if not native:
        del want["mpeg.open.parser"]   # the Python parse opens no parser
    assert {name for name, _, _ in spans} == set(want)
    for name, parent, main in spans:
        assert (parent, main) == (want[name], True), name
    # every span of these names is this decoder's (one key a decoder)
    assert {s[3] for s in col.spans if s[1] in want
            and s[1] != "mpeg.block"} == {dec._key}
    assert [len(w) // 2304 for w in windows] == [32, 32, 8]
    assert col.counts["audio_windows"] == len(windows) == \
        sum(1 for name, _, _ in spans if name == "mpeg.launch")
    assert col.counts["audio_frames"] == 72


def test_batch_audio_prefetch_parses_on_its_own_thread():
    with profiling.collect() as col:
        dec, windows = _batch_audio(prefetch=True)
    spans = _keyed(col, dec)
    # Every window is parsed on the parse thread; after the last one the
    # decoder parses inline, on the main thread, and finds no frames.
    mine = [s for s in col.spans if s[3] == dec._key]
    last_launch = max(s[7] for s in mine if s[1] == "mpeg.launch")
    parses = [s for s in mine if s[1] == "mpeg.parse"]
    assert sum(not s[5] for s in parses) == len(windows)
    assert all(s[6] > last_launch for s in parses if s[5])
    assert {(parent, main) for name, parent, main in spans
            if name == "mpeg.parse"} == {(None, False),
                                         ("mpeg.parse.wait", True)}
    assert {(parent, main) for name, parent, main in spans
            if name == "mpeg.parse.wait"} == {("mpeg.window", True)}
    assert col.counts["audio_frames"] == 72
    assert np.array_equal(np.concatenate(windows),
                          np.concatenate(_batch_audio()[1]))


def test_batch_audio_records_nothing_without_a_collector(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(profiling, "_last", None)
    _, plain = _batch_audio()
    assert calls == [] and profiling.last_trace() is None
    with profiling.collect():
        _, spanned = _batch_audio()
    assert "mpeg.audio.pack" in calls
    assert all(np.array_equal(a, b) for a, b in zip(plain, spanned))


MP2_READERS = ("mp2_enqueue_share", "parse_block_share.mp2", "open_share.mp2",
               "host_blocked_share.mp2", "idle_outside_spans_share.mp2")


@pytest.fixture(scope="module")
def audio_collected():
    """The MP2 batch decode under `collect`: (its collector, seconds)."""
    t0 = time.perf_counter()
    with profiling.collect() as col:
        _batch_audio()
    return col, time.perf_counter() - t0


@pytest.mark.parametrize("name", MP2_READERS)
def test_mp2_readers_read_the_audio_decoders_spans(monkeypatch,
                                                   audio_collected, name):
    col, seconds = audio_collected
    reader = _reader(name)
    reading = types.SimpleNamespace(window_s=seconds)
    monkeypatch.setattr(profiling, "_last", col)
    value = reader.read(reading)
    assert 0.0 <= value <= 100.0
    if name.startswith(("mp2_enqueue", "parse_block", "open", "host_blocked")):
        assert value > 0.0
    with profiling.collect():
        # no span: the enqueue share leaves itself out, the rest read 0
        want = None if name == "mp2_enqueue_share" else 0.0
        assert reader.read(reading) == want
    monkeypatch.setattr(profiling, "_last", None)
    assert reader.read(reading) is None
