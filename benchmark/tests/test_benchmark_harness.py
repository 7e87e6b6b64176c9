"""BENCHMARK.json against the benchmark's contract, the harness's
data-driven look-up, the traffic's seeding and the run's refusal without
a card."""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import generator

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_only_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]] + \
            [c["source"] for c in BENCH["configs"]] + \
            [c["why"] for c in BENCH["configs"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text


def test_entries_have_just_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) < 64 * 1024


def _e2e_cells(name):
    m = next(e for e in BENCH["end_to_end"] if e["name"] == name)
    return m.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_each_moves_names_a_metric_every_cell_of_it_reports():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert cell in _e2e_cells(m["moves"]), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in harness.metric_specs(w["name"], BENCH,
                                                       False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metric_specs(w["name"], BENCH, True)


def test_every_configuration_has_a_cell_and_its_files():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
    here = harness.HERE
    for w in BENCH["workloads"]:
        wl = harness.load_json(here, "workloads", f"{w['name']}.json")
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert os.path.isfile(os.path.join(here, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(here, "entries",
                                           f"{wl['entry']}.py"))
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics",
                                           f"{m['name']}.py"))


def _clips(folder, cell, seed):
    wl, config, traffic, args = harness.cell_inputs(cell, seed, folder)
    flat = [c for item in traffic.items
            for c in (item if isinstance(item, list) else [item])]
    return [(c.gops, c.pictures, len(c.data)) for c in flat]


@pytest.mark.parametrize("cell", ["m1v1080_single", "m1v1080_64streams",
                                  "ps1080_av_player"])
def test_a_seed_gives_its_clips_and_another_seed_others(small, cell):
    a = _clips(small, cell, 2 ** 31 + 12345)
    assert a == _clips(small, cell, 2 ** 31 + 12345)
    others = [_clips(small, cell, s) for s in (7, 8, 9, 10)]
    assert any(b != a for b in others)
    # the same work for every seed: the same lengths, and for each
    # length the same GOPs, in another order
    for b in others:
        assert sorted((sorted(g), p) for g, p, _ in a) == \
            sorted((sorted(g), p) for g, p, _ in b)


@pytest.mark.parametrize("mix", ["yt8m_queue_120_500s", "ssv2_jobs_64x2_6s",
                                 "kinetics_player_10s"])
def test_a_mixs_clips_keep_to_its_published_range(mix):
    """Each length of a mix, once whole GOPs make it up, lies in the
    range its source publishes, as seconds at the fixture's 30 fps."""
    spec = harness.load_json(harness.HERE, "traffic", f"{mix}.json")
    config = harness.load_json(harness.HERE, "configs",
                               "mpeg1_1080p30_gop12.json")
    fx = generator.load_fixture(config, harness.ROOT)
    lo, hi = spec["clip_pictures"]
    n = spec.get("streams", spec.get("queue_clips"))
    for target in generator.lengths(lo, hi, n, np.random.default_rng(1)):
        gops = generator.clip_gops(fx, target)
        pictures = sum(fx.gop_pictures[g] for g in gops)
        assert target <= pictures < target + 12
        assert lo - 12 <= pictures <= hi + 12


def test_a_player_clip_muxes_its_video_and_looped_audio():
    from benchmark import reference as ref
    wl = harness.load_json(harness.HERE, "workloads",
                           "ps1080_av_player.json")
    config = harness.load_json(harness.HERE, "configs",
                               f"{wl['config']}.json")
    fx = generator.load_fixture(config, harness.ROOT)
    spec = dict(harness.load_json(harness.HERE, "traffic",
                                  f"{wl['traffic']}.json"),
                clip_pictures=[40, 40], queue_clips=1)
    clip = generator.make(spec, fx, 3).items[0]
    video, audio = ref.demux(clip.data)
    assert video == b"".join(fx.gops[g] for g in clip.gops)
    assert clip.audio_frames == generator.audio_frames_for(
        clip.pictures, 30.0, 44100)
    assert audio == b"".join(fx.audio_frames[j % 355]
                             for j in range(clip.audio_frames))


def test_a_fixture_that_differs_fails_the_run(tmp_path):
    config = harness.load_json(harness.HERE, "configs",
                               "mpeg1_1080p30_gop12.json")
    config["video"]["sha256"] = "0" * 64
    with pytest.raises(generator.FixtureError):
        generator.load_fixture(config, harness.ROOT)


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "m1v1080_single",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_a_run_without_a_card_fails_and_prints_no_result():
    r = _run(harness.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    """A new cell (its workload file, a traffic mix of a new kind) and a
    new per-layer metric (its reader), dropped into a copy of the
    benchmark with their BENCHMARK.json entries, run with no edit to any
    file already there."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("mpeg_tpu_torch", "tests"):
        os.symlink(os.path.join(harness.ROOT, name), tmp_path / name)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "m1v1080_tiny", "config":
                               "mpeg1_1080p30_gop12", "traffic": "tiny",
                               "chips": 1, "why": "a test cell"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "frames_per_s")["workloads"].append("m1v1080_tiny")
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frames_per_s",
                               "workloads": ["m1v1080_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = tmp_path / "benchmark"
    (b / "traffic" / "tiny.json").write_text(json.dumps(
        {"kind": "gop_list", "gops": [[2, 0], [1]]}))
    (b / "traffic" / "kinds" / "gop_list.py").write_text(
        "from benchmark.traffic.generator import Clip\n"
        "def make(spec, fx, rng, warm_rng):\n"
        "    clips = [Clip(tuple(g), sum(fx.gop_pictures[i] for i in g),\n"
        "                  b''.join(fx.gops[i] for i in g))\n"
        "             for g in spec['gops']]\n"
        "    return clips[-1], clips\n")
    (b / "workloads" / "m1v1080_tiny.json").write_text(json.dumps(
        {"config": "mpeg1_1080p30_gop12", "traffic": "tiny",
         "entry": "batch_video", "entry_args": {"window": 4,
                                                "prefetch": False},
         "chips": 1, "samples": 8}))
    (b / "metrics" / "frames_seen.py").write_text(
        "def read(r):\n    return float(r.frames)\n")
    code = (
        "import sys, json\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "assert harness.HERE.startswith(%r)\n"
        "for trace in (False, True):\n"
        "    res, lines = harness.run_cell('m1v1080_tiny', 5, 0.5, trace,\n"
        "        device='cpu', cache_dir=%r)\n"
        "    print(json.dumps(res))\n" % (str(tmp_path),
                                          harness.CACHE_DIR))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    plain, traced = [json.loads(x) for x in r.stdout.strip().splitlines()]
    assert plain["correct"] and traced["correct"]
    # the metrics that list their cells report in the new one only where
    # its BENCHMARK.json entry added it
    assert set(plain["metrics"]) == {"frames_per_s", "setup_s"}
    assert traced["metrics"]["frames_seen"]["value"] > 0


def test_the_sample_is_copied_off_the_frames_and_reaches_late_deliveries():
    import torch
    rec = harness.Recorder(2 ** 31 + 5, 8, False)
    rec.open("c", None)
    frames = [torch.full((16,), i, dtype=torch.uint8) for i in range(200)]
    for i in range(0, 200, 2):
        rec.deliver("c", frames[i:i + 2])
    assert rec.offered == 100 and len(rec.held) == 8
    for f in frames:
        f.zero_()       # the program reuses its buffers: the copies stay
    got = list(rec.held_frames())
    assert all((a == k).all() for _, k, a in got)
    assert max(k for _, k, _ in got) > 100   # not only the first eight
    assert rec.pool.device.type == "cpu"
    again = harness.Recorder(2 ** 31 + 5, 8, False)
    again.open("c", None)
    for i in range(0, 200, 2):
        again.deliver("c", frames[i:i + 2])
    assert again.held == rec.held


def test_a_configuration_of_audio_alone_is_loaded_and_checked():
    config = harness.load_json(harness.HERE, "configs",
                               "ps_mpeg1_1080p30_mp2.json")
    del config["video"]
    fx = generator.load_fixture(config, harness.ROOT)
    assert fx.gops == [] and len(fx.audio_frames) == 355
    rec = harness.Recorder(1, 8, False)
    rec.open("c", generator.Clip((), 0, b"", 2))
    pcm = np.arange(2 * 2304, dtype=np.float32).reshape(2, 2304)
    for row in pcm:
        rec.audio("c", row)
    rec.close("c")
    checks = harness.check(rec, {"pcm": np.concatenate([pcm] * 5)})
    assert "frames_compared" not in checks
    assert harness.passed(checks) and checks["pcm_compared"]["value"] == 2


def test_the_benchmarks_own_copies_are_left_out_of_the_device_time(tmp_path):
    from benchmark import tracing
    host = 1_000_000.0
    events = [
        {"ph": "X", "name": tracing.WINDOW, "ts": host, "dur": 10_000,
         "tid": 1},
        {"ph": "X", "name": tracing.SAMPLE, "ts": host + 100, "dur": 50,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": host + 120, "dur": 5, "tid": 1, "args": {"correlation": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": host + 130, "dur": 5, "tid": 2, "args": {"correlation": 6}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": host + 200, "dur": 1000, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "reconstruct_kernel",
         "ts": host + 300, "dur": 2000, "args": {"correlation": 6}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tracing.summarize({"trace": str(path)}, 0.0, 0.01, [])
    assert [e[0] for e in s["events"]] == ["reconstruct_kernel"]
    assert abs(s["busy_s"] - 0.002) < 1e-12
