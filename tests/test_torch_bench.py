"""The port's bench leg (`mpeg_tpu_torch.bench`) on the CPU against the JAX
package's `bench.py`, loaded by path with JAX on the CPU: the bucket
discovery, the headline's window filler (parse threads 1 and 2), the
64-stream global filler and the fixture recipe byte for byte; the
headline decode against `mpeg_tpu.parallel.sharding`'s blob decoder on a
one-device mesh, every display of every round, and against the C++ host
decoder over the looping 1080p fixture; no ring slot written while its
copy pends; the mesh mode on a CPU mesh; and the command line on the CPU
and without a card.  Tolerance: exact."""

import hashlib
import importlib.util
import json
import os
import pathlib
import queue
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from mpeg_tpu.parallel import sharding as jsh
from mpeg_tpu_torch import bench
from mpeg_tpu_torch.parallel import batch as tb
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTDATA = REPO / "tests" / "testdata"
ES = TESTDATA / "test.mpeg1video"
FIXTURE_1080P = TESTDATA / "test1080.m1v"
FIXTURE_SHA256 = \
    "85397303558f295e"   # the first 16 hex digits of the committed file's


@pytest.fixture(scope="module")
def jbench():
    """The JAX package's bench.py, loaded by path."""
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cut(data: bytes, pictures: int) -> bytes:
    """`data` up to its picture start code number `pictures`."""
    pos = -1
    for _ in range(pictures + 1):
        pos = data.find(b"\x00\x00\x01\x00", pos + 1)
    return data[:pos]


def _geom(g):
    return (g.width, g.height, g.mb_width, g.mb_height)


@pytest.mark.parametrize("name,window", [("test1080.m1v", 16),
                                         ("test1080.m1v", 2),
                                         ("test.mpeg1video", 16)])
def test_discover_buckets_equal_bench_py(jbench, name, window):
    data = (TESTDATA / name).read_bytes()
    geom, pics, km, ke = bench.discover_buckets(data, window)
    jgeom, jpics, jkm, jke = jbench.discover_buckets(data, window)
    assert (_geom(geom), pics, km, ke) == (_geom(jgeom), jpics, jkm, jke)
    if name == "test1080.m1v" and window == 16:
        assert (pics, km, ke) == (32, 524288, 1024)


@pytest.mark.parametrize("threads", [1, 2])
def test_window_filler_equals_bench_py(jbench, threads, monkeypatch):
    """4 streams x 3 rounds of 16 on the 1080p fixture (the third round
    reloops) through rings of 2 slots, so the third fill recycles a slot:
    the meta stack, the main lanes and kt byte-equal to bench.py's."""
    data = FIXTURE_1080P.read_bytes()
    window, n = 16, 4
    geom, _, km, ke = bench.discover_buckets(data, window)
    jgeom, _, _, _ = jbench.discover_buckets(data, window)
    fill, ring = bench.make_window_filler(geom, window, km, ke, n, depth=2,
                                          device="cpu",
                                          parse_threads=threads)
    monkeypatch.setattr(jbench, "PARSE_THREADS", threads)
    jfill, jring = jbench.make_window_filler(jgeom, window, km, ke, n,
                                             depth=2)
    streams = [bench.Stream(data) for _ in range(n)]
    jstreams = [jbench.Stream(data) for _ in range(n)]
    split = tb.blob_split(geom, window, km, ke)
    try:
        for _ in range(3):
            (meta, mainb, kt), slot = fill(streams)
            (jmeta, jmainb, jkt), jslot = jfill(jstreams)
            assert meta.shape == (n, split) and mainb.shape == (n, 4 * km)
            assert kt == jkt and kt <= km
            np.testing.assert_array_equal(meta.numpy(), jmeta)
            np.testing.assert_array_equal(mainb.numpy(), jmainb)
            ring.release(slot)
            jring.release(jslot)
    finally:
        ring.close()


def test_global_filler_equals_bench_fill64(jbench):
    """The 64-stream leg's global filler at 8 streams x window 2 on the
    small fixture (staggered as bench.py staggers them) against bench.py's
    fill64 logic (bench.py:838-871) carried here on the JAX package's
    parser: four fills through two slots, byte for byte."""
    from mpeg_tpu import native as jnative
    from mpeg_tpu.parallel.batch import blob_split, pool_bucket, split_views

    data = ES.read_bytes()
    s_n, w = 8, 2
    gw = s_n * w
    geom, pics, km, ke = bench.discover_buckets(data, w)
    jgeom = jbench.discover_buckets(data, w)[0]
    kmg = pool_bucket(s_n * km // 2, 4096)
    keg = pool_bucket(s_n * ke, 64)
    mb = geom.mb_size
    hb = (mb * 6 * 64 >> 16) + 2

    def staggered(parser_of):
        streams = [parser_of() for _ in range(s_n)]
        scratch = (np.empty(2 * (km + hb), np.uint16),
                   np.empty(ke + hb, np.uint16), np.empty(ke + hb, np.int32),
                   np.empty(mb, np.int16), np.empty(mb, np.int16),
                   np.empty(mb, np.uint16), np.empty(mb, np.uint8))
        for s, st in enumerate(streams):
            for _ in range(s % pics):
                if st.p.blob_prepare() == 0:
                    break
                st.p.blob_emit(*scratch, 0)
        return streams

    class JStream:
        def __init__(self):
            self.p = jnative.NativeVideoParser(data)

        def reloop(self):
            self.p.reset(data)

    streams = staggered(lambda: bench.Stream(data))
    jstreams = staggered(JStream)
    fill, ring = bench.make_global_filler(geom, w, kmg, keg, s_n,
                                          device="cpu")

    ring64 = queue.Queue()          # bench.py's fill64, as it is there
    split_g = blob_split(jgeom, gw, kmg, keg)
    for _ in range(2):
        meta_g = np.empty(split_g, np.uint8)
        main_g = np.empty(4 * kmg, np.uint8)
        vg = split_views(meta_g, main_g, jgeom, gw, kmg, keg)
        ring64.put([meta_g, main_g, vg, np.empty(gw, np.int32), kmg, keg])

    def fill64(streams):
        slot = ring64.get()
        meta_g, main_g, vg, types_g, hw_m, hw_e = slot
        nm = ne = pm = pe = 0
        for s, st in enumerate(streams):
            w_done = s * w
            while w_done < (s + 1) * w:
                n, nm, ne, pending, pm, pe = st.p.blob_window(
                    w_done, (s + 1) * w, kmg, keg, nm, ne,
                    vg["main_rec"], vg["esc_didx"], vg["esc_val"],
                    vg["mv_h"], vg["mv_v"], vg["nbcls"], vg["mbmisc"],
                    vg["flags"], types_g,
                    hw_nm=hw_m if s == s_n - 1 else 0,
                    hw_ne=hw_e if s == s_n - 1 else 0,
                    prev_m=pm, prev_e=pe)
                assert pending == 0
                w_done += n
                if w_done < (s + 1) * w:
                    st.reloop()
        slot[4], slot[5] = nm, ne
        return (meta_g, main_g, nm), slot

    for _ in range(4):
        (meta, main, nm), slot = fill(streams)
        (jmeta, jmain, jnm), jslot = fill64(jstreams)
        assert nm == jnm > 0
        np.testing.assert_array_equal(meta.numpy(), jmeta)
        np.testing.assert_array_equal(main.numpy(), jmain)
        ring.release(slot)
        ring64.put(jslot)


def test_headline_decode_equals_jax_sharded_decoder(jbench):
    """The headline decode (the window filler, `HeadlineDecoder.transfer`
    and `.decode`) over 4 streams of the small fixture cut to 12
    pictures, window 4, for 5 rounds (every stream reloops after its
    third), against the JAX package's `make_sharded_blob_decoder` on a
    one-device CPU mesh fed the same whole blobs: every display of every
    round, and the pictures decoded."""
    import jax

    data = _cut(ES.read_bytes(), 12)
    window, n = 4, 4
    geom, pics, km, ke = bench.discover_buckets(data, window)
    assert pics == 12
    jgeom = jbench.discover_buckets(data, window)[0]
    fill, ring = bench.make_window_filler(geom, window, km, ke, n,
                                          device="cpu")
    head = bench.HeadlineDecoder(geom, window, km, ke, n, ring, "cpu")
    jmesh = jsh.make_mesh(jax.devices()[:1])
    jdec = jsh.make_sharded_blob_decoder(jgeom, jmesh, window, km, ke)
    jcarry = jsh.zero_carry(jgeom, n, jmesh)
    carry = head.fresh_carry()
    streams = [bench.Stream(data) for _ in range(n)]
    for rnd in range(5):
        filled = fill(streams)
        (meta, mainb, _kt), _slot = filled
        blobs = np.concatenate([meta.numpy(), mainb.numpy()], 1)
        carry, disps = head.decode(carry, head.transfer(filled))
        jcarry, jdisps, jpx = jdec(jcarry, blobs)
        assert disps.shape == (n, window, geom.total_size)
        np.testing.assert_array_equal(disps.numpy(), np.asarray(jdisps),
                                      err_msg=f"round {rnd}")
        assert int(jpx) == n * window * geom.frame_size
    ring.close()


def test_headline_displays_equal_the_looping_host_decoder():
    """`chip_smoke.py`'s check of the headline at CPU scale: one stream of
    the 1080p fixture (I and P pictures only, so no picture of a loop
    predicts from the loop before), window 16, 3 rounds (the third
    reloops): every display but the first (the reference delay holds it
    back) equals the JAX package's C++ host decoder run over the looping
    fixture, reset at each loop's end as the bench's streams are."""
    from mpeg_tpu import native as jnative

    data = FIXTURE_1080P.read_bytes()
    window, rounds = 16, 3
    geom, pics, km, ke = bench.discover_buckets(data, window)
    fill, ring = bench.make_window_filler(geom, window, km, ke, 1,
                                          device="cpu")
    head = bench.HeadlineDecoder(geom, window, km, ke, 1, ring, "cpu")
    streams = [bench.Stream(data)]
    carry, got = head.fresh_carry(), []
    for _ in range(rounds):
        carry, disps = head.decode(carry, head.transfer(fill(streams)))
        got += [disps[0, t] for t in range(window)]
    ref, want = jnative.NativeHostDecoder(data), []
    for loop in range(2):
        if loop:
            ref.reset(data)
        while (f := ref.decode_next()) is not None:
            want.append(f)
    assert pics == 32 and len(want) == 64
    fs = geom.frame_size
    for i, a in enumerate(got[1:]):
        assert np.array_equal(a[:fs].numpy(), want[i][:fs]), f"display {i}"


class LazyGate:
    """A copy that completes only when waited on or after a few polls,
    standing in for the card's asynchronous copy: its host parts must not
    be written while it is pending (checked at every new copy, every wait
    and the test's end)."""

    live, faults = [], []

    def __init__(self, parts):
        self.parts, self.snapshot = parts, [p.clone() for p in parts]
        self.polls = 3

    @classmethod
    def check_live(cls):
        for gate in cls.live:
            if any(not torch.equal(p, s)
                   for p, s in zip(gate.parts, gate.snapshot)):
                cls.faults.append(gate)

    def query(self):
        self.polls -= 1
        if self.polls <= 0:
            self.synchronize()
        return self.polls <= 0

    def synchronize(self):
        LazyGate.check_live()
        if self in LazyGate.live:
            LazyGate.live.remove(self)


def test_ring_slot_waits_for_its_copy(monkeypatch):
    """Passes of the headline through a ring of 2 slots with a parse
    thread, every copy pending until its gate is waited on: the parse
    thread never writes a slot whose copy is pending, and the displays
    equal those of the same rounds without the lazy gate."""
    plain = tb.device_put

    def lazy_put(parts, device):
        LazyGate.check_live()
        outs, _ = plain(parts, device)
        gate = LazyGate(list(parts))
        LazyGate.live.append(gate)
        return outs, gate

    data = _cut(ES.read_bytes(), 12)
    window, n, rounds = 4, 2, 6

    def run(lazy):
        geom, _, km, ke = bench.discover_buckets(data, window)
        fill, ring = bench.make_window_filler(geom, window, km, ke, n,
                                              depth=2, device="cpu")
        head = bench.HeadlineDecoder(geom, window, km, ke, n, ring, "cpu")
        streams = [bench.Stream(data) for _ in range(n)]
        q = queue.Queue(maxsize=1)
        th = threading.Thread(
            target=lambda: [q.put(fill(streams)) for _ in range(rounds)],
            daemon=True)
        th.start()
        carry, out = head.fresh_carry(), []
        for _ in range(rounds):
            carry, disps = head.decode(carry, head.transfer(q.get()))
            out.append(disps)
        th.join(timeout=60)
        assert not th.is_alive()
        return out

    want = run(lazy=False)
    LazyGate.live, LazyGate.faults = [], []
    monkeypatch.setattr(bench, "device_put", lazy_put)
    got = run(lazy=True)
    LazyGate.check_live()
    assert not LazyGate.faults
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fixture_recipe_writes_the_committed_fixture(tmp_path):
    """bench.py's recipe, as the port keeps it, writes the committed
    1080p fixture byte for byte."""
    pytest.importorskip("cv2")
    path = bench.ensure_fixture(str(tmp_path))
    got = pathlib.Path(path).read_bytes()
    assert got == FIXTURE_1080P.read_bytes()
    assert hashlib.sha256(got).hexdigest().startswith(FIXTURE_SHA256)


def test_mesh_mode_on_a_cpu_mesh():
    """`BENCH_MESH=2` on the CPU: 2 streams as 2 shards of the sharded
    blob decoder on the CPU listed twice, ROUNDS rounds of window 4, every
    picture counted by the decoder's int64 pixel count."""
    out = bench.mesh_bench(2, "cpu", bench.Settings(window=4), str(ES))
    assert out["devices"] == ["cpu", "cpu"] and out["distinct_devices"] == 1
    assert out["frames"] == 2 * 4 * bench.ROUNDS and out["value"] > 0


# bench.py's JSON keys (bench.py:758-784) and its recon block's structure
# under the port's names.
_KEYS = ("metric", "value", "unit", "vs_baseline", "sustained_fps",
         "sustained_lap_min", "sustained_lap_median", "sustained_worst_lap",
         "parse_fps", "recon")
_RECON = ("plain_ms", "k1_ms", "k3_ms", "plain_contended_ms",
          "k1_contended_ms", "k3_contended_ms", "contended_pump_mbs",
          "auto_picks", "verdict", "agrees_with_default")


def _bench_cli(args, **env):
    return subprocess.run(
        [sys.executable, "-m", "mpeg_tpu_torch.bench", *args], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                 **env))


def test_bench_cli_on_the_cpu():
    """`python -m mpeg_tpu_torch.bench --device cpu` on the small fixture
    (no sustained segment, no 64-stream or long-form leg): one stdout
    line, a JSON object with bench.py's keys and the port's context."""
    r = _bench_cli(["--device", "cpu", "--fixture", str(ES)],
                   BENCH_SUSTAIN="0", BENCH_64STREAM="0",
                   BENCH_LONGFORM="0", BENCH_WINDOW="4")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    line = json.loads(lines[0])
    assert set(_KEYS) <= set(line), sorted(line)
    assert set(_RECON) <= set(line["recon"]), sorted(line["recon"])
    assert line["unit"] == "fps" and line["value"] > 0
    assert line["sustained_fps"] is None and line["parse_fps"] > 0
    assert line["recon"]["auto_picks"] == "k1"
    assert len(line["recon"]["contended_pump_mbs"]) == 3
    assert line["device"] == "cpu (the plain versions)"
    assert line["power_limit"] is None and line["pinned_bytes"] == 0
    assert line["host_cpus"] == os.cpu_count()
    assert line["parse_threads"] == 1
    assert line["fixture_sha256"] == hashlib.sha256(
        ES.read_bytes()).hexdigest()
    if bench._cv2() is None:
        assert line["vs_baseline"] is None
        assert line["baseline"] == "not measured: cv2 not importable"
    else:
        assert line["vs_baseline"] > 0
        assert line["baseline"].startswith("libavcodec")
    assert "C++ host-only decode" in r.stderr and "MP2 audio" in r.stderr


def test_bench_cli_needs_a_card_by_default():
    """Without `--device` it runs on the card: here, with no CUDA device,
    it exits non-zero with the CUDA error before any decode."""
    r = _bench_cli(["--fixture", str(ES)], BENCH_SUSTAIN="0")
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert r.stdout == ""
    assert "baseline" not in r.stderr and "END-TO-END" not in r.stderr
