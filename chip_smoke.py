#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mpeg_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--baseline RECON_CU]
                          [--synth-baseline SYNTH_CU]
                          [--densify-baseline DENSIFY_CU]

Builds the hand-written CUDA kernels from `mpeg_tpu_torch/csrc` with nvcc
(recon.cu, synth.cu and densify.cu, each its own library, and the C++
host parser with g++, all at the same time) and holds each kernel against
its plain
PyTorch version on the card at 1080p (K1 on adversarial plans, one
picture and 64 streams in one launch; K2; K3, the whole path and its two
plane launches alone; K1 and K3 on the 1080p fixture's 32 pictures in
decode order), each timed beside its byte bound, and K4, the MP2
synthesis, bit for bit in every form (`k4`: the ring form from all 16 V
positions and at ragged step counts, 32-frame and ragged windows as f32,
s16 and raw outputs, 8 streams in one launch), timed per frame and per
window in turns with its plain version beside its bound and the launch
floor; and K5, the window densify and metadata unpack (`k5`), bit for
bit on every coded block and metadata tensor at the main path's shapes
(the 1080p fixture's window of 16, two rounds of the 64-stream decode at
window 2, the 8-stream shard at window 16, a one-picture blob, malformed
chains), `DENSIFY_LAUNCHES` launches a call (as the library reports them
and as torch.profiler sees them), timed beside its bound and its plain
version; then drives every path
of the port and checks its output (the benchmark's cells, not this
run, time the single-stream, 64-stream and A/V player paths):

- `golden`: the fixtures and the custom-matrix ES through
  `BatchVideoDecoder(window=16, device="cuda")`, prefetch off and on,
  against their golden hashes;
- `e2e_1080p`: the 1080p fixture against the C++ host decoder;
- `recon_multi_1080p`: the same with K3 (K2 + two plane launches) in
  K1's place, then timed and profiled (K3's device time a picture);
- `multistream_golden`: four mixed streams in lockstep against solo
  decodes and the goldens;
- `multistream_1080p`: 64 streams of the 1080p fixture, window 2, every
  frame against the C++ host decoder;
- `rgba`: the 1080p fixture with `emit_rgba=True` against numpy;
- `audio`: MP2 through `Audio(device="cuda")` and `BatchAudioDecoder`
  (f32, s16, `out_device`) against the no-FMA golden and each other, K4
  launched once a frame and once a window after one pinned copy of
  samples each, timed;
- `interactive_golden`: `Video(device="cuda")` (both parsers) and
  `MPEG(test.mpg, device="cuda")` against the goldens, K1 launched once
  a picture, and a seek;
- `interactive_1080p`: a 1080p A/V program stream (the 1080p fixture and
  test.mp2, muxed by tools/ps_mux.py) through `MPEG.decode(tick)`, video
  against the C++ host decoder and audio against the CPU, K4 launched
  once an audio frame, at most two pageable copies;
- `dense`: `BatchVideoDecoder(transport="dense")` (the Python parse) on
  the golden, then on the 1080p fixture cut to 9 pictures against the
  blob transport and the C++ host decoder, every copy pinned and the
  dense ring within three window stacks, timed and profiled (its h2d
  card time); and `make_sharded_scan_decoder` on the card's mesh and on
  the card listed twice, four streams against the blob sharded decoder
  and the C++ host decoder, K1 launched once a step a shard;
- `sharded_1080p`: 8 streams of the 1080p fixture (four lengths) as
  native window blobs through `parallel.sharding` on the card's mesh and
  on the card listed twice, every frame against the C++ host decoder and
  the int64 pixel count exact, timed; and the sharded MP2 synthesis
  (one pinned copy and one K4 launch a shard) against the single-stream
  one and the golden;
- `transport`: the window transport under an adversary that holds the
  compute stream and the copy stream (`torch.cuda._sleep`) before every
  window, round or call: the 1080p fixture (prefetch on), 8 lockstep
  streams (prefetch on) and the sharded decode on the card listed twice
  against the C++ host decoder; and one more step of each blob, dense
  and MP2 path, with both streams held, returning while the held work
  pends (the MP2 paths that hand back host PCM wait for it), its output
  equal to the same step's run free;
- `streams`: the custom-matrix ES on its golden through `Video` (both
  parsers) and `MultiStreamVideoDecoder`, and the 8-frame 3840x2160 ES
  through `BatchVideoDecoder(window=4)` and `MultiStreamVideoDecoder`
  against the C++ host decoder;
- `multihost`: `parallel.multihost.launch` as one NCCL process and as two
  gloo processes on the card, each on the golden;
- `examples`: the seven `examples_torch/` scripts on the card, at once,
  each in its own process.

`--baseline` (which may be repeated) also builds K1 and K3 from another
copy of `recon.cu` (an earlier commit's, or an edited copy with another
ring depth, CTAs a SM or consumer mapping) and times them and this K1
and K3 in turns (baseline, this, this, baseline) on the fixture's
pictures, the adversarial plan and (K1) 64-stream launches.
`--synth-baseline` (which may be repeated) likewise builds K4 from
another copy of `synth.cu` with K4's flags, holds its outputs and states
equal to this K4's on ragged calls and on the timed inputs, and times the
two in turns (baseline, this, this, baseline, twice) a frame, a window
(f32 and s16) and 8 streams' windows.
`--densify-baseline` (which may be repeated) likewise builds K5 from
another copy of `densify.cu` with K5's flags, through that copy's own
struct size and scratch function, holds its coded blocks and metadata
equal to this K5's at every `k5` shape and times the two in turns
(baseline, this, this, baseline, twice) at each.

Timing: a kernel's `ms` is card time by CUDA events (`queued_ms`); a
plain version's `plain_ms` is the wall of back-to-back calls by CUDA
events (`cuda_ms`), its own host waits included.  K4's plain version (a
few hundred plain torch launches a call) is also timed on the card by
CUDA events around CUDA-graph replays (`graph_ms`).  torch.profiler only
measures the profiled decode passes' (K3's, the dense and the sharded
decodes') idle share and kernel time by name, and K5's kernels a call;
its device time of K5's launches B and C, which start early
(programmatic dependent launch), includes their waits for the launch
before, so it is reported as such and compared with nothing.

The window transport's own count (`parallel.batch.transport_counts`:
copies, those from pinned memory, bytes) is read on every decode path
(single stream, 64 streams, sharded, interactive A/V, dense, sharded
dense, the MP2 paths) and must show every copy pinned; the profiled
passes add the h2d copies' card time, rate and share under kernels, and
the union busy time (`transport_summary`); the interactive pass, run
under torch.profiler, may copy only the decoders' two constant tables
from pageable memory.
Each path's kernel launch counts (the wrappers' counters) are set to 0
just before it runs and read just after; the MP2 paths also fail if the
plain filterbank sees a CUDA tensor, and the video paths if the plain
densify or metadata unpack does (`no_plain_densify`).  Every phase
prints one JSON line; any failure raises, so the exit code is nonzero
and the closing `{"ok": true, ...}` line never prints.  Without a CUDA
device, or outside a checkout of the repository, it exits nonzero
before printing any result.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(REPO, "tests", "testdata")

GOLDEN_VIDEO = (260, 0xEA6D7FCB1340BA3F)   # test.mpeg1video
GOLDEN_PS = (278, 0xD00818EDCAFDC702)      # test.mpg (tests/test_torch_batch.py)
# test_custom_matrix.m1v: tools/gen_custom_matrix.py's splice of
# test.mpeg1video (tests/test_custom_matrix.py's golden)
GOLDEN_CUSTOM = (260, 0x82A9768F1F2B499B)
GOLDEN_AUDIO = (355, 0xF1B76CDF8E6CDEA5)   # test.mp2, the no-FMA golden
# test.mpg's audio through MPEG.decode_audio, pinned from the JAX package's
# MPEG(backend="numpy") by tests/test_torch_interactive.py.
GOLDEN_PS_AUDIO = (355, 0xF1B76CDF8E6CDEA5)
E2E_PASSES = 3
N_STREAMS = 64        # bench.py secondary_64stream: 64 x 1080p, window 2
# Pictures kept of the 32-picture 1080p fixture, stream s taking entry
# s % 4 (None: the whole stream): four lengths, four flush rounds.
STREAM_CUTS = (None, 25, 17, 9)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# How the kernels line's times were taken (copied into each row).
TIMED_BY = {"ms": "cuda_events_queued", "plain_ms": "cuda_events_wall"}


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of `fn` on the current stream, by CUDA
    events around `iters` back-to-back calls after one warm-up call.  Where
    the host issues calls slower than the card runs them, or `fn` waits
    for the card, this is the host's rate, not the card's: the plain
    versions are timed so."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Milliseconds of card time per call of `fn`, by CUDA events around
    `iters` calls that the card runs back to back: a spin kernel
    (torch.cuda._sleep) holds the stream while the host queues them all,
    so the host's launch cost does not enter the time (the launches'
    gaps on the card do).  Every kernel time comes from here, not from
    torch.profiler, which on the card's machine records nothing at all
    in some sessions and drops records of short launches in others."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Spin for twice the host's queueing time at up to 2 GHz, +2 ms.
    torch.cuda._sleep(int((2 * host_s * iters + 2e-3) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int) -> float:
    """Median microseconds of host time one call of `fn` takes to return
    while a spin kernel holds the card, so that no call waits for it: its
    checks, allocations and launches on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int((2 * host_s * iters + 2e-3) * 2e9))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def graph_ms(fn, iters: int) -> float:
    """Milliseconds of card time per call of `fn`, by CUDA events around
    `iters` back-to-back replays of one CUDA graph of it.  For functions
    of hundreds of small launches, which `queued_ms` cannot time: the
    host blocks once the launch queue is full, and the card then waits
    for the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                       # warm-up: cached tables, allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_floor_ms() -> float:
    """The floor of `queued_ms`: K2 on 32 zero blocks, one CTA."""
    import torch

    from mpeg_tpu_torch.ops import cuda_kernels

    c1, n1 = (torch.zeros(s, dtype=torch.int32, device="cuda")
              for s in ((32, 64), (32,)))
    return queued_ms(lambda: cuda_kernels.idct_batch(c1, n1), 200)


def phase_probe() -> dict:
    from mpeg_tpu_torch.device import probe

    p = probe()
    emit({"phase": "probe", **p})
    if not p["cuda_available"] or not p["sm"] or p["sm"][0] != 9:
        fail(f"needs a CUDA device of SM 9.x, probe says {p}")
    return p


def _ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "Compiling entry" in ln
            or "bytes stack frame" in ln]


def phase_build() -> None:
    """nvcc (one process a kernel source) and g++ (the host parser), all
    at the same time."""
    from concurrent.futures import ThreadPoolExecutor

    from mpeg_tpu_torch import native
    from mpeg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.LIBRARIES) + 1) as pool:
        kernels = {name: pool.submit(_build.build_library, name)
                   for name in _build.LIBRARIES}
        parser = pool.submit(native.build)
        built = {name: f.result() for name, f in kernels.items()}
        parser_so = parser.result()
    secs = time.perf_counter() - t0
    lib = _build.load()
    _build.load("synth")
    _build.load("densify")
    native.load()
    emit({"phase": "build",
          "libraries": {name: {"library": os.path.relpath(so, REPO),
                               "flags": _build.nvcc_flags(name),
                               "ptxas": _ptxas_lines(log)}
                        for name, (so, log) in built.items()},
          "parser_library": os.path.relpath(parser_so, REPO),
          "seconds": secs,
          "k1_dynamic_smem_bytes": lib.mt_reconstruct_smem_bytes(),
          "k3_dynamic_smem_bytes": {"luma": lib.mt_plane_smem_bytes(0),
                                    "chroma": lib.mt_plane_smem_bytes(1)}})


def _max_abs_err(got, want) -> int:
    return int((got.to(int) - want.to(int)).abs().max().item())


def phase_kernel_parity(seed: int) -> dict:
    """K1, K2 and K3 against their plain versions at 1080p on adversarial
    plans (every MC mode, src_sel 0/1/2, junk MVs of +-3000, forward
    aliasing backward), byte for byte, K3 (the whole path, and its plane
    launches on a given residual) against K1, and the stream-batched K1
    over 64 pictures against 64 single launches and its plain version;
    then each timed at the main path's shapes."""
    import numpy as np
    import torch

    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.ops import video_recon as plain
    from mpeg_tpu_torch.ops.video_recon import FrameGeometry
    from mpeg_tpu_torch.testing import plan_args, random_blocks, random_plan

    dev = torch.device("cuda")
    geom = FrameGeometry.for_size(1920, 1080)
    rng = np.random.default_rng(seed)
    frame = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(0, 256, geom.total_size).astype(np.uint8)).to(dev)
    cur, fwd, bwd = frame(), frame(), frame()
    errs = {"k1": 0, "k2": 0, "k3": 0}

    def check(kernel, got, want, what):
        torch.cuda.synchronize()
        errs[kernel] = max(errs[kernel], _max_abs_err(got, want))
        if not torch.equal(got, want):
            fail(f"{kernel} differs from its plain version: {what}")

    for trial in range(4):
        args = plan_args(random_plan(geom, rng, 1 + trial % 2), dev)
        if trial == 3:
            fwd = bwd                      # reference picture: aliased
        new = cuda_kernels.reconstruct_picture(cur, fwd, bwd, *args, geom)
        check("k1", new, plain.reconstruct_picture(cur, fwd, bwd, *args,
                                                   geom), f"trial {trial}")
        for pallas_idct in (True, False):
            k3 = cuda_kernels.reconstruct_picture_multi(
                cur, fwd, bwd, *args, geom, pallas_idct=pallas_idct)
            check("k3", k3, plain.reconstruct_picture_multi(
                cur, fwd, bwd, *args, geom),
                f"trial {trial}, pallas_idct={pallas_idct}")
            check("k3", k3, new, f"K3 against K1, trial {trial}")
        check("k3", cuda_kernels.reconstruct_planes(
            cur, fwd, bwd, plain.idct_batch(*args[:2]), *args[1:], geom),
            new, f"K3's plane launches, trial {trial}")
        coeffs, nblocks = args[0].view(-1, 64), args[1].view(-1)
        check("k2", cuda_kernels.idct_batch(coeffs, nblocks),
              plain.idct_batch(coeffs, nblocks), f"trial {trial}")
        cur, fwd, bwd = new, bwd, cur      # evolve state across trials
    # Uncoded blocks whose coefficients are junk: K1 must not read them.
    args = list(plan_args(random_plan(geom, rng, 2), dev))
    uncoded = torch.from_numpy(rng.random(tuple(args[1].shape)) < 0.7)
    args[1] = torch.where(uncoded.to(dev), 0, args[1])
    want = plain.reconstruct_picture(cur, fwd, bwd, *args, geom)
    check("k1", cuda_kernels.reconstruct_picture(cur, fwd, bwd, *args, geom),
          want, "junk coefficients in uncoded blocks")
    check("k3", cuda_kernels.reconstruct_picture_multi(cur, fwd, bwd, *args,
                                                       geom),
          want, "junk coefficients in uncoded blocks")
    # Exact-variant coverage: sparse blocks of every class, and a batch
    # that ends in a part-filled CTA (16,376 blocks, 32 a CTA).
    c, n = (torch.from_numpy(a).to(dev) for a in random_blocks(
        rng, [0, 1, 2, 5, 9, 10, 33, 64], 2047))
    check("k2", cuda_kernels.idct_batch(c, n), plain.idct_batch(c, n),
          "variant blocks")

    # The stream axis: 64 streams, four pool frames each, one random
    # picture each (indices out of stream order), every third stream a
    # reference step (forward aliases backward).
    s_n = N_STREAMS
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.randint(0, 256, (4 * s_n, geom.total_size), generator=gen,
                         device=dev, dtype=torch.uint8)
    plans = [torch.stack(a) for a in zip(*(
        plan_args(random_plan(geom, rng, 1 + s % 2), dev)
        for s in range(s_n)))]
    perm = rng.permutation(s_n)
    rows = [[4 * s, 4 * s + (2 if s % 3 == 0 else 1), 4 * s + 2, 4 * s + 3,
             int(perm[s])] for s in range(s_n)]
    for s in (5, 40):              # two no-op streams in the parity launch
        rows[s][4] = -1
    table = torch.tensor(rows, dtype=torch.int32, device=dev)
    before = pool.clone()
    cuda_kernels.reconstruct_pictures(pool, table, *plans, geom)
    want = plain.reconstruct_pictures(before.clone(), table, *plans, geom)
    check("k1", pool, want, "64 streams against the plain version")
    for c_, f_, b_, o_, pic in rows:
        if pic < 0:
            check("k1", pool[o_], before[o_], "a no-op stream's out slot")
            continue
        check("k1", pool[o_], cuda_kernels.reconstruct_picture(
            before[c_], before[f_], before[b_],
            *(a[pic] for a in plans), geom), f"stream of picture {pic}")
    table[:, 4] = torch.from_numpy(perm).to(dev, torch.int32)   # timed: all

    # Timing at the main path's shapes: one 1080p picture, and one
    # picture-step of 64 streams (per picture: / 64), as TIMED_BY says.
    args = plan_args(random_plan(geom, rng, 2), dev)
    coeffs, nblocks = args[0].view(-1, 64), args[1].view(-1)
    res = plain.idct_batch(*args[:2])
    fns = {
        "k1": (lambda: cuda_kernels.reconstruct_picture(
            cur, fwd, bwd, *args, geom), 200, 1),
        "k1_plain": (lambda: plain.reconstruct_picture(
            cur, fwd, bwd, *args, geom), 20, 1),
        "k1_streams": (lambda: cuda_kernels.reconstruct_pictures(
            pool, table, *plans, geom), 20, s_n),
        "k1_streams_plain": (lambda: plain.reconstruct_pictures(
            pool, table, *plans, geom), 2, s_n),
        "k2": (lambda: cuda_kernels.idct_batch(coeffs, nblocks), 200, 1),
        "k2_plain": (lambda: plain.idct_batch(coeffs, nblocks), 20, 1),
        "k3": (lambda: cuda_kernels.reconstruct_picture_multi(
            cur, fwd, bwd, *args, geom), 200, 1),
        "k3_plain": (lambda: plain.reconstruct_picture_multi(
            cur, fwd, bwd, *args, geom), 20, 1),
        "k3_planes": (lambda: cuda_kernels.reconstruct_planes(
            cur, fwd, bwd, res, *args[1:], geom), 200, 1),
        "k3_planes_plain": (lambda: plain.reconstruct_planes(
            cur, fwd, bwd, res, *args[1:], geom), 20, 1),
    }
    t = {}
    for name, (fn, iters, per) in fns.items():
        timer = cuda_ms if name.endswith("_plain") else queued_ms
        t[f"{name}_ms"] = timer(fn, iters) / per
    t["launch_floor_ms"] = launch_floor_ms()
    # Bounds from these inputs (each input byte read once, each output
    # byte written once, at 3.35 TB/s): K1 and K3 compute one function,
    # and K3's plane launches move K1's bytes; K3's path adds K2's.
    bound = cuda_kernels.reconstruct_bound(args[1], args[2], geom)
    streams_bound = cuda_kernels.reconstruct_bound(plans[1], plans[2], geom)
    n_blk = int(nblocks.numel())
    t["k1_bound_ms"] = t["k3_bound_ms"] = t["k3_planes_bound_ms"] = \
        bound["us"] / 1e3
    t["k3_path_bound_ms"] = cuda_kernels.reconstruct_bound(
        args[1], args[2], geom, separate_idct=True)["us"] / 1e3
    t["k1_streams_bound_ms"] = streams_bound["us"] / 1e3 / s_n
    t["k2_bound_ms"] = n_blk * (256 + 4 + 256) \
        / cuda_kernels.HBM_BYTES_PER_S * 1e3
    out = {"phase": "kernel_parity", "geometry": "1920x1080",
           "mb": geom.mb_size, "blocks": int(nblocks.numel()),
           "streams": s_n, "k1_equal": True, "k1_max_abs_err": errs["k1"],
           "k2_equal": True, "k2_max_abs_err": errs["k2"],
           "k3_equal": True, "k3_max_abs_err": errs["k3"],
           "unit": "ms per 1080p picture", **t}
    emit(out)
    return out


def _subbands(rng, streams: int, steps: int, edge: bool = False):
    """int32 [S, T, 2, 32] subband samples to 2^18 in magnitude (twice the
    parsers' range) with silent subbands; `edge`: whole steps at +-2^18
    and whole subbands silent."""
    import numpy as np

    s = rng.integers(-(1 << 18), 1 << 18, (streams, steps, 2, 32))
    s[rng.random(s.shape) < 0.3] = 0
    if edge:
        s[:, ::3] = 1 << 18
        s[:, 1::3] = -(1 << 18)
        s[..., 20:] = 0
    return s.astype(np.int32)


def phase_k4(seed: int, launch_floor_ms: float, baselines=(),
             variants=()) -> dict:
    """K4 against its plain version (`ops.filterbank` on the same CUDA
    tensors), bit for bit: the ring form (`synthesize_ring`, Audio's
    launch) from all 16 V positions on one frame, and at 16, 17, 36 and
    53 steps from four positions; a 32-frame window (`synthesize`,
    BatchAudioDecoder's launch) and 8 streams in one launch (the sharded
    synthesis'), on random and edge samples, and windows of 48 and 1,168
    steps; each in the u, f32 and s16 forms, with the new ring or
    history.  Then timed in turns (plain, K4, K4, plain, twice) per frame
    (ring, f32), per window (f32 and s16) and per 8-stream window (u): K4
    by `queued_ms`, the plain version by `graph_ms` (card) and `cuda_ms`
    (wall), beside K4's bound (`cuda_kernels.synth_bound`) and the launch
    floor (K2 on one CTA), and K4's microseconds above that floor.  Also
    the plain version's launches a call (`count_launches`: its aten ops;
    K4 is one launch).

    Each source of `baselines` (another synth.cu, e.g. an earlier
    commit's) is built with K4's flags, held equal to this K4 on the
    ragged and the timed inputs, and timed in turns with it (baseline,
    this, this, baseline, twice) on the four timed inputs (`turns`);
    each source of `variants` (a copy that computes only part of K4) is
    timed so without the check (`variant_turns`)."""
    import numpy as np
    import torch

    from mpeg_tpu_torch.ops import cuda_kernels as ck
    from mpeg_tpu_torch.ops import filterbank

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    err = 0.0
    form = ck._plain_form            # the plain version's output forms

    def check(got, want, what):
        nonlocal err
        torch.cuda.synchronize()
        err = max(err, float((got.double() - want.double()).abs().max()))
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"k4 differs from its plain version: {what}")

    def rand_ring(streams):
        return torch.from_numpy((rng.standard_normal((streams, 2, 1024))
                                 * 3e4).astype(np.float32)).to(dev)

    def rand_hist(streams):
        return torch.from_numpy((rng.standard_normal((streams, 15, 2, 64))
                                 * 1e4).astype(np.float32)).to(dev)

    def check_ring(x, ring, v_pos, what):
        plain = [filterbank.synthesize_frame(x[s], ring[s], v_pos)
                 for s in range(x.shape[0])]
        u = torch.stack([p[0] for p in plain])
        want_ring = torch.stack([p[1] for p in plain])
        for out in ("u", "f32", "s16"):
            got, got_ring, pos = ck.synthesize_ring(x, ring, v_pos, out=out)
            check(got, form(u, out), f"{what}, {out}")
            check(got_ring, want_ring, f"{what}: the ring")
            if pos != plain[0][2]:
                fail(f"k4 {what}: position {pos}, want {plain[0][2]}")

    def check_window(x, hist, what):
        plain = [filterbank.synthesize_window(x[s], hist[s])
                 for s in range(x.shape[0])]
        u = torch.stack([p[0] for p in plain])
        want_hist = torch.stack([p[1] for p in plain])
        for out in ("u", "f32", "s16"):
            got, got_hist = ck.synthesize(x, hist, out=out)
            check(got, form(u, out), f"{what}, {out}")
            check(got_hist, want_hist, f"{what}: the history")
        return u, want_hist

    ck.reset_launches()
    cases = 0
    for v_pos in range(0, 1024, 64):
        x = torch.from_numpy(_subbands(rng, 1, 36, v_pos % 128 == 64)).to(dev)
        check_ring(x, rand_ring(1), v_pos, f"ring from {v_pos}")
        cases += 3
    # Ragged ring calls: chunks and CTAs that end inside a ring period.
    for steps in (16, 17, 36, 53):
        for v_pos in (0, 64, 448, 960):
            x = torch.from_numpy(_subbands(rng, 2, steps, steps == 17)) \
                .to(dev)
            check_ring(x, rand_ring(2), v_pos,
                       f"ring of {steps} steps from {v_pos}")
            cases += 3
    for streams, edge in ((1, False), (1, True), (8, False), (8, True)):
        x = torch.from_numpy(_subbands(rng, streams, 32 * 36, edge)).to(dev)
        hist = rand_hist(streams)
        what = f"{streams} streams, edge={edge}"
        u, want_hist = check_window(x, hist, what)
        cases += 3
        # Two windows, the history carried, equal one window of both.
        half = x.shape[1] // 2
        first, h1 = ck.synthesize(x[:, :half].contiguous(), hist)
        second, h2 = ck.synthesize(x[:, half:].contiguous(), h1)
        check(torch.cat([first, second], 1), u, f"{what}, two windows")
        check(h2, want_hist, f"{what}, two windows: history")
        cases += 2
    for streams in (1, 8):           # ragged windows: 3 and 73 ring periods
        for steps in (48, 1168):
            x = torch.from_numpy(_subbands(rng, streams, steps)).to(dev)
            check_window(x, rand_hist(streams),
                         f"{streams} streams of {steps} steps")
            cases += 3
    if ck.synthesize.launches != cases:
        fail(f"k4 launched {ck.synthesize.launches} times for {cases} calls")

    # Timing, at the paths' shapes: name -> (samples, hist, ring, out,
    # K4 iterations, plain iterations, plain version).
    x1 = torch.from_numpy(_subbands(rng, 1, 32 * 36)).to(dev)
    x8 = torch.from_numpy(_subbands(rng, 8, 32 * 36)).to(dev)
    h1 = torch.zeros((1, 15, 2, 64), dtype=torch.float32, device=dev)
    h8 = torch.zeros((8, 15, 2, 64), dtype=torch.float32, device=dev)
    ring = torch.zeros((1, 2, 1024), dtype=torch.float32, device=dev)
    frame = x1[:, :36].contiguous()
    timed = {
        "frame": (frame, None, ring, "f32", 200, 50,
                  lambda: filterbank.finalize(filterbank.synthesize_frame(
                      frame[0], ring[0], 0)[0])),
        "window": (x1, h1, None, "f32", 200, 20,
                   lambda: filterbank.finalize(filterbank.synthesize_window(
                       x1[0], h1[0])[0])),
        "window_s16": (x1, h1, None, "s16", 200, 20,
                       lambda: filterbank.synthesize_window_s16(x1[0],
                                                                h1[0])),
        "sharded_8": (x8, h8, None, "u", 200, 5,
                      lambda: [filterbank.synthesize_window(x8[s], h8[s])
                               for s in range(8)]),
    }

    res = {"phase": "k4", "equal": True, "calls_checked": cases,
           "max_abs_err": err, "launch_floor_ms": launch_floor_ms,
           "unit": "ms a call", "timed_by": {
               "ms": "cuda_events_queued", "plain_graph_ms":
               "cuda_events_graph_replay", "plain_ms": "cuda_events_wall"}}
    for name, (x, hist, ring_, out, k_iters, p_iters, plain) in \
            timed.items():
        k4 = lambda: _k4(x, hist, ring_, out)  # noqa: E731
        got = {"ms": [], "plain_graph_ms": []}
        for _ in range(2):
            for who in ("plain", "k4", "k4", "plain"):
                if who == "k4":
                    got["ms"].append(queued_ms(k4, k_iters))
                else:
                    got["plain_graph_ms"].append(graph_ms(plain, p_iters))
        bound = ck.synth_bound(x.shape[0], x.shape[1], out,
                               ring=ring_ is not None)
        ms = statistics.median(got["ms"])
        res[name] = {
            "streams": x.shape[0], "steps": x.shape[1], "out": out,
            "ms": ms, "all_ms": got["ms"],
            "above_floor_us": (ms - launch_floor_ms) * 1e3,
            "plain_graph_ms": statistics.median(got["plain_graph_ms"]),
            "all_plain_graph_ms": got["plain_graph_ms"],
            "plain_ms": cuda_ms(plain, p_iters),
            "plain_launches": count_launches(plain),
            "bound_ms": bound["us"] / 1e3, "bound_by": bound["bound_by"],
            "bound_bytes": bound["bytes"], "bound_flops": bound["flops"]}
    inputs = {name: v[:4] for name, v in timed.items()}
    if baselines:
        res["turns"] = {src: _synth_turns(src, inputs, True,
                                          launch_floor_ms)
                        for src in baselines}
    if variants:
        res["variant_turns"] = {src: _synth_turns(src, inputs, False,
                                                  launch_floor_ms)
                                for src in variants}
    emit(res)
    return res


def _k4(x, hist, ring, out: str):
    """This K4 on one timed input: (output, new state), from the ring at
    position 0 when `ring` is given, else from `hist`."""
    from mpeg_tpu_torch.ops import cuda_kernels as ck

    if ring is None:
        return ck.synthesize(x, hist, out=out)
    return ck.synthesize_ring(x, ring, 0, out=out)[:2]


def _synth_turns(source: str, inputs: dict, check: bool,
                 floor_ms: float) -> dict:
    """K4 built from `source` with K4's flags ("baseline") and this K4
    ("this") in turns baseline, this, this, baseline (twice) on each of
    `inputs` (name -> (samples, hist, ring, out); a ring from position
    0): card ms a call (`queued_ms`), the median of each and its
    microseconds above `floor_ms`, the launch floor.  With
    `check`, the baseline's outputs and states equal this K4's on these
    inputs and on ragged ones first."""
    import numpy as np
    import torch

    from mpeg_tpu_torch.ops import _build
    from mpeg_tpu_torch.ops import cuda_kernels as ck

    so, log = _build.build(os.path.abspath(source), _build.nvcc_flags("synth"))
    lib = _build.bind_synth(so)

    def base(x, hist, ring, out):
        pcm, state = ck._synth_outputs(x, hist if ring is None else ring, out)
        code = lib.mt_synthesize(
            x.data_ptr(), None if hist is None else hist.data_ptr(),
            None if ring is None else ring.data_ptr(), 0,
            ck._synth_tables(x.device).data_ptr(), x.shape[0], x.shape[1],
            ck._SYNTH_FORMS[out], pcm.data_ptr(), state.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"baseline K4 {source}: CUDA error {code}")
        return pcm, state

    if check:
        rng = np.random.default_rng(2)
        ragged = []
        for steps in (16, 17, 36, 53):
            ragged.append((torch.from_numpy(_subbands(rng, 2, steps))
                           .cuda(), None, torch.from_numpy(
                               rng.standard_normal((2, 2, 1024))
                               .astype(np.float32)).cuda()))
        for streams, steps in ((1, 48), (8, 1168)):
            ragged.append((torch.from_numpy(_subbands(rng, streams, steps))
                           .cuda(), torch.from_numpy(rng.standard_normal(
                               (streams, 15, 2, 64)).astype(np.float32))
                           .cuda(), None))
        for x, hist, ring in ragged + [v[:3] for v in inputs.values()]:
            for out in ("u", "f32", "s16"):
                got, want = base(x, hist, ring, out), _k4(x, hist, ring, out)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if g.dtype == torch.float32:
                        g, w = g.view(torch.int32), w.view(torch.int32)
                    if not torch.equal(g, w):
                        fail(f"baseline K4 {source} and this K4 differ: "
                             f"{tuple(x.shape)}, {out}")
    res = {"equal": True} if check else {}
    for name, (x, hist, ring, out) in inputs.items():
        got = {"baseline": [], "this": []}
        for _ in range(2):
            for who in ("baseline", "this", "this", "baseline"):
                fn = base if who == "baseline" else _k4
                got[who].append(queued_ms(
                    lambda: fn(x, hist, ring, out), 200))
        res[name] = {k: {"ms": statistics.median(v), "all_ms": v,
                         "above_floor_us": (statistics.median(v)
                                            - floor_ms) * 1e3}
                     for k, v in got.items()}
    res["ptxas"] = _ptxas_lines(log)
    return res


def _k5_inputs(dev) -> dict:
    """K5's inputs at the main path's shapes, on the card: name ->
    (meta_esc, main_rec, geom, window, km, ke), the blobs as each path
    transfers them: the 1080p fixture's first window of 16 (a bucket of
    its filled records); the first two rounds of 64 streams of the fixture
    (four lengths) at window 2, one global chain of 128 pictures; the
    first window of 8 streams at window 16, a [8, bytes] stack at common
    buckets, as the sharded decoder gets it; the fixture's first picture
    as a one-picture blob, as `PictureBlobRecon` gets it; and a malformed
    64x48 blob whose main chain wraps negative (every delta 0xFFFF), past
    2^31 between two record tiles, and the same past it inside one."""
    import numpy as np
    import torch

    from mpeg_tpu_torch.ops.video_recon import FrameGeometry
    from mpeg_tpu_torch.parallel import (BatchVideoDecoder,
                                         MultiStreamVideoDecoder)
    from mpeg_tpu_torch.parallel.batch import (
        _MIN_KM, blob_layout, blob_split, blob_views, pool_bucket)

    data = _fixture_1080p()

    def window_blob(window):
        dec = BatchVideoDecoder(data, window=window, device="cuda")
        blob, _types, fill = dec._native_window_blob()
        km, ke = dec._km, dec._ke
        split = blob_split(dec.geom, window, km, ke)
        kt = min(pool_bucket(max(fill[0], 1), _MIN_KM), km)
        return (blob[:split].to(dev), blob[split:split + 4 * kt].to(dev),
                dec.geom, window, km, ke)

    out = {"fixture_window_16": window_blob(16)}
    cuts = _stream_cuts(data)
    ms = MultiStreamVideoDecoder(
        [cuts[s % len(cuts)] for s in range(N_STREAMS)], window=2,
        device="cuda")
    for r in range(2):
        slot, _types, nm, (kmg, keg) = ms._fill()
        kt = min(pool_bucket(max(nm, 1), _MIN_KM), kmg)
        out[f"streams_64_round_{r}"] = (
            torch.from_numpy(slot.meta).to(dev),
            torch.from_numpy(slot.main[:4 * kt]).to(dev), ms.geom,
            ms.n * ms.window, kmg, keg)
        slot.evt.set()
    parsed = [_native_windows(c, 16) for c in cuts]
    geom = parsed[0][0]
    blobs, _types, km, ke = _common_blobs(
        [parsed[s % len(cuts)][1] for s in range(SHARDED_STREAMS)], geom, 16)
    stack = torch.from_numpy(blobs[0]).to(dev)
    split = blob_split(geom, 16, km, ke)
    out["sharded_8_window_16"] = (stack[:, :split], stack[:, split:], geom,
                                  16, km, ke)
    out["interactive_picture"] = window_blob(1)
    small = FrameGeometry.for_size(64, 48)
    km, ke = 65536, 64
    blob = np.zeros(blob_layout(small, 2, km, ke)[1], np.uint8)
    v = blob_views(blob, small, 2, km, ke)
    v["main_rec"][0::2] = 0xFFFF
    v["main_rec"].view(np.int16)[1::2] = 3
    v["esc_didx"][:] = 0xFFFF
    v["esc_val"][:] = 7
    v["nbcls"][:] = 0x0FFF            # every block coded
    split = blob_split(small, 2, km, ke)
    out["malformed_wrapping"] = (torch.from_numpy(blob[:split]).to(dev),
                                 torch.from_numpy(blob[split:]).to(dev),
                                 small, 2, km, ke)
    # The same with a first delta of 0x7FFF: the chain passes 2^31 inside
    # a record tile, not between two.
    v["main_rec"][0] = 0x7FFF
    out["malformed_straddling"] = (torch.from_numpy(blob[:split]).to(dev),
                                   torch.from_numpy(blob[split:]).to(dev),
                                   small, 2, km, ke)
    return out


def phase_k5(baselines=(), variants=()) -> dict:
    """K5 against its plain version on the card at the main path's shapes
    (`_k5_inputs`): every coded block's coefficients and every metadata
    tensor bit for bit, K5's outputs allocated on memory left full of
    junk, `DENSIFY_LAUNCHES` launches a call as the library reports them
    (`launches_a_call`) and as torch.profiler records them
    (`_k5_profiled`); then K5 by `queued_ms`, the plain pair by `cuda_ms`
    and its aten ops (`count_launches`), beside `densify_bound`.

    Each source of `baselines` (another densify.cu, e.g. an earlier
    commit's) is built with K5's flags, held equal to this K5 on every
    shape and timed in turns with it (baseline, this, this, baseline,
    twice; `turns`), each turn's host us a call (`host_us`) beside its card
    time; each source of `variants` (a copy that computes only part of K5,
    or another partition) is timed so without the check
    (`variant_turns`)."""
    import torch

    from mpeg_tpu_torch.ops import _build, cuda_kernels
    from mpeg_tpu_torch.parallel import batch
    from mpeg_tpu_torch.tables import PREMULTIPLIER_MATRIX

    dev = torch.device("cuda")
    premult = torch.tensor(PREMULTIPLIER_MATRIX, dtype=torch.int32,
                           device=dev)
    rep = torch.tensor(batch._NB_CLASS_REP, dtype=torch.int32, device=dev)
    out = {"phase": "k5", "owner_macroblocks":
               _build.load("densify").mt_densify_granule_mbs(),
           "shapes": {}}
    bases = {src: _densify_library(src) for src in baselines}
    others = {src: _densify_library(src) for src in variants}
    turns = {src: {} for src in (*baselines, *variants)}
    worst = 0
    for name, (meta, main, geom, window, km, ke) in _k5_inputs(dev).items():
        args = (meta, main, geom, window, km, ke, premult, rep)
        want_c, want_m = batch.densify_unpack_plain(*args)
        junk = torch.full_like(want_c, -0x2A2A2A2B)
        del junk                       # K5's torch.empty lands on junk
        cuda_kernels.reset_launches()
        got_c, got_m = batch.densify_unpack(*args)
        torch.cuda.synchronize()
        launches = cuda_kernels.densify_unpack.launches
        coded = want_m["nblocks"] > 0
        err = _max_abs_err(got_c[coded], want_c[coded]) if coded.any() else 0
        worst = max(worst, err)
        if launches != cuda_kernels.DENSIFY_LAUNCHES or err or \
                not _same_meta(got_m, want_m):
            fail(f"k5 differs from its plain version on {name} "
                 f"(max abs err {err}, {launches} launches)")
        out["launches_a_call"] = launches
        for src, base in bases.items():
            base_c, base_m = base(*args)
            torch.cuda.synchronize()
            if not torch.equal(base_c[coded], got_c[coded]) or \
                    not _same_meta(base_m, got_m):
                fail(f"baseline K5 {src} and this K5 differ on {name}")
            del base_c
        streams = meta.shape[0] if meta.dim() == 2 else 1
        kt = main.shape[-1] // 4
        bound = cuda_kernels.densify_bound(want_m["nblocks"], streams * kt,
                                           streams * ke)
        del want_c, got_c
        iters = 20 if window * geom.mb_size > 100_000 else 100
        k5 = lambda: batch.densify_unpack(*args)  # noqa: E731
        out["shapes"][name] = {
            "streams": streams, "pictures": streams * window,
            "main_records": streams * kt, "escape_records": streams * ke,
            "coded_blocks": int(coded.sum()), "max_abs_err": err,
            "ms": queued_ms(k5, iters),
            "plain_ms": cuda_ms(lambda: batch.densify_unpack_plain(*args),
                                max(iters // 4, 5)),
            "plain_launches": count_launches(
                lambda: batch.densify_unpack_plain(*args)),
            "bound_ms": bound["us"] / 1e3, "bound_bytes": bound["bytes"],
            **_k5_profiled(k5)}
        for src, base in (*bases.items(), *others.items()):
            got = {"baseline": [], "this": []}
            host = {"baseline": [], "this": []}
            for _ in range(2):
                for who in ("baseline", "this", "this", "baseline"):
                    fn = (lambda: base(*args)) if who == "baseline" else k5
                    got[who].append(queued_ms(fn, iters))
                    host[who].append(host_us(fn, iters))
            turns[src][name] = {
                **{who: {"ms": statistics.median(v), "all_ms": v,
                         "host_us": statistics.median(host[who]),
                         "all_host_us": host[who]}
                   for who, v in got.items()},
                "bound_ms": bound["us"] / 1e3}
    out["max_abs_err"] = worst
    if baselines:
        out["turns"] = {src: {"equal": True, **turns[src],
                              "ptxas": bases[src].ptxas}
                        for src in baselines}
    if variants:
        out["variant_turns"] = {src: {**turns[src],
                                      "ptxas": others[src].ptxas}
                                for src in variants}
    emit(out)
    return out


def _same_meta(got: dict, want: dict) -> bool:
    import torch

    return set(got) == set(want) and all(torch.equal(got[k], want[k])
                                          for k in want)


def _densify_library(source: str):
    """A densify.cu copy (e.g. an earlier commit's) built with K5's flags
    into a library of its own, as a function of `batch.densify_unpack`'s
    arguments that calls it as this K5's wrapper calls this K5 (its launch
    counts nothing) through its own struct size and scratch function:
    five arguments, or (S, kt, ke) in a copy without
    `mt_densify_granule_mbs`, whose `mt_densify_unpack` also reports its
    launches.  Its `ptxas` holds the compiler's lines."""
    import ctypes

    from mpeg_tpu_torch.ops import _build, cuda_kernels
    from mpeg_tpu_torch.parallel.batch import blob_layout

    so, log = _build.build(os.path.abspath(source),
                           _build.nvcc_flags("densify"))
    lib = ctypes.CDLL(so)
    lib.mt_densify_args_bytes.restype = ctypes.c_int
    if lib.mt_densify_args_bytes() != ctypes.sizeof(_build.DensifyArgs):
        fail(f"baseline K5 {source}: MtDensifyArgs of "
             f"{lib.mt_densify_args_bytes()} bytes, DensifyArgs "
             f"{ctypes.sizeof(_build.DensifyArgs)}")
    words = lib.mt_densify_scratch_words
    rows = hasattr(lib, "mt_densify_granule_mbs")
    words.argtypes = [ctypes.c_int] * (5 if rows else 3)
    words.restype = ctypes.c_longlong
    lib.mt_densify_unpack.argtypes = [
        ctypes.POINTER(_build.DensifyArgs), ctypes.c_void_p,
        *([ctypes.POINTER(ctypes.c_int)] if rows else [])]
    lib.mt_densify_unpack.restype = ctypes.c_int
    launched = ctypes.c_int(0)

    def scratch_words(s_n, window, mb, kt, ke):
        return words(s_n, window, mb, kt, ke) if rows else words(s_n, kt, ke)

    def unpack(args, stream):
        more = (ctypes.byref(launched),) if rows else ()
        return lib.mt_densify_unpack(args, stream, *more)

    def run(meta, main, geom, window, km, ke, premult, rep):
        offs = blob_layout(geom, window, km, ke)[0]
        code, coeffs, meta_out = cuda_kernels._densify_call(
            unpack, scratch_words, meta, main, geom, window, offs, premult,
            rep)
        if code:
            fail(f"baseline K5 {source}: CUDA error {code}")
        return coeffs, meta_out

    run.ptxas = _ptxas_lines(log)
    return run


def _k5_profiled(fn, calls: int = 5) -> dict:
    """K5's kernels a call as torch.profiler records them over `calls`
    calls of `fn` (`profiled_launches_a_call`: launch A
    `densify_tiles_kernel`, B `densify_rows_kernel`, C
    `densify_assemble_kernel`, each once a call), and each one's device us
    a call (`profiled_us_with_waits`: B and C start early by programmatic
    dependent launch, and their device time includes their waits for A's
    and B's writes, so the three overstate K5's card time, which is
    `ms`).  The counts are printed beside the library's, which the phase
    checks: the profiler on the card's machine drops some records of short
    launches.  "not measured" when it recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counts, us = {}, {}
    recorded = False
    for k in prof.key_averages():
        if k.device_type.name != "CUDA":
            continue
        recorded = True
        name = _kernel_name(k.key).split("(")[0]
        if name.startswith("densify_"):
            counts[name] = counts.get(name, 0) + k.count / calls
            us[name] = us.get(name, 0) + k.device_time_total / calls
    if not recorded:
        missing = "not measured: torch.profiler recorded no device activity"
        return {"profiled_launches_a_call": missing,
                "profiled_us_with_waits": missing}
    return {"profiled_launches_a_call": counts, "profiled_us_with_waits": us}


def _fixture_1080p() -> bytes:
    return open(os.path.join(TESTDATA, "test1080.m1v"), "rb").read()


def _fixture_pictures(dev) -> list:
    """The 1080p fixture's pictures in decode order, as K1 gets them in
    the decode: [(cur, fwd, bwd, plan tensors)], the frames K1's own
    outputs, each picture held against the plain version on the way."""
    import torch

    from mpeg_tpu_torch.native import NativeVideoParser
    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.ops import video_recon as plain
    from mpeg_tpu_torch.tables import PICTURE_TYPE_B
    from mpeg_tpu_torch.testing import plan_args

    parser = NativeVideoParser(_fixture_1080p())
    geom = parser.geom()
    cur, fwd, bwd = (torch.zeros(geom.total_size, dtype=torch.uint8,
                                 device=dev) for _ in range(3))
    pictures = []
    while (item := parser.parse_next_plan()) is not None:
        plan, ptype = item
        args = plan_args(plan, dev)
        is_ref = ptype != PICTURE_TYPE_B
        fwd_eff = bwd if is_ref else fwd
        new = cuda_kernels.reconstruct_picture(cur, fwd_eff, bwd, *args,
                                               geom)
        want = plain.reconstruct_picture(cur, fwd_eff, bwd, *args, geom)
        torch.cuda.synchronize()
        if not torch.equal(new, want):
            fail(f"k1 differs from its plain version on fixture picture "
                 f"{len(pictures)}")
        pictures.append((cur, fwd_eff, bwd, args, ptype))
        if is_ref:
            cur, fwd, bwd = fwd, bwd, new
        else:
            cur = new
    if len(pictures) != 32:
        fail(f"the 1080p fixture parsed into {len(pictures)} pictures")
    return geom, pictures


def phase_k1_fixture(baselines: list) -> dict:
    """K1 and K3 on the 1080p fixture's 32 pictures in decode order (each
    byte equal to the plain version), timed in turn (32 pictures a call,
    so each finds its coefficients or residual outside the 50 MB L2)
    beside each picture's bound: K1, K3's whole path, and K3's plane
    launches alone on each picture's residual (K2's, made beforehand).
    K1 and K3 built from each source of `baselines` are timed in turns
    with these on the fixture, the adversarial plan and (K1) 64-stream
    launches."""
    import torch

    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.ops import video_recon as plain

    dev = torch.device("cuda")
    geom, pics = _fixture_pictures(dev)
    bounds = [cuda_kernels.reconstruct_bound(a[1], a[2], geom)
              for _, _, _, a, _ in pics]
    by_type = {}
    for (_, _, _, _, ptype), b in zip(pics, bounds):
        by_type.setdefault({1: "I", 2: "P", 3: "B"}[ptype], []) \
            .append(b["us"])
    run = lambda: [cuda_kernels.reconstruct_picture(  # noqa: E731
        c, f, b, *a, geom) for c, f, b, a, _ in pics]
    run_plain = lambda: [plain.reconstruct_picture(  # noqa: E731
        c, f, b, *a, geom) for c, f, b, a, _ in pics]
    ms = queued_ms(run, 5)
    plain_ms = cuda_ms(run_plain, 1)
    n = len(pics)
    bound_ms = sum(b["us"] for b in bounds) / n / 1e3
    out = {"phase": "k1_fixture", "pictures": n,
           "types": "".join({1: "I", 2: "P", 3: "B"}[p]
                            for *_, p in pics),
           "equal": True, "unit": "ms per 1080p picture",
           "k1_ms": ms / n, "k1_plain_ms": plain_ms / n,
           "bound_ms": bound_ms, "bound_share": bound_ms / (ms / n),
           "bound_us_by_type": {k: [min(v), statistics.mean(v), max(v)]
                                for k, v in by_type.items()},
           "coded_blocks": [int((a[1] > 0).sum()) for _, _, _, a, _ in pics]}
    for label, t in (("I", 1), ("P", 2)):
        sub = [p for p in pics if p[4] == t]
        out[f"k1_{label}_ms"] = queued_ms(lambda: [  # noqa: B023
            cuda_kernels.reconstruct_picture(c, f, b, *a, geom)
            for c, f, b, a, _ in sub], 5) / len(sub)

    res = [cuda_kernels.idct_batch(a[0].view(-1, 64), a[1].view(-1))
           .view(a[0].shape) for _, _, _, a, _ in pics]
    for i, ((c, f, b, a, _), r) in enumerate(zip(pics, res)):
        want = plain.reconstruct_picture(c, f, b, *a, geom)
        k3 = cuda_kernels.reconstruct_picture_multi(c, f, b, *a, geom)
        planes = cuda_kernels.reconstruct_planes(c, f, b, r, *a[1:], geom)
        torch.cuda.synchronize()
        if not (torch.equal(k3, want) and torch.equal(planes, want)):
            fail(f"k3 differs from its plain version on fixture picture {i}")
    run_k3 = lambda: [cuda_kernels.reconstruct_picture_multi(  # noqa: E731
        c, f, b, *a, geom) for c, f, b, a, _ in pics]
    run_planes = lambda: [cuda_kernels.reconstruct_planes(  # noqa: E731
        c, f, b, r, *a[1:], geom) for (c, f, b, a, _), r in zip(pics, res)]
    run_planes_plain = lambda: [plain.reconstruct_planes(  # noqa: E731
        c, f, b, r, *a[1:], geom) for (c, f, b, a, _), r in zip(pics, res)]
    path_bound_ms = sum(cuda_kernels.reconstruct_bound(
        a[1], a[2], geom, separate_idct=True)["us"]
        for _, _, _, a, _ in pics) / n / 1e3
    out.update({
        "k3_equal": True, "k3_ms": queued_ms(run_k3, 5) / n,
        "k3_planes_ms": queued_ms(run_planes, 5) / n,
        "k3_planes_plain_ms": cuda_ms(run_planes_plain, 1) / n,
        "k3_planes_bound_ms": bound_ms, "k3_path_bound_ms": path_bound_ms})
    if baselines:
        out["turns"] = {src: _turns(src, geom, pics, res)
                        for src in baselines}
    emit(out)
    return out


def _turns(source: str, geom, pics, fixture_res) -> dict:
    """K1 and K3 from `source` ("baseline") and this K1 and K3 ("this"),
    in turns baseline, this, this, baseline (twice): card ms per 1080p
    picture (`queued_ms`), the median of each case, beside each case's
    bound; the baseline's outputs equal these.  K1 on the fixture's
    pictures (cold), one adversarial plan repeated (warm) and 64-stream
    launches.  The 64-stream launch runs three times: adversarial plans,
    streams in order with distinct slots ("streams_64"); as
    `kernel_parity` times it, each stream reading a permuted picture and
    every third a reference step whose forward aliases backward
    ("streams_64_perm"); and the fixture's plans, stream s taking picture
    7s mod 32, as the 64-stream decode launches K1 on real pictures
    ("streams_64_fixture").  K3 ("k3_*") on the adversarial plan and the
    fixture's pictures, its whole path (K2 and the plane launches) and
    its two plane launches alone on a given residual (`fixture_res`, and
    the adversarial plan's); the baseline's K3 is K2 and the plane
    launches from `source`, with the pad bytes copied after them where
    its chroma launch does not write them (before this K3 it did not)."""
    import numpy as np
    import torch

    from mpeg_tpu_torch.ops import _build, cuda_kernels
    from mpeg_tpu_torch.testing import plan_args, random_plan

    so, log = _build.build(os.path.abspath(source),
                           _build.nvcc_flags("recon"))
    lib = _build.bind(so)
    dev = torch.device("cuda")

    def base_k1(pool, table, n, cur, fwd, bwd, out, args):
        code = lib.mt_reconstruct_pictures(
            cur.data_ptr(), fwd.data_ptr(), bwd.data_ptr(), out.data_ptr(),
            None if table is None else table.data_ptr(), n,
            *(a.data_ptr() for a in args), geom.mb_width, geom.mb_height,
            torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"baseline K1: CUDA error {code}")

    def base_one(c, f, b, args):
        out = torch.empty_like(c)
        base_k1(None, None, 1, c, f, b, out, args)
        return out

    pad_copy = not hasattr(lib, "mt_plane_smem_bytes")  # an older K3

    def base_planes(c, f, b, r, args):
        out = torch.empty_like(c)
        stream = torch.cuda.current_stream().cuda_stream
        for chroma in (0, 1):
            code = lib.mt_reconstruct_plane(
                c.data_ptr(), f.data_ptr(), b.data_ptr(), r.data_ptr(),
                *(a.data_ptr() for a in args[1:]), out.data_ptr(),
                geom.mb_width, geom.mb_height, chroma, stream)
            if code:
                fail(f"baseline K3: CUDA error {code}")
        if pad_copy:
            out[geom.frame_size:].copy_(c[geom.frame_size:])
        return out

    def base_k3(c, f, b, args):
        r = torch.empty_like(args[0])
        code = lib.mt_idct_batch(args[0].data_ptr(), args[1].data_ptr(),
                                 r.data_ptr(), r.numel() // 64,
                                 torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"baseline K2: CUDA error {code}")
        return base_planes(c, f, b, r, args)

    rng = np.random.default_rng(1)
    frame = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(0, 256, geom.total_size).astype(np.uint8)).to(dev)
    cur, fwd, bwd = frame(), frame(), frame()
    adv = plan_args(random_plan(geom, rng, 2), dev)
    adv_res = cuda_kernels.idct_batch(adv[0].view(-1, 64),
                                      adv[1].view(-1)).view(adv[0].shape)
    s_n = N_STREAMS
    pool = torch.from_numpy(rng.integers(0, 256, (4 * s_n, geom.total_size))
                            .astype(np.uint8)).to(dev)
    plans = [torch.stack(a) for a in zip(*(
        plan_args(random_plan(geom, rng, 1 + s % 2), dev)
        for s in range(s_n)))]
    table = torch.tensor([[4 * s, 4 * s + 1, 4 * s + 2, 4 * s + 3, s]
                          for s in range(s_n)], dtype=torch.int32,
                         device=dev)
    perm = rng.permutation(s_n)
    table_perm = torch.tensor(
        [[4 * s, 4 * s + (2 if s % 3 == 0 else 1), 4 * s + 2, 4 * s + 3,
          int(perm[s])] for s in range(s_n)], dtype=torch.int32, device=dev)
    plans_fix = [torch.stack(x) for x in zip(*(p[3] for p in pics))]
    table_fix = torch.tensor(
        [[4 * s, 4 * s + 1, 4 * s + 2, 4 * s + 3, 7 * s % len(pics)]
         for s in range(s_n)], dtype=torch.int32, device=dev)
    for c, f, b, a, _ in pics[:3] + pics[-2:]:
        if not torch.equal(base_one(c, f, b, a),
                           cuda_kernels.reconstruct_picture(c, f, b, *a,
                                                            geom)):
            fail("baseline K1 and this K1 differ on a fixture picture")
    got = pool.clone()
    base_k1(got, table_fix, s_n, got, got, got, got, plans_fix)
    if not torch.equal(got, cuda_kernels.reconstruct_pictures(
            pool.clone(), table_fix, *plans_fix, geom)):
        fail("baseline K1 and this K1 differ on 64 fixture streams")
    del got
    for (c, f, b, a, _), r in [(pics[k], fixture_res[k])
                               for k in (0, 1, 2, 30, 31)] + \
            [((cur, fwd, bwd, adv, 2), adv_res)]:
        want = cuda_kernels.reconstruct_planes(c, f, b, r, *a[1:], geom)
        if not (torch.equal(base_planes(c, f, b, r, a), want)
                and torch.equal(base_k3(c, f, b, a), want)):
            fail("baseline K3 and this K3 differ")
    fix = list(zip(pics, fixture_res))
    cases = {
        "fixture_cold": (
            lambda: [base_one(c, f, b, a) for c, f, b, a, _ in pics],
            lambda: [cuda_kernels.reconstruct_picture(c, f, b, *a, geom)
                     for c, f, b, a, _ in pics], 5, len(pics)),
        "adversarial_warm": (
            lambda: base_one(cur, fwd, bwd, adv),
            lambda: cuda_kernels.reconstruct_picture(cur, fwd, bwd, *adv,
                                                     geom), 200, 1),
        "streams_64": (
            lambda: base_k1(pool, table, s_n, pool, pool, pool, pool,
                            plans),
            lambda: cuda_kernels.reconstruct_pictures(pool, table, *plans,
                                                      geom), 10, s_n),
        "streams_64_perm": (
            lambda: base_k1(pool, table_perm, s_n, pool, pool, pool, pool,
                            plans),
            lambda: cuda_kernels.reconstruct_pictures(pool, table_perm,
                                                      *plans, geom), 10, s_n),
        "streams_64_fixture": (
            lambda: base_k1(pool, table_fix, s_n, pool, pool, pool, pool,
                            plans_fix),
            lambda: cuda_kernels.reconstruct_pictures(pool, table_fix,
                                                      *plans_fix, geom),
            10, s_n),
        "k3_fixture_cold": (
            lambda: [base_k3(c, f, b, a) for c, f, b, a, _ in pics],
            lambda: [cuda_kernels.reconstruct_picture_multi(c, f, b, *a,
                                                            geom)
                     for c, f, b, a, _ in pics], 5, len(pics)),
        "k3_planes_fixture_cold": (
            lambda: [base_planes(c, f, b, r, a)
                     for (c, f, b, a, _), r in fix],
            lambda: [cuda_kernels.reconstruct_planes(c, f, b, r, *a[1:],
                                                     geom)
                     for (c, f, b, a, _), r in fix], 5, len(pics)),
        "k3_adversarial_warm": (
            lambda: base_k3(cur, fwd, bwd, adv),
            lambda: cuda_kernels.reconstruct_picture_multi(
                cur, fwd, bwd, *adv, geom), 200, 1),
        "k3_planes_adversarial_warm": (
            lambda: base_planes(cur, fwd, bwd, adv_res, adv),
            lambda: cuda_kernels.reconstruct_planes(
                cur, fwd, bwd, adv_res, *adv[1:], geom), 200, 1),
    }
    # Each case's bound a picture (`cuda_kernels.reconstruct_bound`; K3's
    # whole path with K2's bytes).
    def bound(nb, ib, n, k2=False):
        return cuda_kernels.reconstruct_bound(
            nb, ib, geom, separate_idct=k2)["us"] / 1e3 / n

    fix_pics = table_fix[:, 4].long()
    bounds = {
        "fixture_cold": sum(bound(a[1], a[2], 1) for *_, a, _ in pics)
        / len(pics),
        "k3_fixture_cold": sum(bound(a[1], a[2], 1, True)
                               for *_, a, _ in pics) / len(pics),
        "adversarial_warm": bound(adv[1], adv[2], 1),
        "k3_adversarial_warm": bound(adv[1], adv[2], 1, True),
        "streams_64": bound(plans[1], plans[2], s_n),
        "streams_64_perm": bound(plans[1], plans[2], s_n),
        "streams_64_fixture": bound(plans_fix[1][fix_pics],
                                    plans_fix[2][fix_pics], s_n),
    }
    bounds["k3_planes_fixture_cold"] = bounds["fixture_cold"]
    bounds["k3_planes_adversarial_warm"] = bounds["adversarial_warm"]
    res = {}
    for name, (fb, ft, iters, per) in cases.items():
        got = {"baseline": [], "this": []}
        for _ in range(2):
            for who in ("baseline", "this", "this", "baseline"):
                fn = fb if who == "baseline" else ft
                got[who].append(queued_ms(fn, iters) / per)
        res[name] = {k: {"ms": statistics.median(v), "all_ms": v}
                     for k, v in got.items()}
        res[name]["bound_ms"] = bounds[name]
    res["baseline_ptxas"] = _ptxas_lines(log)
    return res


def _native_frames(data: bytes) -> list:
    """Every displayed frame of `data` from the C++ host decoder."""
    from mpeg_tpu_torch.native import NativeHostDecoder

    ref = NativeHostDecoder(data)
    frames = []
    while (f := ref.decode_next()) is not None:
        frames.append(f)
    return frames


def _kernel_name(name: str) -> str:
    return name.replace("(anonymous namespace)::", "")


def _transport_counts():
    """The transport counts (`parallel.batch.transport_counts`), set to
    0."""
    from mpeg_tpu_torch.parallel import batch

    batch.reset_transport_counts()
    return batch.transport_counts


def _counts(counts) -> dict:
    return {"copies": counts.copies, "pinned_copies": counts.pinned_copies,
            "bytes": counts.bytes}


def check_transport(counts, what: str) -> dict:
    """The transport's own count of a checked pass: every copy from
    pinned memory, at least one copy."""
    got = _counts(counts)
    if got["copies"] == 0 or got["pinned_copies"] != got["copies"]:
        fail(f"{what}: {got['copies']} copies, {got['pinned_copies']} "
             "from pinned memory")
    return got


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _timeline(prof, wall_median: float) -> dict:
    """The profiled pass's device timeline (the profiler's per-launch and
    per-copy records): the h2d copies' device us and how much of it ran
    while a kernel ran, pinned and pageable copies as the records name
    them and the pinned ones' device us, and the busy time as the union
    of every record (a copy under a kernel counted once) with the idle
    share against the unprofiled wall.  The profiler drops some records
    (one copy of a sharded pass's eight, once): counts of copies come
    from the transport."""
    import bisect

    from torch.autograd import DeviceType

    evs = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return {}
    h2d = [(a, b, n) for a, b, n in evs if n.startswith("Memcpy HtoD")]
    kernels = _merged((a, b) for a, b, n in evs
                      if not n.startswith(("Memcpy", "Memset")))
    starts = [a for a, _ in kernels]
    overlap = 0.0
    for a, b, _n in h2d:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(kernels) and kernels[i][0] < b:
            overlap += max(0.0, min(b, kernels[i][1]) - max(a, kernels[i][0]))
            i += 1
    h2d_us = sum(b - a for a, b, _ in h2d)
    busy = sum(b - a for a, b in _merged((a, b) for a, b, _ in evs))
    return {"h2d_device_us": h2d_us, "h2d_records": len(h2d),
            "h2d_pinned_us": sum(b - a for a, b, n in h2d if "Pinned" in n),
            "h2d_pinned_records": sum("Pinned" in n for _, _, n in h2d),
            "h2d_pageable_records": sum("Pageable" in n for _, _, n in h2d),
            "h2d_under_kernels_us": overlap,
            "h2d_under_kernels_share": overlap / h2d_us if h2d_us else None,
            "device_busy_union_s": busy / 1e6,
            "device_idle_share_union_unprofiled_wall":
                1 - busy / 1e6 / wall_median}


def profiled_pass(run, wall_median: float, kernels=None) -> dict:
    """One more pass of `run` under torch.profiler: how busy the card is
    and what fills it (rates are taken without the profiler).  The idle
    share is given against the profiled wall and against the unprofiled
    median wall, which the profiler does not slow down.  In some sessions
    on the card's machine the profiler records no device activity at
    all: the pass then reports its wall and `"device_recorded": false`,
    and no idle share (its frames are checked elsewhere); `main` says so
    in its `idle_share` line.  `kernels` maps a label to a part of a
    kernel's name (spaces ignored): the pass adds up each label's device
    us and launches.  Also the h2d copies' device time, their overlap
    with kernels and the union busy time (`_timeline`), and the
    transport's own count of the pass and, where the profiler
    recorded each of its copies, their rate over their device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counts = _transport_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sorted(((k.device_time_total, _kernel_name(k.key), k.count)
                  for k in prof.key_averages()
                  if k.device_type.name == "CUDA"), reverse=True)
    busy_us = sum(us for us, _, _ in dev)
    if busy_us <= 0:
        return {"wall_s": wall, "device_recorded": False}
    top = [[us, name[:80]] for us, name, _ in dev[:5]]
    out = {"wall_s": wall, "device_recorded": True,
           "device_busy_s": busy_us / 1e6,
           "device_idle_share": 1 - busy_us / 1e6 / wall,
           "device_idle_share_unprofiled_wall":
               1 - busy_us / 1e6 / wall_median,
           "top_device_us": top}
    for label, part in (kernels or {}).items():
        hits = [(us, n) for us, name, n in dev
                if part.replace(" ", "") in name.replace(" ", "")]
        out[f"{label}_device_us"] = sum(us for us, _ in hits)
        out[f"{label}_launches"] = sum(n for _, n in hits)
    out.update(_timeline(prof, wall_median))
    out["transport"] = _counts(counts)
    # The rate only where the profiler recorded every copy of the
    # transport (its records carry no byte counts on this torch).
    if out.get("h2d_pinned_records") == counts.copies and \
            out.get("h2d_pinned_us"):
        out["h2d_gb_per_s"] = counts.bytes / out["h2d_pinned_us"] / 1e3
    return out


def _check_against_host(frames, want, fs: int, what: str) -> None:
    """Every frame equal to the host decoder's, compared on the card."""
    import numpy as np
    import torch

    if len(frames) != len(want):
        fail(f"{what}: {len(frames)} frames, host decoder {len(want)}")
    for i, (a, b) in enumerate(zip(frames, want)):
        if isinstance(b, np.ndarray):
            b = torch.from_numpy(b[:fs]).to(a.device)
        if not torch.equal(a[:fs], b[:fs]):
            fail(f"{what}: frame {i} differs from NativeHostDecoder")


def _digest(frames, geom) -> int:
    from mpeg_tpu_torch.utils import Fnv1a64

    h = Fnv1a64()
    for f in frames:
        h.write(f[:geom.frame_size].cpu().numpy().tobytes())
    return h.sum64()


def phase_golden() -> None:
    """The goldens through `BatchVideoDecoder(window=16)`, with the parse
    prefetch thread off and on."""
    from mpeg_tpu_torch.parallel import BatchVideoDecoder

    for name, (frames_want, hash_want) in (
            ("test.mpeg1video", GOLDEN_VIDEO), ("test.mpg", GOLDEN_PS),
            ("test_custom_matrix.m1v", GOLDEN_CUSTOM)):
        data = open(os.path.join(TESTDATA, name), "rb").read()
        for prefetch in (False, True):
            dec = BatchVideoDecoder(data, window=16, prefetch=prefetch,
                                    device="cuda")
            frames = dec.decode_all()
            digest = _digest(frames, dec.geom)
            emit({"phase": "golden", "input": name, "prefetch": prefetch,
                  "frames": len(frames), "hash": f"{digest:#018x}",
                  "want": f"{hash_want:#018x}"})
            if len(frames) != frames_want or digest != hash_want:
                fail(f"{name} (prefetch {prefetch}): {len(frames)} frames, "
                     f"hash {digest:#018x}")


def phase_e2e_1080p() -> dict:
    """The single-stream path: the 1080p fixture through the port, all
    frames held against the C++ host decoder, the kernels' launch counts
    and the transport's count read from that run (the benchmark's
    m1v1080_single cells time this path)."""
    import torch

    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.parallel import BatchVideoDecoder

    data = _fixture_1080p()
    want = _native_frames(data)

    dec = BatchVideoDecoder(data, window=16, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    counts = _transport_counts()
    cuda_kernels.reset_launches()
    frames = dec.decode_all()
    torch.cuda.synchronize()
    launches = {"reconstruct_picture": cuda_kernels.reconstruct_picture
                .launches, "idct_batch": cuda_kernels.idct_batch.launches,
                "densify_unpack": cuda_kernels.densify_unpack.launches}
    transport = check_transport(counts, "1080p")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    held = [b for _g, b, *_ in dec._blob_inflight] + \
        [b for b, *_ in dec._blob_free]
    pinned_bytes = sum(b.numel() for b in held if b.is_pinned())
    pictures = len(dec._types)
    fs = dec.geom.frame_size
    if len(want) != 32:
        fail(f"1080p: the host decoder gave {len(want)} frames, not 32")
    _check_against_host(frames, want, fs, "1080p")
    if launches["reconstruct_picture"] != pictures or pictures == 0:
        fail(f"K1 launched {launches['reconstruct_picture']} times for "
             f"{pictures} pictures")
    if launches["densify_unpack"] != \
            cuda_kernels.DENSIFY_LAUNCHES * -(-pictures // 16):
        fail(f"K5 launched {launches['densify_unpack']} times for "
             f"{pictures} pictures in windows of 16")

    out = {"phase": "e2e_1080p", "frames": len(frames),
           "pictures": pictures, "equal_to_native_host_decoder": True,
           "launches": launches, "transport": transport,
           "peak_device_gib": peak_gib,
           "pinned_host_bytes_held": pinned_bytes}
    emit(out)
    return out


# K3's and K2's kernels by a part of their names (the plane launches are
# the reconstruct kernel's residual instantiations).
K3_KERNELS = {"k3_luma": "PlaneSet<0, 1, false>",
              "k3_chroma": "PlaneSet<1, 3, false>",
              "k2": "idct_batch_kernel"}
# K5's launches by name ("k5_with_waits": all of them, in any tree's
# densify.cu).  Launches B and C start early (programmatic dependent
# launch), and their device time includes their waits for the launch
# before: the sums overstate K5's card time, which `queued_ms` takes.
K5_KERNELS = {"k5_with_waits": "densify_", "k5_tiles": "densify_tiles_kernel",
              "k5_rows_with_waits": "densify_rows_kernel",
              "k5_assemble_with_waits": "densify_assemble_kernel"}


def phase_recon_multi_1080p() -> dict:
    """The 1080p fixture with K3 in K1's place (the decoder's internal
    reconstruct argument): all frames against the C++ host decoder, K3
    launched twice a picture and K2 once, K1 not at all; then timed over
    fresh decoders after one untimed pass, and one profiled pass: K3's
    and K2's device time a picture inside the decode and the card's idle
    share."""
    import torch

    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.parallel import BatchVideoDecoder

    data = _fixture_1080p()
    want = _native_frames(data)
    dec = BatchVideoDecoder(data, window=16, device="cuda")
    dec._recon = cuda_kernels.reconstruct_picture_multi
    cuda_kernels.reset_launches()
    t0 = time.perf_counter()
    frames = dec.decode_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"reconstruct_picture_multi":
                cuda_kernels.reconstruct_picture_multi.launches,
                "idct_batch": cuda_kernels.idct_batch.launches,
                "reconstruct_picture": cuda_kernels.reconstruct_picture
                .launches,
                "densify_unpack": cuda_kernels.densify_unpack.launches}
    pictures = len(dec._types)
    _check_against_host(frames, want, dec.geom.frame_size,
                        "1080p through K3")
    if len(frames) != 32 or launches != {
            "reconstruct_picture_multi": 2 * pictures,
            "idct_batch": pictures, "reconstruct_picture": 0,
            "densify_unpack":
                cuda_kernels.DENSIFY_LAUNCHES * -(-pictures // 16)}:
        fail(f"K3 path: {len(frames)} frames, {pictures} pictures, "
             f"launches {launches}")

    def decode():
        d = BatchVideoDecoder(data, window=16, device="cuda")
        d._recon = cuda_kernels.reconstruct_picture_multi
        return d.decode_all()

    walls = []
    for i in range(1 + E2E_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        if i:                              # the first pass: not timed
            walls.append(time.perf_counter() - t0)
    profiled = profiled_pass(decode, statistics.median(walls), K3_KERNELS)
    if profiled["device_recorded"]:
        profiled["k3_planes_us_per_picture"] = (
            profiled["k3_luma_device_us"] + profiled["k3_chroma_device_us"]
        ) / pictures
        profiled["k2_us_per_picture"] = profiled["k2_device_us"] / pictures
    out = {"phase": "recon_multi_1080p", "frames": len(frames),
           "pictures": pictures, "equal_to_native_host_decoder": True,
           "launches": launches, "wall_s_first_pass": wall,
           "walls_s": walls, "profiled_pass": profiled}
    emit(out)
    return out


def phase_multistream_golden() -> None:
    """tests/test_multistream.py's mixed sources in lockstep at window 4
    on the card, the parse prefetch thread off and on: each stream equal
    to the port's solo decoder on the card, and the whole streams on
    their goldens."""
    import torch

    from mpeg_tpu_torch.parallel import (BatchVideoDecoder,
                                         MultiStreamVideoDecoder)

    es = open(os.path.join(TESTDATA, "test.mpeg1video"), "rb").read()
    ps = open(os.path.join(TESTDATA, "test.mpg"), "rb").read()
    sources = [es, ps, es[:len(es) // 3], es]
    solos = [BatchVideoDecoder(data, window=4, device="cuda").decode_all()
             for data in sources]
    for prefetch in (False, True):
        ms = MultiStreamVideoDecoder(sources, window=4, prefetch=prefetch,
                                     device="cuda")
        got = ms.decode_all()
        fs = ms.geom.frame_size
        for s, solo in enumerate(solos):
            if len(got[s]) != len(solo) or not all(
                    torch.equal(a[:fs], b[:fs])
                    for a, b in zip(got[s], solo)):
                fail(f"multistream stream {s} (prefetch {prefetch}) "
                     "differs from its solo decode")
        hashes = [_digest(g, ms.geom) for g in got]
        for s, (frames_want, hash_want) in ((0, GOLDEN_VIDEO),
                                            (1, GOLDEN_PS),
                                            (3, GOLDEN_VIDEO)):
            if (len(got[s]), hashes[s]) != (frames_want, hash_want):
                fail(f"multistream stream {s} (prefetch {prefetch}): "
                     f"{len(got[s])} frames, hash {hashes[s]:#018x}")
    emit({"phase": "multistream_golden", "window": 4, "chunks": ms.chunks,
          "frames": [len(g) for g in got],
          "hashes": [f"{h:#018x}" for h in hashes],
          "equal_to_solo": True})


def _stream_cuts(data: bytes) -> list:
    """The fixture cut before picture k for each k of STREAM_CUTS."""
    starts, pos = [], data.find(b"\x00\x00\x01\x00")
    while pos >= 0:
        starts.append(pos)
        pos = data.find(b"\x00\x00\x01\x00", pos + 1)
    return [data if k is None else data[:starts[k]] for k in STREAM_CUTS]


def phase_multistream_1080p() -> dict:
    """The slice's main path at full width: 64 streams of the 1080p
    fixture (four lengths) in lockstep at window 2, default chunks.  Every
    frame of every stream against the C++ host decoder on that stream's
    bytes, K1's launches against rounds x window x chunks (the
    benchmark's m1v1080_64streams cell times this path)."""
    import torch

    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.parallel import MultiStreamVideoDecoder

    cuts = _stream_cuts(_fixture_1080p())
    streams = [cuts[s % len(cuts)] for s in range(N_STREAMS)]
    want = [[torch.from_numpy(f).cuda() for f in _native_frames(c)]
            for c in cuts]

    ms = MultiStreamVideoDecoder(streams, window=2, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    counts = _transport_counts()
    cuda_kernels.reset_launches()
    rounds, frames = 0, [[] for _ in streams]
    while (got := ms.decode_window()) is not None:
        rounds += 1
        for s, f in enumerate(got):
            frames[s].extend(f)
    torch.cuda.synchronize()
    transport = check_transport(counts, "64-stream 1080p")
    # Pinned host memory at the high-water mark: the two slots of the
    # grown buckets and the step tables' staging ring.
    pinned_bytes = sum(s.meta_host.numel() + s.main_host.numel()
                       for s in ms._slots) + \
        sum(b.numel() for b, _g in ms._decode._staging._bufs
            if b is not None)
    launches = {"reconstruct_picture": cuda_kernels.reconstruct_picture
                .launches, "idct_batch": cuda_kernels.idct_batch.launches,
                "reconstruct_picture_multi":
                    cuda_kernels.reconstruct_picture_multi.launches,
                "densify_unpack": cuda_kernels.densify_unpack.launches}
    fs = ms.geom.frame_size
    for s in range(N_STREAMS):
        _check_against_host(frames[s], want[s % len(cuts)], fs,
                            f"64-stream 1080p, stream {s}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_frames = sum(len(f) for f in frames)
    bound = rounds * ms.window * ms.chunks
    if not 0 < launches["reconstruct_picture"] <= bound:
        fail(f"K1 launched {launches['reconstruct_picture']} times in "
             f"{rounds} rounds (bound {bound})")
    k5_rounds = -(-max(len(w) for w in want) // ms.window)
    if launches["densify_unpack"] != \
            cuda_kernels.DENSIFY_LAUNCHES * k5_rounds:
        fail(f"K5 launched {launches['densify_unpack']} times in "
             f"{k5_rounds} rounds that hold pictures")

    out = {"phase": "multistream_1080p", "streams": N_STREAMS,
           "window": ms.window, "chunks": ms.chunks,
           "stream_pictures_kept": list(STREAM_CUTS), "rounds": rounds,
           "frames": n_frames, "equal_to_native_host_decoder": True,
           "launches": launches, "k1_launch_bound": bound,
           "transport": transport, "pinned_host_bytes_held": pinned_bytes,
           # the checked pass's peak: it keeps every frame, as decode_all
           "peak_device_gib": peak_gib}
    emit(out)
    return out


def _rgba_numpy(flat, geom):
    """RGBA [H, W, 4] of a flat frame in numpy, as Go's
    image/color.YCbCrToRGB computes it (4:2:0, each chroma sample over a
    2x2 luma block; alpha 255): this script's own formulation, apart
    from the port's torch one."""
    import numpy as np

    h, w = geom.height, geom.width
    cb0, cr0 = geom.luma_size, geom.luma_size + geom.chroma_size
    y = flat[:cb0].reshape(geom.luma_height, geom.luma_width)[:h, :w]
    up = lambda p: np.repeat(np.repeat(  # noqa: E731
        p.reshape(geom.chroma_height, geom.chroma_width), 2, 0), 2, 1)[:h, :w]
    cb, cr = up(flat[cb0:cr0]), up(flat[cr0:geom.frame_size])
    yy1 = y.astype(np.int32) * 0x10101
    cb1, cr1 = cb.astype(np.int32) - 128, cr.astype(np.int32) - 128

    def squash(c):   # Go: uint32(c)&0xff000000 == 0 ? c >> 16 : ^(c>>31)
        keep = (c.astype(np.uint32) & np.uint32(0xFF000000)) == 0
        return np.where(keep, c >> 16, ~(c >> 31) & 0xFFFF).astype(np.uint8)

    r = squash(yy1 + 91881 * cr1)
    g = squash(yy1 - 22554 * cb1 - 46802 * cr1)
    b = squash(yy1 + 116130 * cb1)
    return np.stack([r, g, b, np.full_like(r, 255)], axis=-1)


def phase_rgba() -> None:
    """The 1080p fixture with emit_rgba=True: every frame equal to the
    numpy RGBA of the C++ host decoder's frame."""
    import numpy as np

    from mpeg_tpu_torch.parallel import BatchVideoDecoder

    data = _fixture_1080p()
    want = _native_frames(data)
    dec = BatchVideoDecoder(data, window=16, device="cuda", emit_rgba=True)
    frames = dec.decode_all()
    if len(frames) != len(want):
        fail(f"rgba: {len(frames)} frames, host decoder {len(want)}")
    for i, (a, b) in enumerate(zip(frames, want)):
        if a.shape != (1080, 1920, 4) or not np.array_equal(
                a.cpu().numpy(), _rgba_numpy(b, dec.geom)):
            fail(f"rgba frame {i} differs from numpy")
    emit({"phase": "rgba", "frames": len(frames), "shape": [1080, 1920, 4],
          "equal_to_numpy": True})


def count_launches(fn) -> int:
    """Kernel launches of one call of `fn`, counted as the aten ops it
    dispatches that are not views: each elementwise op, copy, gather,
    fill or cat of the plain filterbank is one launch.  A kernel launched
    through ctypes (K1-K4) is no aten op: its launches are the wrappers'
    counters, and what this counts around a wrapper call is its copies
    and allocations."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


@contextlib.contextmanager
def no_plain_synthesis():
    """Fails the run when the plain filterbank runs on the card inside:
    every plain synthesis calls `filterbank.dct32`, which is wrapped
    meanwhile to record the CUDA tensors it gets (a CUDA path must go
    through K4)."""
    from mpeg_tpu_torch.ops import filterbank

    plain, on_card = filterbank.dct32, []

    def dct32(x):
        if x.device.type == "cuda":
            on_card.append(tuple(x.shape))
        return plain(x)

    filterbank.dct32 = dct32
    try:
        yield
    finally:
        filterbank.dct32 = plain
    if on_card:
        fail(f"the plain filterbank ran on the card {len(on_card)} times "
             f"(shapes {on_card[:3]})")


@contextlib.contextmanager
def no_plain_densify():
    """Fails the run when the plain version of K5 (`parallel.batch`'s
    `densify_split` or `unpack_blob_meta`) runs on the card inside: both
    are wrapped meanwhile to record the CUDA tensors they get (every video
    path on the card must go through K5)."""
    from mpeg_tpu_torch.parallel import batch

    names = ("densify_split", "unpack_blob_meta")
    plain, on_card = {name: getattr(batch, name) for name in names}, []

    def guard(name, fn):
        def run(blob, *args, **kwargs):
            if blob.device.type == "cuda":
                on_card.append(name)
            return fn(blob, *args, **kwargs)
        return run

    for name, fn in plain.items():
        setattr(batch, name, guard(name, fn))
    try:
        yield
    finally:
        for name, fn in plain.items():
            setattr(batch, name, fn)
    if on_card:
        fail(f"the plain densify ran on the card {len(on_card)} times "
             f"({sorted(set(on_card))})")


def _passes(run, n: int = E2E_PASSES) -> list:
    """Walls (s) of `n` calls of `run` after one untimed warm-up call,
    each ended by a synchronize."""
    import torch

    walls = []
    for i in range(1 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
    return walls


def _pcm_hash(chunks) -> int:
    from mpeg_tpu_torch.utils import Fnv1a64

    h = Fnv1a64()
    for c in chunks:
        h.write(c.astype("<f4").tobytes())
    return h.sum64()


def _frame_copy_host_us(calls: int = 2000) -> dict:
    """Host us a call of one MP2 frame's copy to the card (9,216 bytes of
    samples), each way the port could make it: `device_put` on the copy
    stream with its gate (the window paths'), `device_put` on the current
    stream (`Audio`'s) and `Tensor.to` from pageable memory; each queued
    `calls` times back to back, the card synchronized once after them."""
    import numpy as np
    import torch

    from mpeg_tpu_torch.parallel.batch import device_put, host_blob

    dev = torch.device("cuda", torch.cuda.current_device())
    frame = np.zeros((36, 2, 32), np.int32)
    host = host_blob(frame.nbytes, dev)
    ways = {"device_put_copy_stream": lambda: device_put([host], dev),
            "device_put_current_stream":
                lambda: device_put([host], dev, current_stream=True),
            "pageable_to": lambda: torch.from_numpy(frame).to(dev)}
    out = {}
    for name, fn in ways.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def phase_audio() -> dict:
    """MP2 on the card: `Audio(device="cuda")` on test.mp2 on the no-FMA
    golden with K4 launched once a frame; `BatchAudioDecoder` at window
    32 with K4 launched once a window, f32 on the golden, s16 equal to the
    s16 the host derives from those samples, and `out_device=True` equal
    to both; no plain filterbank op on the card in any of them, and one
    copy of samples a launch, from pinned memory (the transport's count).
    Then timed (median of 3 after a warm-up): Audio.decode and
    BatchAudioDecoder frames/s, the aten ops (copies, allocations:
    `count_launches`) of one `Audio._synthesize`, beside its one K4
    launch, and a frame's copy's host us each way
    (`_frame_copy_host_us`)."""
    import io

    import numpy as np
    import torch

    from mpeg_tpu_torch import Audio, Buffer
    from mpeg_tpu_torch.device import gpu_name_and_power_limit
    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.parallel import BatchAudioDecoder

    data = open(os.path.join(TESTDATA, "test.mp2"), "rb").read()

    def new_audio():
        buf = Buffer(io.BytesIO(data))
        buf.set_load_callback(buf.load_reader_callback)
        return Audio(buf, device="cuda")

    def decode_audio():
        audio = new_audio()
        frames = []
        while (smp := audio.decode()) is not None:
            frames.append(smp.interleaved)
        return frames

    transports = {}

    def k4_launches(run, want, what: str):
        """(run(), K4's count in it) with the count from 0 and no plain
        filterbank on the card; K4 launched want(result) times, and one
        copy of samples, pinned, each time."""
        counts = _transport_counts()
        cuda_kernels.reset_launches()
        with no_plain_synthesis():
            got = run()
        torch.cuda.synchronize()
        launches = cuda_kernels.synthesize.launches
        if launches != want(got):
            fail(f"{what}: K4 launched {launches} times, want {want(got)}")
        transports[what] = check_transport(counts, what)
        if transports[what]["copies"] != launches:
            fail(f"{what}: {transports[what]['copies']} copies for "
                 f"{launches} launches")
        return got, launches

    frames, frame_launches = k4_launches(decode_audio, len, "Audio")
    if (len(frames), _pcm_hash(frames)) != GOLDEN_AUDIO:
        fail(f"Audio: {len(frames)} frames, hash {_pcm_hash(frames):#018x}")
    n = len(frames)

    def windows_of(pcm):             # 32 frames of 2,304 samples a window
        return -(-len(pcm) // (32 * 2304))
    f32, window_launches = k4_launches(
        BatchAudioDecoder(data, window=32, device="cuda").decode_all,
        windows_of, "BatchAudioDecoder f32")
    if _pcm_hash([f32]) != GOLDEN_AUDIO[1] or \
            not np.array_equal(f32, np.concatenate(frames)):
        fail(f"BatchAudioDecoder f32: hash {_pcm_hash([f32]):#018x}")
    s16, _ = k4_launches(BatchAudioDecoder(data, window=32, out_format="s16",
                                           device="cuda").decode_all,
                         windows_of, "BatchAudioDecoder s16")
    want_s16 = np.trunc(np.where(f32 < 0, f32 * np.float32(0x8000),
                                 f32 * np.float32(0x7FFF))).astype(np.int16)
    if not np.array_equal(s16, want_s16):
        fail("BatchAudioDecoder s16 differs from the host s16 of f32")
    for fmt, want in (("f32", f32), ("s16", s16)):
        dev, _ = k4_launches(BatchAudioDecoder(
            data, window=32, out_format=fmt, out_device=True,
            device="cuda").decode_all, windows_of, f"out_device {fmt}")
        if dev.device.type != "cuda" or \
                not np.array_equal(dev.cpu().numpy(), want):
            fail(f"BatchAudioDecoder out_device {fmt} differs")

    audio_walls = _passes(decode_audio)
    batch_walls = _passes(lambda: BatchAudioDecoder(
        data, window=32, device="cuda").decode_all())
    audio = new_audio()
    sub = np.random.default_rng(0).integers(
        -1 << 17, 1 << 17, (36, 2, 32)).astype(np.int32)
    out = {"phase": "audio", "card": gpu_name_and_power_limit(),
           "frames": n, "hash": f"{_pcm_hash(frames):#018x}",
           "want": f"{GOLDEN_AUDIO[1]:#018x}", "batch_f32_golden": True,
           "batch_s16_equal_host_s16": True, "out_device_equal": True,
           "k4_launches": frame_launches, "transport": transports,
           "batch_windows": windows_of(f32),
           "batch_k4_launches": window_launches,
           "launches_counted_by": "the wrapper's counter "
           "(cuda_kernels.synthesize.launches)",
           "audio_fps_median": n / statistics.median(audio_walls),
           "audio_walls_s": audio_walls,
           "batch_fps_median": n / statistics.median(batch_walls),
           "batch_walls_s": batch_walls,
           "synthesize_aten_ops_a_frame": count_launches(
               lambda: audio._synthesize(sub)),
           "frame_copy_host_us": _frame_copy_host_us(),
           "aten_ops_counted_by": "count_launches: the h2d and d2h copies "
           "and the allocations, not the ctypes launch"}
    emit(out)
    return out


def _video_pictures(data: bytes) -> int:
    """The pictures of an ES or PS, counted by the C++ parser."""
    from mpeg_tpu_torch.native import NativePipeline, NativeVideoParser

    parser = NativePipeline(data) if data[:4] == b"\x00\x00\x01\xBA" \
        else NativeVideoParser(data)
    n = 0
    while parser.parse_next_plan() is not None:
        n += 1
    return n


def phase_interactive_golden() -> dict:
    """The reference-shaped API on the card: `Video(device="cuda")` on
    test.mpeg1video with both parsers, and `MPEG(test.mpg,
    device="cuda")` (decode_video, decode_audio), each on its golden with
    K1 launched once a picture and K4 once an audio frame;
    `seek(3.0, True)` fires the video callback once."""
    import io

    from mpeg_tpu_torch import MPEG, Buffer, Video
    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.utils import Fnv1a64

    es = open(os.path.join(TESTDATA, "test.mpeg1video"), "rb").read()
    ps = open(os.path.join(TESTDATA, "test.mpg"), "rb").read()
    out = {"phase": "interactive_golden"}

    def frames_hash(decode):
        h, n = Fnv1a64(), 0
        while (f := decode()) is not None:
            h.write(f.y.tobytes())
            h.write(f.cb.tobytes())
            h.write(f.cr.tobytes())
            n += 1
        return n, h.sum64()

    for parser in ("native", "python"):
        buf = Buffer(io.BytesIO(es))
        buf.set_load_callback(buf.load_reader_callback)
        video = Video(buf, parser=parser, device="cuda")
        cuda_kernels.reset_launches()
        got = frames_hash(video.decode)
        launches = cuda_kernels.reconstruct_picture.launches
        k5 = cuda_kernels.densify_unpack.launches
        out[f"video_{parser}"] = {"frames": got[0], "hash": f"{got[1]:#018x}",
                                  "k1_launches": launches,
                                  "k5_launches": k5}
        if got != GOLDEN_VIDEO or launches != _video_pictures(es) or \
                k5 != cuda_kernels.DENSIFY_LAUNCHES * launches:
            fail(f"Video({parser}): {got[0]} frames, hash {got[1]:#018x}, "
                 f"K1 launched {launches} times, K5 {k5}")

    m = MPEG(ps, device="cuda")
    m.set_audio_enabled(False)
    cuda_kernels.reset_launches()
    got = frames_hash(m.decode_video)
    launches = cuda_kernels.reconstruct_picture.launches
    k5 = cuda_kernels.densify_unpack.launches
    out["mpeg_video"] = {"frames": got[0], "hash": f"{got[1]:#018x}",
                         "k1_launches": launches, "k5_launches": k5}
    if got != GOLDEN_PS or launches != _video_pictures(ps) or \
            k5 != cuda_kernels.DENSIFY_LAUNCHES * launches:
        fail(f"MPEG.decode_video: {got[0]} frames, hash {got[1]:#018x}, "
             f"K1 launched {launches} times, K5 {k5}")
    m = MPEG(ps, device="cuda")
    m.set_video_enabled(False)
    pcm = []
    cuda_kernels.reset_launches()
    with no_plain_synthesis():
        while (smp := m.decode_audio()) is not None:
            pcm.append(smp.interleaved)
    launches = cuda_kernels.synthesize.launches
    out["mpeg_audio"] = {"frames": len(pcm), "hash": f"{_pcm_hash(pcm):#018x}",
                         "k4_launches": launches}
    if (len(pcm), _pcm_hash(pcm)) != GOLDEN_PS_AUDIO or launches != len(pcm):
        fail(f"MPEG.decode_audio: {len(pcm)} frames, hash "
             f"{_pcm_hash(pcm):#018x}, K4 launched {launches} times")
    m = MPEG(ps, device="cuda")
    count = [0]
    m.set_video_callback(lambda mp, f: count.__setitem__(0, count[0] + 1))
    m.set_audio_callback(lambda mp, smp: None)
    if not m.seek(3.0, True) or count[0] != 1:
        fail(f"seek(3.0, True) fired the video callback {count[0]} times")
    out["seek_callbacks"] = count[0]
    emit(out)
    return out


def _ps_1080p() -> bytes:
    """One pass of the 1080p fixture's 32 pictures and test.mp2's first
    seconds, muxed into an MPEG-PS (tools/ps_mux.py, test tooling)."""
    import io

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from ps_mux import mux

    seconds = 32 / 30.0
    out = io.BytesIO()
    mux(_fixture_1080p(), open(os.path.join(TESTDATA, "test.mp2"),
                               "rb").read(),
        video_seconds=seconds, audio_seconds=355 * 1152 / 44100.0,
        target_seconds=seconds, out=out)
    return out.getvalue()


def _clock_decode(m, on_video, on_audio, fps: float = 30.0) -> None:
    """`MPEG.decode(1 / fps)` with both callbacks until the stream ends."""
    m.set_video_callback(on_video)
    m.set_audio_callback(on_audio)
    steps = 0
    while not m.done:
        m.decode(1.0 / fps)
        steps += 1
        if steps > 10_000:
            fail("the clock-driven decode did not end")


def phase_interactive_1080p() -> dict:
    """The reference-shaped API at full width: a 1080p A/V PS through
    `MPEG(..., device="cuda").decode(tick)` with both callbacks, every
    video frame against the C++ host decoder on the 1080p ES and the
    audio against `MPEG(..., device="cpu")` on the same bytes, K1's
    and K4's launches read from that run (once a picture, once an audio
    frame; no plain filterbank op on the card), one pinned copy a picture
    and one an audio frame, and at most the two constant tables copied
    from pageable memory where torch.profiler recorded the card (the
    benchmark's ps1080_av_player cell times this path)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpeg_tpu_torch import MPEG
    from mpeg_tpu_torch.ops import cuda_kernels

    ps = _ps_1080p()
    want = _native_frames(_fixture_1080p())
    cpu_pcm = []
    _clock_decode(MPEG(ps, device="cpu"), None,
                  lambda _m, smp: cpu_pcm.append(smp.interleaved.copy()))

    frames, pcm = [], []
    m = MPEG(ps, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    counts = _transport_counts()
    cuda_kernels.reset_launches()
    with no_plain_synthesis(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        _clock_decode(m, lambda _m, f: frames.append(f.flat.clone()),
                      lambda _m, smp: pcm.append(smp.interleaved.copy()))
        torch.cuda.synchronize()
    transport = check_transport(counts, "interactive 1080p")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = cuda_kernels.reconstruct_picture.launches
    k4_launches = cuda_kernels.synthesize.launches
    k5_launches = cuda_kernels.densify_unpack.launches
    pictures = _video_pictures(ps)
    geom = m.video().geom
    _check_against_host(frames, want, geom.frame_size, "interactive 1080p")
    if len(frames) != 32 or launches != pictures:
        fail(f"interactive 1080p: {len(frames)} frames, K1 launched "
             f"{launches} times for {pictures} pictures")
    if k4_launches != len(pcm):
        fail(f"interactive 1080p: K4 launched {k4_launches} times for "
             f"{len(pcm)} audio frames")
    if k5_launches != cuda_kernels.DENSIFY_LAUNCHES * pictures:
        fail(f"interactive 1080p: K5 launched {k5_launches} times for "
             f"{pictures} pictures")
    if not pcm or len(pcm) != len(cpu_pcm) or \
            not np.array_equal(np.concatenate(pcm), np.concatenate(cpu_pcm)):
        fail(f"interactive 1080p audio: {len(pcm)} frames on the card, "
             f"{len(cpu_pcm)} on the CPU, or they differ")
    if transport["copies"] != pictures + len(pcm):
        fail(f"interactive 1080p: {transport['copies']} copies for "
             f"{pictures} pictures and {len(pcm)} audio frames")
    # Pageable copies left: the decoders' two constant tables, copied
    # once a decoder (`PictureBlobRecon`'s premultipliers and classes).
    h2d = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name.startswith("Memcpy HtoD")]
    pageable = sum("Pageable" in name for name in h2d)
    if pageable > 2:
        fail(f"interactive 1080p: {pageable} pageable copies")
    out = {"phase": "interactive_1080p", "bytes": len(ps), "frames": 32,
           "pictures": pictures,
           "audio_frames": len(pcm), "equal_to_native_host_decoder": True,
           "audio_equal_to_cpu": True, "k1_launches": launches,
           # a copy a picture and a copy an audio frame
           "transport": transport, "peak_device_gib": peak_gib,
           "k4_launches": k4_launches, "k5_launches": k5_launches,
           # 0 h2d records: the profiler recorded nothing on the card
           "profiled_h2d_records": len(h2d), "pageable_h2d_records": pageable}
    emit(out)
    return out


def _pinned_host() -> dict:
    """torch's pinned host allocator's own count (bytes pinned and held),
    where this torch has it."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return {"note": "not measured: torch.cuda.host_memory_stats absent"}
    got = stats()
    return {k: got[k] for k in ("allocated_bytes.current",
                                "reserved_bytes.current",
                                "reserved_bytes.peak") if k in got}


def _ring_held(ring, stack_bytes: int, what: str, least: int = 1) -> dict:
    """A dense ring's pinned buffers against the bound of `_DENSE_RING`
    window stacks, each at its power-of-two bucket (the size torch's
    pinned allocator gives it); at least `least` of them (one ring served
    every window)."""
    from mpeg_tpu_torch.parallel.batch import _DENSE_RING, pool_bucket

    bufs = [b for b, _g in ring._bufs if b is not None]
    held = sum(b.numel() for b in bufs)
    bound = _DENSE_RING * pool_bucket(stack_bytes, 4096)
    if not all(b.is_pinned() for b in bufs) or \
            not least <= len(bufs) <= _DENSE_RING or held > bound:
        fail(f"{what}: {len(bufs)} ring buffers, {held} bytes held "
             f"(bound {bound}), pinned {[b.is_pinned() for b in bufs]}")
    return {"buffers": len(bufs), "bytes": held, "stack_bytes": stack_bytes,
            "bound_bytes": bound}


def _dense_stream_windows(per_stream, geom, window: int):
    """Each window's stacked dense plans [S, T, ...] and per-stream types
    (`sharding.stack_stream_plans`)."""
    from mpeg_tpu_torch.parallel import sharding as sh

    n_win = -(-max(len(p) for p in per_stream) // window)
    out = []
    for w in range(n_win):
        part = [p[w * window:(w + 1) * window] for p in per_stream]
        out.append((sh.stack_stream_plans(part, geom, window),
                    [[t for _, t in p] for p in part]))
    return out


def _sharded_frames(decode, carry, windows, dev0):
    """Each stream's displayed frames from a sharded decoder over
    `windows` [(inputs, per-stream types)], the reference delay and the
    end-of-stream flush applied: (frames, summed total_px)."""
    import torch

    from mpeg_tpu_torch.tables import PICTURE_TYPE_B

    n = len(windows[0][1])
    frames = [[] for _ in range(n)]
    has_ref, last = [False] * n, [0] * n
    total_px = 0
    for inputs, types in windows:
        carry, disps, px = decode(carry, inputs)
        if px.dtype != torch.int64:
            fail(f"sharded total_px is {px.dtype}, not int64")
        total_px += int(px)
        disps = torch.cat([d.to(dev0) for d in disps])
        for s in range(n):
            for i, t in enumerate(types[s]):
                last[s] = t
                if t == PICTURE_TYPE_B or has_ref[s]:
                    frames[s].append(disps[s, i])
                else:
                    has_ref[s] = True
    bwd = torch.cat([b.to(dev0) for b in carry[2]])
    for s in range(n):
        if has_ref[s] and last[s] != PICTURE_TYPE_B:
            frames[s].append(bwd[s])
    return frames, total_px


# The sharded dense decoder's streams: the fixture's pictures kept, so that
# each shard of the card listed twice has a stream with every step valid.
DENSE_SHARDED_CUTS = (None, 25, None, 17)


def _native_plans(data: bytes):
    """(geom, [(plan, picture type)]) of `data` from the C++ parser."""
    from mpeg_tpu_torch.native import NativeVideoParser

    parser, plans = NativeVideoParser(data), []
    while (item := parser.parse_next_plan()) is not None:
        plans.append(item)
    return parser.geom(), plans


def phase_dense() -> dict:
    """The dense transport on the card: test.mpeg1video through
    `BatchVideoDecoder(transport="dense", use_native=False)` on its golden
    with K1 launched once a picture; then the 1080p fixture cut to 9
    pictures, every frame equal to the blob transport's and to the C++
    host decoder's, with the bytes each transport ships; each pass's
    copies all pinned (the transport's count), the dense ring within
    `_DENSE_RING` stacks; the cut timed (median of 3 after a warm-up that
    pins the ring) and profiled (its `Memcpy HtoD` card time).  Then
    `make_sharded_scan_decoder` on `make_mesh()` and on ["cuda:0",
    "cuda:0"]: four streams of the fixture (DENSE_SHARDED_CUTS) as the C++
    parser's dense plans at window 16, every frame equal to the blob
    sharded decoder's and to the C++ host decoder's, K1 launched once a
    step a shard, every copy pinned, its rings within the bound."""
    import torch

    from mpeg_tpu_torch.device import gpu_name_and_power_limit
    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.parallel import BatchVideoDecoder
    from mpeg_tpu_torch.parallel import sharding as sh
    from mpeg_tpu_torch.parallel.batch import stack_layout
    from mpeg_tpu_torch.utils.profiling import DecodeStats

    es = open(os.path.join(TESTDATA, "test.mpeg1video"), "rb").read()
    dec = BatchVideoDecoder(es, window=16, transport="dense",
                            use_native=False, device="cuda")
    counts = _transport_counts()
    cuda_kernels.reset_launches()
    frames = dec.decode_all()
    torch.cuda.synchronize()
    launches = cuda_kernels.reconstruct_picture.launches
    golden_transport = check_transport(counts, "dense golden")
    golden_ring = _ring_held(dec._scan._ring,
                             stack_layout(dec.geom, 16)[1], "dense golden",
                             least=2)
    pictures = len(dec._types)
    digest = _digest(frames, dec.geom)
    if (len(frames), digest) != GOLDEN_VIDEO or launches != pictures:
        fail(f"dense: {len(frames)} frames, hash {digest:#018x}, K1 "
             f"launched {launches} times for {pictures} pictures")

    fixture = _fixture_1080p()
    cut = _stream_cuts(fixture)[STREAM_CUTS.index(9)]
    want = _native_frames(cut)
    stats = {"dense": DecodeStats(), "blob": DecodeStats()}
    d = BatchVideoDecoder(cut, window=16, transport="dense",
                          use_native=False, device="cuda",
                          stats=stats["dense"])
    counts = _transport_counts()
    cuda_kernels.reset_launches()
    got = d.decode_all()
    torch.cuda.synchronize()
    cut_launches = cuda_kernels.reconstruct_picture.launches
    cut_transport = check_transport(counts, "dense 1080p cut")
    stack_bytes = stack_layout(d.geom, 16)[1]
    cut_ring = _ring_held(d._scan._ring, stack_bytes, "dense 1080p cut")
    blob = BatchVideoDecoder(cut, window=16, device="cuda",
                             stats=stats["blob"]).decode_all()
    fs = d.geom.frame_size
    _check_against_host(got, want, fs, "dense 1080p cut")
    _check_against_host(got, blob, fs, "dense 1080p cut against blob")
    if cut_launches != len(d._types):
        fail(f"dense 1080p: K1 launched {cut_launches} times for "
             f"{len(d._types)} pictures")
    del got, blob

    def run():
        return BatchVideoDecoder(cut, window=16, transport="dense",
                                 use_native=False,
                                 device="cuda").decode_all()

    walls = _passes(run)
    profiled = profiled_pass(run, statistics.median(walls))

    by_kept = dict(zip(STREAM_CUTS, _stream_cuts(fixture)))
    cuts = [by_kept[k] for k in DENSE_SHARDED_CUTS]
    window = 16
    parsed = [_native_plans(c) for c in cuts]
    geom = parsed[0][0]
    windows = _dense_stream_windows([p for _, p in parsed], geom, window)
    blob_parsed = [_native_windows(c, window) for c in cuts]
    blobs, blob_types, km, ke = _common_blobs([w for _, w in blob_parsed],
                                              geom, window)
    host = [[torch.from_numpy(f).cuda() for f in _native_frames(c)]
            for c in cuts]
    sharded = {}
    for name, devices in (("card", None), ("card_twice",
                                           ["cuda:0", "cuda:0"])):
        mesh = sh.make_mesh(devices)
        decode = sh.make_sharded_scan_decoder(geom, mesh)
        counts = _transport_counts()
        cuda_kernels.reset_launches()
        dense_frames, total_px = _sharded_frames(
            decode, sh.zero_carry(geom, len(cuts), mesh), windows,
            mesh.devices[0])
        torch.cuda.synchronize()
        k1 = cuda_kernels.reconstruct_picture.launches
        k5 = cuda_kernels.densify_unpack.launches
        transport = check_transport(counts, f"sharded dense ({name})")
        steps = len(windows) * window * len(mesh.devices)
        if k1 != steps or k5:
            fail(f"sharded dense ({name}): K1 launched {k1} times for "
                 f"{steps} steps of its shards, K5 {k5} times")
        # A shard a window: its stack, K1's two step tables (one put) and
        # the carry's index.
        if transport["copies"] != 4 * len(windows) * len(mesh.devices):
            fail(f"sharded dense ({name}): {transport['copies']} copies "
                 f"for {len(windows)} windows of {len(mesh.devices)} shards")
        rings = decode.__closure__[decode.__code__.co_freevars.index(
            "staging")].cell_contents
        ring, = rings.values()
        held = _ring_held(ring, stack_layout(geom, window * len(cuts))[1],
                          f"sharded dense ({name})", least=len(windows))
        blob_frames, blob_px = _sharded_decode(sh, geom, mesh, blobs,
                                               blob_types, window, km, ke)
        n_pictures = sum(len(p) for _, p in parsed)
        if total_px != blob_px or total_px != n_pictures * geom.frame_size:
            fail(f"sharded dense ({name}): total_px {total_px}, blob "
                 f"{blob_px}, want {n_pictures * geom.frame_size}")
        for s in range(len(cuts)):
            _check_against_host(dense_frames[s], host[s], geom.frame_size,
                                f"sharded dense ({name}), stream {s}")
            _check_against_host(dense_frames[s], blob_frames[s],
                                geom.frame_size,
                                f"sharded dense ({name}) against blob, "
                                f"stream {s}")
        sharded[name] = {"devices": [str(dev) for dev in mesh.devices],
                         "frames": sum(len(f) for f in dense_frames),
                         "equal_to_native_host_decoder": True,
                         "equal_to_blob_sharded": True, "k1_launches": k1,
                         "steps_times_shards": steps, "k5_launches": k5,
                         "transport": transport, "ring": held}
        del dense_frames, blob_frames
    out = {"phase": "dense", "card": gpu_name_and_power_limit(),
           "golden_frames": len(frames), "hash": f"{digest:#018x}",
           "k1_launches": launches, "golden_transport": golden_transport,
           "golden_ring": golden_ring,
           "cut_pictures": len(d._types), "cut_frames": len(want),
           "equal_to_native_host_decoder": True, "equal_to_blob": True,
           "cut_k1_launches": cut_launches,
           "cut_transfer_bytes": {k: v.transfer_bytes
                                  for k, v in stats.items()},
           "transport": cut_transport, "cut_ring": cut_ring,
           "pinned_host_allocator": _pinned_host(),
           "cut_fps_median_python_parse_included":
               len(want) / statistics.median(walls),
           "cut_walls_s": walls, "profiled_pass": profiled,
           "sharded_streams_pictures_kept": list(DENSE_SHARDED_CUTS),
           "sharded_window": window, "sharded": sharded}
    emit(out)
    return out


SHARDED_STREAMS = 8


def _native_windows(data: bytes, window: int):
    """`data`'s windows as the C++ parser packs them: (geom, [(blob, km,
    ke, picture types)]), each blob a numpy copy."""
    import numpy as np

    from mpeg_tpu_torch.parallel import BatchVideoDecoder

    dec = BatchVideoDecoder(data, window=window, device="cuda")
    out = []
    while True:
        blob, types, _fill = dec._native_window_blob()
        if not types:
            return dec.geom, out
        out.append((np.asarray(blob).copy(), dec._km, dec._ke, types))


def _common_blobs(per_stream, geom, window: int):
    """Each stream's native blobs re-laid to common buckets, window by
    window (reference: examples/clip_serving.py): ([blobs uint8 [S,
    bytes]], [[types of stream s] per window], km, ke).  A stream with no
    picture left gets an all-zero blob: every step a no-op."""
    import numpy as np

    from mpeg_tpu_torch.parallel.batch import blob_layout, blob_views

    km = max(w[1] for s in per_stream for w in s)
    ke = max(w[2] for s in per_stream for w in s)
    total = blob_layout(geom, window, km, ke)[1]
    n_win = max(len(s) for s in per_stream)
    blobs, types = [], []
    for w in range(n_win):
        stacked = np.zeros((len(per_stream), total), np.uint8)
        types.append([])
        for s, wins in enumerate(per_stream):
            if w >= len(wins):
                types[-1].append([])
                continue
            blob, bkm, bke, t = wins[w]
            src = blob_views(blob, geom, window, bkm, bke)
            dst = blob_views(stacked[s], geom, window, km, ke)
            for k in src:
                dst[k][:src[k].size] = src[k]
            types[-1].append(t)
        blobs.append(stacked)
    return blobs, types, km, ke


def _sharded_decode(sh, geom, mesh, blobs, types, window, km, ke):
    """Every window through the sharded blob decoder: (per-stream
    displayed frames, summed total_px, the flush included)."""
    decode = sh.make_sharded_blob_decoder(geom, mesh, window, km, ke)
    return _sharded_frames(decode, sh.zero_carry(geom, blobs[0].shape[0],
                                                 mesh),
                           list(zip(blobs, types)), mesh.devices[0])


def phase_sharded_1080p() -> dict:
    """8 streams of the 1080p fixture (stream s cut as STREAM_CUTS[s % 4])
    at window 16, as native window blobs at common buckets, through
    `make_sharded_blob_decoder` on `make_mesh()` (the card) and on
    ["cuda:0", "cuda:0"] (two shards on it): every frame, flush included,
    against the C++ host decoder, total_px against pictures x frame_size
    in int64, K1's launches; then the displayed frames/s of the decode
    calls (the parse is done before; median of 3 after a warm-up), one
    profiled pass and the peak device memory.  Then
    `make_sharded_audio_synth` on the card's mesh and on the card listed
    twice: 8 streams of test.mp2's frames (stream s from frame 4s, 320
    frames), K4 launched once a shard (no plain filterbank op on the
    card) after one pinned copy a shard, each stream equal to the plain
    single-stream
    `synthesize_window` + `finalize`, and stream 0 with the golden
    decode's last 35 frames on the golden."""
    import numpy as np
    import torch

    from mpeg_tpu_torch.device import gpu_name_and_power_limit
    from mpeg_tpu_torch.native import NativeAudioParser
    from mpeg_tpu_torch.ops import cuda_kernels, filterbank
    from mpeg_tpu_torch.parallel import BatchAudioDecoder
    from mpeg_tpu_torch.parallel import sharding as sh

    window = 16
    cuts = _stream_cuts(_fixture_1080p())
    parsed = [_native_windows(c, window) for c in cuts]
    geom = parsed[0][0]
    per_stream = [parsed[s % len(cuts)][1] for s in range(SHARDED_STREAMS)]
    blobs, types, km, ke = _common_blobs(per_stream, geom, window)
    want = [[torch.from_numpy(f).cuda() for f in _native_frames(c)]
            for c in cuts]
    pictures = sum(len(t) for w in types for t in w)
    fs = geom.frame_size
    out = {"phase": "sharded_1080p", "card": gpu_name_and_power_limit(),
           "streams": SHARDED_STREAMS, "window": window,
           "stream_pictures_kept": list(STREAM_CUTS), "pictures": pictures,
           "pool_buckets": [km, ke], "meshes": {}}
    for name, devices in (("card", None), ("card_twice",
                                           ["cuda:0", "cuda:0"])):
        mesh = sh.make_mesh(devices)
        torch.cuda.reset_peak_memory_stats()
        counts = _transport_counts()
        cuda_kernels.reset_launches()
        frames, total_px = _sharded_decode(sh, geom, mesh, blobs, types,
                                           window, km, ke)
        torch.cuda.synchronize()
        transport = check_transport(counts, f"sharded 1080p ({name})")
        launches = cuda_kernels.reconstruct_picture.launches
        k5_launches = cuda_kernels.densify_unpack.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        for s in range(SHARDED_STREAMS):
            _check_against_host(frames[s], want[s % len(cuts)], fs,
                                f"sharded 1080p ({name}), stream {s}")
        if total_px != pictures * fs:
            fail(f"sharded total_px {total_px}, want {pictures * fs}")
        bound = len(blobs) * window * len(mesh.devices)
        if not 0 < launches <= bound:
            fail(f"sharded ({name}): K1 launched {launches} times "
                 f"(bound {bound})")
        if k5_launches != cuda_kernels.DENSIFY_LAUNCHES * len(blobs) * \
                len(mesh.devices):
            fail(f"sharded ({name}): K5 launched {k5_launches} times for "
                 f"{len(blobs)} windows on {len(mesh.devices)} shards")
        n_frames = sum(len(f) for f in frames)
        del frames

        def run():
            return _sharded_decode(sh, geom, mesh, blobs, types, window,
                                   km, ke)

        walls = _passes(run)
        out["meshes"][name] = {
            "devices": [str(d) for d in mesh.devices], "frames": n_frames,
            "equal_to_native_host_decoder": True, "total_px": total_px,
            "total_px_dtype": "int64", "k1_launches": launches,
            "k5_launches": k5_launches, "transport": transport,
            "k1_launch_bound": bound, "peak_device_gib": peak_gib,
            "fps_median": n_frames / statistics.median(walls),
            "walls_s": walls,
            "profiled_pass": profiled_pass(run, statistics.median(walls),
                                           K5_KERNELS)}

    mp2 = open(os.path.join(TESTDATA, "test.mp2"), "rb").read()
    parser = NativeAudioParser(mp2)
    sub = []
    while (f := parser.parse_next_frame()) is not None:
        sub.append(f)
    n_frames = 320
    samples = np.stack([np.asarray(sub[4 * s:4 * s + n_frames], np.int32)
                        .reshape(-1, 2, 32) for s in range(SHARDED_STREAMS)])
    k4_launches, audio_transport = {}, {}
    for name, devices in (("card", None), ("card_twice",
                                           ["cuda:0", "cuda:0"])):
        mesh = sh.make_mesh(devices)
        counts = _transport_counts()
        cuda_kernels.reset_launches()
        with no_plain_synthesis():
            u, _hist, total = sh.make_sharded_audio_synth(mesh)(
                samples, sh.zero_audio_hist(SHARDED_STREAMS, mesh))
            torch.cuda.synchronize()
        k4_launches[name] = cuda_kernels.synthesize.launches
        if k4_launches[name] != len(mesh.devices):
            fail(f"sharded synthesis ({name}): K4 launched "
                 f"{k4_launches[name]} times for {len(mesh.devices)} shards")
        audio_transport[name] = check_transport(
            counts, f"sharded synthesis ({name})")
        if audio_transport[name]["copies"] != len(mesh.devices):
            fail(f"sharded synthesis ({name}): "
                 f"{audio_transport[name]['copies']} copies for "
                 f"{len(mesh.devices)} shards")
        u = torch.cat(u)
        if name == "card":
            u_card = u
        elif not torch.equal(u.view(torch.int32), u_card.view(torch.int32)):
            fail("sharded synthesis: the card twice differs from the card")
    zero = torch.zeros((15, 2, 64), dtype=torch.float32, device="cuda")
    for s in range(SHARDED_STREAMS):
        one, _ = filterbank.synthesize_window(
            torch.from_numpy(samples[s]).cuda(), zero)
        if not torch.equal(filterbank.finalize(u[s]),
                           filterbank.finalize(one)):
            fail(f"sharded synthesis stream {s} differs from one stream's")
    if int(total) != samples.shape[0] * samples.shape[1] * 32:
        fail(f"sharded synthesis total {int(total)}")
    golden = BatchAudioDecoder(mp2, window=32, device="cuda").decode_all()
    pcm = np.concatenate([filterbank.finalize(u[0]).cpu().numpy(),
                          golden[n_frames * 2304:]])
    if _pcm_hash([pcm]) != GOLDEN_AUDIO[1]:
        fail(f"sharded synthesis stream 0: hash {_pcm_hash([pcm]):#018x}")
    out["audio"] = {"streams": SHARDED_STREAMS, "frames": n_frames,
                    "equal_to_one_stream": True, "total": int(total),
                    "golden_with_decoder_tail": True,
                    "k4_launches": k4_launches, "transport": audio_transport}
    emit(out)
    return out


# About 50 ms of the card's time at its ~2 GHz clock: longer than a
# window's parse, so that the copies are still pending when the prefetch
# thread wants the next blob.
HOLD_CYCLES = 100_000_000


def _hold(dev, cycles: int = HOLD_CYCLES) -> None:
    """The transport's adversary: the compute stream and the copy stream
    each busy for `cycles` clocks from now (`torch.cuda._sleep`)."""
    import torch

    from mpeg_tpu_torch.parallel.batch import copy_stream

    torch.cuda._sleep(cycles)
    with torch.cuda.stream(copy_stream(dev)):
        torch.cuda._sleep(cycles)


def phase_transport() -> dict:
    """The window transport under an adversary that holds the compute
    stream and the copy stream before every window, round or call, so
    that copies and kernels are in flight while the parse prefetch
    thread wants a free blob: the 1080p fixture at window 4 (prefetch
    on), 8 lockstep streams of its four lengths at window 2 (prefetch
    on) and the sharded decode of 8 streams on the card listed twice
    (the caller's blobs overwritten after each call), every frame against
    the C++ host decoder; and one more window, round, call or picture on
    each of the four blob paths, the dense paths (`BatchVideoDecoder`,
    `make_dense_scan_decoder`, the sharded dense decoder on the card and
    on it twice) and the MP2 paths (`BatchAudioDecoder(out_device=True)`,
    the sharded synthesis on both meshes) with both streams held returns
    while the held work is pending (no copy waits for the card), its
    output equal to the same step's run free; `Audio` and
    `BatchAudioDecoder` with host PCM, which wait for their PCM by
    contract, equal too."""
    import io

    import numpy as np
    import torch

    from mpeg_tpu_torch import Audio, Buffer, Video
    from mpeg_tpu_torch.native import NativeAudioParser
    from mpeg_tpu_torch.parallel import (BatchAudioDecoder,
                                         BatchVideoDecoder,
                                         MultiStreamVideoDecoder,
                                         make_dense_scan_decoder)
    from mpeg_tpu_torch.parallel import sharding as sh
    from mpeg_tpu_torch.parallel.batch import copy_stream, stack_plans

    dev = torch.device("cuda", torch.cuda.current_device())
    data = _fixture_1080p()
    cuts = _stream_cuts(data)
    want = [[torch.from_numpy(f).to(dev) for f in _native_frames(c)]
            for c in cuts]
    out = {"phase": "transport", "hold_cycles": HOLD_CYCLES}

    t0 = time.perf_counter()
    dec = BatchVideoDecoder(data, window=4, prefetch=True, device="cuda")
    frames = []
    while True:
        _hold(dev)
        got = dec.decode_window()
        if not got:
            break
        frames.extend(got)
    torch.cuda.synchronize()
    _check_against_host(frames, want[0], dec.geom.frame_size,
                        "transport adversary, 1080p")
    out["single_stream"] = {"frames": len(frames),
                            "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    streams = [cuts[s % len(cuts)] for s in range(8)]
    ms = MultiStreamVideoDecoder(streams, window=2, prefetch=True,
                                 device="cuda")
    frames = [[] for _ in streams]
    while True:
        _hold(dev)
        got = ms.decode_window()
        if got is None:
            break
        for s, f in enumerate(got):
            frames[s].extend(f)
    torch.cuda.synchronize()
    for s in range(8):
        _check_against_host(frames[s], want[s % len(cuts)],
                            ms.geom.frame_size,
                            f"transport adversary, stream {s}")
    out["streams_8"] = {"frames": sum(len(f) for f in frames),
                        "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    parsed = [_native_windows(c, 8) for c in cuts]
    geom = parsed[0][0]
    blobs, types, km, ke = _common_blobs(
        [parsed[s % len(cuts)][1] for s in range(8)], geom, 8)
    mesh = sh.make_mesh([str(dev), str(dev)])

    class Held:
        """The sharded decoder, both streams held before each call and
        the caller's blobs overwritten after it."""

        def make_sharded_blob_decoder(self, *args):
            decode = sh.make_sharded_blob_decoder(*args)

            def held(carry, stacked):
                _hold(dev)
                stacked = stacked.copy()
                got = decode(carry, stacked)
                stacked[:] = 0xA5
                return got
            return held

        def __getattr__(self, name):
            return getattr(sh, name)

    frames, _px = _sharded_decode(Held(), geom, mesh, blobs, types, 8, km,
                                  ke)
    torch.cuda.synchronize()
    for s in range(8):
        _check_against_host(frames[s], want[s % len(cuts)], geom.frame_size,
                            f"transport adversary, sharded stream {s}")
    out["sharded_card_twice"] = {"frames": sum(len(f) for f in frames),
                                 "seconds": time.perf_counter() - t0}

    # One more step on each path with both streams held.
    es = open(os.path.join(TESTDATA, "test.mpeg1video"), "rb").read()

    def busy():
        return not torch.cuda.current_stream(dev).query() and \
            not copy_stream(dev).query()

    waited = {}
    d = BatchVideoDecoder(es, window=4, pool_buckets=(1 << 16, 1 << 10),
                          device="cuda")
    d.decode_window()
    torch.cuda.synchronize()
    _hold(dev)
    d.decode_window()
    waited["batch"] = not busy()
    torch.cuda.synchronize()
    m = MultiStreamVideoDecoder([es, es], window=2,
                                pool_buckets=(1 << 16, 1 << 10),
                                device="cuda")
    m.decode_window()
    torch.cuda.synchronize()
    _hold(dev)
    m.decode_window()
    waited["multistream"] = not busy()
    torch.cuda.synchronize()
    g, wins = _native_windows(es, 8)
    two, _t, kmc, kec = _common_blobs([wins, wins], g, 8)
    for name, devices in (("sharded", None),
                          ("sharded_card_twice", [str(dev), str(dev)])):
        smesh = sh.make_mesh(devices)
        decode = sh.make_sharded_blob_decoder(g, smesh, 8, kmc, kec)
        carry, _d, _p = decode(sh.zero_carry(g, 2, smesh), two[0])
        torch.cuda.synchronize()
        _hold(dev)
        decode(carry, two[1])
        waited[name] = not busy()
        torch.cuda.synchronize()
    buf = Buffer(io.BytesIO(es))
    buf.set_load_callback(buf.load_reader_callback)
    video = Video(buf, device="cuda")
    for _ in range(3):
        video.decode()
    torch.cuda.synchronize()
    _hold(dev)
    video.decode()
    waited["interactive"] = not busy()
    torch.cuda.synchronize()

    # The dense and MP2 paths: each runs a first window or call, then one
    # more, free and then with both streams held; held, the step returns
    # while the held work pends (the MP2 paths that hand back host PCM
    # wait for it, by contract), and the two steps' outputs are equal.
    def steps_equal(name, start, step, returns=True):
        outs = []
        for held in (False, True):
            state = start()
            torch.cuda.synchronize()
            if held:
                _hold(dev)
            got = step(state)
            outs.append([t.clone() for t in got] if isinstance(got, list)
                        else got)
            if held and returns:
                waited[name] = not busy()
            torch.cuda.synchronize()
        a, b = ([torch.as_tensor(t) for t in o] if isinstance(o, list)
                else [torch.as_tensor(o)] for o in outs)
        if len(a) != len(b) or not all(torch.equal(x.cpu(), y.cpu())
                                       for x, y in zip(a, b)):
            fail(f"transport, {name}: the held step's output differs")

    def dense_batch():
        d = BatchVideoDecoder(es, window=4, transport="dense",
                              use_native=False, device="cuda")
        d.decode_window()
        return d

    steps_equal("dense_batch", dense_batch, lambda d: d.decode_window())
    dgeom, dplans = _native_plans(es)
    stacks = [stack_plans(dplans[a:a + 8], dgeom, 8) for a in (0, 8)]

    def dense_scan():
        scan = make_dense_scan_decoder(dgeom, device="cuda")
        carry = tuple(torch.zeros(dgeom.total_size, dtype=torch.uint8,
                                  device=dev) for _ in range(3))
        return scan, scan(carry, stacks[0])[0]

    steps_equal("dense_scan", dense_scan,
                lambda st: st[0](st[1], stacks[1])[1])
    dwins = _dense_stream_windows([dplans[:16], dplans[:13]], dgeom, 8)
    for name, devices in (("sharded_dense", None),
                          ("sharded_dense_card_twice",
                           [str(dev), str(dev)])):
        def sharded_dense(devices=devices):
            smesh = sh.make_mesh(devices)
            decode = sh.make_sharded_scan_decoder(dgeom, smesh)
            return decode, decode(sh.zero_carry(dgeom, 2, smesh),
                                  dwins[0][0])[0]

        steps_equal(name, sharded_dense, lambda st: torch.cat(
            st[0](st[1], dwins[1][0])[1]))
    mp2 = open(os.path.join(TESTDATA, "test.mp2"), "rb").read()
    for out_device in (True, False):
        def batch_audio(out_device=out_device):
            a = BatchAudioDecoder(mp2, window=32, out_device=out_device,
                                  device="cuda")
            a.decode_window()
            return a

        steps_equal("batch_audio_out_device" if out_device
                    else "batch_audio_host_pcm", batch_audio,
                    lambda a: a.decode_window(), returns=out_device)

    def audio():
        b = Buffer(io.BytesIO(mp2))
        b.set_load_callback(b.load_reader_callback)
        a = Audio(b, device="cuda")
        a.decode()
        return a

    steps_equal("audio_frame", audio,
                lambda a: a.decode().interleaved.copy(), returns=False)
    parser, sub = NativeAudioParser(mp2), []
    while (f := parser.parse_next_frame()) is not None:
        sub.append(f)
    samples = np.stack([np.asarray(sub[4 * k:4 * k + 32], np.int32)
                        .reshape(-1, 2, 32) for k in range(4)])
    for name, devices in (("sharded_synthesis", None),
                          ("sharded_synthesis_card_twice",
                           [str(dev), str(dev)])):
        def sharded_synth(devices=devices):
            smesh = sh.make_mesh(devices)
            return sh.make_sharded_audio_synth(smesh), \
                sh.zero_audio_hist(4, smesh)

        def synth_step(st):
            x = samples.copy()
            u = torch.cat(st[0](x, st[1])[0])
            x[:] = 0              # the caller reuses its samples at once
            return u

        steps_equal(name, sharded_synth, synth_step)
    out["waited_for_the_card"] = waited
    emit(out)
    if any(waited.values()):
        fail(f"a path waited for the card with its streams held: {waited}")
    return out


def phase_streams() -> dict:
    """The inputs the 1080p fixture does not cover, through K5 and K1: the
    custom-matrix ES on its golden through `Video` (both parsers),
    `BatchVideoDecoder` (prefetch off and on; also in `golden`) and
    `MultiStreamVideoDecoder` beside the default-matrix ES; the 8-frame
    3840x2160 ES (32,400 macroblocks a picture) through
    `BatchVideoDecoder(window=4)` and `MultiStreamVideoDecoder` (it and a
    half of it, window 2), against the C++ host decoder, timed."""
    import io

    import torch

    from mpeg_tpu_torch import Buffer, Video
    from mpeg_tpu_torch.ops import cuda_kernels
    from mpeg_tpu_torch.parallel import (BatchVideoDecoder,
                                         MultiStreamVideoDecoder)
    from mpeg_tpu_torch.utils import Fnv1a64

    custom = open(os.path.join(TESTDATA, "test_custom_matrix.m1v"),
                  "rb").read()
    es = open(os.path.join(TESTDATA, "test.mpeg1video"), "rb").read()
    out = {"phase": "streams"}
    for parser in ("native", "python"):
        buf = Buffer(io.BytesIO(custom))
        buf.set_load_callback(buf.load_reader_callback)
        video = Video(buf, parser=parser, device="cuda")
        h, n = Fnv1a64(), 0
        while (f := video.decode()) is not None:
            h.write(f.y.tobytes())
            h.write(f.cb.tobytes())
            h.write(f.cr.tobytes())
            n += 1
        out[f"custom_matrix_video_{parser}"] = f"{h.sum64():#018x}"
        if (n, h.sum64()) != GOLDEN_CUSTOM:
            fail(f"custom matrices, Video({parser}): {n} frames, hash "
                 f"{h.sum64():#018x}")
    ms = MultiStreamVideoDecoder([custom, es], window=8, prefetch=True,
                                 device="cuda")
    got = ms.decode_all()
    hashes = [(len(g), _digest(g, ms.geom)) for g in got]
    out["custom_matrix_multistream"] = [f"{h:#018x}" for _, h in hashes]
    if hashes != [GOLDEN_CUSTOM, GOLDEN_VIDEO]:
        fail(f"custom matrices, multistream: {hashes}")

    data = open(os.path.join(TESTDATA, "test4k.m1v"), "rb").read()
    want = _native_frames(data)
    dec = BatchVideoDecoder(data, window=4, device="cuda")
    cuda_kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = dec.decode_all()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fs = dec.geom.frame_size
    if len(want) != 8 or dec.geom.mb_size != 32_400:
        fail(f"4K: {len(want)} host frames, {dec.geom.mb_size} macroblocks")
    _check_against_host(frames, want, fs, "4K")
    k1, k5 = (cuda_kernels.reconstruct_picture.launches,
              cuda_kernels.densify_unpack.launches)
    ms = MultiStreamVideoDecoder([data, data[:len(data) // 2]], window=2,
                                 device="cuda")
    got = ms.decode_all()
    _check_against_host(got[0], want, fs, "4K, multistream")
    out["4k"] = {"frames": len(frames), "mb": dec.geom.mb_size,
                 "equal_to_native_host_decoder": True, "k1_launches": k1,
                 "k5_launches": k5, "first_pass_s": seconds,
                 "multistream_frames": [len(g) for g in got]}
    emit(out)
    return out


def phase_multihost() -> dict:
    """`parallel.multihost.launch` on the card: one process with NCCL and
    two with gloo (NCCL refuses two ranks on one card), the two launches
    at once, each process decoding test.mpeg1video on its local stream,
    every report on the golden."""
    from concurrent.futures import ThreadPoolExecutor

    from mpeg_tpu_torch.parallel.multihost import launch

    def run(backend, n):
        t0 = time.perf_counter()
        reports = launch(num_processes=n, local_devices=1, device="cuda",
                         backend=backend, timeout=300)
        return reports, time.perf_counter() - t0

    runs = {"nccl": 1, "gloo": 2}
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {b: pool.submit(run, b, n) for b, n in runs.items()}
        results = {b: f.result() for b, f in futures.items()}
    out = {"phase": "multihost"}
    for backend, (reports, secs) in results.items():
        if len(reports) != runs[backend] or not all(
                "golden 0xea6d7fcb1340ba3f on all" in r for r in reports):
            fail(f"multihost {backend}: {reports}")
        out[backend] = {"processes": runs[backend], "reports": reports,
                        "seconds": secs}
    emit(out)
    return out


EXAMPLES = ("play.py", "pipe_streaming.py", "batch_decode.py",
            "av_serving.py", "multistream_serving.py", "multistream_mesh.py",
            "clip_serving.py")


def phase_examples() -> dict:
    """The seven `examples_torch/` scripts on the card (their default
    device), all started at once, each in its own process: each must
    exit 0 and print."""
    import subprocess

    play_dir = os.path.join(REPO, "build", "chip_smoke_play")
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in EXAMPLES:
            args = [os.path.join(TESTDATA, "test.mpg"), play_dir] \
                if name == "play.py" else []
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.join(REPO, "examples_torch", name),
                 *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=REPO)
        results = {name: p.communicate(timeout=300)
                   for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    out = {"phase": "examples", "seconds": secs, "last_lines": {}}
    for name, (stdout, stderr) in results.items():
        if procs[name].returncode != 0 or not stdout.strip():
            fail(f"examples_torch/{name}: rc {procs[name].returncode}, "
                 f"stdout {stdout[-300:]!r}, stderr {stderr[-800:]}")
        out["last_lines"][name] = stdout.strip().splitlines()[-1]
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the adversarial kernel inputs")
    ap.add_argument("--baseline", metavar="RECON_CU", action="append",
                    default=[],
                    help="also time K1 and K3 built from this copy of "
                         "recon.cu in turns with this K1 and K3 (may be "
                         "repeated)")
    ap.add_argument("--synth-baseline", metavar="SYNTH_CU", action="append",
                    default=[],
                    help="also build K4 from this copy of synth.cu, hold "
                         "it equal to this K4 and time the two in turns "
                         "(may be repeated)")
    ap.add_argument("--densify-baseline", metavar="DENSIFY_CU",
                    action="append", default=[],
                    help="also build K5 from this copy of densify.cu, hold "
                         "it equal to this K5 and time the two in turns "
                         "(may be repeated)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available (this runs on an NVIDIA GPU)")
    if not os.path.isdir(os.path.join(REPO, "mpeg_tpu_torch")):
        fail(f"no mpeg_tpu_torch package beside {__file__}: run from a "
             "checkout of the repository")
    sys.path.insert(0, REPO)

    from mpeg_tpu_torch.device import gpu_name_and_power_limit

    t_start = time.perf_counter()
    phase_probe()
    phase_build()
    parity = phase_kernel_parity(args.seed)
    k4 = phase_k4(args.seed, parity["launch_floor_ms"], args.synth_baseline)
    fixture = phase_k1_fixture(args.baseline)
    k5 = phase_k5(args.densify_baseline)
    with no_plain_densify():
        phase_golden()
        e2e = phase_e2e_1080p()
        multi = phase_recon_multi_1080p()
        phase_multistream_golden()
        streams = phase_multistream_1080p()
        phase_rgba()
        audio = phase_audio()
        phase_interactive_golden()
        interactive = phase_interactive_1080p()
        dense = phase_dense()
        sharded = phase_sharded_1080p()
        phase_transport()
        phase_streams()
    phase_multihost()
    phase_examples()
    # The profiled decodes' idle share, or that the profiler recorded
    # nothing (the benchmark's cells trace the paths they run).
    emit({"idle_share": {
        name: (out["profiled_pass"]["device_idle_share_unprofiled_wall"]
               if out["profiled_pass"]["device_recorded"] else
               "not measured: torch.profiler recorded no device activity")
        for name, out in (("recon_multi_1080p", multi),
                          ("sharded_1080p", sharded["meshes"]["card"]))}})
    # The transport of the six paths: its own count of the checked pass,
    # and where profiled, the h2d copies' card time, rate and overlap.
    prof_keys = ("h2d_device_us", "h2d_records", "h2d_pinned_us",
                 "h2d_gb_per_s", "h2d_under_kernels_share",
                 "h2d_pinned_records", "h2d_pageable_records",
                 "device_idle_share_unprofiled_wall",
                 "device_idle_share_union_unprofiled_wall", "transport")
    emit({"transport_summary": {
        name: {"checked_pass": out["transport"],
               "peak_device_gib": out.get("peak_device_gib"),
               "profiled_pass": {k: out["profiled_pass"].get(k)
                                 for k in prof_keys}
               if "profiled_pass" in out else "not profiled"}
        for name, out in (("e2e_1080p", e2e),
                          ("multistream_1080p", streams),
                          ("sharded_1080p", sharded["meshes"]["card"]),
                          ("sharded_1080p_card_twice",
                           sharded["meshes"]["card_twice"]),
                          ("interactive_1080p", interactive),
                          ("dense_1080p_cut", dense))}})
    k3_decode = multi["profiled_pass"]

    recon, pk = "mpeg_tpu_torch/csrc/recon.cu", "mpeg_tpu/ops/pallas_kernels.py"

    def row(name, launches, err, ms, plain_ms, bound_ms, source=recon,
            replaces=None, bound_by="bytes", **more):
        # library_ms: no PyTorch call computes these functions (the exact
        # IDCT rounds between its passes; no single op does MC + compose;
        # K4's products in a matmul or conv would be reordered and
        # contracted, and the golden is bit-exact).
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
                "bound_by": bound_by, "library_ms": None, **more,
                "timed_by": TIMED_BY}

    frame, window = k4["frame"], k4["window"]
    emit({"kernels": [
        # K1: launches on the 64-stream path (the stream-batched K1); its
        # time per 1080p picture of one 64-stream launch of adversarial
        # plans (the main path's launch), the fixture's pictures in decode
        # order (the main path's inputs) beside it.
        row("reconstruct_picture",
            streams["launches"]["reconstruct_picture"],
            parity["k1_max_abs_err"], parity["k1_streams_ms"],
            parity["k1_streams_plain_ms"], parity["k1_streams_bound_ms"],
            replaces=f"{pk}:520", fixture_ms=fixture["k1_ms"],
            fixture_plain_ms=fixture["k1_plain_ms"],
            fixture_bound_ms=fixture["bound_ms"],
            interactive_launches=interactive["k1_launches"],
            sharded_launches=sharded["meshes"]["card"]["k1_launches"]),
        row("idct_batch", multi["launches"]["idct_batch"],
            parity["k2_max_abs_err"], parity["k2_ms"],
            parity["k2_plain_ms"], parity["k2_bound_ms"],
            replaces=f"{pk}:93"),
        # K3: launches (two plane launches a picture) on the K3 decode;
        # `ms` the whole path (K2 and the plane launches) on one
        # adversarial picture, `bound_ms` the function's (K1's) bound,
        # `path_bound_ms` with K2's bytes; `planes_*` the two plane
        # launches alone on a given residual; `fixture_*` the fixture's
        # pictures in decode order; `decode_planes_us` the plane
        # launches' device us a picture in the profiled K3 decode.
        row("reconstruct_picture_multi",
            multi["launches"]["reconstruct_picture_multi"],
            parity["k3_max_abs_err"], parity["k3_ms"],
            parity["k3_plain_ms"], parity["k3_bound_ms"],
            replaces=f"{pk}:246", path_bound_ms=parity["k3_path_bound_ms"],
            planes_ms=parity["k3_planes_ms"],
            planes_plain_ms=parity["k3_planes_plain_ms"],
            planes_bound_ms=parity["k3_planes_bound_ms"],
            fixture_ms=fixture["k3_ms"],
            fixture_planes_ms=fixture["k3_planes_ms"],
            fixture_planes_plain_ms=fixture["k3_planes_plain_ms"],
            fixture_bound_ms=fixture["k3_planes_bound_ms"],
            fixture_path_bound_ms=fixture["k3_path_bound_ms"],
            decode_planes_us=k3_decode.get("k3_planes_us_per_picture",
                                           "not measured")),
        # K4, the counterpart of jitted JAX programs, not of a
        # pallas_call: launches on Audio's path (once a frame); `ms` a
        # frame's launch (the ring form, f32 out), `window_*` a 32-frame
        # window's (f32, BatchAudioDecoder's); `plain_graph_ms` the plain
        # version's card time by graph replay; `launch_floor_ms` the
        # floor of `queued_ms` (K2 on one CTA), which the bound is below,
        # and `above_floor_us` each timed shape's microseconds above it;
        # `baseline_turns` the ms of each `--synth-baseline` and this K4
        # in turns.
        row("synthesize", audio["k4_launches"], k4["max_abs_err"],
            frame["ms"], frame["plain_ms"], frame["bound_ms"],
            source="mpeg_tpu_torch/csrc/synth.cu",
            replaces="mpeg_tpu/ops/filterbank.py:475",
            bound_by=frame["bound_by"],
            also_replaces=["mpeg_tpu/ops/filterbank.py:575",
                           "mpeg_tpu/ops/filterbank.py:442",
                           "mpeg_tpu/ops/filterbank.py:423"],
            plain_graph_ms=frame["plain_graph_ms"],
            window_ms=window["ms"], window_plain_ms=window["plain_ms"],
            window_plain_graph_ms=window["plain_graph_ms"],
            window_bound_ms=window["bound_ms"],
            window_s16_ms=k4["window_s16"]["ms"],
            sharded_8_ms=k4["sharded_8"]["ms"],
            sharded_8_plain_graph_ms=k4["sharded_8"]["plain_graph_ms"],
            launch_floor_ms=k4["launch_floor_ms"],
            above_floor_us={name: k4[name]["above_floor_us"] for name in
                            ("frame", "window", "window_s16", "sharded_8")},
            baseline_turns={src: {name: {who: t[name][who]["ms"]
                                         for who in ("baseline", "this")}
                                  for name in ("frame", "window",
                                               "window_s16", "sharded_8")}
                            for src, t in k4.get("turns", {}).items()},
            batch_launches=audio["batch_k4_launches"],
            interactive_launches=interactive["k4_launches"],
            sharded_launches=sharded["audio"]["k4_launches"]["card"],
            library_note="none: no single PyTorch call computes the "
            "synthesis bit-exactly (a matmul reorders and contracts)"),
        # K5, the counterpart of the jitted densify and metadata unpack,
        # not of a pallas_call: launches on the 64-stream path
        # (`launches_a_call` a round, as the library reported them in the
        # `k5` phase); `ms` a round of it (the first, I and P pictures),
        # each shape of the `k5` phase in `shapes`, `baseline_turns` the
        # ms of each `--densify-baseline` and this K5 in turns a shape.
        row("densify_unpack", streams["launches"]["densify_unpack"],
            k5["max_abs_err"], k5["shapes"]["streams_64_round_0"]["ms"],
            k5["shapes"]["streams_64_round_0"]["plain_ms"],
            k5["shapes"]["streams_64_round_0"]["bound_ms"],
            source="mpeg_tpu_torch/csrc/densify.cu",
            replaces="mpeg_tpu/parallel/batch.py:392",
            also_replaces=["mpeg_tpu/parallel/batch.py:460"],
            launches_a_call=k5["launches_a_call"],
            baseline_turns={src: {name: {who: t[name][who]["ms"]
                                         for who in ("baseline", "this")}
                                  for name in k5["shapes"]}
                            for src, t in k5.get("turns", {}).items()},
            single_launches=e2e["launches"]["densify_unpack"],
            interactive_launches=interactive["k5_launches"],
            sharded_launches=sharded["meshes"]["card"]["k5_launches"],
            shapes=k5["shapes"],
            library_note="none: index_add_ is only the scatter, the last "
            "step; no PyTorch call does the prefix sum, the premultiply, "
            "the scatter and the unpack"),
    ]})
    emit({"chip_smoke_wall_s": time.perf_counter() - t_start})
    smi = gpu_name_and_power_limit()
    if not smi:
        fail("nvidia-smi gave no name and power limit")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
