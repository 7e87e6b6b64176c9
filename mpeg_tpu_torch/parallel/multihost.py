"""Multi-process data-parallel decode: one process a host, joined by
`torch.distributed`.

Port of `mpeg_tpu/parallel/multihost.py`.  N processes join one process
group; each runs its OWN parse and feeds only its local devices' stream
shards (`parallel.sharding`, a mesh of its local devices), so the
host-to-device feed stays host-local.  Streams are embarrassingly
parallel, so the only cross-process traffic is the int64 `all_reduce` of
the decoded pixel count.

The rehearsal needs no cluster: `launch()` starts N local processes
(`python -m mpeg_tpu_torch.parallel.multihost`) that meet at a free
localhost port.  The backend is NCCL when every rank has cards of its
own, and gloo otherwise: on the CPU, and for several ranks on one card,
which NCCL refuses.

Each worker decodes the reference fixture on every local stream and
checks the full golden hash (0xea6d7fcb1340ba3f) with the end-of-stream
flush frame, and that the reduced pixel count is the global one.
"""

from __future__ import annotations

import argparse
import os
import sys

GOLDEN_VIDEO_HASH = 0xEA6D7FCB1340BA3F
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _local_devices(process_id: int, local_devices: int, dev) -> list:
    """This rank's devices: its own cards in turn (wrapping round when
    the machine has fewer), or the CPU repeated."""
    import torch

    if dev.type == "cpu":
        return ["cpu"] * local_devices
    n = torch.cuda.device_count()
    return [f"cuda:{(process_id * local_devices + i) % n}"
            for i in range(local_devices)]


def default_backend(num_processes: int, local_devices: int, device) -> str:
    """"nccl" when every rank's devices are cards of its own, else
    "gloo"."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and \
            num_processes * local_devices <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def run_worker(process_id: int, num_processes: int, port: int,
               local_devices: int, fixture: str, window: int = 16, *,
               device="cuda", backend: str = None) -> str:
    """One host's role in the multi-process decode; returns a report
    line.  `device` is "cuda" (the default; it raises without a card) or
    "cpu"; `backend` the process group's ("nccl" or "gloo"; default
    `default_backend`).  Raises on any mismatch."""
    import torch
    import torch.distributed as dist

    from ..buffer import Buffer
    from ..device import resolve_device
    from ..tables import PICTURE_TYPE_B
    from ..utils import Fnv1a64
    from ..video import Video
    from . import sharding as sh
    from .batch import count_pool_records, pool_bucket

    dev = resolve_device(device)
    if backend is None:
        backend = default_backend(num_processes, local_devices, dev)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (expected \"nccl\" "
                         "or \"gloo\")")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' reduces on the card: it needs "
                         "device='cuda'")
    devices = _local_devices(process_id, local_devices, dev)
    if backend == "nccl":
        torch.cuda.set_device(torch.device(devices[0]))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=num_processes, rank=process_id)
    try:
        n_local = local_devices          # one stream a local device
        n_global = num_processes * local_devices

        # Host-local feed: THIS process parses only its own streams.
        videos = []
        for _ in range(n_local):
            buf = Buffer(open(fixture, "rb"))
            buf.set_load_callback(buf.load_reader_callback)
            videos.append(Video(buf, backend="plan"))
        if not all(v.has_header() for v in videos):
            raise RuntimeError(f"{fixture}: no sequence header")
        geom = videos[0].geom

        all_windows = []
        while True:
            per_stream = []
            for v in videos:
                plans = []
                while len(plans) < window:
                    item = v.parse_next_plan()
                    if item is None:
                        break
                    plans.append(item)
                per_stream.append(plans)
            if not any(per_stream):
                break
            all_windows.append(per_stream)
        nm = max(count_pool_records(p)[0] for w in all_windows for p in w
                 if p)
        ne = max(count_pool_records(p)[1] for w in all_windows for p in w
                 if p)
        km, ke = pool_bucket(nm, 4096), pool_bucket(max(ne, 1), 64)

        mesh = sh.make_mesh(devices)     # this process's shards + group
        decode = sh.make_sharded_blob_decoder(geom, mesh, window, km, ke)
        carry = sh.zero_carry(geom, n_local, mesh)

        hashes = [Fnv1a64() for _ in range(n_local)]
        counts = [0] * n_local
        has_ref = [False] * n_local
        last_type = [0] * n_local
        for per_stream in all_windows:
            blobs = sh.stack_stream_blobs(per_stream, geom, window, km, ke)
            carry, disps, total_px = decode(carry, blobs)
            # The all_reduce crosses the processes: every process sees the
            # GLOBAL pixel count.
            want_px = sum(len(p) for p in per_stream) * geom.frame_size
            if int(total_px) != want_px * num_processes:
                raise RuntimeError(f"reduced pixel count {int(total_px)}, "
                                   f"want {want_px * num_processes}")
            disps = torch.cat([d.cpu() for d in disps]).numpy()
            for s, plans in enumerate(per_stream):
                for i, (_, t) in enumerate(plans):
                    last_type[s] = t
                    if t == PICTURE_TYPE_B or has_ref[s]:
                        hashes[s].write(disps[s, i, :geom.frame_size]
                                        .tobytes())
                        counts[s] += 1
                    else:
                        has_ref[s] = True

        bwd = torch.cat([b.cpu() for b in carry[2]]).numpy()
        for s in range(n_local):
            if has_ref[s] and last_type[s] != PICTURE_TYPE_B:
                hashes[s].write(bwd[s, :geom.frame_size].tobytes())
                counts[s] += 1

        for s in range(n_local):
            if counts[s] != 260 or hashes[s].sum64() != GOLDEN_VIDEO_HASH:
                raise RuntimeError(f"stream {s}: {counts[s]} frames, hash "
                                   f"{hashes[s].sum64():#018x}")
    finally:
        dist.destroy_process_group()
    return (f"OK process {process_id}/{num_processes}: {n_local} local "
            f"streams of {n_global} global, golden "
            f"{GOLDEN_VIDEO_HASH:#018x} on all, window {window}")


def launch(num_processes: int = 2, local_devices: int = 4,
           fixture: str = None, window: int = 16, timeout: float = 600.0,
           *, device="cuda", backend: str = None) -> list[str]:
    """Start `num_processes` local worker processes against a fresh
    localhost port; returns their report lines (raises on any failure).
    Every process it starts has ended when it returns or raises."""
    import socket
    import subprocess
    import tempfile
    import time

    from ..device import resolve_device

    dev = resolve_device(device)   # "cuda" raises here without a card
    if fixture is None:
        fixture = os.path.join(_REPO, "tests", "testdata",
                               "test.mpeg1video")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    cmd = [sys.executable, "-m", "mpeg_tpu_torch.parallel.multihost",
           "--num-processes", str(num_processes), "--port", str(port),
           "--local-devices", str(local_devices), "--fixture", fixture,
           "--window", str(window), "--device", dev.type]
    if backend is not None:
        cmd += ["--backend", backend]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    procs, logs = [], []
    try:
        for pid in range(num_processes):
            logs.append((tempfile.TemporaryFile("w+"),
                         tempfile.TemporaryFile("w+")))
            procs.append(subprocess.Popen(
                cmd + ["--process-id", str(pid)], stdout=logs[-1][0],
                stderr=logs[-1][1], text=True, env=env, cwd=_REPO))
        # A rank that fails leaves the others waiting for it: stop them.
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs):
                break
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(cmd, timeout)
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports, errs = [], []
    for pid, (p, (out, err)) in enumerate(zip(procs, logs)):
        out.seek(0)
        err.seek(0)
        if p.returncode != 0:
            errs.append(f"process {pid} rc={p.returncode}:\n"
                        f"{err.read()[-2000:]}")
        else:
            reports.append(out.read().strip().splitlines()[-1])
        out.close()
        err.close()
    if errs:
        raise RuntimeError("multi-process decode failed:\n" + "\n".join(errs))
    return reports


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--fixture", required=True)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args()
    print(run_worker(a.process_id, a.num_processes, a.port,
                     a.local_devices, a.fixture, a.window, device=a.device,
                     backend=a.backend), flush=True)


if __name__ == "__main__":
    main()
