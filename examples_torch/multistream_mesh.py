#!/usr/bin/env python3
"""Multi-stream decode sharded over a list of devices.

Usage:
  python examples_torch/multistream_mesh.py [--device DEV [DEV ...]]

The default mesh is every CUDA device; `--device cpu cpu cpu cpu`
rehearses four devices on the CPU (the kernels' plain versions), and
`--device cuda:0 cuda:0` two shards on one card.  Each device decodes its
own stream's window blobs; the only collective is the int64 sum of the
decoded pixels (streams are embarrassingly parallel).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mpeg_tpu_torch as mpeg
from mpeg_tpu_torch.parallel import sharding as sh
from mpeg_tpu_torch.parallel.batch import count_pool_records, pool_bucket


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", nargs="+", default=None,
                    help="the mesh's devices (default: every CUDA device)")
    args = ap.parse_args()
    mesh = sh.make_mesh(args.device)
    n = len(mesh.devices)
    print(f"mesh: {n} x {mesh.devices[0].type}")

    path = os.path.join(os.path.dirname(__file__), "..",
                        "tests", "testdata", "test.mpeg1video")

    videos = []
    for _ in range(n):
        buf = mpeg.Buffer(open(path, "rb"))
        buf.set_load_callback(buf.load_reader_callback)
        videos.append(mpeg.Video(buf, backend="plan"))
    assert all(v.has_header() for v in videos)
    geom = videos[0].geom

    carry = sh.zero_carry(geom, n, mesh)

    window = 8
    km, ke = 4096, 64   # sticky pool buckets (grow on demand)
    decode = None
    total_frames = 0
    while True:
        per_stream = []
        for v in videos:
            plans = []
            while len(plans) < window and \
                    (item := v.parse_next_plan()) is not None:
                plans.append(item)
            per_stream.append(plans)
        if not any(per_stream):
            break
        nm = max(count_pool_records(p)[0] for p in per_stream)
        ne = max(count_pool_records(p)[1] for p in per_stream)
        if pool_bucket(nm, km) != km or pool_bucket(max(ne, 1), ke) != ke \
                or decode is None:
            km, ke = pool_bucket(nm, km), pool_bucket(max(ne, 1), ke)
            decode = sh.make_sharded_blob_decoder(geom, mesh, window, km, ke)
        blobs = sh.stack_stream_blobs(per_stream, geom, window, km, ke)
        carry, disps, px = decode(carry, blobs)
        total_frames += sum(len(p) for p in per_stream)
        print(f"window: decoded {int(px):>12,} px across the mesh "
              f"({blobs.nbytes / 1e6:.2f} MB h2d)")

    print(f"total: {total_frames} pictures over {n} streams")


if __name__ == "__main__":
    main()
