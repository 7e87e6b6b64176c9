#!/usr/bin/env python3
"""Serving-style parallel clip extraction: decode K clips of one .mpg
from different timestamps simultaneously, one clip a mesh device.

Usage:
  python examples_torch/clip_serving.py [file.mpg t1 t2 ...]
      [--device DEV [DEV ...]]

The default mesh is every CUDA device; `--device cpu cpu cpu cpu`
rehearses four on the CPU.  Composes the serving pieces: deterministic
intra-targeted clip extraction (BatchVideoDecoder.at_time builds the clip
bytes), the fully-native PS pipeline a clip, and stream data parallelism
over the mesh (window-pool blobs, one shard a device).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from mpeg_tpu_torch.parallel import BatchVideoDecoder
from mpeg_tpu_torch.parallel import sharding as sh
from mpeg_tpu_torch.parallel.batch import blob_layout, blob_views


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "testdata", "test.mpg"))
    ap.add_argument("times", nargs="*", type=float)
    ap.add_argument("--device", nargs="+", default=None,
                    help="the mesh's devices (default: every CUDA device)")
    args = ap.parse_args()
    data = open(args.path, "rb").read()
    devices = sh.make_mesh(args.device).devices

    times = args.times or [0.0, 2.5, 5.0, 7.5]
    n = min(len(times), len(devices))
    times = times[:n]
    decs = []
    for t in times:
        got = BatchVideoDecoder.at_time(data, t, window=8,
                                        device=devices[0])
        assert got is not None, f"no intra frame at/before t={t}"
        dec, pts = got
        decs.append(dec)
        print(f"clip @ {t:5.1f}s -> intra packet pts {pts:.3f}")

    geom = decs[0].geom
    window = 8

    # One window a clip, all extracted through the native pipeline,
    # stacked and decoded in ONE sharded call.
    blobs = []
    km = ke = 0
    for dec in decs:
        blob, _types, _fill = dec._native_window_blob()
        km, ke = max(km, dec._km), max(ke, dec._ke)
        blobs.append((blob, dec._km, dec._ke))

    # Re-layout every clip's blob to the common capacity buckets.
    _, total = blob_layout(geom, window, km, ke)
    stacked = np.zeros((n, total), np.uint8)
    for s, (blob, bkm, bke) in enumerate(blobs):
        src = blob_views(blob, geom, window, bkm, bke)
        dst = blob_views(stacked[s], geom, window, km, ke)
        for k in src:
            dst[k][:src[k].size] = src[k]

    mesh = sh.make_mesh(devices[:n])
    decode = sh.make_sharded_blob_decoder(geom, mesh, window, km, ke)
    carry = sh.zero_carry(geom, n, mesh)
    carry, disps, px = decode(carry, stacked)
    disps = torch.cat([d.cpu() for d in disps]).numpy()
    print(f"mesh: decoded {int(px):,} px across {n} devices in one "
          f"call; first window of each clip is on its device")
    for s, t in enumerate(times):
        y = disps[s, -1, :geom.luma_size]
        print(f"  clip @ {t:.1f}s window[-1] luma mean {y.mean():.1f}")


if __name__ == "__main__":
    main()
