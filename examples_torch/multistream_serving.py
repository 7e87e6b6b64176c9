#!/usr/bin/env python3
"""Many-streams-per-device serving: N independent sources decode in
lockstep through ONE global record chain (MultiStreamVideoDecoder — the
64-stream north-star transport).

Usage:
  python examples_torch/multistream_serving.py [file1 file2 ...]
      [--device cuda]

With no files, serves a mixed batch built from the test fixtures: a raw
elementary stream, an MPEG-PS program stream, and a truncated stream
(different lengths — per-stream end-of-stream flushes land on different
rounds, like real tenants churning).  `--device cpu` runs the kernels'
plain versions.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mpeg_tpu_torch.parallel import MultiStreamVideoDecoder


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    td = os.path.join(os.path.dirname(__file__), "..", "tests", "testdata")
    if args.paths:
        sources = [open(p, "rb").read() for p in args.paths]
        names = args.paths
    else:
        es = open(os.path.join(td, "test.mpeg1video"), "rb").read()
        ps = open(os.path.join(td, "test.mpg"), "rb").read()
        sources = [es, ps, es[:len(es) // 3]]
        names = ["test.mpeg1video", "test.mpg", "test.mpeg1video[:1/3]"]

    ms = MultiStreamVideoDecoder(sources, window=4, device=args.device)
    print(f"{len(sources)} streams x {ms.geom.width}x{ms.geom.height}, "
          f"window {ms.window}, {ms.chunks} device chunk(s)")

    rounds = 0
    counts = [0] * len(sources)
    while (got := ms.decode_window()) is not None:
        rounds += 1
        for s, frames in enumerate(got):
            counts[s] += len(frames)

    for s, name in enumerate(names):
        print(f"  stream {s} ({name}): {counts[s]} frames")
    print(f"{sum(counts)} frames in {rounds} lockstep rounds; the round "
          f"transfer is the metadata block + one bucket of the SUMMED "
          f"record fills (no per-stream pool pad slack)")
    # Sanity: a frame is real pixel data, not zeros.
    assert counts[0] > 0
    pool, slots = ms._carry
    assert pool[slots[0, 2]].any()      # stream 0's backward frame


if __name__ == "__main__":
    main()
