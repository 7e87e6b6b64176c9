#!/usr/bin/env python3
"""Live-stream decode from a NON-seekable source (pipe / socket / HTTP
body): the MPEG class runs the same fully-native C++ pipeline as for
files — zero per-packet Python on the steady path — with seek/duration
degraded exactly as the reference degrades non-seekable sources
(buffer.go:74-76; mpeg.go:137,515).

Usage:
    python examples_torch/pipe_streaming.py [file.mpg] [--device cuda]
    cat file.mpg | python examples_torch/pipe_streaming.py -   # stdin pipe

The simulated mode wraps the file in a read-only, unseekable reader so
the example runs standalone; piping through stdin exercises a true
single-pass OS pipe.  `--device cpu` runs the kernels' plain versions.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mpeg_tpu_torch as mpeg


class UnseekableReader:
    """Read-only view of a file object: what an HTTP body or socket
    stream looks like to the decoder."""

    def __init__(self, f):
        self._f = f

    def read(self, n=-1):
        return self._f.read(n)

    def seekable(self):
        return False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("source", nargs="?", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "testdata", "test.mpg"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.source == "-":
        reader = sys.stdin.buffer
        label = "stdin pipe"
    else:
        reader = UnseekableReader(open(args.source, "rb"))
        label = f"{os.path.basename(args.source)} (simulated pipe)"

    m = mpeg.MPEG(reader, device=args.device)
    engine = "native pipeline" if m._pipeline is not None \
        else "python routing"
    print(f"source: {label} | engine: {engine} | "
          f"{m.width()}x{m.height()} @ {m.framerate():.2f} fps | "
          f"audio {m.samplerate()} Hz")

    # Single-pass ground rules, straight from the reference's contract:
    # no seeking on an unseekable source.
    assert m.seek_frame(5.0, False) is None

    frames = samples = 0
    t0 = time.time()
    while True:
        f = m.decode_video()
        s = m.decode_audio()
        if f is None and s is None:
            break
        frames += f is not None
        samples += 0 if s is None else s.interleaved.size // 2
    dt = time.time() - t0
    print(f"decoded {frames} frames + {samples} audio samples in "
          f"{dt:.2f}s ({frames / dt:.1f} fps) — single pass, "
          f"zero per-packet Python")


if __name__ == "__main__":
    main()
