#!/usr/bin/env python3
"""Throughput decode: a raw mpeg1video ES — or a whole .mpg program
stream — through the windowed decode path.

Usage: python examples_torch/batch_decode.py [file.m1v | file.mpg]
       [--device cuda]

One window of pictures goes to the device at a time (native C++
demux+parse feeding window-pool blobs, one K1 launch a picture); frames
stay on the device — here we pull stats, one thumbnail and (for the PS
demo) RGBA output back.  `--device cpu` runs the kernels' plain versions.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mpeg_tpu_torch.parallel import BatchAudioDecoder, BatchVideoDecoder


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "testdata",
        "test.mpeg1video"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    data = open(args.path, "rb").read()

    dec = BatchVideoDecoder(data, window=32, device=args.device)
    t0 = time.time()
    frames = dec.decode_all()
    dt = time.time() - t0
    geom = dec.geom
    print(f"{geom.width}x{geom.height}: {len(frames)} frames in {dt:.2f}s "
          f"({len(frames)/dt:.1f} fps incl. compile)")

    last = frames[-1].cpu().numpy()
    y = last[:geom.luma_size].reshape(geom.luma_height, geom.luma_width)
    print(f"last frame luma mean {y.mean():.1f}")

    if bytes(data[:4]) == b"\x00\x00\x01\xBA":
        # Program stream: audio rides the same fully-native pipeline,
        # and video can come back as RGBA converted on the device.
        adec = BatchAudioDecoder(data, device=args.device)
        pcm = adec.decode_all()
        rate = adec.samplerate
        if rate:
            print(f"audio: {pcm.size // 2} samples "
                  f"({pcm.size / 2 / rate:.1f}s)")
        else:
            print("audio: no audio stream")
        rgba = BatchVideoDecoder(data, window=32, emit_rgba=True,
                                 device=args.device)
        first = rgba.decode_window()[0].cpu().numpy()
        print(f"RGBA output: {first.shape} "
              f"mean=({first[..., 0].mean():.0f}, "
              f"{first[..., 1].mean():.0f}, {first[..., 2].mean():.0f})")


if __name__ == "__main__":
    main()
