#!/usr/bin/env python3
"""Production-shaped A/V serving: decode a .mpg program stream with
EVERYTHING device-resident — video frames as RGBA and audio PCM as
device-quantized S16 — so downstream device consumers (overlays,
encoders, mixers) read straight from device memory and the serve loop
never blocks on device-to-host transfers.

Usage: python examples_torch/av_serving.py [file.mpg] [--device cuda]

The two decoders share the fully-native C++ PS pipeline (demux + both
ES parsers, zero per-packet Python); the video decoder overlaps its
parse thread with the device work (prefetch=True).  `--device cpu` runs
the kernels' plain versions.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from mpeg_tpu_torch.parallel import BatchAudioDecoder, BatchVideoDecoder


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default=os.path.join(
        os.path.dirname(__file__), "..", "tests", "testdata", "test.mpg"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    data = open(args.path, "rb").read()

    video = BatchVideoDecoder(data, window=16, emit_rgba=True,
                              prefetch=True, device=args.device)
    audio = BatchAudioDecoder(data, window=64, out_format="s16",
                              out_device=True, device=args.device)

    t0 = time.time()
    frames = 0
    last_frame = None
    while got := video.decode_window():
        frames += len(got)
        last_frame = got[-1]          # [H, W, 4] uint8, device-resident
    samples = 0
    last_pcm = None
    while (pcm := audio.decode_window()) is not None:
        samples += pcm.numel() // 2   # int16 interleaved, device-resident
        last_pcm = pcm
    if video.device.type == "cuda":
        torch.cuda.synchronize(video.device)
    dt = time.time() - t0

    print(f"{frames} RGBA frames + {samples} stereo samples decoded "
          f"in {dt:.2f}s — all output device-resident "
          f"(platform: {video.device.type})")
    # Only the demo pulls anything to host: one thumbnail + peak level.
    # (Either substream may be absent in a user-supplied file.)
    if last_frame is not None:
        thumb = last_frame.cpu().numpy()[::16, ::16, :3]
        print(f"last frame thumbnail {thumb.shape}, mean RGB "
              f"{thumb.reshape(-1, 3).mean(axis=0).round(1)}")
    if last_pcm is not None:
        peak = float(last_pcm.abs().max()) / 0x7FFF
        print(f"audio peak {peak:.3f}")


if __name__ == "__main__":
    main()
