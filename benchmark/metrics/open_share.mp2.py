"""Item opening in the MP2 batch decode (`mpeg.open`: `BatchAudioDecoder`'s
constructor), read as `open_share.py` reads it, for the cell that
reports `delivery_p95_ms` and not `frames_per_s` (a per-layer metric
names one end-to-end metric, which each of its cells reports)."""

import os

from benchmark.harness import load_file_module

HERE = os.path.dirname(os.path.abspath(__file__))
read = load_file_module(
    os.path.join(HERE, "open_share.py"),
    "benchmark_metric_open_share_for_mp2").read
