"""Host parse in the MP2 batch decode, as the decode waited for it
(`mpeg.parse.wait`), read as `parse_block_share.py` reads it, for the
cell that reports `delivery_p95_ms` and not `frames_per_s` (a per-layer
metric names one end-to-end metric, which each of its cells reports)."""

import os

from benchmark.harness import load_file_module

HERE = os.path.dirname(os.path.abspath(__file__))
read = load_file_module(
    os.path.join(HERE, "parse_block_share.py"),
    "benchmark_metric_parse_block_share_for_mp2").read
