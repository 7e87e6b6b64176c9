"""The device in the MP2 batch decode, its idle time that the program's
spans do not explain, read as `idle_outside_spans_share.batch.py` reads
it, for the cell that reports `delivery_p95_ms` and not `frames_per_s`
(a per-layer metric names one end-to-end metric, which each of its cells
reports)."""

import os

from benchmark.harness import load_file_module

HERE = os.path.dirname(os.path.abspath(__file__))
read = load_file_module(
    os.path.join(HERE, "idle_outside_spans_share.batch.py"),
    "benchmark_metric_idle_outside_spans_share_batch_for_mp2").read
