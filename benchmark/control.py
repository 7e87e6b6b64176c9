"""The check's control: the plain reference computed at a lower
precision (the IDCT on bfloat16 coefficients, the MP2 synthesis output
rounded to bfloat16), put in the measured program's place, through the
same sampling and comparison as a run.  Each seed must come out not
correct.

    python benchmark/control.py --workload <cell> --frames <n> --seeds <s>...

`--frames` is how many frames a run of the cell displays (its rate times
`run_seconds`).  The control's outputs hang on the fixture alone, so it
needs no card and no window: the deliveries are laid out by the cell's
entry (`entries/<entry>.py`, its `control`) as the entry point makes
them.  Prints one JSON line a seed and exits 0 when every seed failed
the check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import harness, refcache  # noqa: E402


class Outputs:
    """The control's frames and PCM, where the program's would be."""

    def __init__(self, ctl: dict):
        self.ctl = ctl

    def frame(self, clip, k: int):
        import torch
        return torch.from_numpy(refcache.clip_frame(self.ctl, clip.gops, k))

    def pcm(self, j: int):
        return refcache.pcm_frame(self.ctl, j)


def control_checks(cell: str, seed: int, frames: int, cache_dir: str,
                   folder: str = harness.HERE) -> dict:
    """The numbers a run of `cell` would compare, with the control in
    the program's place, over about `frames` displayed frames."""
    wl, config, traffic, args = harness.cell_inputs(cell, seed, folder)
    entry = harness.load_entry(folder, wl["entry"])
    out = Outputs(refcache.expected(config, harness.ROOT, cache_dir,
                                    control=True))
    exp = refcache.expected(config, harness.ROOT, cache_dir)
    rec = harness.Recorder(seed, wl["samples"], False)
    done, i = 0, 0
    while done < frames:
        done += entry.control(rec, ("clip", i),
                              traffic.items[i % len(traffic.items)], args,
                              out)
        i += 1
    checks = harness.check(rec, exp)
    checks.pop("_bad_clips")
    return checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    caught = True
    for seed in a.seeds:
        checks = control_checks(a.workload, seed, a.frames,
                                harness.CACHE_DIR)
        ok = harness.passed(checks)
        caught &= not ok
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control_correct": ok,
                          "checks": {k: c["value"]
                                     for k, c in checks.items()}}),
              flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
