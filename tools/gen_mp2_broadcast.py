"""The broadcast MP2 profile: MPEG-1 Layer II as DVB services carry it
(ETSI TS 101 154), 48 kHz joint stereo at 256 kbit/s, 768-byte frames
with no padding and no CRC.

The frames come from `gen_mp2.gen_frame` (seeded, spec-valid fields).
Each frame's mode_extension (the joint-stereo bound) is drawn from the
seed over all four values, as a joint-stereo encoder switches it, and
its fields at allocation density 0.6.  A frame whose payload would
overflow its 768 bytes is drawn again from the same generator, with the
same mode_extension: `gen_frame` draws every field before it checks the
size, so a redraw continues the generator's sequence.

This writes the committed `tests/testdata/mp2_48k_joint_256.mp2`, from
the root of the repository:

    PYTHONPATH=. python tools/gen_mp2_broadcast.py tests/testdata/mp2_48k_joint_256.mp2
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gen_mp2 import MODE_JOINT, gen_frame  # noqa: E402

BITRATE_INDEX = 11       # 256 kbit/s
SAMPLERATE_INDEX = 1     # 48 kHz
FRAME_BYTES = 768        # 144 * 256000 / 48000
DENSITY = 0.6
SEED = 20


def gen_broadcast_stream(frames: int = 500, seed: int = SEED) -> bytes:
    """`frames` joint-stereo frames of the broadcast profile."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(frames):
        mode_ext = int(rng.integers(0, 4))
        while True:
            try:
                out.append(gen_frame(rng, MODE_JOINT, BITRATE_INDEX,
                                     SAMPLERATE_INDEX, mode_ext=mode_ext,
                                     sparsity=DENSITY))
                break
            except AssertionError:   # the payload overflows the frame
                pass
    return b"".join(out)


if __name__ == "__main__":
    with open(sys.argv[1], "wb") as f:
        f.write(gen_broadcast_stream())
