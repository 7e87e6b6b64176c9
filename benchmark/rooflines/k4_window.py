"""K4 in its window form (`cuda_kernels.synthesize`, one launch a window
of `BatchAudioDecoder`): the least work of a stream's frames synthesized
a window at a time.  A frame: 256 B of samples in and 256 B of float32
PCM out a step, a DCT (304 float ops) and 32 16-tap MACs a step and
channel and one divide an output sample, as `k4.py`.  A window: the 15
previous DCT blocks of both channels (7,680 B) in once and out once, not
a frame's 8 KiB ring.  Bytes bound it."""

from .peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S

KERNELS = ("synth_kernel",)
STEPS = 36
WINDOW = 32
HISTORY = 15 * 2 * 64 * 4


def window_bytes(frames: float, window: int = WINDOW) -> float:
    """Bytes of `frames` frames in windows of `window`."""
    return frames * STEPS * (256 + 256) + frames / window * 2 * HISTORY


def seconds(frames: float, window: int = WINDOW) -> float:
    flops = frames * STEPS * (2 * (304 + 32 * 32) + 64)
    return max(window_bytes(frames, window) / HBM_BYTES_PER_S,
               flops / F32_FLOPS_PER_S)
