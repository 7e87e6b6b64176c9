"""K4, the MP2 synthesis (`cuda_kernels.synthesize_ring`, one launch an
audio frame in `Audio`): the least work of one frame of one stream, a
frozen copy of `synth_bound(1, 36, "f32", ring=True)`: 256 B of samples
in and 256 B of output out a step, the 15 previous DCT blocks (7,680 B)
in and the new 8 KiB ring out; a DCT (304 float ops) and 32 16-tap MACs
a step and channel and one divide an output sample."""

from .peaks import F32_FLOPS_PER_S, HBM_BYTES_PER_S

KERNELS = ("synth_kernel",)
STEPS = 36


def frame_seconds() -> float:
    nbytes = STEPS * (256 + 256) + 15 * 2 * 64 * 4 + 2 * 1024 * 4
    flops = STEPS * (2 * (304 + 32 * 32) + 64)
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
