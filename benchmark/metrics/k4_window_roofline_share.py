"""MP2 synthesis, K4 in its window form (`csrc/synth.cu` `synth_kernel`
through `cuda_kernels.synthesize`): the least time of the window's MP2
frames (`rooflines/k4_window.py`) over K4's card time in the device
trace, in %.  The frames are the harness's own count (its K4 bound over
`rooflines/k4.py`'s seconds a frame), not the program's counters."""


def read(r):
    from benchmark.rooflines import k4, k4_window
    frames = r.bound_s.get("k4", 0.0) / k4.frame_seconds()
    t = r.kernel_seconds(k4_window.KERNELS)
    if t <= 0 or frames <= 0:
        return None
    return 100.0 * k4_window.seconds(frames) / t
