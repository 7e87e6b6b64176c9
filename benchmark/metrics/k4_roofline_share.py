"""MP2 synthesis, K4 (`csrc/synth.cu` `synth_kernel`): the least time of
the window's audio frames (`rooflines/k4.py`) over K4's card time in the
device trace, in %."""


def read(r):
    return r.roofline_share("k4")
