"""Densify + unpack, K5 (`csrc/densify.cu`): the least time of the
window's pictures' K5 work (`rooflines/k5.py`, bytes at 3.35 TB/s) over
K5's card time in the device trace, the merged intervals of its three
kernels, in %.  The second and third kernel start early (programmatic
dependent launch) and wait on the card, so the merged span of a call
is its card time and the waits inside it count."""


def read(r):
    return r.roofline_share("k5")
