"""Reconstruct, K1 (`csrc/recon.cu` `reconstruct_kernel`): the least
time of the window's reconstructed pictures (`rooflines/k1.py`, bytes
at 3.35 TB/s) over K1's card time in the device trace, in %."""


def read(r):
    return r.roofline_share("k1")
