"""The device (H100) in the batch decodes: 1 - the merged intervals of
every kernel, copy and fill in the device trace over the traced window,
in %."""


def read(r):
    return r.idle_share()
