"""The device (H100) under the A/V player: 1 - the merged intervals of
every kernel, copy and fill in the device trace over the traced window,
in %."""


def read(r):
    return r.idle_share()
