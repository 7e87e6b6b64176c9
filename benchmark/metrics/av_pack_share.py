"""The interactive picture path (`video.py` `Video._reconstruct`: the
one-picture blob pack, its copy and the launches): the benchmark's span
around each call, summed over the window, in %."""


def read(r):
    t = r.spans.get("video_reconstruct", 0.0)
    return 100.0 * t / r.window_s if t > 0 else None
