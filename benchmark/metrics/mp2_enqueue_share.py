"""Decoder host half of the MP2 batch decode
(`parallel/audio_batch.py`): the program's `mpeg.audio.pack` (the
window's samples packed into the ring's pinned buffer), `mpeg.h2d` and
`mpeg.launch` spans on the main thread, each merged (they follow one
another on one thread), summed, over the window, in %.
None when the program recorded no such span
(`utils.profiling.last_trace`)."""

NAMES = ("mpeg.audio.pack", "mpeg.h2d", "mpeg.launch")


def read(r):
    from mpeg_tpu_torch.utils import profiling
    last = getattr(profiling, "last_trace", None)
    col = last() if last is not None else None
    if col is None:
        return None
    t = sum(col.seconds(name, main_only=True) for name in NAMES)
    return 100.0 * t / r.window_s if t > 0 else None
