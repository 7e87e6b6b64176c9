"""Clip opening: the program's `mpeg.open` spans (the decoders'
constructors: the clip's bytes copied, the native parsers made and
fed), merged, over the window, in %.  None when the program recorded no
spans (`utils.profiling.last_trace`)."""


def read(r):
    from mpeg_tpu_torch.utils import profiling
    last = getattr(profiling, "last_trace", None)
    col = last() if last is not None else None
    if col is None:
        return None
    return 100.0 * col.seconds("mpeg.open") / r.window_s
