"""h2d, its pinned host buffers: the program's `mpeg.alloc.pinned` spans
(`parallel/batch.py` `host_blob`, which makes every blob, `HostRing`,
`_Slot` and `Audio` staging buffer), on all threads, merged, over the
window, in %.  None when the program recorded no spans
(`utils.profiling.last_trace`)."""


def read(r):
    from mpeg_tpu_torch.utils import profiling
    last = getattr(profiling, "last_trace", None)
    col = last() if last is not None else None
    if col is None:
        return None
    return 100.0 * col.seconds("mpeg.alloc.pinned") / r.window_s
