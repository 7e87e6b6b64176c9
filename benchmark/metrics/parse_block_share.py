"""Host parse, as the decode waited for it: the program's `mpeg.parse.wait`
spans on the main thread (`parallel/batch.py` `_next_parsed`,
`parallel/multistream.py` `_next_filled`: the inline parse, or the wait
for the prefetch queue), merged, over the window, in %.  None when the
program recorded no spans (`utils.profiling.last_trace`)."""


def read(r):
    from mpeg_tpu_torch.utils import profiling
    last = getattr(profiling, "last_trace", None)
    col = last() if last is not None else None
    if col is None:
        return None
    return 100.0 * col.seconds("mpeg.parse.wait", main_only=True) \
        / r.window_s
