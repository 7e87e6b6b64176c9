"""Host parse across threads (`parallel/multistream.py` `_fill`): the
program's `mpeg.parse.stream` spans (one stream's parse in one fill, on
whichever thread ran it), their seconds summed over every thread and not
merged, over the main thread's merged `mpeg.parse.wait` seconds, in x:
how many threads, on average, parsed while the decode waited for the
parse.  None when the program recorded no such span: no collector
(`utils.profiling.last_trace`), or a program whose fill runs on one
thread and records none."""


def read(r):
    from mpeg_tpu_torch.utils import profiling
    last = getattr(profiling, "last_trace", None)
    col = last() if last is not None else None
    if col is None:
        return None
    busy = sum(s[7] - s[6] for s in col.spans
               if s[1] == "mpeg.parse.stream") * 1e-9
    wait = col.seconds("mpeg.parse.wait", main_only=True)
    if busy <= 0 or wait <= 0:
        return None
    return busy / wait
