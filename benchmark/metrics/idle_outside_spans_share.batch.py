"""The device in the batch decodes, its idle time that the program's spans
do not explain: of the card's idle seconds in the traced capture, the
share under no `mpeg.*` span on the main thread
(`utils.profiling.idle_by_span`, None's entry), in %. None when the
program recorded no spans (`utils.profiling.last_trace`); 0 when it
found no idle time."""


def read(r):
    from mpeg_tpu_torch.utils import profiling
    last = getattr(profiling, "last_trace", None)
    col = last() if last is not None else None
    if col is None:
        return None
    idle = sum(col.idle_by_span.values())
    return 100.0 * col.idle_by_span.get(None, 0.0) / idle if idle > 0 \
        else 0.0
