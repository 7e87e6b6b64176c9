"""The interactive picture path's host work (`video.py`
`Video._reconstruct`): the self time of the program's
`mpeg.video.records` spans (the pool records, `plan_pool_records`,
`_window_records`, `delta_encode`) and `mpeg.video.pack` spans (the
ring's buffer and `pack_plans_blob`; a wait for the card or a pinned
allocation inside it is its own span), over the window, in %.  None when
the program recorded no spans (`utils.profiling.last_trace`)."""


def read(r):
    from mpeg_tpu_torch.utils import profiling
    last = getattr(profiling, "last_trace", None)
    col = last() if last is not None else None
    if col is None:
        return None
    return 100.0 * (col.self_seconds("mpeg.video.records") +
                    col.self_seconds("mpeg.video.pack")) / r.window_s
