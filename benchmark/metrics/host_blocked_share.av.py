"""Host-card sync under the A/V player: the program's `mpeg.block` spans on
the main thread (every place the host waits for the card: `HostRing`'s
wait for its oldest copy, `_Slot.wait`'s gate, `Audio`'s and
`BatchAudioDecoder`'s PCM copies back), merged, over the window, in %.
None when the program recorded no spans (`utils.profiling.last_trace`)."""


def read(r):
    from mpeg_tpu_torch.utils import profiling
    last = getattr(profiling, "last_trace", None)
    col = last() if last is not None else None
    if col is None:
        return None
    return 100.0 * col.seconds("mpeg.block", main_only=True) / r.window_s
