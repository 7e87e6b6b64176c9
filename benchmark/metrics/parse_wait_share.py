"""Host parse (the C++ parser through `parallel/batch.py` and
`parallel/multistream.py`): `DecodeStats.host_seconds` over the window,
in %.  Without prefetch it is the parse the decode waited for; with
prefetch the decoder records the parse thread's time, which runs beside
the decode."""


def read(r):
    if r.stats is None or r.stats.frames == 0:
        return None
    return 100.0 * r.stats.host_seconds / r.window_s
