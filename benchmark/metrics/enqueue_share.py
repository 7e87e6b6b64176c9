"""Decoder host half (`parallel/batch.py`, `parallel/multistream.py`:
staging, `device_put`, launches): `DecodeStats.device_seconds` over the
window, in %.  This is host enqueue time, whatever its name says: the
copies and launches are asynchronous."""


def read(r):
    if r.stats is None or r.stats.frames == 0:
        return None
    return 100.0 * r.stats.device_seconds / r.window_s
