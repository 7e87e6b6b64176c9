"""h2d (`parallel/batch.py` `device_put`): bytes the decoders copied to
the card in the window (`transport_counts`) per displayed frame."""


def read(r):
    if r.frames == 0 or r.h2d_bytes == 0:
        return None
    return r.h2d_bytes / r.frames
