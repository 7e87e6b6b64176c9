"""Jobs of clips decoded in lockstep: each job one
`MultiStreamVideoDecoder(clips, window, device)` driven round by round
(`decode_window()`) until every clip has ended; the next job starts
then.  Frames stay on the card."""

from __future__ import annotations

import time


def run(ctx, rec, items, until: float) -> None:
    from mpeg_tpu_torch.parallel import MultiStreamVideoDecoder
    for key, job in items:
        keys = [(key, s) for s in range(len(job))]
        for k, clip in zip(keys, job):
            rec.open(k, clip)
        with rec.span("open"):
            dec = MultiStreamVideoDecoder([c.data for c in job],
                                          window=ctx.args["window"],
                                          stats=ctx.stats,
                                          device=ctx.device)
        rec.wrap(dec, "_next_filled", "parse")
        try:
            while True:
                with rec.span("decode_window"):
                    got = dec.decode_window()
                if got is None:
                    for k in keys:
                        rec.close(k)
                    break
                rec.returned()
                picks = []
                for k, frames in zip(keys, got):
                    k0 = rec.frames_of(k, frames)
                    picks += [(k, k0 + i, f) for i, f in enumerate(frames)]
                rec.sample(picks)
                if time.perf_counter() >= until:
                    return
        finally:
            dec.close()


def control(rec, key, job, args, out) -> int:
    """A MultiStreamVideoDecoder's rounds over `job`, with `out`'s frames
    in the program's place: each stream shows the frames of its
    pictures decoded so far less one, and the last when every stream
    has run dry."""
    window = args["window"]
    keys = [(key, s) for s in range(len(job))]
    for k, clip in zip(keys, job):
        rec.open(k, clip)
    shown = [0] * len(job)
    r = 0
    while any(shown[s] < c.pictures - 1 for s, c in enumerate(job)):
        r += 1
        picks = []
        for s, (k, clip) in enumerate(zip(keys, job)):
            upto = min(clip.pictures, window * r) - 1
            frames = [out.frame(clip, i) for i in range(shown[s], upto)]
            k0 = rec.frames_of(k, frames)
            picks += [(k, k0 + i, f) for i, f in enumerate(frames)]
            shown[s] = upto
        rec.sample(picks)
    picks = []
    for k, clip in zip(keys, job):
        f = [out.frame(clip, clip.pictures - 1)]
        picks.append((k, rec.frames_of(k, f), f[0]))
        rec.close(k)
    rec.sample(picks)
    return sum(c.pictures for c in job)
