"""One client decoding a queue of clips, each through a fresh
`BatchVideoDecoder(clip, window, prefetch, device)` driven by
`decode_window()` until it returns no frame.  Frames stay on the card."""

from __future__ import annotations

import time


def run(ctx, rec, items, until: float) -> None:
    from mpeg_tpu_torch.parallel import BatchVideoDecoder
    for key, clip in items:
        rec.open(key, clip)
        with rec.span("open"):
            dec = BatchVideoDecoder(
                clip.data, window=ctx.args["window"],
                prefetch=ctx.args.get("prefetch", False), stats=ctx.stats,
                device=ctx.device)
        rec.wrap(dec, "_next_parsed", "parse")
        try:
            while True:
                with rec.span("decode_window"):
                    frames = dec.decode_window()
                if not frames:
                    rec.close(key)
                    break
                rec.deliver(key, frames)
                if time.perf_counter() >= until:
                    return
        finally:
            dec.close()


def control(rec, key, clip, args, out) -> int:
    """The deliveries a BatchVideoDecoder makes of `clip`, with `out`'s
    frames in the program's place: window - 1 frames, then whole
    windows, the rest, and the flushed last frame on its own."""
    window = args["window"]
    rec.open(key, clip)
    n, k = clip.pictures, 0
    sizes = [min(window - 1, n - 1)]
    while sum(sizes) < n - 1:
        sizes.append(min(window, n - 1 - sum(sizes)))
    for size in sizes + [1]:
        rec.deliver(key, [out.frame(clip, k + i) for i in range(size)])
        k += size
    rec.close(key)
    return n
