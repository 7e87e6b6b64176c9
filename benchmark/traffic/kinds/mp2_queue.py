"""One client decoding one MP2 item after another: `queue_clips` items of
lengths spread over `clip_frames` (MP2 frames), cycled; the warm-up one
item of `warmup_frames`.  An item is the configuration's MP2 fixture
looped from its frame 0 to the item's length, with no video: a `Clip`
of no GOPs whose pictures and audio frames are both its MP2 frames
(the clips of `clip_queue` are counted in GOPs' pictures, which an
audio-only fixture has none of).  The client's decoder settings are the
mix's `client` block."""

from benchmark.traffic.generator import Clip, lengths


def item(fx, n: int) -> Clip:
    frames = fx.audio_frames
    loops, rest = divmod(n, len(frames))
    data = b"".join(frames) * loops + b"".join(frames[:rest])
    return Clip((), n, data, n)


def make(spec, fx, rng, warm_rng):
    lo, hi = spec["clip_frames"]
    return item(fx, spec["warmup_frames"]), \
        [item(fx, n) for n in lengths(lo, hi, spec["queue_clips"], rng)]
