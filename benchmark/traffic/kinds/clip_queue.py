"""One client decoding one clip after another: `queue_clips` clips of
lengths spread over `clip_pictures`, cycled; the warm-up one clip of
`warmup_pictures`.  With a `player` block each clip is MPEG-PS, muxed
with the MP2 fixture looped to its length at the block's `samplerate`.
The client's decoder settings are the mix's `client` block."""

from benchmark.traffic.generator import clip, lengths


def make(spec, fx, rng, warm_rng):
    lo, hi = spec["clip_pictures"]
    player = spec.get("player")
    warm = clip(fx, warm_rng, spec["warmup_pictures"], player)
    return warm, [clip(fx, rng, n, player)
                  for n in lengths(lo, hi, spec["queue_clips"], rng)]
