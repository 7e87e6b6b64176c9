"""Jobs of `streams` clips decoded in lockstep, the next job once all
have ended: `jobs` jobs, each of clips of lengths spread over
`clip_pictures`, cycled; the warm-up one job of clips of
`warmup_pictures`."""

from benchmark.traffic.generator import clip, lengths


def make(spec, fx, rng, warm_rng):
    lo, hi = spec["clip_pictures"]
    s = spec["streams"]
    warm = [clip(fx, warm_rng, spec["warmup_pictures"]) for _ in range(s)]
    return warm, [[clip(fx, rng, n) for n in lengths(lo, hi, s, rng)]
                  for _ in range(spec["jobs"])]
