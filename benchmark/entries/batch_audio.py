"""One client decoding a queue of MP2 items, each through a fresh
`BatchAudioDecoder(item, window, device)` with float32 PCM copied back
to the host (as a feature job reads it) and prefetch off, driven by
`decode_window()` until it returns None.  A delivered frame is an MP2
frame of 1,152 samples a channel.

A run decodes on the order of a million MP2 frames, so the PCM is not
kept whole: the check's PCM is a uniform sample of `samples` frames,
drawn from the seed as `Recorder.sample` draws pictures (a delivery
enters the sample by reservoir sampling, then one of its frames)."""

from __future__ import annotations

import time

import numpy as np

FRAME = 2304   # interleaved samples of an MP2 frame


def deliver(rec, key, n: int, frame) -> None:
    """One return of `n` MP2 frames of item `key`; `frame(i)` is the
    PCM of its i-th frame, read only for a frame the sample takes."""
    rec.returned()
    k0 = rec.frames_of(key, range(n))
    rec.clips[key].audio += n
    rec.audio_frames += n
    if rec.samples == 0:
        return
    i, rec.offered = rec.offered, rec.offered + 1
    slot = i if i < rec.samples else int(rec.rng.integers(i + 1))
    if slot >= rec.samples:
        return
    j = int(rec.rng.integers(n))
    pick = (key, k0 + j, np.array(frame(j), np.float32))
    if slot == len(rec.pcm):
        rec.pcm.append(pick)
    else:
        rec.pcm[slot] = pick


def run(ctx, rec, items, until: float) -> None:
    from mpeg_tpu_torch.parallel import BatchAudioDecoder
    for key, clip in items:
        rec.open(key, clip)
        with rec.span("open"):
            dec = BatchAudioDecoder(clip.data, window=ctx.args["window"],
                                    out_format="f32", prefetch=False,
                                    stats=ctx.stats, device=ctx.device)
        try:
            while True:
                with rec.span("decode_window"):
                    pcm = dec.decode_window()
                if pcm is None:
                    rec.close(key)
                    break
                deliver(rec, key, len(pcm) // FRAME,
                        lambda j, pcm=pcm: pcm[j * FRAME:(j + 1) * FRAME])
                if time.perf_counter() >= until:
                    return
        finally:
            dec.close()


def control(rec, key, clip, args, out) -> int:
    """The deliveries a BatchAudioDecoder makes of `clip`, with `out`'s
    PCM in the program's place: whole windows, then the rest."""
    window = args["window"]
    rec.open(key, clip)
    for k in range(0, clip.audio_frames, window):
        deliver(rec, key, min(window, clip.audio_frames - k),
                lambda j, k=k: out.pcm(k + j))
    rec.close(key)
    return clip.audio_frames
