"""One player on the reference-shaped API: each MPEG-PS clip opened as
`MPEG(ps, device)` with a video and an audio callback, and
`decode(tick)` called back to back until `done`.  The video callback
keeps the frame on the card; the audio callback gets the PCM on the
host, as the API gives it."""

from __future__ import annotations

import time


def run(ctx, rec, items, until: float) -> None:
    from mpeg_tpu_torch import MPEG
    tick = ctx.args["tick_s"]
    for key, clip in items:
        rec.open(key, clip)
        with rec.span("open"):
            m = MPEG(clip.data, device=ctx.device)

        def on_video(_m, frame, key=key):
            k = rec.frames_of(key, [frame])
            rec.sample([(key, k, frame.flat)])

        def on_audio(_m, samples, key=key):
            rec.audio(key, samples.interleaved)

        m.set_video_callback(on_video)
        m.set_audio_callback(on_audio)
        while not m.done:
            if m.video_decoder is not None:
                rec.wrap(m.video_decoder, "_native_next_plan", "video_parse")
                rec.wrap(m.video_decoder, "_reconstruct", "video_reconstruct")
            if m.audio_decoder is not None:
                rec.wrap(m.audio_decoder, "_native_next_frame", "audio_parse")
                rec.wrap(m.audio_decoder, "_synthesize", "audio_synthesize")
            t = time.perf_counter()
            with rec.span("tick"):
                m.decode(tick)
            rec.ticks.append(time.perf_counter() - t)
            rec.returned()
            if time.perf_counter() >= until:
                return
        rec.close(key)


def control(rec, key, clip, args, out) -> int:
    """A player's frames and PCM of `clip`, with `out`'s in the
    program's place."""
    rec.open(key, clip)
    for k in range(clip.pictures):
        rec.sample([(key, rec.frames_of(key, [None]), out.frame(clip, k))])
    for j in range(clip.audio_frames):
        rec.audio(key, out.pcm(j))
    rec.close(key)
    return clip.pictures
