"""Demux + parse (`pipeline.py` picture pulls `_native_next_plan` and
the MP2 frame pulls `_native_next_frame`, which drive the C++ demuxer
and parsers): the benchmark's spans around each call, summed over the
window, in %."""


def read(r):
    t = r.spans.get("video_parse", 0.0) + r.spans.get("audio_parse", 0.0)
    return 100.0 * t / r.window_s if t > 0 else None
