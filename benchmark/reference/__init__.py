"""The benchmark's plain reference: an MPEG-1 video decoder, an MP2
decoder and an MPEG-PS demuxer in Python and NumPy.

A frozen copy of the repository's original numpy oracle (the parse of
`video.py` and `audio.py`, the integer reconstruct and the no-FMA
filterbank), cut down to that path and made to import nothing but numpy
and the standard library.  It imports nothing of the measured program,
so the benchmark's `correct` does not rest on the code it judges.
"""

from __future__ import annotations

import io

import numpy as np

from .audio import Audio
from .buffer import Buffer
from .demux import PACKET_AUDIO_1, PACKET_VIDEO_1, Demux
from .recon import idct_batch_bf16
from .video import Video


def _buffer(data: bytes) -> Buffer:
    buf = Buffer(io.BytesIO(bytes(data)))
    buf.set_load_callback(buf.load_reader_callback)
    return buf


def decode_video(es: bytes, control: bool = False) -> list:
    """Every displayed frame of an MPEG-1 video elementary stream, in
    display order: flat uint8 arrays of the Y, Cb and Cr planes at their
    macroblock-rounded sizes (`geom.frame_size` bytes).  `control`
    computes the IDCT on bfloat16 coefficients."""
    video = Video(_buffer(es), idct=idct_batch_bf16 if control else None)
    frames = []
    while (f := video.decode()) is not None:
        frames.append(np.array(f.flat[:video.geom.frame_size]))
    return frames


def decode_audio(es: bytes, control: bool = False) -> np.ndarray:
    """Every frame of an MP2 elementary stream: float32 [frames, 2304],
    the interleaved normalized samples.  `control` rounds the synthesis
    output to bfloat16."""
    audio = Audio(_buffer(es), control=control)
    out = []
    while (s := audio.decode()) is not None:
        out.append(np.array(s.interleaved, np.float32))
    return np.stack(out) if out else np.zeros((0, 2304), np.float32)


def demux(ps: bytes) -> tuple:
    """(video ES, first audio ES) payload bytes of an MPEG-PS."""
    d = Demux(_buffer(ps))
    video, audio = bytearray(), bytearray()
    while (p := d.decode()) is not None:
        data = bytes(p.data[:p.length])
        if p.type == PACKET_VIDEO_1:
            video += data
        elif p.type == PACKET_AUDIO_1:
            audio += data
    return bytes(video), bytes(audio)
