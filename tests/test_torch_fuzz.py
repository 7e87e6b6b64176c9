"""Corrupt streams through the port on the CPU (the counterpart of
tests/test_fuzz.py): bit-flipped and truncated ES, MP2 and PS never
raise.  `Video` parses (backend "plan") with either parser, `Audio`
decodes with either, and `MPEG` decodes video with the Python parse
(reconstructing with the plain versions), then `duration` and `seek`;
the window decoders take the corrupt ES and PS too.  The same set runs on
the card in tests/test_torch_streams_cuda.py."""

import io

import pytest

import mpeg_tpu_torch as mpeg
from mpeg_tpu_torch import native
from mpeg_tpu_torch.parallel import BatchVideoDecoder
from torch_threads import one_torch_thread  # noqa: F401

PARSERS = ["python"] + (["native"] if native.available() else [])


def bitflip(data: bytes, i: int) -> bytes:
    d = bytearray(data)
    step = max(1, len(d) // 17)
    for off in range(step * (i + 1) % len(d), len(d), 7919):
        d[off] ^= 1 << (i % 8)
    return bytes(d)


def drive_video(data: bytes, parser: str):
    buf = mpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    v = mpeg.Video(buf, backend="plan", parser=parser, device="cpu")
    n = 0
    while v.has_header() and v.parse_next_plan() is not None and n < 300:
        n += 1


def drive_audio(data: bytes, parser: str, device="cpu"):
    buf = mpeg.Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    a = mpeg.Audio(buf, parser=parser, device=device)
    n = 0
    while a.decode() is not None and n < 400:
        n += 1


def drive_ps(data: bytes, parser: str, device="cpu"):
    try:
        m = mpeg.MPEG(data, config=mpeg.Config(parser=parser),
                      device=device)
    except mpeg.InvalidMpegError:
        return   # rejecting junk outright is fine
    n = 0
    while m.decode_video() is not None and n < 300:
        n += 1
    m.duration()
    m.seek(1.0, True)


def drive_batch(data: bytes, device="cpu"):
    """The window decoder on corrupt bytes: its blobs go through K5 and
    K1 (the plain versions on the CPU)."""
    if not native.available():
        return
    dec = BatchVideoDecoder(data, window=8, device=device)
    n = 0
    while (got := dec.decode_window()) and n < 300:
        n += len(got)


@pytest.mark.parametrize("parser", PARSERS)
@pytest.mark.parametrize("i", range(0, 16, 3))
def test_bitflip_streams_never_raise(i, parser, mpeg1video_path, mp2_path,
                                     mpg_path):
    es = bitflip(mpeg1video_path.read_bytes(), i)
    drive_video(es, parser)
    drive_audio(bitflip(mp2_path.read_bytes(), i), parser)
    if parser == "python":   # the reconstructs cost the same either way
        drive_ps(bitflip(mpg_path.read_bytes(), i), parser)
        drive_batch(es)


@pytest.mark.parametrize("frac", [0.003, 0.01, 0.5])
def test_truncated_streams_never_raise(frac, mpeg1video_path, mp2_path,
                                       mpg_path):
    for parser in PARSERS:
        cut = lambda p: p.read_bytes()[:int(p.stat().st_size * frac)]  # noqa
        drive_video(cut(mpeg1video_path), parser)
        drive_audio(cut(mp2_path), parser)
    drive_ps(cut(mpg_path), "python")
    drive_batch(cut(mpeg1video_path))
