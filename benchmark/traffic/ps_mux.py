"""MPEG-1 Program Stream muxer: a frozen copy of the repository's
`tools/ps_mux.py` (pack header, system header, PES packets with the
MPEG-1 PTS marker), with `mux_once`, which sends each elementary stream
once, whole, where the original loops both to a target duration."""

from __future__ import annotations


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, value: int, bits: int):
        self._acc = (self._acc << bits) | (value & ((1 << bits) - 1))
        self._n += bits
        while self._n >= 8:
            self._n -= 8
            self.out.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def bytes(self) -> bytes:
        if self._n:
            raise ValueError("unaligned")
        return bytes(self.out)


def _clock33(w: _BitWriter, seconds: float):
    """33-bit 90 kHz clock with marker bits (pack SCR / PES PTS body)."""
    t = int(round(seconds * 90000)) & ((1 << 33) - 1)
    w.write(t >> 30, 3)
    w.write(1, 1)
    w.write((t >> 15) & 0x7FFF, 15)
    w.write(1, 1)
    w.write(t & 0x7FFF, 15)
    w.write(1, 1)


def pack_header(scr_seconds: float = 0.0, mux_rate: int = 10000) -> bytes:
    w = _BitWriter()
    w.write(0x000001BA, 32)
    w.write(0x2, 4)              # MPEG-1 pack marker
    _clock33(w, scr_seconds)
    w.write(1, 1)
    w.write(mux_rate, 22)        # mux rate (units of 50 B/s)
    w.write(1, 1)
    return w.bytes()


def system_header(n_audio: int = 1, n_video: int = 1,
                  rate_bound: int = 10000) -> bytes:
    w = _BitWriter()
    w.write(0x000001BB, 32)
    w.write(6, 16)               # header length (bytes after this field)
    w.write(1, 1)
    w.write(rate_bound, 22)
    w.write(1, 1)
    w.write(n_audio, 6)          # audio bound
    w.write(0, 2)                # fixed, CSPS
    w.write(0, 2)                # audio/video lock
    w.write(1, 1)                # marker
    w.write(n_video, 5)          # video bound
    w.write(0xFF, 8)             # reserved
    return w.bytes()


def pes_packet(stream_id: int, payload: bytes, pts: float = None) -> bytes:
    w = _BitWriter()
    w.write(0x000001, 24)
    w.write(stream_id, 8)
    tail = 5 if pts is not None else 1
    w.write(len(payload) + tail, 16)
    if pts is not None:
        w.write(0x2, 4)          # '0010' PTS-only marker
        _clock33(w, pts)
    else:
        w.write(0x0F, 8)         # no PTS/DTS
    return w.bytes() + payload


def mux_once(video_es: bytes, audio_es: bytes, video_seconds: float,
             audio_seconds: float, chunk: int = 2048) -> bytes:
    """Interleave two elementary streams, each sent once and whole, into
    one PS; packets alternate by which stream's clock is behind, as
    `tools/ps_mux.py` interleaves them."""
    video_rate = len(video_es) / video_seconds   # bytes per second
    audio_rate = len(audio_es) / audio_seconds
    out = [pack_header(), system_header()]
    v_sent = a_sent = 0
    while v_sent < len(video_es) or a_sent < len(audio_es):
        v_time = v_sent / video_rate
        a_time = a_sent / audio_rate
        if a_sent >= len(audio_es) or \
                (v_sent < len(video_es) and v_time <= a_time):
            part = video_es[v_sent:v_sent + chunk]
            out.append(pes_packet(0xE0, part, pts=v_time))
            v_sent += len(part)
        else:
            part = audio_es[a_sent:a_sent + chunk]
            out.append(pes_packet(0xC0, part, pts=a_time))
            a_sent += len(part)
    return b"".join(out)
