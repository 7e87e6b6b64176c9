"""MPEG-PS (Program Stream) demuxer.

Host-side component.  Splits a Program Stream into typed PES packets with
PTS, and provides stream probing, start-time/duration estimation and
PTS-targeted seeking.  Behavior parity with the reference demuxer
(reference demux.go); the packet payload is valid until the next
decode() call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import math

from .buffer import Buffer


def _fdiv(a: float, b: float) -> float:
    """IEEE float division (Go semantics): x/0 is +/-Inf or NaN, never a
    raised exception — the seek estimator relies on it."""
    if b != 0:
        return a / b
    if a > 0:
        return math.inf
    if a < 0:
        return -math.inf
    return math.nan

# Packet types map directly to MPEG-PES start codes (demux.go:20-29).
PACKET_INVALID_TS = -1.0

PACKET_PRIVATE = 0xBD
PACKET_AUDIO_1 = 0xC0
PACKET_AUDIO_2 = 0xC1
PACKET_AUDIO_3 = 0xC2
PACKET_AUDIO_4 = 0xC3
PACKET_VIDEO_1 = 0xE0

START_PACK = 0xBA
START_END = 0xB9
START_SYSTEM = 0xBB

# How far past the first PTS to scan for reordered (B-frame) packets
# (demux.go:351-352).
REORDER_WINDOW = 1.0


class InvalidHeaderError(Exception):
    """Pack and system headers were not found (demux.go:32)."""


def payload_has_intra(data, length: int) -> bool:
    """Does this video packet payload start an intra picture?  Picture
    start code, then frame-type bits == 1 — the exact sniff (including
    the `length - 6` bound) of the reference's intra seek
    (demux.go:308-322).  Shared by Demux.seek and the batch clip
    extraction."""
    for i in range(length - 6):
        if data[i] == 0x00 and data[i + 1] == 0x00 and \
                data[i + 2] == 0x01 and data[i + 3] == 0x00:
            return (data[i + 5] & 0x38) == 8
    return False


@dataclass
class Packet:
    """One demuxed PES packet (demux.go:11-17)."""

    type: int = 0
    pts: float = PACKET_INVALID_TS
    data: memoryview | bytes = b""
    length: int = 0


class Demux:
    """Demux an MPEG Program Stream into separate packets."""

    def __init__(self, buf: Buffer):
        self.buf = buf
        self.sys_clock_ref = 0.0
        self.last_file_size = 0
        self.last_decoded_pts = 0.0
        self.start_time: dict[int, float] = {}
        self.duration_cache: dict[int, float] = {}
        # Raw first/last PTS per type: reference points for the seek estimator.
        self.first_pts: dict[int, float] = {}
        self.last_pts: dict[int, float] = {}

        self.start_code = -1
        self.has_pack_header = False
        self.has_system_header = False
        self._has_headers = False

        self.num_audio_streams = 0
        self.num_video_streams = 0

        # Byte offset of the start code of the packet the last successful
        # seek() returned (consumed by the native re-feed seek protocol).
        self.last_seek_offset = -1

        self.current_packet = Packet()
        self.next_packet = Packet()

        if not self.has_headers():
            raise InvalidHeaderError("invalid MPEG-PS header")

    def buffer(self) -> Buffer:
        return self.buf

    def has_headers(self) -> bool:
        """Parse pack+system headers if not yet seen (demux.go:85-138)."""
        if self._has_headers:
            return True

        if not self.has_pack_header:
            if self.start_code != START_PACK and \
                    self.buf.find_start_code(START_PACK) == -1:
                return False
            self.start_code = START_PACK
            if not self.buf.has(64):
                return False
            self.start_code = -1

            if self.buf.read(4) != 0x02:
                return False
            self.sys_clock_ref = self._decode_time()
            self.buf.skip(1)
            self.buf.skip(22)   # mux rate * 50
            self.buf.skip(1)
            self.has_pack_header = True

        if not self.has_system_header:
            if self.start_code != START_SYSTEM and \
                    self.buf.find_start_code(START_SYSTEM) == -1:
                return False
            self.start_code = START_SYSTEM
            if not self.buf.has(56):
                return False
            self.start_code = -1

            self.buf.skip(16)   # header length
            self.buf.skip(24)   # rate bound
            self.num_audio_streams = self.buf.read(6)
            self.buf.skip(5)    # misc flags
            self.num_video_streams = self.buf.read(5)
            self.has_system_header = True

        self._has_headers = True
        return True

    def probe(self, probe_size: int) -> bool:
        """Count actual stream start codes; headers can lie (demux.go:141-179)."""
        prev_pos = self.buf.tell()

        video_stream = False
        audio_streams = [False] * 4

        while True:
            self.start_code = self.buf.next_start_code()
            if self.start_code == PACKET_VIDEO_1:
                video_stream = True
            elif PACKET_AUDIO_1 <= self.start_code <= PACKET_AUDIO_4:
                audio_streams[self.start_code - PACKET_AUDIO_1] = True
            if self.start_code == -1 or self.buf.tell() - prev_pos > probe_size:
                break

        self.num_video_streams = 1 if video_stream else 0
        self.num_audio_streams = sum(audio_streams)

        self.buf.seek(prev_pos)
        return self.num_video_streams > 0 or self.num_audio_streams > 0

    def get_num_video_streams(self) -> int:
        return self.num_video_streams if self.has_headers() else 0

    def get_num_audio_streams(self) -> int:
        return self.num_audio_streams if self.has_headers() else 0

    def rewind(self) -> None:
        self.buf.rewind()
        self.current_packet.length = 0
        self.next_packet.length = 0
        self.start_code = -1

    def reanchor(self, pos: int, pts: float) -> None:
        """Re-anchor the seek estimator to a known (byte offset, stream
        PTS) pair.  Used by the native pipeline's MPEG class: there the
        Python demuxer is a control plane that doesn't consume packets,
        so before a seek its position/last-PTS must be synced to the live
        decode position (the reference demuxer is always there because it
        IS the packet source, demux.go:216-254)."""
        self._buffer_seek(max(0, min(pos, self.buf.size())))
        self.last_decoded_pts = pts

    def has_ended(self) -> bool:
        return self.buf.has_ended()

    def seek(self, seek_time: float, typ: int, force_intra: bool) -> Optional[Packet]:
        """Byte-rate jump search for a packet with PTS just before seek_time.

        When force_intra, only packets containing an intra frame are
        considered.  Parity: demux.go:216-349 (including the exponential
        scan-span growth and the 32-retry cap).
        """
        if not self._has_headers:
            return None

        # Anchor on the raw PTS span, not corrected StartTime/Duration.
        self.get_duration(typ)
        start_pts = self.first_pts.get(typ, PACKET_INVALID_TS)
        span = self.last_pts.get(typ, PACKET_INVALID_TS) - start_pts

        file_size = self.buf.size()
        byte_rate = _fdiv(file_size, span)

        cur_time = self.last_decoded_pts
        scan_span = 1.0

        seek_time = max(0.0, min(seek_time, span)) + start_pts

        for _ in range(32):
            found_packet_with_pts = False
            found_packet_in_range = False
            last_valid_packet_start = -1
            first_packet_time = PACKET_INVALID_TS

            cur_pos = self.buf.tell()

            # Estimate byte offset and jump to it.  A non-finite estimate
            # converts like Go's float->int (minInt64) and clamps to 0.
            offset = (seek_time - cur_time - scan_span) * byte_rate
            off_i = int(offset) if math.isfinite(offset) else -(1 << 63)
            seek_pos = min(max(cur_pos + off_i, 0), file_size - 256)
            self._buffer_seek(seek_pos)

            # Scan packets up to seek_time for the last intra-frame packet.
            while self.buf.find_start_code(typ) != -1:
                packet_start = self.buf.tell()
                packet = self._decode_packet(typ)
                if packet is None or packet.pts == PACKET_INVALID_TS:
                    continue

                # Bail if outside [seek_time - scan_span, seek_time]; refine
                # the rate estimate for the next jump.  Guard the refit:
                # a zero/negative/non-finite rate (possible when the jump
                # landed at/behind the current position) makes every later
                # offset degenerate, so fall back to the global estimate.
                if packet.pts > seek_time or packet.pts < seek_time - scan_span:
                    found_packet_with_pts = True
                    refit = _fdiv(seek_pos - cur_pos, packet.pts - cur_time)
                    byte_rate = refit if (math.isfinite(refit) and refit > 0) \
                        else _fdiv(file_size, span)
                    cur_time = packet.pts
                    break

                if not found_packet_in_range:
                    found_packet_in_range = True
                    first_packet_time = packet.pts

                if force_intra:
                    if payload_has_intra(packet.data, packet.length):
                        last_valid_packet_start = packet_start
                else:
                    last_valid_packet_start = packet_start

            if last_valid_packet_start != -1:
                # The recorded position is right AFTER the 4-byte start
                # code; the packet itself begins 4 bytes earlier.
                self.last_seek_offset = last_valid_packet_start - 4
                self._buffer_seek(last_valid_packet_start)
                return self._decode_packet(typ)
            if found_packet_in_range:
                # Right range but no intra frame: widen exponentially.
                scan_span *= 2
                seek_time = first_packet_time
            elif not found_packet_with_pts:
                # Probably past the end; re-anchor the estimates.
                byte_rate = _fdiv(seek_pos - cur_pos, span - cur_time)
                cur_time = span

        return None

    def get_start_time(self, typ: int) -> float:
        """Lowest PTS of this type within the reorder window (demux.go:356-400)."""
        if typ in self.start_time:
            return self.start_time[typ]

        prev_pos = self.buf.tell()
        prev_start_code = self.start_code

        start_time = PACKET_INVALID_TS
        anchor = PACKET_INVALID_TS

        self.rewind()
        while True:
            packet = self.decode()
            if packet is None:
                break
            if packet.type != typ or packet.pts == PACKET_INVALID_TS:
                continue
            if anchor == PACKET_INVALID_TS:
                anchor = packet.pts
                start_time = packet.pts
            else:
                if packet.pts < start_time:
                    start_time = packet.pts
                if packet.pts >= anchor + REORDER_WINDOW:
                    break

        self._buffer_seek(prev_pos)
        self.start_code = prev_start_code

        if start_time != PACKET_INVALID_TS:
            self.start_time[typ] = start_time
            self.first_pts[typ] = anchor
        return start_time

    def get_duration(self, typ: int) -> float:
        """Highest-lowest PTS plus one frame step (demux.go:404-453)."""
        file_size = self.buf.size()
        if typ in self.duration_cache and self.last_file_size == file_size:
            return self.duration_cache[typ]

        prev_pos = self.buf.tell()
        prev_start_code = self.start_code

        start_range = 64 * 1024
        max_range = 4096 * 1024

        r = start_range
        while r <= max_range:
            seek_pos = file_size - r
            if seek_pos < 0:
                seek_pos = 0
                r = max_range   # bail after this round
            self._buffer_seek(seek_pos)
            self.current_packet.length = 0

            pts_list = []
            while True:
                packet = self.decode()
                if packet is None:
                    break
                if packet.pts != PACKET_INVALID_TS and packet.type == typ:
                    pts_list.append(packet.pts)

            if pts_list:
                pts_list.sort()
                last = pts_list[-1]
                self.last_pts[typ] = last
                self.duration_cache[typ] = \
                    last - self.get_start_time(typ) + _frame_step(pts_list)
                break
            r *= 2

        self._buffer_seek(prev_pos)
        self.start_code = prev_start_code
        self.last_file_size = file_size
        return self.duration_cache.get(typ, 0.0)

    def decode(self) -> Optional[Packet]:
        """Decode and return the next packet (demux.go:473-511)."""
        if not self.has_headers():
            return None

        if self.current_packet.length != 0:
            bits_till_next = self.current_packet.length << 3
            if not self.buf.has(bits_till_next):
                return None
            self.buf.skip(bits_till_next)
            self.current_packet.length = 0

        # Pending packet waiting for data?
        if self.next_packet.length != 0:
            return self._packet()

        # Pending packet waiting for header?
        if self.start_code != -1:
            return self._decode_packet(self.start_code)

        while True:
            self.start_code = self.buf.next_start_code()
            if self.start_code == PACKET_VIDEO_1 or \
                    self.start_code == PACKET_PRIVATE or \
                    PACKET_AUDIO_1 <= self.start_code <= PACKET_AUDIO_4:
                return self._decode_packet(self.start_code)
            if self.start_code == -1:
                break
        return None

    # -- internals ----------------------------------------------------------

    def _buffer_seek(self, pos: int) -> None:
        self.buf.seek(pos)
        self.current_packet.length = 0
        self.next_packet.length = 0
        self.start_code = -1

    def _decode_time(self) -> float:
        """33-bit 90 kHz system clock reference (demux.go:520-529)."""
        clock = self.buf.read(3) << 30
        self.buf.skip(1)
        clock |= self.buf.read(15) << 15
        self.buf.skip(1)
        clock |= self.buf.read(15)
        self.buf.skip(1)
        return clock / 90000.0

    def _decode_packet(self, typ: int) -> Optional[Packet]:
        """PES header parse: length, stuffing, P-STD, PTS (demux.go:531-568)."""
        if not self.buf.has(16 << 3):
            return None

        self.start_code = -1
        self.next_packet.type = typ
        self.next_packet.length = self.buf.read(16)
        self.next_packet.length -= self.buf.skip_bytes(0xFF)   # stuffing

        # Skip P-STD
        if self.buf.read(2) == 0x01:
            self.buf.skip(16)
            self.next_packet.length -= 2

        pts_dts_marker = self.buf.read(2)
        if pts_dts_marker == 0x03:
            self.next_packet.pts = self._decode_time()
            self.last_decoded_pts = self.next_packet.pts
            self.buf.skip(40)   # skip DTS
            self.next_packet.length -= 10
        elif pts_dts_marker == 0x02:
            self.next_packet.pts = self._decode_time()
            self.last_decoded_pts = self.next_packet.pts
            self.next_packet.length -= 5
        elif pts_dts_marker == 0x00:
            self.next_packet.pts = PACKET_INVALID_TS
            self.buf.skip(4)
            self.next_packet.length -= 1
        else:
            return None   # invalid

        return self._packet()

    def _packet(self) -> Optional[Packet]:
        if not self.buf.has(self.next_packet.length << 3):
            return None

        index = self.buf.index()
        end = index + self.next_packet.length
        # Copied out (a memoryview would pin the bytearray against resizing).
        self.current_packet.data = bytes(self.buf.bytes()[index:end])
        self.current_packet.type = self.next_packet.type
        self.current_packet.pts = self.next_packet.pts
        self.current_packet.length = self.next_packet.length
        self.next_packet.length = 0
        return self.current_packet


def _frame_step(sorted_pts: list[float]) -> float:
    """Smallest positive gap between sorted timestamps (demux.go:456-470)."""
    step = PACKET_INVALID_TS
    for a, b in zip(sorted_pts, sorted_pts[1:]):
        gap = b - a
        if gap > 0 and (step == PACKET_INVALID_TS or gap < step):
            step = gap
    return 0.0 if step == PACKET_INVALID_TS else step
