"""MPEG-PS (Program Stream) demuxer.

Splits a Program Stream into typed PES packets with PTS (behavior parity
with the original Go demuxer, demux.go); the packet payload is valid
until the next decode() call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .buffer import Buffer


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

class InvalidHeaderError(Exception):
    """Pack and system headers were not found (demux.go:32)."""


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

        self.start_code = -1
        self.has_pack_header = False
        self.has_system_header = False
        self._has_headers = False

        self.num_audio_streams = 0
        self.num_video_streams = 0

        self.current_packet = Packet()
        self.next_packet = Packet()

        if not self.has_headers():
            raise InvalidHeaderError("invalid MPEG-PS header")

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

    def has_ended(self) -> bool:
        return self.buf.has_ended()

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

