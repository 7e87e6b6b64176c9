"""Bit-level data source shared by the demuxer and both decoders.

Host-side component.  Mirrors the reference Buffer contract
(/root/reference/buffer.go:17-386): one type serving two modes —
reader-backed (pull via a load callback) and push-fed (`write` +
`signal_end`) — with MSB-first bit reads, start-code scanning, and
compaction so streaming memory stays bounded.

VLC reads use flat multi-bit lookup tables (tables.FlatVlc) instead of the
reference's 1-bit/step tree walk (buffer.go:352-376): peek up to 16 bits,
one table index, advance by the codeword length.
"""

from __future__ import annotations

import io
from typing import Callable, Optional

# Default refill chunk size (parity: buffer.go:8-11).
BUFFER_SIZE = 128 * 1024


class CorruptStream(Exception):
    """Raised on an invalid VLC prefix; callers abort the current picture."""


class Buffer:
    """Byte-growable, bit-addressed data source."""

    def __init__(self, reader: Optional[io.IOBase] = None,
                 chunk_size: int = None):
        self.reader = reader
        self.chunk_size = chunk_size if chunk_size else BUFFER_SIZE
        self.data = bytearray()
        self.bit_index = 0
        self.total_size = 0
        self._has_ended = False
        self.end_signaled = False
        self.discard_read = True
        self.load_callback: Optional[Callable[["Buffer"], None]] = None

        if reader is not None and reader.seekable():
            cur = reader.seek(0, io.SEEK_CUR)
            self.total_size = reader.seek(0, io.SEEK_END)
            reader.seek(cur, io.SEEK_SET)

    # -- public surface (parity: buffer.go:63-156) --------------------------

    def bytes(self) -> bytearray:
        """Unread-inclusive view of the current buffer contents."""
        return self.data

    def index(self) -> int:
        return self.bit_index >> 3

    def seekable(self) -> bool:
        return self.reader is not None and self.total_size > 0

    def write(self, p: bytes) -> int:
        if self.discard_read:
            self.discard_read_bytes()
        self.data += p
        self._has_ended = False
        self.end_signaled = False
        return len(p)

    def signal_end(self) -> None:
        self.total_size = len(self.data)
        self.end_signaled = True

    def set_load_callback(self, callback: Callable[["Buffer"], None]) -> None:
        self.load_callback = callback

    def rewind(self) -> None:
        self.seek(0)

    def size(self) -> int:
        return self.total_size if self.total_size > 0 else len(self.data)

    def remaining(self) -> int:
        return len(self.data) - (self.bit_index >> 3)

    def has_ended(self) -> bool:
        return self._has_ended

    def load_reader_callback(self, _buffer: "Buffer" = None) -> None:
        """Default load callback: read one chunk from the reader."""
        if self._has_ended:
            return
        chunk = self.reader.read(self.chunk_size)
        if not chunk:
            self._has_ended = True
            return
        self.write(chunk)

    # -- internals ----------------------------------------------------------

    def seek(self, pos: int) -> None:
        self._has_ended = False
        self.end_signaled = False
        if self.reader is not None and self.total_size > 0:
            self.reader.seek(pos, io.SEEK_SET)
            del self.data[:]
            self.bit_index = 0
        elif self.reader is None:
            if not self.discard_read:
                # Retained push buffer (discard disabled, e.g. the
                # non-seekable tee's control window): every byte since
                # stream start is still here, so any in-window position
                # is addressable — demux probe/start-time save/restore
                # positions through this.  A position beyond the window
                # (e.g. a save/restore landing past the tee's retention
                # cap) clamps to the buffered end and marks the stream
                # ended so the caller sees EOS instead of silently
                # continuing from an unrelated offset.
                if pos <= len(self.data):
                    self.bit_index = pos << 3
                else:
                    self.bit_index = len(self.data) << 3
                    self._has_ended = True
            elif pos == 0:
                del self.data[:]
                self.bit_index = 0

    def tell(self) -> int:
        if self.reader is not None and self.total_size > 0:
            off = self.reader.seek(0, io.SEEK_CUR)
            return off + (self.bit_index >> 3) - len(self.data)
        return self.bit_index >> 3

    def discard_read_bytes(self) -> None:
        byte_pos = self.bit_index >> 3
        if byte_pos == len(self.data):
            del self.data[:]
            self.bit_index = 0
        elif byte_pos > 0:
            del self.data[:byte_pos]
            self.bit_index -= byte_pos << 3

    def has(self, count: int) -> bool:
        """True if `count` bits are available, pulling more on underflow."""
        if (len(self.data) << 3) - self.bit_index >= count:
            return True
        if self.load_callback is not None:
            self.load_callback(self)
            if (len(self.data) << 3) - self.bit_index >= count:
                return True
        if self.total_size != 0 and len(self.data) == self.total_size:
            self._has_ended = True
        return False

    def read(self, count: int) -> int:
        """MSB-first read of `count` bits (parity: buffer.go:223-244)."""
        value = 0
        data = self.data
        idx = self.bit_index
        while count:
            current = data[idx >> 3]
            remaining = 8 - (idx & 7)
            n = count if count < remaining else remaining
            shift = remaining - n
            mask = 0xFF >> (8 - n)
            value = (value << n) | ((current & (mask << shift)) >> shift)
            idx += n
            count -= n
        self.bit_index = idx
        return value

    def read1(self) -> int:
        idx = self.bit_index
        self.bit_index = idx + 1
        return (self.data[idx >> 3] >> (7 - (idx & 7))) & 1

    def peek(self, count: int) -> int:
        """Read without consuming; bits past the end read as zero."""
        idx = self.bit_index
        end_bits = len(self.data) << 3
        if idx + count <= end_bits:
            value = self.read(count)
            self.bit_index = idx
            return value
        avail = end_bits - idx
        if avail <= 0:
            return 0
        value = self.read(avail)
        self.bit_index = idx
        return value << (count - avail)

    def align(self) -> None:
        self.bit_index = ((self.bit_index + 7) >> 3) << 3

    def skip(self, count: int) -> None:
        if self.has(count):
            self.bit_index += count

    def skip_bytes(self, v: int) -> int:
        self.align()
        skipped = 0
        while self.has(8) and self.data[self.bit_index >> 3] == v:
            self.bit_index += 8
            skipped += 1
        return skipped

    def next_start_code(self) -> int:
        """Scan for the next 00 00 01 xx start code; -1 when exhausted.

        Parity with buffer.go:279-302 including the not-found resting
        position (4 bytes before the end) so a code split across a refill
        boundary is still caught on retry.
        """
        self.align()
        while True:
            data = self.data
            stop = len(data) - 4
            start = self.bit_index >> 3
            if start < stop:
                i = data.find(b"\x00\x00\x01", start, stop + 3)
                if 0 <= i < stop:
                    self.bit_index = (i + 4) << 3
                    return data[i + 3]
                self.bit_index = stop << 3
            if not self.has(5 << 3):
                return -1

    def find_start_code(self, code: int) -> int:
        while True:
            current = self.next_start_code()
            if current == code or current == -1:
                return current

    def has_start_code(self, code: int) -> int:
        """Peek variant of find_start_code: restores position afterwards."""
        prev_bit_index = self.bit_index
        prev_discard = self.discard_read
        self.discard_read = False
        current = self.find_start_code(code)
        self.bit_index = prev_bit_index
        self.discard_read = prev_discard
        return current

    def find_frame_sync(self) -> bool:
        """Scan for MP2 frame sync 0xFF 0xFC.. (parity: buffer.go:326-339)."""
        data = self.data
        n = len(data)
        i = self.bit_index >> 3
        while True:
            i = data.find(0xFF, i, n - 1)
            if i < 0:
                self.bit_index = n << 3
                return False
            if (data[i + 1] & 0xFE) == 0xFC:
                self.bit_index = ((i + 1) << 3) + 3
                return True
            i += 1

    def peek_non_zero(self, bit_count: int) -> bool:
        if not self.has(bit_count):
            return False
        idx = self.bit_index
        val = self.read(bit_count)
        self.bit_index = idx
        return val != 0

    def read_vlc(self, table) -> int:
        """Decode one codeword using a flat lookup table."""
        maxlen = table.maxlen
        bits = self.peek(maxlen)
        length = table.lengths[bits]
        if length == 0:
            raise CorruptStream("invalid VLC prefix")
        self.bit_index += length
        return table.values[bits]
