"""FNV-1a 64-bit hash, matching Go's hash/fnv.

Used by the golden end-to-end tests to anchor bit-exactness against the
reference decoder's recorded hashes (mpeg_test.go:193-197, 227).
"""

from __future__ import annotations

_OFFSET = 0xCBF29CE484222325
_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


class Fnv1a64:
    """Incremental FNV-1a 64."""

    def __init__(self) -> None:
        self.state = _OFFSET

    def write(self, data: bytes) -> None:
        h = self.state
        for b in data:
            h = ((h ^ b) * _PRIME) & _MASK
        self.state = h

    def sum64(self) -> int:
        return self.state


def fnv1a64(data: bytes) -> int:
    h = Fnv1a64()
    h.write(data)
    return h.sum64()
