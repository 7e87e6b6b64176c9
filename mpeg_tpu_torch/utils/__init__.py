"""Host-side utilities: hashing and decode counters."""

from .fnv import fnv1a64, Fnv1a64

__all__ = ["fnv1a64", "Fnv1a64"]
