"""Decoder defaults (the port's copy of `mpeg_tpu/config.py`, with what
`BatchVideoDecoder` reads).

Pass a `Config` to `BatchVideoDecoder` to override its defaults in one
place; explicit keyword arguments still win over the Config.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    # Batched decode knobs.
    window: int = 32          # pictures per window blob
    transport: str = "blob"   # "blob" (window pool) | "dense" (still to port)

    # Buffer refill chunk (reference BufferSize, buffer.go:8-11).
    buffer_size: int = 128 * 1024


DEFAULT = Config()
