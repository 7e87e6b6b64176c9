"""Decoder defaults (the port's copy of `mpeg_tpu/config.py`).

Mirrors the reference's config mechanisms: `backend` and `parser` select
the compute backend and the host parser, `BufferSize` is carried over
verbatim, and the runtime setters (audio format/stream/lead time, loop,
no-delay, probe size) live on the decoder objects as in the reference.
Pass a `Config` to `MPEG`, `Video`, `Audio` or `BatchVideoDecoder` to
override their defaults in one place; explicit arguments still win over
the Config.  The device is an argument of each entry point
(`device="cuda"` by default), not a field here.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    # Compute backend of the per-frame decode paths: "torch" (the only
    # one; `device` picks the card or the CPU).  `Video` also takes
    # "plan" (parse only).  The JAX package's "jax" and "numpy" raise.
    backend: str = "torch"

    # Host parser: "native" (C++) or "python"; "auto" picks native when
    # the shared object builds/loads.
    parser: str = "auto"

    # Batched decode knobs.
    window: int = 32          # pictures per window blob
    transport: str = "blob"   # "blob" (window pool) | "dense" (stacked plans)

    # Buffer refill chunk (reference BufferSize, buffer.go:8-11).
    buffer_size: int = 128 * 1024

    # Audio defaults (reference SetAudioFormat/SetAudioLeadTime).
    audio_format: int = 0        # AudioFormat.F32N
    audio_lead_time: float = 0.0


DEFAULT = Config()
