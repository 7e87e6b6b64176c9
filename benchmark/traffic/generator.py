"""The one traffic generator: builds a cell's inputs from its traffic
file (`traffic/<mix>.json`) and the run's seed.

A mix names its `kind`, and the kind's builder is
`traffic/kinds/<kind>.py`, found by that name: `clip_queue` (one client
decoding one clip after another; with a `player` block, MPEG-PS clips of
video and looped MP2) and `clip_jobs` (jobs of many clips decoded in
lockstep, the next job once all have ended).  Each is a closed loop over
clips cut from the configuration's fixture.  A clip is a
sequence of the fixture's self-contained GOPs, each with its sequence
header, so any sequence of them is a valid stream whose displayed frames
are the concatenation of each GOP's frames.

Against seed-to-seed noise every seed gets the same work: the same clip
lengths, spread evenly over the mix's range, and for each length the
same GOPs (`clip_gops`), in another order.
"""

from __future__ import annotations

import hashlib
import math
import os
from dataclasses import dataclass, field

import numpy as np

from ..harness import load_file_module
from .ps_mux import mux_once

SEQUENCE_HEADER = b"\x00\x00\x01\xb3"
PICTURE_START = b"\x00\x00\x01\x00"
MP2_FRAME_SAMPLES = 1152


HERE = os.path.dirname(os.path.abspath(__file__))


class FixtureError(RuntimeError):
    pass


def read_checked(root: str, rel: str, sha256: str) -> bytes:
    """A fixture's bytes; raises unless their SHA-256 is `sha256`."""
    with open(os.path.join(root, rel), "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != sha256:
        raise FixtureError(f"{rel}: SHA-256 {got}, the configuration "
                           f"states {sha256}")
    return data


def split_gops(es: bytes) -> list:
    """The stream cut at each sequence header: one chunk a GOP, each
    starting with its sequence header (a trailing sequence end code, if
    any, is dropped)."""
    starts = []
    i = es.find(SEQUENCE_HEADER)
    while i != -1:
        starts.append(i)
        i = es.find(SEQUENCE_HEADER, i + 4)
    if not starts:
        raise FixtureError("no sequence header")
    ends = starts[1:] + [len(es)]
    chunks = [es[a:b] for a, b in zip(starts, ends)]
    if chunks[-1].endswith(b"\x00\x00\x01\xb7"):
        chunks[-1] = chunks[-1][:-4]
    return chunks


def count_pictures(chunk: bytes) -> int:
    return chunk.count(PICTURE_START)


def mp2_frames(es: bytes) -> list:
    """An MP2 elementary stream cut into its frames (MPEG-1 layer II:
    144 * bitrate / samplerate bytes, plus one when padded)."""
    rates = (32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320,
             384)
    samplerates = (44100, 48000, 32000)
    out, i = [], 0
    while i + 4 <= len(es):
        b = es[i:i + 4]
        if b[0] != 0xFF or (b[1] & 0xE0) != 0xE0:
            raise FixtureError(f"MP2 sync lost at byte {i}")
        br = rates[(b[2] >> 4) - 1] * 1000
        sr = samplerates[(b[2] >> 2) & 3]
        n = 144 * br // sr + ((b[2] >> 1) & 1)
        out.append(es[i:i + n])
        i += n
    return out


@dataclass
class Fixture:
    """A configuration's inputs, checked and cut up: its video, its
    audio, or both."""
    gops: list = field(default_factory=list)           # video ES, a GOP each
    gop_pictures: list = field(default_factory=list)   # pictures in each
    fps: float = 0.0
    audio_frames: list = field(default_factory=list)   # MP2 frames


def load_fixture(config: dict, root: str) -> Fixture:
    fx = Fixture()
    if "video" in config:
        v = config["video"]
        fx.gops = split_gops(read_checked(root, v["fixture"], v["sha256"]))
        fx.gop_pictures = [count_pictures(g) for g in fx.gops]
        fx.fps = v["fps"]
        if fx.gop_pictures != v["gop_pictures"]:
            raise FixtureError(f"GOPs of {fx.gop_pictures} pictures, the "
                               f"configuration states {v['gop_pictures']}")
    if "audio" in config:
        a = config["audio"]
        fx.audio_frames = mp2_frames(
            read_checked(root, a["fixture"], a["sha256"]))
        if len(fx.audio_frames) != a["frames"]:
            raise FixtureError(f"{len(fx.audio_frames)} MP2 frames, the "
                               f"configuration states {a['frames']}")
    return fx


@dataclass
class Clip:
    gops: tuple           # indices into Fixture.gops, in order
    pictures: int         # displayed video frames
    data: bytes           # the ES (or, for a player, the PS)
    audio_frames: int = 0


def audio_frames_for(pictures: int, fps: float, samplerate: int) -> int:
    return math.ceil(pictures / fps * samplerate / MP2_FRAME_SAMPLES)


def clip_gops(fx: Fixture, target: int) -> list:
    """The GOPs of a clip of at least `target` pictures, the same for
    every seed: whole rounds of the fixture's GOPs, then its first GOPs
    in order until the clip reaches the target."""
    per_round = sum(fx.gop_pictures)
    rounds = max(target, 1) // per_round
    gops, n = list(range(len(fx.gops))) * rounds, per_round * rounds
    for g in range(len(fx.gops)):
        if n >= max(target, 1):
            break
        gops.append(g)
        n += fx.gop_pictures[g]
    return gops


def clip(fx: Fixture, rng, target: int, player: dict = None) -> Clip:
    """A clip of at least `target` pictures: `clip_gops` in the order
    `rng` draws; for a player, muxed as MPEG-PS with the MP2 fixture
    looped to its length."""
    gops = clip_gops(fx, target)
    gops = [gops[i] for i in rng.permutation(len(gops))]
    n = sum(fx.gop_pictures[g] for g in gops)
    es = b"".join(fx.gops[g] for g in gops)
    if player is None:
        return Clip(tuple(gops), n, es)
    na = audio_frames_for(n, fx.fps, player["samplerate"])
    audio = b"".join(fx.audio_frames[j % len(fx.audio_frames)]
                     for j in range(na))
    ps = mux_once(es, audio, n / fx.fps,
                  na * MP2_FRAME_SAMPLES / player["samplerate"])
    return Clip(tuple(gops), n, ps, na)


def lengths(lo: int, hi: int, n: int, rng) -> list:
    """n clip lengths spread evenly over [lo, hi], in the seed's order."""
    ls = [round(lo + (hi - lo) * (i + 0.5) / n) for i in range(n)]
    return [ls[i] for i in rng.permutation(n)]


@dataclass
class Traffic:
    kind: str
    warmup: object        # a Clip, or a job (a list of Clips)
    items: list           # Clips, or jobs, taken in turn and cycled
    params: dict


def make(traffic: dict, fx: Fixture, seed: int,
         folder: str = os.path.dirname(HERE)) -> Traffic:
    """The cell's inputs for `seed` (any non-negative integer), built by
    `<folder>/traffic/kinds/<kind>.py`: its `make(traffic, fx, rng,
    warm_rng)` returns (warm-up item, items).  The warm-up is the same
    for every seed."""
    kind = traffic["kind"]
    path = os.path.join(folder, "traffic", "kinds", f"{kind}.py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown traffic kind {kind!r}: no {path}")
    mod = load_file_module(path, f"benchmark_traffic_kind_{kind}")
    warm, items = mod.make(traffic, fx, np.random.default_rng(seed),
                           np.random.default_rng(0))
    return Traffic(kind, warm, items, traffic)
