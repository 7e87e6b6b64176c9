"""What the plain reference expects of a configuration, worked out once
a checkout and kept in `build/benchmark/` under the fixture's SHA-256
and a digest of the reference's sources.

For video: each GOP's displayed frames and each picture's counts for the
rooflines.  A clip's frames are the concatenation of its GOPs', with one
care: the parse of a GOP's last picture reads past its end, so that
picture decodes one way when the next GOP's sequence header follows and
another at the end of the stream.  So each GOP is decoded twice, once
followed by a GOP ("frames") and once alone ("frames_eof", for a
clip's last GOP).

For audio: five passes of the MP2 fixture decoded back to back.  The
filterbank's state carries across passes: its V ring is rewritten whole
within a frame, but a pass starts at a ring position that moves by 768
of 1,024 floats a pass (355 frames of 36 steps of 64), and the position
sets the order of the window's sums.  So the first pass (from the zero
state) stands alone and later passes repeat with a period of four;
`benchmark/tests` holds the reference to that.

The cache holds nothing that the measured program made.
"""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

from . import reference as ref
from .reference import tables as T
from .reference.recon import idct_batch_bf16
from .reference.video import Video
from .traffic import generator

HERE = os.path.dirname(os.path.abspath(__file__))
LOOPS = 5   # passes of the MP2 fixture: the first, then a period of four
_PREMULT = np.asarray(T.PREMULTIPLIER_MATRIX, np.int64)


def source_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(HERE, "reference", "*.py"))) \
            + [os.path.abspath(__file__)]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def picture_counts(plan, mb_size: int) -> list:
    """[coded blocks, predicted blocks, main records, escape records] of
    one picture's plan: the quantities the roofline byte counts take.  A
    nonzero coefficient that is an int16 multiple of its premultiplier
    is a main record (4 B), any other an escape (6 B)."""
    coded = plan.nblocks > 0
    predicted = ~(coded & (plan.intra_blk > 0))
    flat = plan.coeffs.reshape(-1).astype(np.int64)
    idx = np.flatnonzero(flat)
    v, p = flat[idx], _PREMULT[idx & 63]
    q = v // p
    main = (q * p == v) & (q >= -32768) & (q <= 32767)
    return [int(coded.sum()), int(predicted.sum()), int(main.sum()),
            int((~main).sum())]


def _decode_gop(chunk: bytes, n: int = None, control: bool = False):
    """(frames [n, frame_size] uint8, counts [n, 4], geometry) of the
    first `n` displayed frames of a stream of self-contained GOPs (all
    when `n` is None), through the reference with its plans read."""
    counts = []
    video = Video(ref._buffer(chunk),
                  idct=idct_batch_bf16 if control else None)

    recon = video._reconstruct

    def counting():
        recon()
        counts.append(picture_counts(video._plan, video.geom.mb_size))
    video._reconstruct = counting
    frames = []
    while (n is None or len(frames) < n) and \
            (f := video.decode()) is not None:
        frames.append(np.array(f.flat[:video.geom.frame_size]))
    counts = counts[:len(frames)]
    g = video.geom
    geom = {"mb_size": g.mb_size, "frame_size": g.frame_size,
            "total_size": g.total_size}
    return np.stack(frames), np.asarray(counts, np.int64), geom


def expected(config: dict, root: str, cache_dir: str,
             control: bool = False) -> dict:
    """The reference's expectation for `config` (loaded from the cache
    when it holds it).  For a configuration with video: "gop_frames" and
    "gop_frames_eof" (one [n, frame_size] array a GOP, followed by a GOP
    and at the end of the stream), "gop_counts" (one [n, 4] array a GOP)
    and "geom"; with audio: "pcm" [LOOPS * frames, 2304] float32."""
    fx = generator.load_fixture(config, root)
    key = [config[part]["sha256"][:16] for part in ("video", "audio")
           if part in config]
    name = f"{'ctl' if control else 'ref'}-{'-'.join(key)}-" \
        f"{source_digest()}.npz"
    path = os.path.join(cache_dir, name)
    if os.path.exists(path):
        z = np.load(path)
        out = {}
        if "n_gops" in z:
            n = int(z["n_gops"])
            out = {"gop_frames": [z[f"frames{i}"] for i in range(n)],
                   "gop_frames_eof": [z[f"eof{i}"] for i in range(n)],
                   "gop_counts": [z[f"counts{i}"] for i in range(n)],
                   "geom": {k: int(z[k]) for k in
                            ("mb_size", "frame_size", "total_size")}}
        if "pcm" in z:
            out["pcm"] = z["pcm"]
        return out
    arrays, out = {}, {}
    if fx.gops:
        frames, eofs, counts = [], [], []
        for i, chunk in enumerate(fx.gops):
            n = fx.gop_pictures[i]
            f, c, geom = _decode_gop(chunk + fx.gops[0], n, control)
            e = _decode_gop(chunk, None, control)[0]
            if len(f) != n or len(e) != n or len(c) != n:
                raise RuntimeError(f"GOP {i}: the reference displayed "
                                   f"{len(f)} and {len(e)} frames of {n}")
            frames.append(f)
            eofs.append(e)
            counts.append(c)
            arrays[f"frames{i}"], arrays[f"eof{i}"] = f, e
            arrays[f"counts{i}"] = c
        out = {"gop_frames": frames, "gop_frames_eof": eofs,
               "gop_counts": counts, "geom": geom}
        arrays.update(n_gops=len(fx.gops), **geom)
    if fx.audio_frames:
        loops = b"".join(fx.audio_frames) * LOOPS
        pcm = ref.decode_audio(loops, control)
        if len(pcm) != LOOPS * len(fx.audio_frames):
            raise RuntimeError(f"the reference decoded {len(pcm)} MP2 "
                               f"frames of {LOOPS * len(fx.audio_frames)}")
        out["pcm"] = arrays["pcm"] = pcm
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".part.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return out


def clip_frame(exp: dict, gops: tuple, k: int) -> np.ndarray:
    """Displayed frame k of the clip made of `gops`."""
    for i, g in enumerate(gops):
        n = len(exp["gop_frames"][g])
        if k < n:
            last = i == len(gops) - 1
            return exp["gop_frames_eof" if last else "gop_frames"][g][k]
        k -= n
    raise IndexError("past the clip's last frame")


def pcm_frame(exp: dict, j: int) -> np.ndarray:
    """Audio frame j of the MP2 fixture looped without end."""
    n = len(exp["pcm"]) // LOOPS
    loop, i = divmod(j, n)
    if loop >= LOOPS:
        loop = 1 + (loop - 1) % (LOOPS - 1)
    return exp["pcm"][loop * n + i]
