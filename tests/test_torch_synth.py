"""K4, the MP2 synthesis kernel (`cuda_kernels.synthesize` and
`synthesize_ring`, csrc/synth.cu), held to the JAX package's jitted
synthesis programs.

On the CPU the wrappers run the plain version (`ops.filterbank`); each
result is compared with the JAX program's on the same numpy inputs, made
from a seed, bit for bit (tolerance 0: floats compare as uint32 bits, so
-0.0 differs from +0.0): the ring form from every V position against
`make_synthesize_frame_jax` (values, ring, position); the hist form over 3
streams against `jax.vmap(make_synthesize_parallel_jax())`; the f32 form
against `make_finalize_jax`; the s16 form against
`make_synthesize_parallel_s16_jax`; two chained windows carrying the
history.  Then what the wrappers refuse, on every device.  Then K4's
partition (csrc/synth.cu) mirrored in numpy: which CTA owns which steps,
where each tap's row comes from (the CTA's own rows, a recomputed halo
row, the ring or the hist) and each warp's shared taps, assembled from
the plain `dct32` and an explicit 16-tap loop, bit for bit against the
plain frame and window synthesis at ragged step counts and at every
chunk the host can choose.

The tests marked `cuda` hold K4 against its plain version on the card in
every form, at ragged step counts, check that it refuses misaligned
inputs and count its launches on the decoders' paths; they skip in
their body without a card (run them there with
`python -m pytest --noconftest tests/test_torch_synth.py -q -m cuda`)."""

import pathlib

import numpy as np
import pytest
import torch

from mpeg_tpu_torch.ops import cuda_kernels as ck
from mpeg_tpu_torch.ops import filterbank as tfb
from mpeg_tpu_torch.tables import D_WINDOW
from torch_threads import one_torch_thread  # noqa: F401

TESTDATA = pathlib.Path(__file__).parent / "testdata"
GOLDEN_AUDIO = (355, 0xF1B76CDF8E6CDEA5)      # test.mp2, the no-FMA golden
# The parsers' dequantized subband samples stay within +-2^17; the tests
# reach twice that.
SAMPLE_RANGE = 1 << 18


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


def _samples(rng, streams: int, steps: int, edge: bool = False):
    """int32 [S, T, 2, 32]: random with silent subbands, or (edge) whole
    steps at +-2^18 and whole subbands silent."""
    s = rng.integers(-SAMPLE_RANGE, SAMPLE_RANGE, (streams, steps, 2, 32))
    s[rng.random(s.shape) < 0.3] = 0
    s[:, 0, 0, :4] = (SAMPLE_RANGE - 1, -SAMPLE_RANGE, 1, -1)
    if edge:
        s[:, ::3] = SAMPLE_RANGE
        s[:, 1::3] = -SAMPLE_RANGE
        s[..., 20:] = 0
        s[:, 5::7, 1] = 0
    return s.astype(np.int32)


def _hist(rng, streams: int) -> np.ndarray:
    return (rng.standard_normal((streams, 15, 2, 64)) * 1e4).astype(np.float32)


@pytest.mark.parametrize("v_pos", range(0, 1024, 64))
def test_ring_form_matches_jax_frame(v_pos):
    """One frame from each V position against jitted
    `make_synthesize_frame_jax`: the window outputs, the new ring and
    position; the f32 and s16 forms against the JAX finalize and S16."""
    import jax.numpy as jnp

    import mpeg_tpu.ops.filterbank as jfb

    rng = np.random.default_rng(700 + v_pos)
    x = _samples(rng, 1, 36)
    ring = (rng.standard_normal((1, 2, 1024)) * 3e4).astype(np.float32)
    ju, jv, jpos = jfb.make_synthesize_frame_jax()(
        jnp.asarray(x[0]), jnp.asarray(ring[0]), v_pos)
    u, got_ring, pos = ck.synthesize_ring(torch.from_numpy(x),
                                          torch.from_numpy(ring), v_pos,
                                          out="u")
    assert pos == int(jpos) == (v_pos - 64 * 36) & 1023
    assert u.shape == (1, 36, 2, 32) and got_ring.shape == (1, 2, 1024)
    np.testing.assert_array_equal(_bits(u[0]), _bits(ju))
    np.testing.assert_array_equal(_bits(got_ring[0]), _bits(jv))
    f32, f32_ring, _ = ck.synthesize_ring(torch.from_numpy(x),
                                          torch.from_numpy(ring), v_pos,
                                          out="f32")
    np.testing.assert_array_equal(_bits(f32[0]),
                                  _bits(jfb.make_finalize_jax()(ju)))
    assert torch.equal(f32_ring, got_ring)
    s16, _, _ = ck.synthesize_ring(torch.from_numpy(x),
                                   torch.from_numpy(ring), v_pos, out="s16")
    np.testing.assert_array_equal(s16[0].numpy(),
                                  jfb.s16_from_u(np.asarray(ju), np))


def _jax_window(x, hist):
    import jax
    import jax.numpy as jnp

    import mpeg_tpu.ops.filterbank as jfb

    return jax.vmap(jfb.make_synthesize_parallel_jax())(jnp.asarray(x),
                                                        jnp.asarray(hist))


@pytest.mark.parametrize("edge", [False, True])
def test_hist_form_matches_vmapped_jax(edge):
    """Three streams of a 4-frame window against the vmapped window
    program: the window outputs and the new history."""
    rng = np.random.default_rng(71)
    x, hist = _samples(rng, 3, 144, edge), _hist(rng, 3)
    ju, jhist = _jax_window(x, hist)
    u, new_hist = ck.synthesize(torch.from_numpy(x), torch.from_numpy(hist))
    assert u.shape == (3, 144, 2, 32) and new_hist.shape == (3, 15, 2, 64)
    np.testing.assert_array_equal(_bits(u), _bits(ju))
    np.testing.assert_array_equal(_bits(new_hist), _bits(jhist))


def test_f32_form_matches_jax_finalize():
    """The normalized, interleaved window [S, T * 64] against
    `make_finalize_jax` of the JAX window outputs."""
    import mpeg_tpu.ops.filterbank as jfb

    rng = np.random.default_rng(72)
    x, hist = _samples(rng, 3, 144), _hist(rng, 3)
    ju, jhist = _jax_window(x, hist)
    pcm, new_hist = ck.synthesize(torch.from_numpy(x),
                                  torch.from_numpy(hist), out="f32")
    assert pcm.shape == (3, 144 * 64) and pcm.dtype == torch.float32
    np.testing.assert_array_equal(_bits(pcm),
                                  _bits(jfb.make_finalize_jax()(ju)))
    np.testing.assert_array_equal(_bits(new_hist), _bits(jhist))


def test_s16_form_matches_jax_s16_program():
    """The S16 window against the vmapped
    `make_synthesize_parallel_s16_jax`."""
    import jax
    import jax.numpy as jnp

    import mpeg_tpu.ops.filterbank as jfb

    rng = np.random.default_rng(73)
    x, hist = _samples(rng, 3, 144), _hist(rng, 3)
    js16, jhist = jax.vmap(jfb.make_synthesize_parallel_s16_jax())(
        jnp.asarray(x), jnp.asarray(hist))
    s16, new_hist = ck.synthesize(torch.from_numpy(x),
                                  torch.from_numpy(hist), out="s16")
    assert s16.dtype == torch.int16 and s16.shape == (3, 144 * 64)
    np.testing.assert_array_equal(s16.numpy(), np.asarray(js16))
    np.testing.assert_array_equal(_bits(new_hist), _bits(jhist))


def test_chained_windows_carry_history():
    """Two windows, the history carried, against the JAX chain, and
    together equal to one window of both."""
    rng = np.random.default_rng(74)
    x, hist = _samples(rng, 2, 288), _hist(rng, 2)
    whole, whole_hist = ck.synthesize(torch.from_numpy(x),
                                      torch.from_numpy(hist))
    j_hist, t_hist, parts = hist, torch.from_numpy(hist), []
    for half in (x[:, :144], x[:, 144:]):
        ju, j_hist = _jax_window(np.ascontiguousarray(half), j_hist)
        u, t_hist = ck.synthesize(torch.from_numpy(
            np.ascontiguousarray(half)), t_hist)
        np.testing.assert_array_equal(_bits(u), _bits(ju))
        np.testing.assert_array_equal(_bits(t_hist), _bits(j_hist))
        parts.append(u)
    assert torch.equal(torch.cat(parts, 1).view(torch.int32),
                       whole.view(torch.int32))
    assert torch.equal(t_hist.view(torch.int32), whole_hist.view(torch.int32))


def _refusal(case: str):
    """(call, message) of one input the wrappers refuse."""
    x = torch.zeros((1, 144, 2, 32), dtype=torch.int32)
    hist = torch.zeros((1, 15, 2, 64))
    ring = torch.zeros((1, 2, 1024))
    cases = {
        "samples_dtype": (lambda: ck.synthesize(x.long(), hist),
                          "samples: expected contiguous torch.int32"),
        "samples_rank": (lambda: ck.synthesize(x[0], hist),
                         r"samples: expected \[S, T, 2, 32\]"),
        "samples_shape": (lambda: ck.synthesize(x[..., :31], hist),
                          "samples: expected contiguous"),
        "samples_noncontiguous": (
            lambda: ck.synthesize(torch.zeros((1, 144, 32, 2),
                                              dtype=torch.int32)
                                  .transpose(-1, -2), hist),
            "samples: expected contiguous"),
        "hist_dtype": (lambda: ck.synthesize(x, hist.double()),
                       "hist: expected contiguous torch.float32"),
        "hist_shape": (lambda: ck.synthesize(x, hist[:, :14]),
                       "hist: expected contiguous"),
        "hist_streams": (lambda: ck.synthesize(x, torch.zeros(2, 15, 2, 64)),
                         "hist: expected contiguous"),
        "hist_device": (lambda: ck.synthesize(x, hist.to("meta")),
                        "hist: expected contiguous"),
        "hist_steps": (lambda: ck.synthesize(x[:, :36].contiguous(), hist),
                       "4n whole frames"),
        "hist_no_steps": (lambda: ck.synthesize(x[:, :0], hist),
                          "4n whole frames"),
        "out_form": (lambda: ck.synthesize(x, hist, out="pcm"),
                     "out: one of"),
        "ring_shape": (lambda: ck.synthesize_ring(x, ring[..., :512], 0),
                       "ring: expected contiguous"),
        "ring_noncontiguous": (
            lambda: ck.synthesize_ring(
                x, torch.zeros((1, 1024, 2)).transpose(-1, -2), 0),
            "ring: expected contiguous"),
        "ring_v_pos": (lambda: ck.synthesize_ring(x, ring, 32),
                       "multiple of 64"),
        "ring_v_pos_range": (lambda: ck.synthesize_ring(x, ring, 1024),
                             "multiple of 64"),
        "ring_steps": (lambda: ck.synthesize_ring(x[:, :8].contiguous(),
                                                  ring, 0),
                       "at least 16"),
        "samples_device": (lambda: ck.synthesize(x.to("meta"),
                                                 hist.to("meta")),
                           "unsupported device"),
    }
    return cases[case]


@pytest.mark.parametrize("case", [
    "samples_dtype", "samples_rank", "samples_shape",
    "samples_noncontiguous", "hist_dtype", "hist_shape", "hist_streams",
    "hist_device", "hist_steps", "hist_no_steps", "out_form", "ring_shape",
    "ring_noncontiguous", "ring_v_pos", "ring_v_pos_range", "ring_steps",
    "samples_device"])
def test_wrappers_refuse(case):
    call, message = _refusal(case)
    before = ck.synthesize.launches
    with pytest.raises(ValueError, match=message):
        call()
    assert ck.synthesize.launches == before


def test_no_streams_give_empty_results():
    x = torch.zeros((0, 144, 2, 32), dtype=torch.int32)
    pcm, hist = ck.synthesize(x, torch.zeros((0, 15, 2, 64)), out="s16")
    assert pcm.shape == (0, 144 * 64) and pcm.dtype == torch.int16
    assert hist.shape == (0, 15, 2, 64)
    u, ring, pos = ck.synthesize_ring(x, torch.zeros((0, 2, 1024)), 64,
                                      out="u")
    assert u.shape == (0, 144, 2, 32) and ring.shape == (0, 2, 1024)
    assert pos == (64 - 64 * 144) & 1023


def test_synth_bound_counts_the_window():
    """A 32-frame window: 294,912 B of samples and of f32 PCM and 7,680 B
    of history each way; bytes bound it.  A frame from a ring reads the
    15 previous blocks (7,680 B) and writes the whole ring (8,192 B)."""
    b = ck.synth_bound(1, 32 * 36, "f32")
    assert b["bytes"] == 2 * 294_912 + 2 * 7_680
    assert b["bound_by"] == "bytes"
    assert b["us"] == pytest.approx(b["bytes"] / ck.HBM_BYTES_PER_S * 1e6)
    assert ck.synth_bound(1, 32 * 36, "s16")["bytes"] == \
        294_912 + 147_456 + 2 * 7_680
    assert ck.synth_bound(1, 36, "f32", ring=True)["bytes"] == \
        2 * 36 * 256 + 7_680 + 8_192 == 34_304


# ---------------------------------------------------------------------------
# K4's partition (csrc/synth.cu), mirrored in numpy
# ---------------------------------------------------------------------------

H100_SMS = 132
MIN_CHUNK, MAX_CHUNK, HALO, WARPS = 4, 96, 15, 16


def _chunk_steps(streams: int, steps: int, sms: int = H100_SMS) -> int:
    """synth.cu `chunk_steps`: steps a CTA, as many as one CTA a SM for
    all streams needs, within [4, 96]."""
    ctas = max(1, sms // streams)
    return min(max(-(-steps // ctas), MIN_CHUNK), MAX_CHUNK)


def _k4_mirror(x: np.ndarray, history: np.ndarray, v_pos: int, ring: bool,
               chunk: int):
    """One stream through K4's schedule: CTA c owns steps [c * chunk,
    (c + 1) * chunk); its rows are the 15 blocks before its first step and
    its own, the first from the ring or the hist where they lie before the
    call, else recomputed with the plain `dct32`; warp w of a CTA runs the
    steps w, w + 16, ... with the taps of the first of them, each output's
    16 products summed in float32 in that order.  Returns (u [T, 2, 32],
    the new ring or hist, {tap source: count})."""
    steps = x.shape[0]
    blocks = tfb.dct32(torch.from_numpy(x)).numpy()          # [T, 2, 64]
    dwin = np.asarray(D_WINDOW, np.float32)
    phase = v_pos >> 6 if ring else 0
    lane = np.arange(32)
    u = np.empty((steps, 2, 32), np.float32)
    sources = {"own": 0, "recomputed": 0, "ring": 0, "hist": 0}
    kept = {}                                   # step -> its block, as held
    for t0 in range(0, steps, chunk):
        n = min(chunk, steps - t0)
        first = max(0, HALO - t0)
        rows = np.empty((HALO + n, 2, 64), np.float32)
        for r in range(first):           # block 15 - t0 - r before step 0
            k = HALO - t0 - r
            if ring:
                p = (v_pos + 64 * (k - 1)) & 1023
                rows[r] = history[:, p:p + 64]
            else:
                rows[r] = history[k - 1]
        rows[first:] = blocks[t0 - HALO + first:t0 + n]
        for tl in range(max(0, steps - (16 if ring else HALO) - t0), n):
            kept[t0 + tl] = rows[HALO + tl]
        tl = np.arange(n)
        vp = (64 * (phase - t0 - tl % WARPS - 1)) & 1023   # each warp's
        d_index, v_index = 512 - (vp >> 1), (vp & 127) >> 1
        acc = np.zeros((n, 2, 32), np.float32)
        for k in range(16):
            if k == 8:
                d_index = d_index - (512 - 32)
                v_index = (128 - 32 + 1024) - v_index
            r = (v_index - vp) & 1023
            row, off = HALO + tl - (r >> 6), r & 63
            sources["own"] += int((row >= HALO).sum())
            sources["recomputed"] += int(((row >= first) & (row < HALO))
                                         .sum())
            sources["ring" if ring else "hist"] += int((row < first).sum())
            taps = rows[row[:, None, None], np.arange(2)[:, None],
                        (off[:, None] + lane)[:, None, :]]
            acc = acc + dwin[d_index[:, None] + lane][:, None, :] * taps
            v_index = v_index + 128
            d_index = d_index + 64
        u[t0:t0 + n] = acc
    if ring:
        new_pos = (v_pos - 64 * steps) & 1023
        state = np.empty((2, 1024), np.float32)
        for t, blk in kept.items():
            p = (new_pos + 64 * (steps - 1 - t)) & 1023
            state[:, p:p + 64] = blk
    else:
        state = np.stack([kept[steps - 1 - j] for j in range(HALO)])
    return u, state, sources


def _check_mirror(x, history, v_pos, ring, chunk):
    got_u, got_state, sources = _k4_mirror(x, history, v_pos, ring, chunk)
    if ring:
        u, state, _ = tfb.synthesize_frame(torch.from_numpy(x),
                                           torch.from_numpy(history), v_pos)
    else:
        u, state = tfb.synthesize_window(torch.from_numpy(x),
                                         torch.from_numpy(history))
    np.testing.assert_array_equal(_bits(got_u), _bits(u), f"chunk {chunk}")
    np.testing.assert_array_equal(_bits(got_state), _bits(state))
    # The history is read exactly by the taps of the first 15 steps that
    # reach before step 0: 15 + 14 + ... + 1.
    assert sources["ring" if ring else "hist"] == 120
    steps = x.shape[0]
    assert sum(sources.values()) == 16 * steps
    assert (sources["recomputed"] > 0) == (steps > chunk)
    return sources


@pytest.mark.parametrize("v_pos", range(0, 1024, 64))
def test_k4_partition_ring_form_matches_plain(v_pos):
    """The ring form's schedule at the ragged step counts 16, 17, 36 and
    53 from every V position, at every chunk the host can choose below
    the step count (and one CTA), against `filterbank.synthesize_frame`
    bit for bit."""
    rng = np.random.default_rng(800 + v_pos)
    for steps in (16, 17, 36, 53):
        x = _samples(rng, 1, steps, steps == 17)[0]
        ring = (rng.standard_normal((2, 1024)) * 3e4).astype(np.float32)
        for chunk in range(MIN_CHUNK, min(steps, MAX_CHUNK) + 1):
            _check_mirror(x, ring, v_pos, True, chunk)


@pytest.mark.parametrize("steps", [48, 1168])
def test_k4_partition_hist_form_matches_plain(steps):
    """The hist form's schedule at 48 and 1,168 steps, at every chunk the
    host can choose, against `filterbank.synthesize_window` bit for bit."""
    rng = np.random.default_rng(900 + steps)
    x, hist = _samples(rng, 1, steps)[0], _hist(rng, 1)[0]
    for chunk in range(MIN_CHUNK, min(steps, MAX_CHUNK) + 1):
        _check_mirror(x, hist, 0, False, chunk)


def test_k4_chunk_choice():
    """The chunks the host picks on an H100 (132 SMs): a frame takes 9
    CTAs of 4 steps, a 32-frame window 128 CTAs of 9, 8 streams' windows
    128 CTAs of 72 (one CTA a SM, one wave); at most 96 steps, so a CTA's
    MAC takes at most 6 steps a warp; each thread at most 2 outputs for a
    frame or a window."""
    assert _chunk_steps(1, 36) == 4 and -(-36 // 4) == 9
    assert _chunk_steps(1, 1152) == 9 and -(-1152 // 9) == 128
    assert _chunk_steps(8, 1152) == 72 and 8 * -(-1152 // 72) == 128
    assert _chunk_steps(64, 1152) == MAX_CHUNK
    assert _chunk_steps(200, 16) == 16
    for streams, steps in ((1, 36), (2, 53), (1, 1168), (8, 1168), (4, 576)):
        chunk = _chunk_steps(streams, steps)
        assert MIN_CHUNK <= chunk <= MAX_CHUNK
        assert streams * -(-steps // chunk) <= H100_SMS or chunk == MAX_CHUNK
    for steps in (36, 1152):            # outputs a thread: 2 a step a warp
        assert 2 * -(-_chunk_steps(1, steps) // WARPS) == 2


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _plain_form(u, out):
    if out == "f32":
        return tfb.finalize(u)
    return tfb.s16_from_u(u) if out == "s16" else u


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("steps", [16, 48, 144, 1152, 1168])
@pytest.mark.parametrize("streams", [1, 8])
def test_k4_hist_form_matches_plain_on_card(streams, steps, edge):
    dev = _card()
    rng = np.random.default_rng(streams * 1000 + steps + edge)
    x = torch.from_numpy(_samples(rng, streams, steps, edge)).to(dev)
    hist = torch.from_numpy(_hist(rng, streams)).to(dev)
    plain = [tfb.synthesize_window(x[s], hist[s]) for s in range(streams)]
    u = torch.stack([p[0] for p in plain])
    want_hist = torch.stack([p[1] for p in plain])
    for out in ("u", "f32", "s16"):
        before = ck.synthesize.launches
        got, got_hist = ck.synthesize(x, hist, out=out)
        torch.cuda.synchronize()
        assert ck.synthesize.launches == before + 1
        assert _same(got, _plain_form(u, out)), out
        assert _same(got_hist, want_hist), out


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("steps", [16, 17, 36, 53, 144, 1152])
@pytest.mark.parametrize("streams", [1, 8])
def test_k4_ring_form_matches_plain_on_card(streams, steps, edge):
    dev = _card()
    rng = np.random.default_rng(streams * 1000 + steps + edge + 1)
    x = torch.from_numpy(_samples(rng, streams, steps, edge)).to(dev)
    ring = torch.from_numpy((rng.standard_normal((streams, 2, 1024)) * 3e4)
                            .astype(np.float32)).to(dev)
    for v_pos in (0, 64, 448, 960):
        plain = [tfb.synthesize_frame(x[s], ring[s], v_pos)
                 for s in range(streams)]
        u = torch.stack([p[0] for p in plain])
        want_ring = torch.stack([p[1] for p in plain])
        for out in ("u", "f32", "s16"):
            got, got_ring, pos = ck.synthesize_ring(x, ring, v_pos, out=out)
            torch.cuda.synchronize()
            assert pos == plain[0][2]
            assert _same(got, _plain_form(u, out)), (v_pos, out)
            assert _same(got_ring, want_ring), (v_pos, out)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["samples", "hist", "ring"])
def test_k4_refuses_misaligned_inputs_on_card(which):
    """K4 copies in 16-byte pieces: a view that starts 4 bytes into its
    storage is refused before any launch."""
    dev = _card()
    flat = torch.zeros(1 + 144 * 64, dtype=torch.int32, device=dev)
    x = torch.zeros((1, 144, 2, 32), dtype=torch.int32, device=dev)
    hist = torch.zeros((1, 15, 2, 64), device=dev)
    ring = torch.zeros((1, 2, 1024), device=dev)
    if which == "samples":
        x = flat[1:].view(1, 144, 2, 32)
    elif which == "hist":
        hist = torch.zeros(1 + hist.numel(), device=dev)[1:].view(1, 15, 2, 64)
    else:
        ring = torch.zeros(1 + ring.numel(), device=dev)[1:].view(1, 2, 1024)
    before = ck.synthesize.launches
    with pytest.raises(ValueError, match=f"{which}: K4 needs its data 16-byte"):
        if which == "ring":
            ck.synthesize_ring(x, ring, 0)
        else:
            ck.synthesize(x, hist)
    assert ck.synthesize.launches == before


@pytest.mark.cuda
def test_k4_launches_on_the_decoders_paths():
    """`Audio` launches K4 once a frame (and gives the golden),
    `BatchAudioDecoder` once a window, the sharded synthesis once a
    shard."""
    import io

    from mpeg_tpu_torch import Audio, Buffer
    from mpeg_tpu_torch.parallel import BatchAudioDecoder
    from mpeg_tpu_torch.parallel import sharding as sh
    from mpeg_tpu_torch.utils import Fnv1a64

    _card()
    data = (TESTDATA / "test.mp2").read_bytes()
    buf = Buffer(io.BytesIO(data))
    buf.set_load_callback(buf.load_reader_callback)
    audio = Audio(buf, device="cuda")
    ck.reset_launches()
    h, n = Fnv1a64(), 0
    while (s := audio.decode()) is not None:
        h.write(s.interleaved.astype("<f4").tobytes())
        n += 1
    assert (n, h.sum64()) == GOLDEN_AUDIO
    assert ck.synthesize.launches == n
    ck.reset_launches()
    dec = BatchAudioDecoder(data, window=32, device="cuda")
    windows = 0
    while dec.decode_window() is not None:
        windows += 1
    assert ck.synthesize.launches == windows == -(-n // 32)
    mesh = sh.make_mesh(["cuda:0", "cuda:0"])
    rng = np.random.default_rng(75)
    ck.reset_launches()
    u, hist, _ = sh.make_sharded_audio_synth(mesh)(
        _samples(rng, 8, 144), sh.zero_audio_hist(8, mesh))
    torch.cuda.synchronize()
    assert ck.synthesize.launches == 2
    assert [t.shape[0] for t in u] == [4, 4]
