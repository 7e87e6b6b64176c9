"""The port's MP2 synthesis filterbank (`mpeg_tpu_torch.ops.filterbank`)
against the JAX package's (`mpeg_tpu.ops.filterbank`) on the CPU, bit for
bit (tolerance 0): the matrixing DCT, the per-frame synthesis from every
V write position, the window synthesis and its S16 form, the exact
constant divisor, the finalize and the S16 quantization at their edges."""

import numpy as np
import pytest
import torch

import mpeg_tpu.ops.filterbank as jfb
from mpeg_tpu_torch.ops import filterbank as tfb
from torch_threads import one_torch_thread  # noqa: F401

# The dequantized subband samples the parsers emit stay within +-2^17
# (a 16-bit level difference times a scale factor below 2^13, >> 12).
SAMPLE_RANGE = 1 << 18


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.uint32)


def _samples(rng, steps: int) -> np.ndarray:
    s = rng.integers(-SAMPLE_RANGE, SAMPLE_RANGE, (steps, 2, 32))
    # Silent subbands and full-scale edges, as real frames have.
    s[rng.random(s.shape) < 0.3] = 0
    s[0, 0, :4] = (SAMPLE_RANGE - 1, -SAMPLE_RANGE, 1, -1)
    return s.astype(np.int32)


def test_dct32_matches_jax_oracle():
    rng = np.random.default_rng(1)
    x = _samples(rng, 512)
    got = tfb.dct32(torch.from_numpy(x)).numpy()
    want = jfb.dct32(x.astype(np.int64), np)
    assert got.dtype == np.float32 and got.shape == (512, 2, 64)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("v_pos", range(0, 1024, 64))
def test_synthesize_frame_matches_oracle(v_pos):
    """One frame from every V write position (frames start at multiples
    of 256, a restored state at any multiple of 64), from a seeded
    non-zero ring: the window outputs, the new ring and position."""
    rng = np.random.default_rng(100 + v_pos)
    samples = _samples(rng, 36)
    v = (rng.standard_normal((2, 1024)) * 3e4).astype(np.float32)
    u, v_want, pos_want = jfb.synthesize_frame_np(samples, v.copy(), v_pos)
    tu, tv, tpos = tfb.synthesize_frame(torch.from_numpy(samples),
                                        torch.from_numpy(v), v_pos)
    assert tpos == pos_want
    np.testing.assert_array_equal(_bits(tu.numpy()), _bits(u))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(v_want))


def test_synthesize_frame_refuses_unaligned_position():
    with pytest.raises(ValueError, match="multiple of 64"):
        tfb.synthesize_frame(torch.zeros((36, 2, 32), dtype=torch.int32),
                             torch.zeros((2, 1024)), 32)


def test_history_and_ring_round_trip():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((2, 1024)).astype(np.float32)
    for v_pos in (0, 64, 448, 960):
        hist = tfb.hist_from_v(torch.from_numpy(v), v_pos).numpy()
        np.testing.assert_array_equal(hist, jfb.hist_from_v(v, v_pos))
        blocks = rng.standard_normal((16, 2, 64)).astype(np.float32)
        np.testing.assert_array_equal(
            tfb.v_from_hist(torch.from_numpy(blocks), v_pos).numpy(),
            jfb.v_from_hist(blocks, v_pos))


def test_window_synthesis_matches_jax():
    """Two windows of 4 frames through `synthesize_window` and its S16
    form, the history carried, against `make_synthesize_parallel_jax` and
    `make_synthesize_parallel_s16_jax` on the same inputs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    synth = jfb.make_synthesize_parallel_jax()
    synth_s16 = jfb.make_synthesize_parallel_s16_jax()
    hist = (rng.standard_normal((15, 2, 64)) * 1e4).astype(np.float32)
    j_hist, t_hist = jnp.asarray(hist), torch.from_numpy(hist)
    for _ in range(2):
        x = _samples(rng, 144)
        u_want, j_next = synth(jnp.asarray(x), j_hist)
        s16_want, _ = synth_s16(jnp.asarray(x), j_hist)
        u, t_next = tfb.synthesize_window(torch.from_numpy(x), t_hist)
        s16, t_next16 = tfb.synthesize_window_s16(torch.from_numpy(x), t_hist)
        np.testing.assert_array_equal(_bits(u.numpy()),
                                      _bits(np.asarray(u_want)))
        np.testing.assert_array_equal(s16.numpy(), np.asarray(s16_want))
        np.testing.assert_array_equal(t_next.numpy(), np.asarray(j_next))
        assert torch.equal(t_next, t_next16)
        j_hist, t_hist = j_next, t_next
    with pytest.raises(ValueError, match="4n whole frames"):
        tfb.synthesize_window(torch.from_numpy(x[:36]), t_hist)


def _edge_bits(rng, n: int) -> np.ndarray:
    """Seeded f32 bit patterns over the whole exponent range, with the
    mantissa branch cut at M = 65 * 2^17, the rounding carry into the
    exponent, zeros, subnormals, the smallest normals and inf."""
    bits = ((rng.integers(0, 1 << 23, n).astype(np.uint32)) |
            (rng.integers(1, 255, n).astype(np.uint32) << 23) |
            (rng.integers(0, 2, n).astype(np.uint32) << 31))
    directed = []
    for m in list(range((65 << 17) - 3, (65 << 17) + 4)) + \
            list(range(1 << 23, (1 << 23) + 8)) + \
            list(range((1 << 24) - 8, 1 << 24)):
        for e in (1, 2, 100, 103, 104, 127, 200, 254):
            directed.append((m & 0x7FFFFF) | (e << 23))
    subnormal = [1, 2, 0x400000, 0x7FFFFF]
    special = [0, 0x7F800000]
    all_bits = np.concatenate([bits, np.asarray(directed + subnormal +
                                                special, np.uint32)])
    return np.concatenate([all_bits, all_bits | np.uint32(0x80000000)])


def test_div_out_scale_exact_matches_numpy():
    u = _edge_bits(np.random.default_rng(11), 100_000).view(np.float32)
    got = tfb.div_out_scale_exact(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jfb.div_out_scale_exact(u, np)))
    # ... which is the IEEE quotient wherever that is normal.
    with np.errstate(all="ignore"):
        want = u / np.float32(jfb.OUT_SCALE)
    normal = np.isfinite(want) & (np.abs(want) >= np.float32(2 ** -126))
    np.testing.assert_array_equal(_bits(got)[normal], _bits(want)[normal])


def test_finalize_matches_numpy():
    """The IEEE quotient, subnormal results included, interleaved."""
    bits = _edge_bits(np.random.default_rng(12), 20_000)
    bits = np.concatenate([bits, np.zeros(-bits.size % 64, np.uint32)])
    u = bits.view(np.float32).reshape(-1, 2, 32)
    got = tfb.finalize(torch.from_numpy(u)).numpy()
    with np.errstate(all="ignore"):
        want = jfb.finalize_np(u)
    assert got.shape == (bits.size,)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (np.abs(want) < np.float32(2 ** -126)).any()   # subnormals hit


def test_s16_from_u_edges_match_numpy():
    """S16 at the quantizer edges: quotients of exactly +-1 (the 0x7FFF
    and 0x8000 scales), one ulp either side, past full scale (int32 ->
    int16 wraps), and tiny and subnormal quotients (truncate to 0)."""
    scale = np.float32(jfb.OUT_SCALE)
    s = np.array([1.0, -1.0, 0.5, -0.5, 1.5, -1.5, 1.9999, -1.9999,
                  3.0, -3.0, 2 ** -15, -(2 ** -15), 2 ** -16, 1e-30,
                  -1e-40, 0.0, -0.0], np.float32)
    s = np.concatenate([s, np.nextafter(s, np.float32(np.inf)),
                        np.nextafter(s, np.float32(-np.inf))])
    u = np.resize(s * scale, 36 * 2 * 32).reshape(36, 2, 32)
    got = tfb.s16_from_u(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, jfb.s16_from_u(u, np))
    # The host lane (Samples.s16) on the exact quotients.
    q = jfb.finalize_np(u)
    want = np.trunc(np.where(q < 0, q * np.float32(0x8000),
                             q * np.float32(0x7FFF))).astype(np.int16)
    np.testing.assert_array_equal(got, want)
    assert {0x7FFF, -0x8000} <= set(got.tolist())
