// K4: the MP2 synthesis filterbank on Hopper, one launch a call.
//
// Replaces the JAX package's jitted synthesis programs, none of which is a
// pallas_call: make_synthesize_frame_jax (mpeg_tpu/ops/filterbank.py:475, a
// lax.scan over the V ring, one dispatch a frame), make_synthesize_parallel_jax
// (:575, one program a window), its S16 form make_synthesize_parallel_s16_jax
// (:442) and make_finalize_jax (:423); the sharded synthesis vmaps the window
// program over streams (mpeg_tpu/parallel/sharding.py).  The plain version is
// mpeg_tpu_torch/ops/filterbank.py; K4 is bit-exact with it.
//
// Plain C entry points loaded with ctypes by mpeg_tpu_torch/ops/_build.py,
// which builds this file into its own library.  mt_synthesize returns the
// cudaGetLastError() code seen right after its launch.
//
// The function.  samples: int32 [S, T, 2, 32] (36 steps a frame).  History,
// one of: the V ring float [S, 2, 1024] whose last write position is v_pos (a
// multiple of 64; the 15 previous blocks sit at (v_pos + 64 j) & 1023), or
// hist float [S, 15, 2, 64], the previous 15 DCT blocks newest first, with the
// write position 0 on entry.  Step t writes its block at V position
// (64 (phase - t - 1)) & 1023, phase = v_pos / 64 (0 for hist), and its window
// output reads 16 blocks: its own and the 15 before it.  Output, one of: u,
// the raw window outputs float [S, T, 2, 32]; f32, u / OUT_SCALE (the IEEE
// quotient) L/R interleaved to [S, T * 64]; s16, the reference's AudioS16
// lane interleaved to int16 [S, T * 64].  New state: a fresh ring (the call's
// last 16 blocks; T >= 16) or a fresh hist (the last 15; T % 16 == 0).  The
// state is never written in place: CTAs read the old one while others write.
//
// Numeric contract (the reference decoder's no-FMA regime, bit for bit):
// - every float multiply, add and subtract is __fmul_rn / __fadd_rn /
//   __fsub_rn, rounded on its own, and _build.py compiles this file with
//   -fmad=false besides (never --use_fast_math);
// - the DCT is the reference's butterfly statement for statement, one thread
//   a block: the int32 sum or difference first (wrapping), then
//   __int2float_rn, then the constant multiply; entry 16 of a block is +0.0
//   and entries 17-63 are x * -1.0f, so +0.0 becomes -0.0;
// - each output is one thread's chain: the windowed MAC starts from +0.0f and
//   adds its 16 products one at a time in the order of the reference's
//   two-pass synthWindow loop (filterbank.py window_offsets), which depends on
//   the step's V position; no sum is split across threads;
// - f32 divides with __fdiv_rn (IEEE, subnormal results kept, like torch's
//   division by a device tensor); s16 divides with the plain version's exact
//   integer form (div_out_scale_exact), then truncates to int32 and wraps to
//   int16.
// The constants (the butterfly's 31 and the 1024-entry D window, padded to
// 1,056 floats) come from the wrapper as one float tensor, the very values the
// plain version uses.
//
// Bound.  A 32-frame window moves ~0.6 MB and does ~3 M float ops: 0.18 us of
// the card's memory rate, far below one launch (an empty kernel of this
// shape takes ~1.9 us queued), so what bounds K4 is the launch and the
// critical path of its longest CTA, not bytes.  A simpler layout (32 steps a
// CTA, 256 threads, one thread an output) measured on an H100 ~1.3 us of
// prologue (strided load -> shared store loops over the constants, the
// samples and the history, one after another), ~0.3 of DCT and ~2.8 of MAC
// (8 serial rounds a frame's first CTA, each spending ~100 integer
// instructions on tap addresses) above that floor; 8 streams took 288 CTAs
// that each recomputed 15 halo blocks.
//
// Design.  A grid of (chunk of C steps, stream) CTAs of 512 threads, C chosen
// on the host from the call's shape (chunk_steps): as large as one CTA a SM
// for all streams needs, within [4, 96].  So a frame (36 steps) takes 9 CTAs
// of 4 steps and a 32-frame window 128 CTAs of 9, each thread at most 2
// outputs; 8 streams' windows take 128 CTAs of 72 steps, one wave, with 15
// recomputed blocks in 87.
// - Prologue: every global read of a CTA is a 16-byte cp.async issued before
//   one wait (cp.async.wait_all): the 1,056 constants, its samples rows
//   (landed at a stride of 36 ints a row and channel, so the DCT threads'
//   16-byte reads hit 8 distinct bank quads) and, in a chunk that starts
//   within 15 steps of the call's first, the history rows before it (a ring
//   row is 64 contiguous floats at (v_pos + 64 k) & 1023, one aligned 256-byte
//   run).  So the pointers must be 16-byte aligned: mt_synthesize refuses
//   others.
// - DCT: one thread a block and channel, all of a CTA's blocks in one round
//   (2 (C + 15) <= 222 threads, counted from the CTA's last thread): its own
//   steps' and the halo steps' that lie in this call, recomputed rather than
//   shared between CTAs (a copy that skips the recompute is no faster at 8
//   streams, so a thread-block cluster would save nothing), written as float4
//   at a row stride of 148 floats and a channel stride of 80 (each quarter
//   warp's 16-byte stores hit 8 distinct bank quads).
// - MAC: warp w takes the steps w, w + 16, ... of its chunk, which share the
//   V position's residue and so the 16 taps.  Its lanes load their 16 window
//   coefficients and compute their tap offsets while the DCT runs (in a short
//   chunk those warps do no DCT), then run both channels' chains of each of
//   their steps (32 shared loads a step, conflict-free) and write the L/R pair
//   as one 8-byte (f32) or 4-byte (s16) store.
// - The CTAs that hold the call's last 16 (ring) or 15 (hist) blocks write
//   them to the new state as float4.
// Dynamic shared memory: 4 (1,056 + 220 (C + 15)) bytes, 101,904 at C = 96;
// above 48 KB the launch raises the kernel's limit first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;      // 16: one V-position residue each
constexpr int kMinChunk = 4;               // steps a CTA, at least
constexpr int kMaxChunk = 96;              // and at most
constexpr int kHalo = 15;                  // blocks before a step its taps read
// Shared layout: the constants, then the DCT rows (channel 0 at 0, channel 1
// at 80, 148 floats a row), then the samples (36 ints a row and channel).
constexpr int kChanStride = 80;
constexpr int kRowStride = 148;
constexpr int kSampleStride = 36;
constexpr int kNumC = 31;                  // butterfly constants
constexpr int kTables = 1056;              // 31 + the 1024-entry D window + 1
constexpr float kOutScale = -1090519040.0f;  // -(65 << 24), exact in float

enum OutForm { kOutU = 0, kOutF32 = 1, kOutS16 = 2 };

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// The matrixing DCT of one step and channel: 32 subband samples s[] -> one
// 64-float V block d[] (filterbank.py dct32; the reference's idct36,
// audio.go:492-772).
__device__ __forceinline__ void dct32(const int* s, const float* c, float* d) {
  float t01, t02, t03, t04, t05, t06, t07, t08, t09, t10, t11, t12, t13, t14,
      t15, t16, t17, t18, t19, t20, t21, t22, t23, t24, t25, t26, t27, t28,
      t29, t30, t31, t32, t33;
  t01 = __int2float_rn(wadd(s[0], s[31]));
  t02 = fmul(__int2float_rn(wsub(s[0], s[31])), c[0]);
  t03 = __int2float_rn(wadd(s[1], s[30]));
  t04 = fmul(__int2float_rn(wsub(s[1], s[30])), c[1]);
  t05 = __int2float_rn(wadd(s[2], s[29]));
  t06 = fmul(__int2float_rn(wsub(s[2], s[29])), c[2]);
  t07 = __int2float_rn(wadd(s[3], s[28]));
  t08 = fmul(__int2float_rn(wsub(s[3], s[28])), c[3]);
  t09 = __int2float_rn(wadd(s[4], s[27]));
  t10 = fmul(__int2float_rn(wsub(s[4], s[27])), c[4]);
  t11 = __int2float_rn(wadd(s[5], s[26]));
  t12 = fmul(__int2float_rn(wsub(s[5], s[26])), c[5]);
  t13 = __int2float_rn(wadd(s[6], s[25]));
  t14 = fmul(__int2float_rn(wsub(s[6], s[25])), c[6]);
  t15 = __int2float_rn(wadd(s[7], s[24]));
  t16 = fmul(__int2float_rn(wsub(s[7], s[24])), c[7]);
  t17 = __int2float_rn(wadd(s[8], s[23]));
  t18 = fmul(__int2float_rn(wsub(s[8], s[23])), c[8]);
  t19 = __int2float_rn(wadd(s[9], s[22]));
  t20 = fmul(__int2float_rn(wsub(s[9], s[22])), c[9]);
  t21 = __int2float_rn(wadd(s[10], s[21]));
  t22 = fmul(__int2float_rn(wsub(s[10], s[21])), c[10]);
  t23 = __int2float_rn(wadd(s[11], s[20]));
  t24 = fmul(__int2float_rn(wsub(s[11], s[20])), c[11]);
  t25 = __int2float_rn(wadd(s[12], s[19]));
  t26 = fmul(__int2float_rn(wsub(s[12], s[19])), c[12]);
  t27 = __int2float_rn(wadd(s[13], s[18]));
  t28 = fmul(__int2float_rn(wsub(s[13], s[18])), c[13]);
  t29 = __int2float_rn(wadd(s[14], s[17]));
  t30 = fmul(__int2float_rn(wsub(s[14], s[17])), c[14]);
  t31 = __int2float_rn(wadd(s[15], s[16]));
  t32 = fmul(__int2float_rn(wsub(s[15], s[16])), c[15]);

  t33 = fadd(t01, t31);
  t31 = fmul(fsub(t01, t31), c[16]);
  t01 = fadd(t03, t29);
  t29 = fmul(fsub(t03, t29), c[17]);
  t03 = fadd(t05, t27);
  t27 = fmul(fsub(t05, t27), c[18]);
  t05 = fadd(t07, t25);
  t25 = fmul(fsub(t07, t25), c[19]);
  t07 = fadd(t09, t23);
  t23 = fmul(fsub(t09, t23), c[20]);
  t09 = fadd(t11, t21);
  t21 = fmul(fsub(t11, t21), c[21]);
  t11 = fadd(t13, t19);
  t19 = fmul(fsub(t13, t19), c[22]);
  t13 = fadd(t15, t17);
  t17 = fmul(fsub(t15, t17), c[23]);
  t15 = fadd(t33, t13);
  t13 = fmul(fsub(t33, t13), c[24]);
  t33 = fadd(t01, t11);
  t01 = fmul(fsub(t01, t11), c[25]);
  t11 = fadd(t03, t09);
  t09 = fmul(fsub(t03, t09), c[26]);
  t03 = fadd(t05, t07);
  t07 = fmul(fsub(t05, t07), c[27]);
  t05 = fadd(t15, t03);
  t15 = fmul(fsub(t15, t03), c[28]);
  t03 = fadd(t33, t11);
  t11 = fmul(fsub(t33, t11), c[29]);
  t33 = fadd(t05, t03);
  t05 = fmul(fsub(t05, t03), c[30]);
  t03 = fadd(t15, t11);
  t15 = fmul(fsub(t15, t11), c[30]);
  t03 = fadd(t03, t15);
  t11 = fadd(t13, t07);
  t13 = fmul(fsub(t13, t07), c[28]);
  t07 = fadd(t01, t09);
  t09 = fmul(fsub(t01, t09), c[29]);
  t01 = fadd(t11, t07);
  t07 = fmul(fsub(t11, t07), c[30]);
  t11 = fadd(t13, t09);
  t13 = fmul(fsub(t13, t09), c[30]);
  t11 = fadd(t11, t13);
  t01 = fadd(t01, t11);
  t11 = fadd(t11, t07);
  t07 = fadd(t07, t13);
  t09 = fadd(t31, t17);
  t31 = fmul(fsub(t31, t17), c[24]);
  t17 = fadd(t29, t19);
  t29 = fmul(fsub(t29, t19), c[25]);
  t19 = fadd(t27, t21);
  t21 = fmul(fsub(t27, t21), c[26]);
  t27 = fadd(t25, t23);
  t23 = fmul(fsub(t25, t23), c[27]);
  t25 = fadd(t09, t27);
  t09 = fmul(fsub(t09, t27), c[28]);
  t27 = fadd(t17, t19);
  t19 = fmul(fsub(t17, t19), c[29]);
  t17 = fadd(t25, t27);
  t27 = fmul(fsub(t25, t27), c[30]);
  t25 = fadd(t09, t19);
  t19 = fmul(fsub(t09, t19), c[30]);
  t25 = fadd(t25, t19);
  t09 = fadd(t31, t23);
  t31 = fmul(fsub(t31, t23), c[28]);
  t23 = fadd(t29, t21);
  t21 = fmul(fsub(t29, t21), c[29]);
  t29 = fadd(t09, t23);
  t23 = fmul(fsub(t09, t23), c[30]);
  t09 = fadd(t31, t21);
  t31 = fmul(fsub(t31, t21), c[30]);
  t09 = fadd(t09, t31);
  t29 = fadd(t29, t09);
  t09 = fadd(t09, t23);
  t23 = fadd(t23, t31);
  t17 = fadd(t17, t29);
  t29 = fadd(t29, t25);
  t25 = fadd(t25, t09);
  t09 = fadd(t09, t27);
  t27 = fadd(t27, t23);
  t23 = fadd(t23, t19);
  t19 = fadd(t19, t31);
  t21 = fadd(t02, t32);
  t02 = fmul(fsub(t02, t32), c[16]);
  t32 = fadd(t04, t30);
  t04 = fmul(fsub(t04, t30), c[17]);
  t30 = fadd(t06, t28);
  t28 = fmul(fsub(t06, t28), c[18]);
  t06 = fadd(t08, t26);
  t08 = fmul(fsub(t08, t26), c[19]);
  t26 = fadd(t10, t24);
  t10 = fmul(fsub(t10, t24), c[20]);
  t24 = fadd(t12, t22);
  t22 = fmul(fsub(t12, t22), c[21]);
  t12 = fadd(t14, t20);
  t20 = fmul(fsub(t14, t20), c[22]);
  t14 = fadd(t16, t18);
  t16 = fmul(fsub(t16, t18), c[23]);
  t18 = fadd(t21, t14);
  t14 = fmul(fsub(t21, t14), c[24]);
  t21 = fadd(t32, t12);
  t32 = fmul(fsub(t32, t12), c[25]);
  t12 = fadd(t30, t24);
  t24 = fmul(fsub(t30, t24), c[26]);
  t30 = fadd(t06, t26);
  t26 = fmul(fsub(t06, t26), c[27]);
  t06 = fadd(t18, t30);
  t18 = fmul(fsub(t18, t30), c[28]);
  t30 = fadd(t21, t12);
  t12 = fmul(fsub(t21, t12), c[29]);
  t21 = fadd(t06, t30);
  t30 = fmul(fsub(t06, t30), c[30]);
  t06 = fadd(t18, t12);
  t12 = fmul(fsub(t18, t12), c[30]);
  t06 = fadd(t06, t12);
  t18 = fadd(t14, t26);
  t26 = fmul(fsub(t14, t26), c[28]);
  t14 = fadd(t32, t24);
  t24 = fmul(fsub(t32, t24), c[29]);
  t32 = fadd(t18, t14);
  t14 = fmul(fsub(t18, t14), c[30]);
  t18 = fadd(t26, t24);
  t24 = fmul(fsub(t26, t24), c[30]);
  t18 = fadd(t18, t24);
  t32 = fadd(t32, t18);
  t18 = fadd(t18, t14);
  t26 = fadd(t14, t24);
  t14 = fadd(t02, t16);
  t02 = fmul(fsub(t02, t16), c[24]);
  t16 = fadd(t04, t20);
  t04 = fmul(fsub(t04, t20), c[25]);
  t20 = fadd(t28, t22);
  t22 = fmul(fsub(t28, t22), c[26]);
  t28 = fadd(t08, t10);
  t10 = fmul(fsub(t08, t10), c[27]);
  t08 = fadd(t14, t28);
  t14 = fmul(fsub(t14, t28), c[28]);
  t28 = fadd(t16, t20);
  t20 = fmul(fsub(t16, t20), c[29]);
  t16 = fadd(t08, t28);
  t28 = fmul(fsub(t08, t28), c[30]);
  t08 = fadd(t14, t20);
  t20 = fmul(fsub(t14, t20), c[30]);
  t08 = fadd(t08, t20);
  t14 = fadd(t02, t10);
  t02 = fmul(fsub(t02, t10), c[28]);
  t10 = fadd(t04, t22);
  t22 = fmul(fsub(t04, t22), c[29]);
  t04 = fadd(t14, t10);
  t10 = fmul(fsub(t14, t10), c[30]);
  t14 = fadd(t02, t22);
  t02 = fmul(fsub(t02, t22), c[30]);
  t14 = fadd(t14, t02);
  t04 = fadd(t04, t14);
  t14 = fadd(t14, t10);
  t10 = fadd(t10, t02);
  t16 = fadd(t16, t04);
  t04 = fadd(t04, t08);
  t08 = fadd(t08, t14);
  t14 = fadd(t14, t28);
  t28 = fadd(t28, t10);
  t10 = fadd(t10, t20);
  t20 = fadd(t20, t02);
  t21 = fadd(t21, t16);
  t16 = fadd(t16, t32);
  t32 = fadd(t32, t04);
  t04 = fadd(t04, t06);
  t06 = fadd(t06, t08);
  t08 = fadd(t08, t18);
  t18 = fadd(t18, t14);
  t14 = fadd(t14, t30);
  t30 = fadd(t30, t28);
  t28 = fadd(t28, t26);
  t26 = fadd(t26, t10);
  t10 = fadd(t10, t12);
  t12 = fadd(t12, t20);
  t20 = fadd(t20, t24);
  t24 = fadd(t24, t02);
  // The V block (audio.go:708-772).
  d[0] = t05;
  d[1] = t30;
  d[2] = t27;
  d[3] = t28;
  d[4] = t07;
  d[5] = t26;
  d[6] = t23;
  d[7] = t10;
  d[8] = t15;
  d[9] = t12;
  d[10] = t19;
  d[11] = t20;
  d[12] = t13;
  d[13] = t24;
  d[14] = t31;
  d[15] = t02;
  d[16] = 0.0f;
  d[17] = fmul(t02, -1.0f);
  d[18] = fmul(t31, -1.0f);
  d[19] = fmul(t24, -1.0f);
  d[20] = fmul(t13, -1.0f);
  d[21] = fmul(t20, -1.0f);
  d[22] = fmul(t19, -1.0f);
  d[23] = fmul(t12, -1.0f);
  d[24] = fmul(t15, -1.0f);
  d[25] = fmul(t10, -1.0f);
  d[26] = fmul(t23, -1.0f);
  d[27] = fmul(t26, -1.0f);
  d[28] = fmul(t07, -1.0f);
  d[29] = fmul(t28, -1.0f);
  d[30] = fmul(t27, -1.0f);
  d[31] = fmul(t30, -1.0f);
  d[32] = fmul(t05, -1.0f);
  d[33] = fmul(t14, -1.0f);
  d[34] = fmul(t09, -1.0f);
  d[35] = fmul(t18, -1.0f);
  d[36] = fmul(t11, -1.0f);
  d[37] = fmul(t08, -1.0f);
  d[38] = fmul(t25, -1.0f);
  d[39] = fmul(t06, -1.0f);
  d[40] = fmul(t03, -1.0f);
  d[41] = fmul(t04, -1.0f);
  d[42] = fmul(t29, -1.0f);
  d[43] = fmul(t32, -1.0f);
  d[44] = fmul(t01, -1.0f);
  d[45] = fmul(t16, -1.0f);
  d[46] = fmul(t17, -1.0f);
  d[47] = fmul(t21, -1.0f);
  d[48] = fmul(t33, -1.0f);
  d[49] = fmul(t21, -1.0f);
  d[50] = fmul(t17, -1.0f);
  d[51] = fmul(t16, -1.0f);
  d[52] = fmul(t01, -1.0f);
  d[53] = fmul(t32, -1.0f);
  d[54] = fmul(t29, -1.0f);
  d[55] = fmul(t04, -1.0f);
  d[56] = fmul(t03, -1.0f);
  d[57] = fmul(t06, -1.0f);
  d[58] = fmul(t25, -1.0f);
  d[59] = fmul(t08, -1.0f);
  d[60] = fmul(t11, -1.0f);
  d[61] = fmul(t18, -1.0f);
  d[62] = fmul(t09, -1.0f);
  d[63] = fmul(t14, -1.0f);
}

// u / OUT_SCALE through the integer mantissa division of the plain version
// (filterbank.py div_out_scale_exact): the IEEE quotient wherever it is
// normal; a zero or subnormal input or a subnormal result gives signed zero.
__device__ __forceinline__ float div_out_scale_exact(float u) {
  const uint32_t bits = __float_as_uint(u);
  const int su = static_cast<int>(bits >> 31);
  const int e = static_cast<int>((bits >> 23) & 0xFF);
  const int m = static_cast<int>((bits & 0x7FFFFF) | 0x800000);
  const bool big = m >= (65 << 17);
  const int t = big ? (m << 6) : (m << 7);   // < 2^31
  const int q = t / 65;
  const int r = t - q * 65;
  const int mant = q + (r >= 33 ? 1 : 0);    // round to nearest (no ties)
  const int e_out = e - 31 + (big ? 1 : 0);
  uint32_t out = (static_cast<uint32_t>(e_out) << 23) +
                 static_cast<uint32_t>(mant - 0x800000);
  if (e == 0 || e_out <= 0) out = 0;
  return __uint_as_float(out | (static_cast<uint32_t>(1 - su) << 31));
}

// 16 bytes global -> shared, asynchronously (completed by cp_async_wait_all).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ constexpr int smem_bytes(int chunk) {
  return 4 * (kTables + (kHalo + chunk) * (kRowStride + 2 * kSampleStride));
}

// One CTA: steps [t0, t0 + n) of stream blockIdx.y, t0 = blockIdx.x * chunk.
template <bool RING, int FORM>
__global__ void __launch_bounds__(kThreads)
synth_kernel(const int* __restrict__ samples, const float* __restrict__ hist,
             const float* __restrict__ ring, int v_pos,
             const float* __restrict__ tables, int steps, int chunk,
             void* __restrict__ out, float* __restrict__ state) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int64_t stream = blockIdx.y;
  const int t0 = blockIdx.x * chunk;
  const int n = min(chunk, steps - t0);
  const int rows = kHalo + n;              // row r holds step t0 - 15 + r
  const int phase = RING ? (v_pos >> 6) : 0;
  float* tab = smem;                       // c[31], then the D window
  float* v = smem + kTables;
  int* sm = reinterpret_cast<int*>(v + (kHalo + chunk) * kRowStride);
  const float* c = tab;
  const float* dwin = tab + kNumC;

  // The prologue: all of it in flight before the one wait.
  for (int i = tid; i < kTables / 4; i += kThreads)
    cp_async16(tab + 4 * i, tables + 4 * i);
  // The samples of the rows whose steps are in this call: 16 pieces a row,
  // 8 a channel.
  const int first = t0 >= kHalo ? 0 : kHalo - t0;   // first such row
  const int* src = samples + (stream * steps + (t0 - kHalo + first)) * 64;
  for (int i = tid; i < (rows - first) * 16; i += kThreads)
    cp_async16(sm + (first * 2 + (i >> 3)) * kSampleStride + 4 * (i & 7),
               src + 4 * i);
  // The rows before the call's first step, from the history: row r is the
  // block k = 15 - t0 - r steps before it; 16 pieces a channel.
  for (int i = tid; i < first * 32; i += kThreads) {
    const int r = i >> 5, ch = (i >> 4) & 1, q = i & 15, k = kHalo - t0 - r;
    const float* g =
        RING ? ring + (stream * 2 + ch) * 1024 + ((v_pos + 64 * (k - 1)) & 1023)
             : hist + ((stream * kHalo + (k - 1)) * 2 + ch) * 64;
    cp_async16(v + r * kRowStride + ch * kChanStride + 4 * q, g + 4 * q);
  }
  cp_async_wait_all();
  __syncthreads();

  // The DCT: one thread a (row, channel) of this call, counted from the
  // last thread, so that in a short chunk the warps with MAC steps are not
  // the DCT's and take their taps meanwhile.
  for (int i = first * 2 + (kThreads - 1 - tid); i < rows * 2; i += kThreads) {
    int x[32];
    const int4* in = reinterpret_cast<const int4*>(sm + i * kSampleStride);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int4 w = in[q];
      x[4 * q] = w.x;
      x[4 * q + 1] = w.y;
      x[4 * q + 2] = w.z;
      x[4 * q + 3] = w.w;
    }
    float d[64];
    dct32(x, c, d);
    float4* dst = reinterpret_cast<float4*>(v + (i >> 1) * kRowStride +
                                            (i & 1) * kChanStride);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      dst[q] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
  }

  // The windowed MAC's taps.  Warp w takes the steps t0 + w + 16 m, whose V
  // positions (64 (phase - t - 1)) & 1023 are one, so are their taps: tap k
  // multiplies the window coefficient dk[k] by the entry at offset off[k]
  // from the step's own row.
  const int lane = tid & 31, warp = tid >> 5;
  float dk[16];
  int off[16];
  if (warp < n) {
    const int vp = (64 * (phase - t0 - warp - 1)) & 1023;
    int d_index = 512 - (vp >> 1);
    int v_index = (vp & 127) >> 1;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k == 8) {                                // the second pass
        d_index -= 512 - 32;
        v_index = (128 - 32 + 1024) - v_index;
      }
      const int r = (v_index - vp) & 1023;         // j = r >> 6 blocks ago
      dk[k] = dwin[d_index + lane];
      off[k] = -(r >> 6) * kRowStride + (r & 63);
      v_index += 128;
      d_index += 64;
    }
  }
  __syncthreads();

  // The windowed MAC: warp w's steps, both channels' chains a lane.
  for (int tl = warp; tl < n; tl += kWarps) {
    const float* vrow = v + (kHalo + tl) * kRowStride + lane;
    float u0 = 0.0f, u1 = 0.0f;                    // channels 0 and 1
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      u0 = fadd(u0, fmul(dk[k], vrow[off[k]]));
      u1 = fadd(u1, fmul(dk[k], vrow[off[k] + kChanStride]));
    }
    const int64_t step = stream * steps + t0 + tl;
    if (FORM == kOutU) {
      float* o = static_cast<float*>(out) + step * 64 + lane;
      o[0] = u0;
      o[32] = u1;
    } else if (FORM == kOutF32) {
      static_cast<float2*>(out)[step * 32 + lane] =
          make_float2(__fdiv_rn(u0, kOutScale), __fdiv_rn(u1, kOutScale));
    } else {
      short2 pcm;
      const float s0 = div_out_scale_exact(u0), s1 = div_out_scale_exact(u1);
      // float -> int32 truncates toward zero; int32 -> int16 wraps.
      pcm.x = static_cast<short>(static_cast<int>(
          s0 < 0.0f ? fmul(s0, 32768.0f) : fmul(s0, 32767.0f)));
      pcm.y = static_cast<short>(static_cast<int>(
          s1 < 0.0f ? fmul(s1, 32768.0f) : fmul(s1, 32767.0f)));
      static_cast<short2*>(out)[step * 32 + lane] = pcm;
    }
  }

  // The new state from the call's last blocks held here: the ring's 16 at
  // (new v_pos + 64 j) & 1023, or hist's 15, j steps before the last.
  const int keep = RING ? 16 : kHalo;
  const int from = max(t0, steps - keep);          // first step kept here
  for (int i = tid; i < (t0 + n - from) * 32; i += kThreads) {
    const int t = from + (i >> 5), ch = (i >> 4) & 1, q = i & 15;
    const int j = steps - 1 - t;
    const float4 val = reinterpret_cast<const float4*>(
        v + (kHalo + t - t0) * kRowStride + ch * kChanStride)[q];
    float* dst;
    if (RING) {
      const int new_pos = (v_pos - 64 * steps) & 1023;
      dst = state + (stream * 2 + ch) * 1024 + ((new_pos + 64 * j) & 1023);
    } else {
      dst = state + ((stream * kHalo + j) * 2 + ch) * 64;
    }
    reinterpret_cast<float4*>(dst)[q] = val;
  }
}

// Steps a CTA: as many as one CTA a SM for all streams needs, within
// [kMinChunk, kMaxChunk].
int chunk_steps(int n_streams, int steps, int sms) {
  const int ctas = sms / n_streams > 1 ? sms / n_streams : 1;  // a stream's
  const int c = (steps + ctas - 1) / ctas;
  return c < kMinChunk ? kMinChunk : (c > kMaxChunk ? kMaxChunk : c);
}

template <bool RING, int FORM>
cudaError_t launch(const int* samples, const float* hist, const float* ring,
                   int v_pos, const float* tables, int n_streams, int steps,
                   void* out, float* state, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int chunk = chunk_steps(n_streams, steps, sms);
  const int bytes = smem_bytes(chunk);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(synth_kernel<RING, FORM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(kMaxChunk));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((steps + chunk - 1) / chunk, n_streams);
  synth_kernel<RING, FORM><<<grid, kThreads, bytes, stream>>>(
      samples, hist, ring, v_pos, tables, steps, chunk, out, state);
  return cudaGetLastError();
}

template <bool RING>
cudaError_t launch_form(const int* samples, const float* hist,
                        const float* ring, int v_pos, const float* tables,
                        int n_streams, int steps, int form, void* out,
                        float* state, cudaStream_t stream) {
  if (form == kOutU)
    return launch<RING, kOutU>(samples, hist, ring, v_pos, tables, n_streams,
                               steps, out, state, stream);
  if (form == kOutF32)
    return launch<RING, kOutF32>(samples, hist, ring, v_pos, tables,
                                 n_streams, steps, out, state, stream);
  return launch<RING, kOutS16>(samples, hist, ring, v_pos, tables, n_streams,
                               steps, out, state, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// K4 over S streams of T steps: the ring form when `ring` is not null (its
// last write position v_pos, T >= 16), else the hist form (T a multiple of
// 16).  form: 0 u, 1 f32, 2 s16.  `state` receives the new ring or hist.
// tables: float [1056], the butterfly constants, the D window and one pad.
// Every pointer must be 16-byte aligned (K4 copies in 16-byte pieces).
// Arguments the wrapper refuses are refused here too, as
// cudaErrorInvalidValue, and nothing launches.
int mt_synthesize(const int* samples, const float* hist, const float* ring,
                  int v_pos, const float* tables, int n_streams, int steps,
                  int form, void* out, float* state, void* stream) {
  const bool ok = n_streams > 0 && n_streams <= 65535 && form >= 0 && form <= 2 &&
                  (ring ? steps >= 16 && v_pos >= 0 && v_pos < 1024 && v_pos % 64 == 0
                        : steps > 0 && steps % 16 == 0) &&
                  aligned16(samples) && aligned16(ring ? ring : hist) &&
                  aligned16(tables) && aligned16(out) && aligned16(state);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      ring ? launch_form<true>(samples, hist, ring, v_pos, tables, n_streams, steps,
                               form, out, state, s)
           : launch_form<false>(samples, hist, ring, v_pos, tables, n_streams, steps,
                                form, out, state, s));
}

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
