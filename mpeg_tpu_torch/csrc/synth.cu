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
// - the DCT is the reference's butterfly statement for statement: the int32
//   sum or difference first (wrapping), then __int2float_rn, then the
//   constant multiply; entry 16 of a block is +0.0 and entries 17-63 are
//   x * -1.0f, so +0.0 becomes -0.0;
// - the windowed MAC starts from +0.0f and adds its 16 products one at a
//   time in the order of the reference's two-pass synthWindow loop
//   (filterbank.py window_offsets), which depends on the step's V position;
// - f32 divides with __fdiv_rn (IEEE, subnormal results kept, like torch's
//   division by a device tensor); s16 divides with the plain version's exact
//   integer form (div_out_scale_exact), then truncates to int32 and wraps to
//   int16.
// The constants (the butterfly's 31 and the 1024-entry D window) come from
// the wrapper as one float tensor, the very values the plain version uses.
//
// Bound and design.  A 32-frame window moves ~0.6 MB and does ~3 M float
// ops: a fraction of a microsecond of the card, far below one launch.  So K4
// is one simple launch a call: a grid of (chunk of 32 steps, stream) CTAs.
// Each CTA computes the DCT blocks of its steps and of the 15 steps before
// them into shared memory (one thread a step and channel; the first chunk
// takes those 15 from the history, the others recompute them), then one
// thread an output (step, lane, channel) runs the 16-tap MAC and writes the
// output form; the CTAs whose steps are among the last 16 (or 15) write the
// new state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;                 // steps a CTA
constexpr int kHalo = 15;                  // blocks before a step its taps read
constexpr int kRows = kHalo + kChunk;      // DCT blocks a CTA holds
constexpr int kThreads = 256;
// Shared layout of a DCT row: channel 0 at 0, channel 1 at 80 (the MAC's two
// half-warps read 16 floats of each: disjoint banks), 161 floats a row (the
// DCT threads of one warp write 16 consecutive rows: disjoint banks).
constexpr int kChanStride = 80;
constexpr int kRowStride = 161;
constexpr int kSampleStride = 33;          // ints a (row, channel) of samples
constexpr int kNumC = 31;                  // butterfly constants
constexpr int kDWindow = 1024;             // D window entries
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

// One CTA: steps [t0, t0 + n) of stream blockIdx.y.
template <bool RING, int FORM>
__global__ void __launch_bounds__(kThreads)
synth_kernel(const int* __restrict__ samples, const float* __restrict__ hist,
             const float* __restrict__ ring, int v_pos,
             const float* __restrict__ tables, int steps,
             void* __restrict__ out, float* __restrict__ state) {
  __shared__ float v[kRows * kRowStride];
  __shared__ int sm[kRows * 2 * kSampleStride];
  __shared__ float c[kNumC];
  __shared__ float dwin[kDWindow];

  const int tid = threadIdx.x;
  const int64_t stream = blockIdx.y;
  const int t0 = blockIdx.x * kChunk;
  const int n = min(kChunk, steps - t0);
  const int rows = kHalo + n;              // row r holds step t0 - 15 + r
  const int phase = RING ? (v_pos >> 6) : 0;

  for (int i = tid; i < kNumC + kDWindow; i += kThreads) {
    if (i < kNumC)
      c[i] = tables[i];
    else
      dwin[i - kNumC] = tables[i];
  }
  // The samples of the rows whose steps are in this call.
  const int first = t0 >= kHalo ? 0 : kHalo - t0;   // first such row
  const int* src = samples + (stream * steps + (t0 - kHalo + first)) * 64;
  for (int i = tid; i < (rows - first) * 64; i += kThreads)
    sm[(first * 2 + (i >> 5)) * kSampleStride + (i & 31)] = src[i];
  // The rows before the call's first step, from the history: row r is the
  // block k = 15 - r steps before it.
  for (int i = tid; i < first * 128; i += kThreads) {
    const int r = i >> 7, ch = (i >> 6) & 1, x = i & 63, k = kHalo - r;
    float val;
    if (RING)
      val = ring[(stream * 2 + ch) * 1024 + ((v_pos + 64 * (k - 1)) & 1023) + x];
    else
      val = hist[((stream * kHalo + (k - 1)) * 2 + ch) * 64 + x];
    v[r * kRowStride + ch * kChanStride + x] = val;
  }
  __syncthreads();

  for (int i = first * 2 + tid; i < rows * 2; i += kThreads)
    dct32(&sm[i * kSampleStride], c, &v[(i >> 1) * kRowStride + (i & 1) * kChanStride]);
  __syncthreads();

  // The windowed MAC: thread i -> step t0 + (i >> 6), lane (i >> 1) & 31,
  // channel i & 1 (so an interleaved output is written contiguously).
  for (int i = tid; i < n * 64; i += kThreads) {
    const int tl = i >> 6, lane = (i >> 1) & 31, ch = i & 1;
    const int t = t0 + tl;
    const int vp = (64 * (phase - t - 1)) & 1023;   // the step's V position
    const float* vrow = &v[(kHalo + tl) * kRowStride + ch * kChanStride + lane];
    float u = 0.0f;
    int d_index = 512 - (vp >> 1);
    int v_index = (vp & 127) >> 1;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = (v_index - vp) & 1023;         // j = r >> 6 blocks ago
      u = fadd(u, fmul(dwin[d_index + lane], vrow[-(r >> 6) * kRowStride + (r & 63)]));
      v_index += 128;
      d_index += 64;
    }
    d_index -= 512 - 32;
    v_index = (128 - 32 + 1024) - v_index;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = (v_index - vp) & 1023;
      u = fadd(u, fmul(dwin[d_index + lane], vrow[-(r >> 6) * kRowStride + (r & 63)]));
      v_index += 128;
      d_index += 64;
    }
    const int64_t step = stream * steps + t;
    if (FORM == kOutU) {
      static_cast<float*>(out)[(step * 2 + ch) * 32 + lane] = u;
    } else if (FORM == kOutF32) {
      static_cast<float*>(out)[step * 64 + (i & 63)] = __fdiv_rn(u, kOutScale);
    } else {
      const float s = div_out_scale_exact(u);
      const float scaled = s < 0.0f ? fmul(s, 32768.0f) : fmul(s, 32767.0f);
      // float -> int32 truncates toward zero; int32 -> int16 wraps.
      static_cast<int16_t*>(out)[step * 64 + (i & 63)] =
          static_cast<int16_t>(static_cast<int>(scaled));
    }
  }

  // The new state from the call's last blocks held here: the ring's 16 at
  // (new v_pos + 64 j) & 1023, or hist's 15, j steps before the last.
  const int keep = RING ? 16 : kHalo;
  const int from = max(t0, steps - keep);          // first step kept here
  for (int i = tid; i < (t0 + n - from) * 128; i += kThreads) {
    const int t = from + (i >> 7), ch = (i >> 6) & 1, x = i & 63;
    const int j = steps - 1 - t;
    const float val = v[(kHalo + t - t0) * kRowStride + ch * kChanStride + x];
    if (RING) {
      const int new_pos = (v_pos - 64 * steps) & 1023;
      state[(stream * 2 + ch) * 1024 + ((new_pos + 64 * j) & 1023) + x] = val;
    } else {
      state[((stream * kHalo + j) * 2 + ch) * 64 + x] = val;
    }
  }
}

template <bool RING>
void launch(const int* samples, const float* hist, const float* ring, int v_pos,
            const float* tables, int n_streams, int steps, int form, void* out,
            float* state, cudaStream_t stream) {
  const dim3 grid((steps + kChunk - 1) / kChunk, n_streams);
  if (form == kOutU)
    synth_kernel<RING, kOutU><<<grid, kThreads, 0, stream>>>(
        samples, hist, ring, v_pos, tables, steps, out, state);
  else if (form == kOutF32)
    synth_kernel<RING, kOutF32><<<grid, kThreads, 0, stream>>>(
        samples, hist, ring, v_pos, tables, steps, out, state);
  else
    synth_kernel<RING, kOutS16><<<grid, kThreads, 0, stream>>>(
        samples, hist, ring, v_pos, tables, steps, out, state);
}

}  // namespace

extern "C" {

// K4 over S streams of T steps: the ring form when `ring` is not null (its
// last write position v_pos, T >= 16), else the hist form (T a multiple of
// 16).  form: 0 u, 1 f32, 2 s16.  `state` receives the new ring or hist.
// tables: float [31 + 1024], the butterfly constants then the D window.
// Arguments the wrapper refuses are refused here too, as
// cudaErrorInvalidValue, and nothing launches.
int mt_synthesize(const int* samples, const float* hist, const float* ring,
                  int v_pos, const float* tables, int n_streams, int steps,
                  int form, void* out, float* state, void* stream) {
  const bool ok = n_streams > 0 && n_streams <= 65535 && form >= 0 && form <= 2 &&
                  (ring ? steps >= 16 && v_pos >= 0 && v_pos < 1024 && v_pos % 64 == 0
                        : steps > 0 && steps % 16 == 0);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ring)
    launch<true>(samples, hist, ring, v_pos, tables, n_streams, steps, form, out, state, s);
  else
    launch<false>(samples, hist, ring, v_pos, tables, n_streams, steps, form, out, state, s);
  return static_cast<int>(cudaGetLastError());
}

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
