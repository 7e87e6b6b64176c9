// Hand-written CUDA kernels for the MPEG-1 picture reconstruct on Hopper.
//
// Plain C entry points (pointers, ints and the caller's stream), loaded
// with ctypes by mpeg_tpu_torch/ops/_build.py.  Each entry returns the
// cudaGetLastError() code seen right after its launch; the Python wrapper
// raises when it is not 0.
//
// All arithmetic is the reference's int32 arithmetic: arithmetic right
// shifts, floor division for flat addresses, and two's-complement wrap on
// overflow.  Signed overflow is undefined in C++, so every sum and product
// that can overflow goes through `wint` (unsigned arithmetic, converted
// back to int32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// int32 value whose +, -, * wrap like the reference's int32 (jnp.int32).
struct wint {
  uint32_t v;
  __device__ __forceinline__ wint(int x = 0) : v(static_cast<uint32_t>(x)) {}
  __device__ __forceinline__ static wint bits(uint32_t u) {
    wint r;
    r.v = u;
    return r;
  }
  __device__ __forceinline__ int i() const { return static_cast<int>(v); }
};
__device__ __forceinline__ wint operator+(wint a, wint b) { return wint::bits(a.v + b.v); }
__device__ __forceinline__ wint operator-(wint a, wint b) { return wint::bits(a.v - b.v); }
__device__ __forceinline__ wint operator*(wint a, wint b) { return wint::bits(a.v * b.v); }
__device__ __forceinline__ wint operator-(wint a) { return wint::bits(0u - a.v); }
// Arithmetic shift, as lax.shift_right_arithmetic / numpy >> on int32.
__device__ __forceinline__ wint operator>>(wint a, int s) { return wint(a.i() >> s); }

// ---------------------------------------------------------------------------
// The exact 8-point IDCT line (reference: mpeg_tpu/ops/video_recon.py
// _butterfly/_pass_full/_pass_sparse).  p[k * stride] for k < 8 is the
// line; SPARSE reads only k < 4 (inputs 4..7 are taken as zero).  The
// result replaces the line in place.
// ---------------------------------------------------------------------------
template <bool SPARSE>
__device__ __forceinline__ void idct_line(int* p, int stride, bool final_shift) {
  wint x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = (SPARSE && k >= 4) ? wint(0) : wint(p[k * stride]);

  wint b1, b3, b4, tmp1, tmp2, b6, m0, x2;
  if (SPARSE) {
    b1 = 0;
    b3 = x[2];
    b4 = -x[3];
    tmp1 = x[1];
    tmp2 = x[3];
    b6 = x[1];
    m0 = x[0];
    x2 = ((x[2] * 362 + 128) >> 8) - b3;
  } else {
    b1 = x[4];
    b3 = x[2] + x[6];
    b4 = x[5] - x[3];
    tmp1 = x[1] + x[7];
    tmp2 = x[3] + x[5];
    b6 = x[1] - x[7];
    m0 = x[0];
    x2 = (((x[2] - x[6]) * 362 + 128) >> 8) - b3;
  }
  wint b7 = tmp1 + tmp2;
  wint x4 = ((b6 * 473 - b4 * 196 + 128) >> 8) - b7;
  wint x0 = x4 - (((tmp1 - tmp2) * 362 + 128) >> 8);
  wint x1 = m0 - b1;
  wint x3 = m0 + b1;
  wint y3 = x1 + x2;
  wint y4 = x3 + b3;
  wint y5 = x1 - x2;
  wint y6 = x3 - b3;
  wint y7 = -x0 - ((b4 * 473 + b6 * 196 + 128) >> 8);
  wint o[8] = {b7 + y4, x4 + y3, y5 - x0, y6 - y7,
               y6 + y7, x0 + y5, y3 - x4, y4 - b7};
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k * stride] = (final_shift ? (o[k] + 128) >> 8 : o[k]).i();
}

// In-place exact 2-D IDCT of `nblk` 8x8 blocks in shared memory, eight
// threads a block (thread t: block t >> 3, line t & 7): a column pass, a
// sync, a row pass, a sync.  The variant follows the block's count n:
// n == 1 replicates (x0 + 128) >> 8, n < 10 (n <= 0 included) is sparse
// (columns and rows 0..3), otherwise full.  Every thread of the CTA calls
// it, since it syncs; threads past the blocks only sync.
__device__ __forceinline__ void smem_idct(int* blocks, const int* nb,
                                          int nblk, int t) {
  const int b = t >> 3, k = t & 7;
  const bool active = b < nblk;
  const int n = active ? nb[b] : 0;
  int* blk = blocks + b * 64;
  int dc = 0;
  if (active) {
    if (n == 1) {
      dc = (wint(blk[0]) + 128 >> 8).i();  // read before the row pass writes
    } else if (n < 10) {
      if (k < 4) idct_line<true>(blk + k, 8, false);
    } else {
      idct_line<false>(blk + k, 8, false);
    }
  }
  __syncthreads();
  if (active) {
    int* row = blk + k * 8;
    if (n == 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) row[j] = dc;
    } else if (n < 10) {
      idct_line<true>(row, 1, true);
    } else {
      idct_line<false>(row, 1, true);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

__device__ __forceinline__ int trunc_div2(int v) {  // Go-style v / 2
  return (v + ((v >> 31) & 1)) >> 1;
}

// The half-pel prediction of one pixel from the flat [fwd | bwd] stack:
// taps at a0, a0 + 1, a0 + stride, a0 + stride + 1 (a0 >= 0), where an
// address past the stack's end reads 0 (the reference's extension
// columns), blended as (a + b*oh + c*ov + d*oh*ov + bias) >> (oh + ov).
// fwd may alias bwd.
__device__ __forceinline__ int mc_taps(const uint8_t* fwd, const uint8_t* bwd,
                                       int total, int a0, int stride,
                                       int oh, int ov) {
  auto tap = [&](int k) -> int {
    return k < total ? fwd[k] : (k < 2 * total ? bwd[k - total] : 0);
  };
  const int a = tap(a0), b = tap(a0 + 1), c = tap(a0 + stride), d = tap(a0 + stride + 1);
  const int sh = oh + ov;
  const int bias = (1 << sh) >> 1;
  return (a + b * oh + c * ov + d * (oh & ov) + bias) >> sh;
}

// ---------------------------------------------------------------------------
// K2: batched IDCT.
//
// Replaces mpeg_tpu/ops/pallas_kernels.py idct_batch_pallas (_idct_kernel,
// _idct2d_posmajor).  The TPU kernel's position-major [64, TILE] layout is
// a lane trick and is gone.
// Bound: bytes.  Each block reads and writes 256 B for ~600 integer ops;
// at 1080p (48,960 blocks, 25 MB moved) the card's 3.35 TB/s bounds it
// near 7.5 us.  The simple design keeps the loads and stores coalesced:
// a CTA of 256 threads copies 32 blocks into shared memory (consecutive
// threads, consecutive words), transforms them there with the 8-point
// line K1 uses (eight threads a block), and copies them out.
// ---------------------------------------------------------------------------
constexpr int kIdctThreads = 256;
constexpr int kIdctBlocksPerCta = kIdctThreads / 8;

__global__ void __launch_bounds__(kIdctThreads)
idct_batch_kernel(const int* __restrict__ coeffs,
                  const int* __restrict__ nblocks,
                  int* __restrict__ out, int64_t nblk) {
  __shared__ int blocks[kIdctBlocksPerCta * 64];
  __shared__ int nb[kIdctBlocksPerCta];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kIdctBlocksPerCta;
  const int count = nblk - first < kIdctBlocksPerCta
                        ? static_cast<int>(nblk - first) : kIdctBlocksPerCta;
  const int t = threadIdx.x;
  const int* src = coeffs + first * 64;
  for (int i = t; i < count * 64; i += kIdctThreads) blocks[i] = src[i];
  if (t < count) nb[t] = nblocks[first + t];
  __syncthreads();
  smem_idct(blocks, nb, count, t);
  int* dst = out + first * 64;
  for (int i = t; i < count * 64; i += kIdctThreads) dst[i] = blocks[i];
}

// ---------------------------------------------------------------------------
// K1: whole pictures, IDCT fused in; one launch reconstructs one
// picture-step of S streams.
//
// Replaces mpeg_tpu/ops/pallas_kernels.py reconstruct_picture_pallas
// (_make_unified_kernel: mb_pred + compose) together with the XLA
// idct_batch that feeds it, and the lax.map over a vmap with which
// mpeg_tpu/parallel/multistream.py runs it over many streams.  The TPU
// kernel's one-hot f32 matmul row and column selection, scalar prefetch
// and packed (8, wp) row layout are Mosaic workarounds and are gone.
//
// Bound: bytes.  What a picture must move depends on its plan: 256 B of
// coefficients for each coded block, 64 B of prediction for each block
// that is not coded intra (from the current frame or a reference), 60 B
// of plan a macroblock, the written frame and the pad it copies
// (ops/cuda_kernels.py reconstruct_bound).  At 1080p an I picture is
// ~16 MB (~4.8 us at 3.35 TB/s); a P picture that codes 5-8% of its
// blocks ~7.5 MB (~2.2 us).  The exact IDCT rounds with >> 8 between its
// passes, so it is no matrix product: wgmma cannot compute it exactly,
// and ~600 integer ops a block stay far below the card's integer rate.
// No tensor cores.
//
// Design, against that bound:
//
// - Uncoded blocks cost nothing: a block with nblocks <= 0 loads none of
//   its 256 B of coefficients and runs no IDCT (compose never reads its
//   residual), and a block coded intra loads no prediction (compose
//   never reads it).  On real P pictures that skips ~93% of the
//   coefficient bytes and of the IDCT.
// - Bytes stay in flight: a persistent grid (kK1CtasPerSm CTAs a SM)
//   walks the (stream, macroblock) work items, CTA c taking items c,
//   c + G, c + 2G, ...  Warp 4 of each CTA is the producer: it reads 32
//   items' plan scalars at once (one lane an item: the table row,
//   nblocks, intra, src_sel, motion vector; each plane's window start
//   by one floor division), then fills a ring of kK1Stages stages in
//   shared memory, one item a stage: the coded blocks' coefficients,
//   each plane's reference rows (or the current frame's rows), the pad
//   bytes and the item's scalars.  The copies are cp.async, 16 B (8 B
//   for current-frame rows) a lane, and complete on the stage's `full`
//   mbarrier (cp.async.mbarrier.arrive.noinc).  cp.async, not 1-D bulk
//   copies: a reference row is two aligned 16-B granules of the flat
//   [fwd | bwd] stack, each from fwd or bwd and zero past 2 * total,
//   which cp.async's source-size operand zero-fills in the same
//   instruction; a bulk copy can neither choose per granule nor
//   zero-fill, and the coefficient blocks are only 256 B.  Warps 0-2
//   consume stages in order and free each on its `empty` mbarrier, so
//   the loads of the next stages overlap the compute on this one.
//   Four CTAs a SM (ptxas: 106 registers; 22,688 B of shared memory a
//   CTA, mt_reconstruct_smem_bytes): on an H100 two were slower on every
//   case, six and eight faster on one picture but slower on 64-stream
//   launches, and rings of 4, 6 and 8 stages timed within 2.3%
//   (chip_smoke.py --k1-baseline; PERF.md).  What holds K1 back is each
//   CTA's serial walk of its items (the producer's issue and the
//   handshakes), not bytes in flight.
// - MC from shared memory: each plane's window is staged as whole rows,
//   two aligned 16-B granules from the row's flat address, so a row
//   that runs past its end continues into the next row's bytes and a
//   granule past 2 * total reads 0.  Pixel row r's taps come from
//   staged row clamp(ys0 + r) - clamp(ys0) (each row clamped on its own
//   to [0, rows2 - 2], so clamped rows repeat) and its c/d taps from
//   the staged row after it (the clamped row + 1): at most 17 rows.
// - Wide stores: a consumer thread computes 4 neighbouring pixels (the
//   taps from two 32-bit shared loads a row, blended byte-parallel) and
//   stores them as one 32-bit word; the pad goes out in 16-B words.
//
// Stream axis: row s of the int32 table [S, 5] holds that stream's
// (cur, fwd, bwd, out) slots in the frame pool (frames of total_size
// bytes from the four base pointers) and its picture index into the
// dense coefficients and the plan; a picture index < 0 makes the
// stream's step a no-op.  Without a table (S == 1) every slot and the
// picture index are 0: the four pointers are the frames.  Pool and
// picture offsets are int64 (64 streams x window 8 at 1080p is 1.6 G
// coefficients).  fwd may alias bwd; out never aliases a frame read.
// ---------------------------------------------------------------------------
constexpr int kTableCols = 5;  // cur, fwd, bwd, out slot; picture index
constexpr int kK1Stages = 6;      // ring depth
constexpr int kK1CtasPerSm = 4;
constexpr int kK1Consumers = 96;                  // warps 0-2
constexpr int kK1Threads = kK1Consumers + 32;     // + the producer warp

// One work item's scalars, 128 B: written by the producer, read by the
// consumers.  cls packs each block's IDCT class in bits 2b..2b+1 (0
// uncoded, 1 DC only, 2 sparse, 3 full) and its intra flag in bit 12 + b;
// cls < 0 marks a skipped item (-2) or the end of the CTA's items (-1).
struct K1Item {
  const uint8_t* cur;
  const uint8_t* fwd;
  const uint8_t* bwd;
  uint8_t* out;
  int64_t pm;        // plan row: picture * mb + macroblock
  int mbx, mby;
  int cls, sel;
  int ys0[3];        // per plane: window start row (floor) ...
  int xs[3];         // ... and column
  int lo[3];         // first staged source row: clamp(ys0)
  int rows[3];       // staged rows: clamp(ys0 + bw - 1) - lo + 2
  int ohov[3];       // half-pel bits: oh | ov << 1
  int unused[3];
};
static_assert(sizeof(K1Item) == 128, "K1Item is 32 words");

// Stage layout (bytes): residual int32 [6][64], the three planes'
// staged rows (32 B a row: luma 17 rows, chroma 9 each), the pad, the
// item.
constexpr int kStCoef = 0;
constexpr int kStWin0 = kStCoef + 6 * 64 * 4;
constexpr int kStPad = kStWin0 + 35 * 32;  // luma 17 rows, chroma 9 + 9
constexpr int kStItem = kStPad + 256;
constexpr int kStageBytes = kStItem + 128;
static_assert(kStageBytes % 16 == 0, "stage alignment");
// The producer's 32 items, 34 words apart (8-byte aligned, and its
// lanes' writes hit distinct bank pairs).
constexpr int kBatchStride = 34;
constexpr int kK1SmemBytes = kK1Stages * kStageBytes + 32 * kBatchStride * 4 +
                             2 * kK1Stages * 8;

// Plane p's staged rows within a stage.
__device__ __forceinline__ int st_win(int p) {
  return kStWin0 + (p == 0 ? 0 : (p == 1 ? 17 : 26)) * 32;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B from global to shared; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// This thread's arrival on `bar`, once all its earlier cp.async are done.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The item of global index g (stream g / mb, macroblock g % mb) as the
// producer lane that owns it computes it.
__device__ __forceinline__ void k1_make_item(
    K1Item& it, int64_t g, int64_t n_items, const uint8_t* cur_pool,
    const uint8_t* fwd_pool, const uint8_t* bwd_pool, uint8_t* out_pool,
    const int* table, const int* nblocks, const int* intra,
    const int* src_sel, const int* mv_h, const int* mv_v, int mb_width,
    int mb_height) {
  it.cls = -2;
  if (g >= n_items) return;
  const int mb = mb_width * mb_height;
  const int s = static_cast<int>(g / mb);
  const int m = static_cast<int>(g - static_cast<int64_t>(s) * mb);
  const int lw = mb_width * 16, cw = mb_width * 8;
  const int luma_size = lw * mb_height * 16;
  const int chroma_size = cw * mb_height * 8;
  const int total = luma_size + 2 * chroma_size + lw * 16;
  int64_t slot[4] = {0, 0, 0, 0}, pic = 0;
  if (table != nullptr) {
    const int* row = table + static_cast<int64_t>(s) * kTableCols;
    if (row[4] < 0) return;
    for (int k = 0; k < 4; ++k) slot[k] = row[k];
    pic = row[4];
  }
  it.cur = cur_pool + slot[0] * total;
  it.fwd = fwd_pool + slot[1] * total;
  it.bwd = bwd_pool + slot[2] * total;
  it.out = out_pool + slot[3] * total;
  const int64_t pm = pic * mb + m;
  it.pm = pm;
  const int mby = m / mb_width, mbx = m - mby * mb_width;
  it.mbx = mbx;
  it.mby = mby;
  const int2* nb2 = reinterpret_cast<const int2*>(nblocks + pm * 6);
  const int2* ib2 = reinterpret_cast<const int2*>(intra + pm * 6);
  int cls = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int2 n = nb2[k], i = ib2[k];
    const int nv[2] = {n.x, n.y}, iv[2] = {i.x, i.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 2 * k + h, v = nv[h];
      const int c = v <= 0 ? 0 : (v == 1 ? 1 : (v < 10 ? 2 : 3));
      cls |= c << (2 * b);
      if (iv[h] > 0) cls |= 1 << (12 + b);
    }
  }
  const int sel = src_sel[pm];
  it.sel = sel;
  int mvh = mv_h[pm], mvv = mv_v[pm];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    // Plane p's window start: floor division of the flat address of the
    // macroblock's pixel row 0 (junk vectors make it negative).
    int base = 0, stride = lw, bw = 16, rows2 = 48 * mb_height + 32;
    if (p > 0) {
      base = luma_size + (p - 1) * chroma_size;
      stride = cw;
      bw = 8;
      rows2 = 96 * mb_height + 64;
      if (p == 1) {
        mvh = trunc_div2(mvh);
        mvv = trunc_div2(mvv);
      }
    }
    const int flat0 = base + (mby * bw + (mvv >> 1)) * stride + mbx * bw +
                      (mvh >> 1) + (sel == 2 ? total : 0);
    const int ys0 = floor_div(flat0, stride);
    const int lo = min(max(ys0, 0), rows2 - 2);
    const int hi = min(max(ys0 + bw - 1, 0), rows2 - 2);
    it.ys0[p] = ys0;
    it.xs[p] = flat0 - ys0 * stride;
    it.lo[p] = lo;
    it.rows[p] = hi - lo + 2;
    it.ohov[p] = (mvh & 1) | ((mvv & 1) << 1);
  }
  it.cls = cls;
}

// The producer lane's copies of item `it` into the stage at `st`.
__device__ __forceinline__ void k1_fill_stage(const K1Item& it, uint32_t st,
                                              const int* coeffs, int lane,
                                              int mb_width, int mb_height) {
  const int lw = mb_width * 16, cw = mb_width * 8;
  const int luma_size = lw * mb_height * 16;
  const int chroma_size = cw * mb_height * 8;
  const int frame_size = luma_size + 2 * chroma_size;
  const int total = frame_size + lw * 16;
  const int cls = it.cls;
  // Coded blocks' coefficients: 16 granules a block.
  const int* cf = coeffs + it.pm * 384;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int t = lane + 32 * k, b = t >> 4;
    if ((cls >> (2 * b)) & 3)
      cp_async16(st + kStCoef + t * 16, cf + t * 4, 16);
  }
  if (it.sel > 0) {
    // Reference rows: two aligned granules of the flat [fwd | bwd] stack
    // a row, each from fwd or bwd, zero past 2 * total.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int t = lane + 32 * k;          // 70 tasks: 34 luma, 18 + 18
      int p, j;
      if (t < 34) {
        p = 0;
        j = t >> 1;
      } else {
        p = 1 + (t >= 52);
        j = (t - (p == 1 ? 34 : 52)) >> 1;
      }
      if (t < 70 && j < it.rows[p]) {
        const int stride = p ? cw : lw;
        const int a = (it.lo[p] + j) * stride + it.xs[p];
        const int c = (a & ~15) + 16 * (t & 1);
        const uint8_t* src = c < total ? it.fwd + c : it.bwd + (c - total);
        cp_async16(st + st_win(p) + j * 32 + 16 * (t & 1),
                   c < 2 * total ? src : it.fwd, c < 2 * total ? 16 : 0);
      }
    }
  } else {
    // The current frame's rows of each block not coded intra, 8 B a
    // row: luma row r at bytes 0..15 of staged row r, chroma at 0..7.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = lane + 32 * k, b = t >> 3, r = t & 7;
      const bool coded_intra = ((cls >> (2 * b)) & 3) && ((cls >> (12 + b)) & 1);
      if (t < 48 && !coded_intra) {
        if (b < 4) {
          const int row = (b >> 1) * 8 + r, half = b & 1;
          cp_async8(st + st_win(0) + row * 32 + half * 8,
                    it.cur + (it.mby * 16 + row) * lw + it.mbx * 16 + half * 8);
        } else {
          cp_async8(st + st_win(b - 3) + r * 32,
                    it.cur + luma_size + (b - 4) * chroma_size +
                        (it.mby * 8 + r) * cw + it.mbx * 8);
        }
      }
    }
  }
  // The pad bytes [frame_size, total_size) carry over from cur: the
  // last macroblock row's items copy 256 B each.
  if (it.mby == mb_height - 1 && lane < 16)
    cp_async16(st + kStPad + lane * 16,
               it.cur + frame_size + it.mbx * 256 + lane * 16, 16);
}

// Four bytes of a staged row from byte `o` on (o + 4 < 32), and the fifth.
__device__ __forceinline__ void k1_row5(const uint8_t* row, int o,
                                        uint32_t& w4, uint32_t& b4) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (o & ~3));
  const uint32_t sh = 8 * (o & 3);
  const uint32_t w0 = w[0], w1 = w[1];
  w4 = __funnelshift_r(w0, w1, sh);
  b4 = (w1 >> sh) & 0xFF;
}

__global__ void __launch_bounds__(kK1Threads, kK1CtasPerSm)
reconstruct_picture_kernel(const uint8_t* cur_pool, const uint8_t* fwd_pool,
                           const uint8_t* bwd_pool, uint8_t* out_pool,
                           const int* __restrict__ table,
                           const int* __restrict__ coeffs,
                           const int* __restrict__ nblocks,
                           const int* __restrict__ intra,
                           const int* __restrict__ src_sel,
                           const int* __restrict__ mv_h,
                           const int* __restrict__ mv_v,
                           int mb_width, int mb_height, int n_streams) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* stages = smem;
  uint32_t* batch = reinterpret_cast<uint32_t*>(smem + kK1Stages * kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(batch + 32 * kBatchStride);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kK1Stages);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kK1Stages; ++s) {
      mbar_init(full0 + 8 * s, 64);             // 32 lanes, twice each
      mbar_init(empty0 + 8 * s, kK1Consumers);
    }
  }
  __syncthreads();

  const int64_t n_items =
      static_cast<int64_t>(n_streams) * mb_width * mb_height;
  const int64_t grid = gridDim.x;

  if (t >= kK1Consumers) {
    // ---- producer warp ----
    const int lane = t - kK1Consumers;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t k0 = 0; blockIdx.x + k0 * grid < n_items; k0 += 32) {
      k1_make_item(*reinterpret_cast<K1Item*>(batch + lane * kBatchStride),
                   blockIdx.x + (k0 + lane) * grid, n_items,
                   cur_pool, fwd_pool, bwd_pool, out_pool, table, nblocks,
                   intra, src_sel, mv_h, mv_v, mb_width, mb_height);
      __syncwarp();
      for (int i = 0; i < 32; ++i) {
        const K1Item& it =
            *reinterpret_cast<const K1Item*>(batch + i * kBatchStride);
        if (it.cls < 0) continue;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        uint8_t* st = stages + stage * kStageBytes;
        reinterpret_cast<uint32_t*>(st + kStItem)[lane] =
            batch[i * kBatchStride + lane];
        k1_fill_stage(it, smem_u32(st), coeffs, lane, mb_width, mb_height);
        mbar_arrive_cp_async(full0 + 8 * stage);
        mbar_arrive(full0 + 8 * stage);
        if (++stage == kK1Stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      __syncwarp();
    }
    // The end marker.
    mbar_wait(empty0 + 8 * stage, phase ^ 1);
    if (lane == 0)
      reinterpret_cast<K1Item*>(stages + stage * kStageBytes + kStItem)->cls =
          -1;
    mbar_arrive_cp_async(full0 + 8 * stage);
    mbar_arrive(full0 + 8 * stage);
    return;
  }

  // ---- consumer warps 0-2 ----
  const int lw = mb_width * 16, cw = mb_width * 8;
  const int luma_size = lw * mb_height * 16;
  const int chroma_size = cw * mb_height * 8;
  const int frame_size = luma_size + 2 * chroma_size;
  // This thread's four pixels of every item: plane, row r, first column.
  int plane, r, px0, blk;
  if (t < 64) {
    plane = 0;
    r = t >> 2;
    px0 = 4 * (t & 3);
    blk = (r >> 3) * 2 + ((t & 3) >> 1);
  } else {
    const int u = t - 64;
    plane = 1 + (u >> 4);
    r = (u & 15) >> 1;
    px0 = 4 * (u & 1);
    blk = 3 + plane;
  }
  const int stride = plane ? cw : lw;
  const int rows2m2 = (plane ? 96 * mb_height + 64 : 48 * mb_height + 32) - 2;
  const int dst_row = plane ? luma_size + (plane - 1) * chroma_size +
                                  r * cw + px0
                            : r * lw + px0;
  const int bw = plane ? 8 : 16;

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(full0 + 8 * stage, phase);
    uint8_t* st = stages + stage * kStageBytes;
    const K1Item& it = *reinterpret_cast<const K1Item*>(st + kStItem);
    const int cls = it.cls;
    if (cls == -1) break;
    int* res = reinterpret_cast<int*>(st + kStCoef);

    // The coded blocks' IDCT in place: warp 0 blocks 0-3, warp 1 blocks
    // 4-5, eight lanes a block (one 8-point line each), so the column
    // and the row pass need only a warp sync.
    if (cls & 0xFFF) {
      if (t < 64) {
        const int b = t >> 3, k = t & 7;
        const int c = b < 6 ? (cls >> (2 * b)) & 3 : 0;
        int* blkp = res + b * 64;
        int dc = 0;
        if (c == 1) {
          dc = (wint(blkp[0]) + 128 >> 8).i();  // read before the row pass
        } else if (c == 2) {
          if (k < 4) idct_line<true>(blkp + k, 8, false);
        } else if (c == 3) {
          idct_line<false>(blkp + k, 8, false);
        }
        __syncwarp();
        int* row = blkp + k * 8;
        if (c == 1) {
#pragma unroll
          for (int j = 0; j < 8; ++j) row[j] = dc;
        } else if (c == 2) {
          idct_line<true>(row, 1, true);
        } else if (c == 3) {
          idct_line<false>(row, 1, true);
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kK1Consumers) : "memory");
    }

    // Four pixels: prediction, residual, clamp, one 32-bit store.  The
    // half-pel blend works on the four bytes at once: (a + b + 1) >> 1
    // is __vavgu4, and (a + b + c + d + 2) >> 2 sums 16-bit lanes.
    const int bc = (cls >> (2 * blk)) & 3;
    const bool bintra = (cls >> (12 + blk)) & 1;
    uint32_t pred = 0;
    if (!(bc && bintra)) {
      const uint8_t* win = st + st_win(plane);
      if (it.sel > 0) {
        const int ys = min(max(it.ys0[plane] + r, 0), rows2m2);
        const int top = ys - it.lo[plane];
        const int xs = it.xs[plane], hv = it.ohov[plane];
        uint32_t a, a5;
        k1_row5(win + top * 32, ((ys * stride + xs) & 15) + px0, a, a5);
        pred = a;
        if (hv) {
          const uint32_t b = __funnelshift_r(a, a5, 8);
          if (hv == 1) {
            pred = __vavgu4(a, b);
          } else {
            uint32_t c, c5;
            k1_row5(win + (top + 1) * 32,
                    (((ys + 1) * stride + xs) & 15) + px0, c, c5);
            if (hv == 2) {
              pred = __vavgu4(a, c);
            } else {
              const uint32_t d = __funnelshift_r(c, c5, 8), m = 0x00FF00FFu;
              const uint32_t lo =
                  (a & m) + (b & m) + (c & m) + (d & m) + 0x00020002u;
              const uint32_t hi = ((a >> 8) & m) + ((b >> 8) & m) +
                                  ((c >> 8) & m) + ((d >> 8) & m) +
                                  0x00020002u;
              pred = ((lo >> 2) & m) | (((hi >> 2) & m) << 8);
            }
          }
        }
      } else {
        pred = *reinterpret_cast<const uint32_t*>(win + r * 32 + px0);
      }
    }
    uint32_t packed = pred;
    if (bc) {
      const int4 rv = *reinterpret_cast<const int4*>(
          res + blk * 64 + (r & 7) * 8 + (px0 & 7));
      const int rr[4] = {rv.x, rv.y, rv.z, rv.w};
      packed = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int base = bintra ? 0 : static_cast<int>((pred >> (8 * k)) & 0xFF);
        const int v = min(max((wint(base) + rr[k]).i(), 0), 255);
        packed |= static_cast<uint32_t>(v) << (8 * k);
      }
    }
    uint8_t* out = it.out;
    *reinterpret_cast<uint32_t*>(
        out + dst_row + (it.mby * bw) * stride + it.mbx * bw) = packed;
    if (it.mby == mb_height - 1 && t < 16) {
      const int pad = frame_size + it.mbx * 256 + t * 16;
      *reinterpret_cast<uint4*>(out + pad) =
          *reinterpret_cast<const uint4*>(st + kStPad + t * 16);
    }
    mbar_arrive(empty0 + 8 * stage);
    if (++stage == kK1Stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// K3: one plane stack of a picture, fed by K2's residual.
//
// Replaces mpeg_tpu/ops/pallas_kernels.py _plane_pallas
// (_make_plane_kernel, _mb_window_starts) and so, with K2 before it,
// reconstruct_picture_pallas_multi: one launch over the luma plane
// (BW = 16) and one over Cb and Cr stacked (BW = 8, Cb macroblock rows
// first), each doing MC, residual add and clamp.  The residual is read
// straight from K2's [mb, 6, 64] block layout (JAX builds residual
// planes first), and each macroblock's window start is computed here
// from its motion vector, not in a pass before.  The aligned (24, 256)
// source tiles, the one-hot f32 matmul row and column selection and the
// 128-lane macroblock grouping and padding are Mosaic workarounds and are
// gone.
//
// Bound: bytes.  It moves K1's bytes plus the residual that K2 writes to
// device memory and this kernel reads back: 12.5 MB each way at 1080p.
// K1 fuses the IDCT to avoid that round trip; this port of K3 exists so
// the two can be measured against each other.  One CTA per macroblock of
// the plane stack, one thread per pixel (BW * BW threads).
// ---------------------------------------------------------------------------
template <int BW>
__global__ void __launch_bounds__(BW * BW)
reconstruct_plane_kernel(const uint8_t* __restrict__ cur,
                         const uint8_t* __restrict__ fwd,
                         const uint8_t* __restrict__ bwd,
                         const int* __restrict__ res,
                         const int* __restrict__ nblocks,
                         const int* __restrict__ intra,
                         const int* __restrict__ src_sel,
                         const int* __restrict__ mv_h,
                         const int* __restrict__ mv_v,
                         uint8_t* __restrict__ out,
                         int mb_width, int mb_height) {
  const int lw = mb_width * 16, cw = mb_width * 8;
  const int luma_size = lw * mb_height * 16;
  const int chroma_size = cw * mb_height * 8;
  const int total = luma_size + 2 * chroma_size + lw * 16;
  const int mb = mb_width * mb_height;

  const int plane = blockIdx.x / mb;  // luma: 0; chroma: 0 Cb, 1 Cr
  const int m = blockIdx.x - plane * mb;
  const int mbx = m % mb_width, mby = m / mb_width;
  const int t = threadIdx.x, py = t / BW, px = t % BW;

  int base, stride, blk, mvh = mv_h[m], mvv = mv_v[m];
  if (BW == 16) {
    base = 0;
    stride = lw;
    blk = (py >> 3) * 2 + (px >> 3);
  } else {
    base = luma_size + plane * chroma_size;
    stride = cw;
    blk = 4 + plane;
    mvh = trunc_div2(mvh);
    mvv = trunc_div2(mvv);
  }
  const int dst = base + (mby * BW + py) * stride + mbx * BW + px;

  const int sel = src_sel[m];
  int pred;
  if (sel > 0) {
    const int hp = mvh >> 1, vp = mvv >> 1, oh = mvh & 1, ov = mvv & 1;
    // The macroblock's window start (ys0, xs): floor divmod of the flat
    // address of its pixel row 0 (_mb_window_starts).  Pixel row r starts
    // at row ys0 + r, clamped on its own to [0, rows2 - 2].
    const int flat0 = base + (mby * BW + vp) * stride + mbx * BW + hp +
                      (sel == 2 ? total : 0);
    const int ys0 = floor_div(flat0, stride);
    const int xs = flat0 - ys0 * stride;
    const int rows2 = 2 * total / stride;
    const int ys = min(max(ys0 + py, 0), rows2 - 2);
    pred = mc_taps(fwd, bwd, total, ys * stride + xs + px, stride, oh, ov);
  } else {
    pred = cur[dst];
  }

  int v = pred;
  if (nblocks[m * 6 + blk] > 0) {
    const int r = res[static_cast<int64_t>(m) * 384 + blk * 64 + (py & 7) * 8 + (px & 7)];
    const int basev = intra[m * 6 + blk] > 0 ? 0 : pred;
    v = min(max((wint(basev) + r).i(), 0), 255);
  }
  out[dst] = static_cast<uint8_t>(v);
}

}  // namespace

extern "C" {

int mt_idct_batch(const int* coeffs, const int* nblocks, int* out,
                  int64_t nblk, void* stream) {
  if (nblk > 0) {
    const int64_t grid = (nblk + kIdctBlocksPerCta - 1) / kIdctBlocksPerCta;
    idct_batch_kernel<<<static_cast<unsigned>(grid), kIdctThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(coeffs, nblocks, out, nblk);
  }
  return static_cast<int>(cudaGetLastError());
}

// S streams' picture-step (table: int32 [S, 5] on the device, or null
// for one picture with every slot 0).  Without streams nothing launches.
// The grid is persistent: kK1CtasPerSm CTAs a SM, or one an item.
int mt_reconstruct_pictures(const uint8_t* cur, const uint8_t* fwd,
                            const uint8_t* bwd, uint8_t* out,
                            const int* table, int n_streams,
                            const int* coeffs, const int* nblocks,
                            const int* intra, const int* src_sel,
                            const int* mv_h, const int* mv_v, int mb_width,
                            int mb_height, void* stream) {
  if (n_streams > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t items =
        static_cast<int64_t>(n_streams) * mb_width * mb_height;
    const int64_t cap = static_cast<int64_t>(sms) * kK1CtasPerSm;
    const unsigned grid = static_cast<unsigned>(items < cap ? items : cap);
    reconstruct_picture_kernel<<<grid, kK1Threads, kK1SmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
        cur, fwd, bwd, out, table, coeffs, nblocks, intra, src_sel, mv_h,
        mv_v, mb_width, mb_height, n_streams);
  }
  return static_cast<int>(cudaGetLastError());
}

// One K3 launch: the luma plane (chroma == 0) or Cb and Cr (chroma != 0).
int mt_reconstruct_plane(const uint8_t* cur, const uint8_t* fwd,
                         const uint8_t* bwd, const int* res,
                         const int* nblocks, const int* intra,
                         const int* src_sel, const int* mv_h,
                         const int* mv_v, uint8_t* out, int mb_width,
                         int mb_height, int chroma, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mb = mb_width * mb_height;
  if (chroma) {
    reconstruct_plane_kernel<8><<<2 * mb, 64, 0, s>>>(
        cur, fwd, bwd, res, nblocks, intra, src_sel, mv_h, mv_v, out,
        mb_width, mb_height);
  } else {
    reconstruct_plane_kernel<16><<<mb, 256, 0, s>>>(
        cur, fwd, bwd, res, nblocks, intra, src_sel, mv_h, mv_v, out,
        mb_width, mb_height);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's dynamic shared memory a CTA (ptxas reports only static shared
// memory).
int mt_reconstruct_smem_bytes() { return kK1SmemBytes; }

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
