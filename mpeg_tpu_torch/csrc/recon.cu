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
// The persistent reconstruct: one kernel template that K1 and K3 share.
//
// A launch walks work items, one macroblock of one stream's picture each,
// and reconstructs a plane set of each item: all three planes with the
// IDCT fused in (K1), or, from K2's residual, the luma plane or Cb and Cr
// (K3's two launches).  What bounds each launch and what it costs on the
// card are in K1's and K3's notes below.  Against its bytes the design
// does this:
//
// - Uncoded blocks cost nothing: a block with nblocks <= 0 loads none of
//   its 256 B of coefficients or residual (compose never reads them; K1
//   runs no IDCT for it), and a block coded intra loads no prediction
//   (compose never reads it).  The producer decides both once a block,
//   from the item's class word.
// - Bytes stay in flight: a persistent grid (a few CTAs a SM) walks the
//   items, CTA c taking items c, c + G, c + 2G, ...  The last warp of
//   each CTA is the producer: it reads 32 items' plan scalars at once
//   (one lane an item: the table row, nblocks, intra, src_sel, motion
//   vector; each plane's window start by one floor division), then fills
//   a ring of stages in shared memory, one item a stage: the coded
//   blocks' coefficients or residual, each plane's reference rows (or the
//   current frame's rows), the pad bytes and the item's scalars.  The
//   copies are cp.async, 16 B (8 B for current-frame rows) a lane, and
//   complete on the stage's `full` mbarrier
//   (cp.async.mbarrier.arrive.noinc).  cp.async, not 1-D bulk copies: a
//   reference row is two aligned 16-B granules of the flat [fwd | bwd]
//   stack, each from fwd or bwd and zero past 2 * total, which cp.async's
//   source-size operand zero-fills in the same instruction; a bulk copy
//   can neither choose per granule nor zero-fill, and a block is only
//   256 B.  The consumer warps hold kItems items at once, one group of
//   warps an item: group g takes items g, g + kItems, ... in ring order
//   and frees each stage on its `empty` mbarrier, so the loads of the
//   next stages overlap the compute on this one.
// - MC from shared memory: each plane's window is staged as whole rows,
//   two aligned 16-B granules from the row's flat address, so a row that
//   runs past its end continues into the next row's bytes and a granule
//   past 2 * total reads 0.  Pixel row r's taps come from staged row
//   clamp(ys0 + r) - clamp(ys0) (each row clamped on its own to
//   [0, rows2 - 2], so clamped rows repeat) and its c/d taps from the
//   staged row after it (the clamped row + 1): at most 17 rows.
// - Wide loads and stores: a consumer thread computes 4 neighbouring
//   pixels (the taps from two 32-bit shared loads a row, blended
//   byte-parallel; the residual one int4 shared load) and stores them as
//   one 32-bit word; the pad goes out in 16-B words.
// - No tensor cores: the work is integer blending bound by bytes, and
//   K1's exact IDCT rounds with >> 8 between its passes, which wgmma
//   cannot compute exactly (~600 integer ops a block stay far below the
//   card's integer rate).
//
// Stream axis (K1): row s of the int32 table [S, 5] holds that stream's
// (cur, fwd, bwd, out) slots in the frame pool (frames of total_size
// bytes from the four base pointers) and its picture index into the
// dense blocks and the plan; a picture index < 0 makes the stream's step
// a no-op.  Without a table (S == 1, and always in K3) every slot and the
// picture index are 0: the four pointers are the frames.  Pool and
// picture offsets are int64 (64 streams x window 8 at 1080p is 1.6 G
// coefficients).  fwd may alias bwd; out never aliases a frame read.
// ---------------------------------------------------------------------------
constexpr int kTableCols = 5;  // cur, fwd, bwd, out slot; picture index
// The producer's 32 items, 34 words apart (8-byte aligned, and its
// lanes' writes hit distinct bank pairs).
constexpr int kBatchStride = 34;

// A launch's plane set: planes [P0, P1) of each macroblock (0 luma, 1 Cb,
// 2 Cr), and whether its stages hold coefficients to transform (K1, all
// three planes) or residual to add (K3: luma, or Cb and Cr).
template <int P0, int P1, bool COEF>
struct PlaneSet {
  static_assert((P0 == 0 || P0 == 1) && P0 < P1 && P1 <= 3, "plane set");
  static_assert(!COEF || (P0 == 0 && P1 == 3), "K1 transforms six blocks");
  static constexpr int kP0 = P0, kP1 = P1;
  static constexpr bool kCoef = COEF;
  static constexpr bool kLuma = P0 == 0;
  static constexpr int kChroma = P1 - 1;                // Cb and Cr planes
  static constexpr int kB0 = kLuma ? 0 : 4;             // first block
  static constexpr int kBlocks = 4 * kLuma + kChroma;
  static constexpr int kLumaRows = kLuma ? 17 : 0;      // staged rows
  static constexpr int kWinRows = kLumaRows + 9 * kChroma;
  static constexpr bool kPad = P1 == 3;   // the launch that writes the pad
  static constexpr int kItemThreads = 64 * kLuma + 16 * kChroma;
  // Stage layout (bytes): the blocks, int32 [kBlocks][64]; the staged
  // rows, 32 B a row (luma 17, Cb and Cr 9 each); the pad; the item.
  static constexpr int kStWin = kBlocks * 256;
  static constexpr int kStPad = kStWin + kWinRows * 32;
  static constexpr int kStItem = kStPad + (kPad ? 256 : 0);
  static constexpr int kStageBytes = kStItem + 128;
  static_assert(kStageBytes % 16 == 0, "stage alignment");
  // Plane p's staged rows within a stage.
  __device__ static __forceinline__ int win(int p) {
    return kStWin + (p == 0 ? 0 : kLumaRows + 9 * (p - 1)) * 32;
  }
};

// A launch's shape: its plane set, ring depth, the items its consumer
// warps hold at once, and CTAs a SM.
template <class PS, int STAGES, int ITEMS, int CTAS>
struct Launch {
  using Planes = PS;
  static_assert(!PS::kCoef || ITEMS == 1, "K1's IDCT syncs all consumers");
  static_assert(STAGES % ITEMS == 0, "each stage serves one consumer group");
  static constexpr int kStages = STAGES, kItems = ITEMS, kCtasPerSm = CTAS;
  static constexpr int kConsumers = ITEMS * PS::kItemThreads;
  static_assert(kConsumers % 32 == 0, "whole consumer warps");
  static constexpr int kThreads = kConsumers + 32;   // + the producer warp
  static constexpr int kSmemBytes =
      STAGES * PS::kStageBytes + 32 * kBatchStride * 4 + 2 * STAGES * 8;
};

// One work item's scalars, 128 B: written by the producer, read by the
// consumers.  cls packs each block's IDCT class in bits 2b..2b+1 (0
// uncoded, 1 DC only, 2 sparse, 3 full) and its intra flag in bit 12 + b,
// for the plane set's blocks b; cls < 0 marks a skipped item (-2) or the
// end of a consumer group's items (-1).
struct Item {
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
static_assert(sizeof(Item) == 128, "Item is 32 words");

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

// Programmatic dependent launch (Hopper): this CTA lets the next kernel in
// the stream, when it was launched to overlap this one, start; and this
// thread waits until the kernel it overlaps has completed and its writes
// are visible.  Without such a launch both return at once.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The item of global index g (stream g / mb, macroblock g % mb) as the
// producer lane that owns it computes it, for the plane set's planes.
template <class PS>
__device__ __forceinline__ void make_item(
    Item& it, int64_t g, int64_t n_items, const uint8_t* cur_pool,
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
  for (int k = PS::kB0 / 2; k < (PS::kB0 + PS::kBlocks) / 2; ++k) {
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
  for (int p = PS::kP0; p < PS::kP1; ++p) {
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

// The producer lane's copies of item `it` into the stage at `st`:
// `blocks` are the coefficients (K1) or the residual (K3), int32
// [pictures * mb, 6, 64].
template <class PS>
__device__ __forceinline__ void fill_stage(const Item& it, uint32_t st,
                                           const int* blocks, int lane,
                                           int mb_width, int mb_height) {
  const int lw = mb_width * 16, cw = mb_width * 8;
  const int luma_size = lw * mb_height * 16;
  const int chroma_size = cw * mb_height * 8;
  const int frame_size = luma_size + 2 * chroma_size;
  const int total = frame_size + lw * 16;
  const int cls = it.cls;
  // The coded blocks: 16 granules a block.
  const int* bk = blocks + it.pm * 384 + PS::kB0 * 64;
#pragma unroll
  for (int k = 0; k < PS::kBlocks / 2; ++k) {
    const int t = lane + 32 * k, b = PS::kB0 + (t >> 4);
    if ((cls >> (2 * b)) & 3) cp_async16(st + t * 16, bk + t * 4, 16);
  }
  if (it.sel > 0) {
    // Reference rows: two aligned granules of the flat [fwd | bwd] stack
    // a row, each from fwd or bwd, zero past 2 * total.  Tasks: 34 luma
    // (17 rows), then 18 Cb and 18 Cr (9 rows each).
    constexpr int kTasks = 34 * PS::kLuma + 18 * PS::kChroma;
#pragma unroll
    for (int k = 0; k < (kTasks + 31) / 32; ++k) {
      const int t = lane + 32 * k;
      int p, j;
      if (PS::kLuma && t < 34) {
        p = 0;
        j = t >> 1;
      } else {
        const int u = t - 34 * PS::kLuma;
        p = 1 + (u >= 18);
        j = (u - (u >= 18 ? 18 : 0)) >> 1;
      }
      if (t < kTasks && j < it.rows[p]) {
        const int stride = p ? cw : lw;
        const int a = (it.lo[p] + j) * stride + it.xs[p];
        const int c = (a & ~15) + 16 * (t & 1);
        const uint8_t* src = c < total ? it.fwd + c : it.bwd + (c - total);
        cp_async16(st + PS::win(p) + j * 32 + 16 * (t & 1),
                   c < 2 * total ? src : it.fwd, c < 2 * total ? 16 : 0);
      }
    }
  } else {
    // The current frame's rows of each block not coded intra, 8 B a
    // row: luma row r at bytes 0..15 of staged row r, chroma at 0..7.
#pragma unroll
    for (int k = 0; k < (PS::kBlocks * 8 + 31) / 32; ++k) {
      const int t = lane + 32 * k, b = PS::kB0 + (t >> 3), r = t & 7;
      const bool coded_intra = ((cls >> (2 * b)) & 3) && ((cls >> (12 + b)) & 1);
      if (t < PS::kBlocks * 8 && !coded_intra) {
        if (b < 4) {
          const int row = (b >> 1) * 8 + r, half = b & 1;
          cp_async8(st + PS::win(0) + row * 32 + half * 8,
                    it.cur + (it.mby * 16 + row) * lw + it.mbx * 16 + half * 8);
        } else {
          cp_async8(st + PS::win(b - 3) + r * 32,
                    it.cur + luma_size + (b - 4) * chroma_size +
                        (it.mby * 8 + r) * cw + it.mbx * 8);
        }
      }
    }
  }
  // The pad bytes [frame_size, total_size) carry over from cur: the
  // last macroblock row's items copy 256 B each.
  if (PS::kPad && it.mby == mb_height - 1 && lane < 16)
    cp_async16(st + PS::kStPad + lane * 16,
               it.cur + frame_size + it.mbx * 256 + lane * 16, 16);
}

// Four bytes of a staged row from byte `o` on (o + 4 < 32), and the fifth.
__device__ __forceinline__ void row5(const uint8_t* row, int o,
                                     uint32_t& w4, uint32_t& b4) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (o & ~3));
  const uint32_t sh = 8 * (o & 3);
  const uint32_t w0 = w[0], w1 = w[1];
  w4 = __funnelshift_r(w0, w1, sh);
  b4 = (w1 >> sh) & 0xFF;
}

template <class L>
__global__ void __launch_bounds__(L::kThreads, L::kCtasPerSm)
reconstruct_kernel(const uint8_t* cur_pool, const uint8_t* fwd_pool,
                   const uint8_t* bwd_pool, uint8_t* out_pool,
                   const int* __restrict__ table,
                   const int* __restrict__ blocks,
                   const int* __restrict__ nblocks,
                   const int* __restrict__ intra,
                   const int* __restrict__ src_sel,
                   const int* __restrict__ mv_h,
                   const int* __restrict__ mv_v,
                   int mb_width, int mb_height, int n_streams) {
  using PS = typename L::Planes;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* stages = smem;
  uint32_t* batch =
      reinterpret_cast<uint32_t*>(smem + kStages * PS::kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(batch + 32 * kBatchStride);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 64);             // 32 lanes, twice each
      mbar_init(empty0 + 8 * s, PS::kItemThreads);   // one consumer group
    }
  }
  // K3's luma launch lets the Cb|Cr launch, which overlaps it, start.
  if constexpr (PS::kLuma && !PS::kCoef) grid_launch_dependents();
  __syncthreads();

  const int64_t n_items =
      static_cast<int64_t>(n_streams) * mb_width * mb_height;
  const int64_t grid = gridDim.x;

  if (t >= L::kConsumers) {
    // ---- producer warp ----
    const int lane = t - L::kConsumers;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t k0 = 0; blockIdx.x + k0 * grid < n_items; k0 += 32) {
      make_item<PS>(*reinterpret_cast<Item*>(batch + lane * kBatchStride),
                    blockIdx.x + (k0 + lane) * grid, n_items, cur_pool,
                    fwd_pool, bwd_pool, out_pool, table, nblocks, intra,
                    src_sel, mv_h, mv_v, mb_width, mb_height);
      __syncwarp();
      for (int i = 0; i < 32; ++i) {
        const Item& it =
            *reinterpret_cast<const Item*>(batch + i * kBatchStride);
        if (it.cls < 0) continue;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        uint8_t* st = stages + stage * PS::kStageBytes;
        reinterpret_cast<uint32_t*>(st + PS::kStItem)[lane] =
            batch[i * kBatchStride + lane];
        fill_stage<PS>(it, smem_u32(st), blocks, lane, mb_width, mb_height);
        mbar_arrive_cp_async(full0 + 8 * stage);
        mbar_arrive(full0 + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      __syncwarp();
    }
    // One end marker for each consumer group: the next kItems items.
    for (int i = 0; i < L::kItems; ++i) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      if (lane == 0)
        reinterpret_cast<Item*>(stages + stage * PS::kStageBytes +
                                PS::kStItem)->cls = -1;
      mbar_arrive_cp_async(full0 + 8 * stage);
      mbar_arrive(full0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // K3's Cb|Cr launch overlaps the luma launch and ends after it.
    if constexpr (!PS::kLuma) grid_wait();
    return;
  }

  // ---- consumer warps: kItems groups of kItemThreads ----
  const int grp = L::kItems == 1 ? 0 : t / PS::kItemThreads;
  const int u = t - grp * PS::kItemThreads;
  const int lw = mb_width * 16, cw = mb_width * 8;
  const int luma_size = lw * mb_height * 16;
  const int chroma_size = cw * mb_height * 8;
  const int frame_size = luma_size + 2 * chroma_size;
  // This thread's four pixels of every item: plane, row r, first column.
  int plane, r, px0, blk;
  if (PS::kLuma && u < 64) {
    plane = 0;
    r = u >> 2;
    px0 = 4 * (u & 3);
    blk = (r >> 3) * 2 + ((u & 3) >> 1);
  } else {
    const int v = u - 64 * PS::kLuma;
    plane = 1 + (v >> 4);
    r = (v & 15) >> 1;
    px0 = 4 * (v & 1);
    blk = 3 + plane;
  }
  const int stride = plane ? cw : lw;
  const int rows2m2 = (plane ? 96 * mb_height + 64 : 48 * mb_height + 32) - 2;
  const int dst_row = plane ? luma_size + (plane - 1) * chroma_size +
                                  r * cw + px0
                            : r * lw + px0;
  const int bw = plane ? 8 : 16;

  int stage = grp;                  // this group's items: grp, grp + kItems, ...
  uint32_t phase = 0;
  while (true) {
    mbar_wait(full0 + 8 * stage, phase);
    uint8_t* st = stages + stage * PS::kStageBytes;
    const Item& it = *reinterpret_cast<const Item*>(st + PS::kStItem);
    const int cls = it.cls;
    if (cls == -1) break;
    int* res = reinterpret_cast<int*>(st);

    if constexpr (PS::kCoef) {
      // The coded blocks' IDCT in place: warp 0 blocks 0-3, warp 1
      // blocks 4-5, eight lanes a block (one 8-point line each), so the
      // column and the row pass need only a warp sync.
      if (cls & 0xFFF) {
        if (u < 64) {
          const int b = u >> 3, k = u & 7;
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
        asm volatile("bar.sync 1, %0;\n" ::"n"(L::kConsumers) : "memory");
      }
    }

    // Four pixels: prediction, residual, clamp, one 32-bit store.  The
    // half-pel blend works on the four bytes at once: (a + b + 1) >> 1
    // is __vavgu4, and (a + b + c + d + 2) >> 2 sums 16-bit lanes.
    const int bc = (cls >> (2 * blk)) & 3;
    const bool bintra = (cls >> (12 + blk)) & 1;
    uint32_t pred = 0;
    if (!(bc && bintra)) {
      const uint8_t* win = st + PS::win(plane);
      if (it.sel > 0) {
        const int ys = min(max(it.ys0[plane] + r, 0), rows2m2);
        const int top = ys - it.lo[plane];
        const int xs = it.xs[plane], hv = it.ohov[plane];
        uint32_t a, a5;
        row5(win + top * 32, ((ys * stride + xs) & 15) + px0, a, a5);
        pred = a;
        if (hv) {
          const uint32_t b = __funnelshift_r(a, a5, 8);
          if (hv == 1) {
            pred = __vavgu4(a, b);
          } else {
            uint32_t c, c5;
            row5(win + (top + 1) * 32, (((ys + 1) * stride + xs) & 15) + px0,
                 c, c5);
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
          res + (blk - PS::kB0) * 64 + (r & 7) * 8 + (px0 & 7));
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
    if (PS::kPad && it.mby == mb_height - 1 && u < 16) {
      const int pad = frame_size + it.mbx * 256 + u * 16;
      *reinterpret_cast<uint4*>(out + pad) =
          *reinterpret_cast<const uint4*>(st + PS::kStPad + u * 16);
    }
    mbar_arrive(empty0 + 8 * stage);
    stage += L::kItems;
    if (stage >= kStages) {
      stage -= kStages;
      phase ^= 1;
    }
  }
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
// blocks ~7.5 MB (~2.2 us).
//
// Design: the persistent kernel above with coefficient stages, an item a
// macroblock's three planes (96 consumer threads: 64 luma, 16 Cb, 16
// Cr); consumer warps 0-1 run the coded blocks' IDCT in the stage before
// the compose.  Four CTAs a SM of one producer and three consumer warps
// and a ring of 6 stages (ptxas: 106 registers; 22,688 B of shared memory
// a CTA, mt_reconstruct_smem_bytes): on an H100 two CTAs were slower on
// every case, six and eight faster on one picture but slower on 64-stream
// launches, and rings of 4, 6 and 8 stages timed within 2.3%
// (chip_smoke.py --baseline; PERF.md).  What holds K1 back is each CTA's
// serial walk of its items (the producer's issue and the handshakes), not
// bytes in flight.
// ---------------------------------------------------------------------------
using K1Launch = Launch<PlaneSet<0, 3, true>, 6, 1, 4>;

// ---------------------------------------------------------------------------
// K3: the two-launch plane reconstruct, fed by K2's residual.
//
// Replaces mpeg_tpu/ops/pallas_kernels.py _plane_pallas
// (_make_plane_kernel, _mb_window_starts) and so, with K2 before it,
// reconstruct_picture_pallas_multi: one launch over the luma plane and
// one over Cb and Cr, each doing MC, residual add and clamp; the Cb|Cr
// launch also writes the pad bytes [frame_size, total_size) from cur, so
// no third launch copies them.  The residual is read from K2's
// [mb, 6, 64] block layout and each macroblock's window start is
// computed here from its motion vector.  The aligned (24, 256) source
// tiles, the one-hot f32 matmul row and column selection and the
// 128-lane macroblock grouping and padding are Mosaic workarounds and
// are gone.  The JAX package keeps this variant to compare with its
// fused kernel, and so does the port: K1 fuses the IDCT and never writes
// a residual to device memory.
//
// Bound: bytes.  The two plane launches move K1's bytes with residual in
// place of coefficients (256 B a coded block either way; reconstruct_bound):
// 5.72 us at 3.35 TB/s on the adversarial 1080p plan, 2.52 us a fixture
// picture on average.  The path adds K2, which reads and writes every
// block (516 B a block, 7.54 us at 1080p; reconstruct_bound with
// separate_idct): 13.3 us on the adversarial plan, so the K3 path's
// floor is never below K1's.
//
// Design: the persistent kernel above with residual stages, nothing
// transformed, no tensor cores (byte-bound integer blending).  A luma
// item is a macroblock's 256 luma pixels (64 consumer threads, 4 pixels
// each), a Cb|Cr item its 2 x 64 chroma pixels (32 threads).  The
// consumers hold one luma item or two Cb|Cr items at once: two consumer
// warps in either launch, so none idles in the Cb|Cr launch (K1's
// three-warp item would leave two of three idle there).  Six CTAs a SM,
// a ring of 6 stages.  The Cb|Cr launch reads nothing the luma launch
// writes, so it is launched to overlap it (programmatic dependent
// launch): its CTAs run beside the luma launch's on each SM, and its
// producers wait for the luma launch only before they exit.
//
// Measured on an H100 (chip_smoke.py --baseline, in turns; PERF.md): the
// plane launches alone take about 13 us a picture on the adversarial
// plan and on the fixture's pictures, K3's whole path about 25-27.
// Holding two luma or four Cb|Cr items at once (four consumer warps) was
// 8-10% slower at four CTAs a SM and 27-32% slower at six with the
// overlap (48 registers x 160 threads x 6 CTAs leave no room on a SM for
// the other launch's CTAs).  More CTAs a SM helped up to 12; six with
// the overlap beat 12 without it by 18-23%.  What holds K3 back is each
// CTA's serial walk of ~10 items a launch (the producer's issue, the
// copies' latency and the handshakes) and the launches' own cost, not
// bytes: the fixture's pictures, which code 5-8% of their blocks, take
// as long as the adversarial plan.
//
// ptxas: 48 registers a thread in either launch, no spills; dynamic
// shared memory 14,624 B a CTA (luma) and 13,280 B (Cb|Cr),
// mt_plane_smem_bytes.
// ---------------------------------------------------------------------------
using K3LumaLaunch = Launch<PlaneSet<0, 1, false>, 6, 1, 6>;
using K3ChromaLaunch = Launch<PlaneSet<1, 3, false>, 6, 2, 6>;

// One launch of L over n_streams items a macroblock: a persistent grid of
// L::kCtasPerSm CTAs a SM, or one an item.  With `overlap` it may start
// while the kernel before it in the stream still runs (it then reads
// nothing that kernel writes, and ends after it).
template <class L>
void launch(const uint8_t* cur, const uint8_t* fwd, const uint8_t* bwd,
            uint8_t* out, const int* table, int n_streams, const int* blocks,
            const int* nblocks, const int* intra, const int* src_sel,
            const int* mv_h, const int* mv_v, int mb_width, int mb_height,
            void* stream, bool overlap = false) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t items = static_cast<int64_t>(n_streams) * mb_width * mb_height;
  const int64_t cap = static_cast<int64_t>(sms) * L::kCtasPerSm;
  const unsigned grid = static_cast<unsigned>(items < cap ? items : cap);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = overlap;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, reconstruct_kernel<L>, cur, fwd, bwd, out, table,
                     blocks, nblocks, intra, src_sel, mv_h, mv_v, mb_width,
                     mb_height, n_streams);
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

// K1: S streams' picture-step (table: int32 [S, 5] on the device, or null
// for one picture with every slot 0).  Without streams nothing launches.
int mt_reconstruct_pictures(const uint8_t* cur, const uint8_t* fwd,
                            const uint8_t* bwd, uint8_t* out,
                            const int* table, int n_streams,
                            const int* coeffs, const int* nblocks,
                            const int* intra, const int* src_sel,
                            const int* mv_h, const int* mv_v, int mb_width,
                            int mb_height, void* stream) {
  if (n_streams > 0)
    launch<K1Launch>(cur, fwd, bwd, out, table, n_streams, coeffs, nblocks,
                     intra, src_sel, mv_h, mv_v, mb_width, mb_height, stream);
  return static_cast<int>(cudaGetLastError());
}

// One K3 launch: the luma plane (chroma == 0) or Cb, Cr and the pad
// (chroma != 0) of one picture, from K2's residual `res`.  The Cb|Cr
// launch overlaps the luma launch, which writes nothing it reads: launch
// it right after that launch on the same stream.
int mt_reconstruct_plane(const uint8_t* cur, const uint8_t* fwd,
                         const uint8_t* bwd, const int* res,
                         const int* nblocks, const int* intra,
                         const int* src_sel, const int* mv_h,
                         const int* mv_v, uint8_t* out, int mb_width,
                         int mb_height, int chroma, void* stream) {
  if (chroma)
    launch<K3ChromaLaunch>(cur, fwd, bwd, out, nullptr, 1, res, nblocks,
                           intra, src_sel, mv_h, mv_v, mb_width, mb_height,
                           stream, true);
  else
    launch<K3LumaLaunch>(cur, fwd, bwd, out, nullptr, 1, res, nblocks, intra,
                         src_sel, mv_h, mv_v, mb_width, mb_height, stream);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a CTA (ptxas reports only static shared memory):
// K1's, and K3's luma (chroma == 0) or Cb|Cr launch's.
int mt_reconstruct_smem_bytes() { return K1Launch::kSmemBytes; }

int mt_plane_smem_bytes(int chroma) {
  return chroma ? K3ChromaLaunch::kSmemBytes : K3LumaLaunch::kSmemBytes;
}

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
