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
// threads, consecutive words), transforms them there with the device
// function K1 uses (eight threads a block), and copies them out.
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
// and packed (8, wp) row layout are Mosaic workarounds and are gone: each
// thread reads its four taps straight from the flat [fwd | bwd] frames.
//
// Bound: bytes in the ideal, latency in practice.  At 1080p a picture
// reads 12.5 MB of dense coefficients, up to ~6.3 MB of reference pixels
// (4 taps per pixel, mostly from L1/L2) and the 3.1 MB current frame, and
// writes 3.1 MB: about 19 MB, ~6 us at 3.35 TB/s.  The simple design: one
// CTA per macroblock, 384 threads (256 luma + 64 Cb + 64 Cr pixels).  The
// CTA loads its 6x64 coefficients coalesced (one int per thread) into
// shared memory, runs the 6 blocks' IDCT there (48 threads, one 8-point
// line each, a column pass and a row pass), then every thread does its
// pixel's 4-tap MC and compose.  Five CTAs fit a SM, so too few bytes are
// in flight to near the byte floor: each CTA's chain of device-memory
// round trips sets the time (PERF.md).  What is computed once per CTA
// stays out of the per-pixel path: the grid is (mb_width, streams,
// mb_height), so no thread divides for its macroblock, and threads 6-8
// compute each plane's window start (one floor division), half-pel bits
// and src_sel into shared memory beside the blocks' counts and intra
// flags.  The CTAs of the last macroblock row also copy the padding bytes
// [frame_size, total_size), 256 each, from the current frame.
//
// Stream axis: blockIdx.y is the stream.  Row y of the int32 table
// [S, 5] holds that stream's (cur, fwd, bwd, out) slots in the frame pool
// (frames of total_size bytes from the four base pointers) and its
// picture index into the dense coefficients and the plan; a picture index
// < 0 makes the stream's step a no-op.  Without a table (S == 1) every
// slot and the picture index are 0: the four pointers are the frames.
// Pool and picture offsets are int64 (64 streams x window 8 at 1080p is
// 1.6 G coefficients).
// ---------------------------------------------------------------------------
constexpr int kReconThreads = 384;
constexpr int kTableCols = 5;  // cur, fwd, bwd, out slot; picture index

__global__ void __launch_bounds__(kReconThreads)
reconstruct_picture_kernel(const uint8_t* __restrict__ cur_pool,
                           const uint8_t* __restrict__ fwd_pool,
                           const uint8_t* __restrict__ bwd_pool,
                           uint8_t* __restrict__ out_pool,
                           const int* __restrict__ table,
                           const int* __restrict__ coeffs,
                           const int* __restrict__ nblocks,
                           const int* __restrict__ intra,
                           const int* __restrict__ src_sel,
                           const int* __restrict__ mv_h,
                           const int* __restrict__ mv_v,
                           int mb_width, int mb_height) {
  __shared__ int res[6 * 64];
  __shared__ int nb[6], ib[6];  // blocks' counts and intra flags
  __shared__ int win[3][4];     // per plane: ys0, xs, oh, ov
  __shared__ int sel;
  const int t = threadIdx.x;
  const int mbx = blockIdx.x, mby = blockIdx.z;

  // Geometry (mpeg_tpu/ops/video_recon.py FrameGeometry).
  const int lw = mb_width * 16, cw = mb_width * 8;
  const int luma_size = lw * mb_height * 16;
  const int chroma_size = cw * mb_height * 8;
  const int frame_size = luma_size + 2 * chroma_size;
  const int total = frame_size + lw * 16;

  // This stream's frames and picture.  The condition is uniform over the
  // CTA, so the early return skips no sync of a thread that stays.
  int64_t slot[4] = {0, 0, 0, 0}, pic = 0;
  if (table != nullptr) {
    const int* row = table + static_cast<int64_t>(blockIdx.y) * kTableCols;
    if (row[4] < 0) return;
    for (int k = 0; k < 4; ++k) slot[k] = row[k];
    pic = row[4];
  }
  const uint8_t* cur = cur_pool + slot[0] * total;
  const uint8_t* fwd = fwd_pool + slot[1] * total;
  const uint8_t* bwd = bwd_pool + slot[2] * total;
  uint8_t* out = out_pool + slot[3] * total;
  // This macroblock in the plan tensors.
  const int64_t pm = pic * (mb_width * mb_height) + mby * mb_width + mbx;

  res[t] = coeffs[pm * 384 + t];
  if (t < 6) {
    nb[t] = nblocks[pm * 6 + t];
    ib[t] = intra[pm * 6 + t];
  } else if (t < 9) {
    // Plane p's window start: floor division of the flat address of the
    // macroblock's pixel row 0 (junk vectors make it negative).  Pixel
    // row r starts r rows lower, at the same column.
    const int p = t - 6, s = src_sel[pm];
    int mvh = mv_h[pm], mvv = mv_v[pm], base = 0, stride = lw, bw = 16;
    if (p > 0) {
      base = luma_size + (p - 1) * chroma_size;
      stride = cw;
      bw = 8;
      mvh = trunc_div2(mvh);
      mvv = trunc_div2(mvv);
    }
    const int flat0 = base + (mby * bw + (mvv >> 1)) * stride + mbx * bw +
                      (mvh >> 1) + (s == 2 ? total : 0);
    const int ys0 = floor_div(flat0, stride);
    win[p][0] = ys0;
    win[p][1] = flat0 - ys0 * stride;
    win[p][2] = mvh & 1;
    win[p][3] = mvv & 1;
    if (p == 0) sel = s;
  }
  __syncthreads();

  // The six blocks' residuals, 48 threads at work.  Uncoded blocks
  // (n <= 0) are transformed too, though compose never reads them.
  smem_idct(res, nb, 6, t);

  // This thread's pixel: plane, stride, block, and rows2 = 2 * total /
  // stride (total = lw * (24 * mb_height + 16)).
  int plane, base, stride, bw, py, px, blk, rows2;
  if (t < 256) {
    plane = 0;
    base = 0;
    stride = lw;
    bw = 16;
    py = t >> 4;
    px = t & 15;
    blk = (py >> 3) * 2 + (px >> 3);
    rows2 = 48 * mb_height + 32;
  } else {
    const int u = t - 256, is_cr = u >> 6;
    plane = 1 + is_cr;
    base = luma_size + is_cr * chroma_size;
    stride = cw;
    bw = 8;
    py = (u & 63) >> 3;
    px = u & 7;
    blk = 4 + is_cr;
    rows2 = 96 * mb_height + 64;
  }
  const int dst = base + (mby * bw + py) * stride + mbx * bw + px;

  int pred;
  if (sel > 0) {
    // Each pixel row's window start clamped on its own to [0, rows2 - 2].
    const int* w = win[plane];
    const int ys = min(max(w[0] + py, 0), rows2 - 2);
    pred = mc_taps(fwd, bwd, total, ys * stride + w[1] + px, stride, w[2], w[3]);
  } else {
    pred = cur[dst];
  }

  int v = pred;
  if (nb[blk] > 0) {
    const int r = res[blk * 64 + (py & 7) * 8 + (px & 7)];
    const int basev = ib[blk] > 0 ? 0 : pred;
    v = min(max((wint(basev) + r).i(), 0), 255);
  }
  out[dst] = static_cast<uint8_t>(v);
  // Bytes [frame_size, total_size) carry over from cur.
  if (mby == mb_height - 1 && t < 256) {
    const int pad = frame_size + mbx * 256 + t;
    out[pad] = cur[pad];
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
int mt_reconstruct_pictures(const uint8_t* cur, const uint8_t* fwd,
                            const uint8_t* bwd, uint8_t* out,
                            const int* table, int n_streams,
                            const int* coeffs, const int* nblocks,
                            const int* intra, const int* src_sel,
                            const int* mv_h, const int* mv_v, int mb_width,
                            int mb_height, void* stream) {
  if (n_streams > 0) {
    const dim3 grid(mb_width, n_streams, mb_height);
    reconstruct_picture_kernel<<<grid, kReconThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        cur, fwd, bwd, out, table, coeffs, nblocks, intra, src_sel, mv_h,
        mv_v, mb_width, mb_height);
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

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
