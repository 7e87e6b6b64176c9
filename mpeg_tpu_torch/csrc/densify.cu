// K5: the window densify and metadata unpack on Hopper, two launches a call.
//
// Replaces the JAX package's jitted window program that rebuilds a window's
// plan from its blob: densify_split_jax (mpeg_tpu/parallel/batch.py:392, its
// own executable in make_blob_scan_decoder, :762-764) and unpack_blob_meta
// (:460, opened by the scan_stage executable, :766-770).  The same pair runs
// in make_picture_blob_recon (:810-811, the interactive decode), in
// make_global_scan_decoder (mpeg_tpu/parallel/multistream.py:66-75) and, per
// stream, in the sharded decoder (unpack_blob_jax,
// mpeg_tpu/parallel/sharding.py:77).  Neither is a pallas_call.  The plain
// version is mpeg_tpu_torch/parallel/batch.py densify_split +
// unpack_blob_meta; K5 equals it on every coded block and on every metadata
// tensor.
//
// Plain C entry points loaded with ctypes by mpeg_tpu_torch/ops/_build.py,
// which builds this file into its own library.  mt_densify_unpack returns the
// first nonzero cudaGetLastError() code of its launches.
//
// The function, for each stream s of S (every stream's blob is its own: its
// own chains from 0 and its own dense span of n = window * mb * 384 int32 at
// coeffs + s * n):
// - main records, one little-endian int32 each: idx is the int32 inclusive
//   prefix sum, wrapping, of rec & 0xFFFF, then min(idx, n - 1); its value is
//   (rec >> 16) * premult[idx & 63], an int32 product that wraps;
// - escape records: idx the prefix sum of the uint16 esc_didx, clamped the
//   same way; the value esc_val;
// - an index below 0 then gets n added, and one still below 0 adds nothing;
//   every other record adds its value at idx (a value of 0 adds nothing and
//   is skipped: hops, pads and the zero tail of a bucketed main lane);
// - metadata, from the blob's prefix: nblocks = nb_class_rep[(nbcls >> 2b) &
//   3], intra_blk = (mbmisc >> b) & 1, src_sel = mbmisc >> 6, mv_h and mv_v
//   sign-extended, is_ref = flags & 1, is_noop = 1 - ((flags >> 1) & 1).
// K5 writes the 64 coefficients of each coded block (2-bit class != 0) and
// no others: the wrapper allocates the span with torch.empty, and an uncoded
// block keeps whatever the memory held.  K1 and K3 load nothing there; K2
// reads it and K3 skips its residual there.  The plain version zero-fills
// the whole span.
//
// Bound: bytes (cuda_kernels.densify_bound): the records read (4 B main, 6 B
// escape), the blob's metadata read (4 B a picture, 7 B a macroblock), the
// unpacked metadata written (8 B a picture, 60 B a macroblock) and 256 B a
// coded block written; the integer work is a few operations a byte.  Writing
// only the coded blocks is what takes the dense span's zero fill off that
// floor: at 1080p a 16-picture window's span is 200.5 MB.
//
// Design.  The prefix sum is the one dependency across the whole call, and
// no CTA may wait on another, so it is split in two launches of 256 threads:
// - Launch A, a grid of (tiles, streams) with three kinds of CTA.  A
//   metadata CTA unpacks 128 macroblocks (a thread a macroblock into shared
//   memory, then coalesced stores of nblocks and intra_blk) and zeroes their
//   coded blocks with 16-byte stores, half a warp a block.  A record CTA sums
//   the deltas of one tile of 4,096 records of one lane (uint32, wrapping)
//   into the scratch `sums`.
// - Launch B, a grid of (record tiles, streams).  Each CTA adds up the sums
//   of its lane's tiles before its own (a few thousand at most), then each
//   warp holds 512 consecutive records, 16 a lane, loaded coalesced; the warp
//   totals give each warp its start, and 16 rounds of a 5-step shuffle scan
//   give every record its index.  Each record with a nonzero value is one
//   atomicAdd into the span: int32 adds commute, so the result does not
//   depend on their order, and sorted chains keep a warp's adds on few
//   lines.
// Offsets into the outputs are int64 (8 streams of 16 1080p pictures are
// 1.6 GB of coefficients); a stream's span stays below 2^31 entries, as the
// int32 chain needs.

#include <cuda_runtime.h>
#include <stdint.h>

// The arguments of one call.  ops/_build.py mirrors this struct field for
// field (DensifyArgs) and checks its size against mt_densify_args_bytes().
struct MtDensifyArgs {
  const uint8_t* meta;       // stream s's blob prefix: meta + s * meta_stride
  const uint8_t* main;       // its main records: main + s * main_stride
  long long meta_stride;     // bytes
  long long main_stride;     // bytes
  const int* premult;        // int32 [64]
  const int* nb_class_rep;   // int32 [4]
  int* coeffs;               // int32 [S * window * mb * 384]
  int* nblocks;              // int32 [S * window * mb * 6]
  int* intra_blk;            // int32 [S * window * mb * 6]
  int* src_sel;              // int32 [S * window * mb]
  int* mv_h;                 // int32 [S * window * mb]
  int* mv_v;                 // int32 [S * window * mb]
  int* is_ref;               // int32 [S * window]
  int* is_noop;              // int32 [S * window]
  unsigned int* sums;        // scratch, mt_densify_scratch_words(S, kt, ke)
  int streams;
  int window;                // pictures a stream
  int mb;                    // macroblocks a picture
  int kt;                    // main records a stream
  int ke;                    // escape records a stream
  int off_flags;             // byte offsets of the prefix's fields
  int off_mv_h;
  int off_mv_v;
  int off_nbcls;
  int off_mbmisc;
  int off_esc_didx;
  int off_esc_val;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 16;                  // records a lane holds
constexpr int kWarpRecords = 32 * kPerLane;   // 512 consecutive records a warp
constexpr int kTile = kThreads * kPerLane;    // 4,096 records a record tile
constexpr int kMbTile = 128;                  // macroblocks a metadata CTA
constexpr int kMbWords = 6 * 64;              // coefficients a macroblock
constexpr int kMaxRecords = 1 << 30;          // a lane, at most
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ int tiles(int records) {
  return (records + kTile - 1) / kTile;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The CTA's sum of v (wrapping), to every thread; red: kWarps words.
__device__ uint32_t block_sum(uint32_t v, uint32_t* red) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  v = warp_sum(v);
  if (l == 0) red[w] = v;
  __syncthreads();
  v = warp_sum(l < kWarps ? red[l] : 0u);
  __syncthreads();
  return v;
}

// Launch A's metadata CTA: macroblocks [tile * 128, +128) of stream s.
__device__ void unpack_tile(const MtDensifyArgs& a, const uint8_t* meta, int s,
                            int tile) {
  __shared__ int nb[kMbTile * 6];
  __shared__ int intra[kMbTile * 6];
  __shared__ uint8_t coded[kMbTile * 6];
  const int total = a.window * a.mb;           // macroblocks a stream
  const int m0 = tile * kMbTile;
  const int here = min(kMbTile, total - m0);
  const long long g0 = static_cast<long long>(s) * total + m0;
  const int t = threadIdx.x;
  if (t < here) {
    const int m = m0 + t;
    const int cls = reinterpret_cast<const uint16_t*>(meta + a.off_nbcls)[m];
    const int misc = meta[a.off_mbmisc + m];
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      const int c = (cls >> (2 * b)) & 3;
      nb[t * 6 + b] = a.nb_class_rep[c];
      intra[t * 6 + b] = (misc >> b) & 1;
      coded[t * 6 + b] = c != 0;
    }
    a.src_sel[g0 + t] = misc >> 6;
    a.mv_h[g0 + t] = reinterpret_cast<const int16_t*>(meta + a.off_mv_h)[m];
    a.mv_v[g0 + t] = reinterpret_cast<const int16_t*>(meta + a.off_mv_v)[m];
  }
  if (tile == 0) {
    const int* flags = reinterpret_cast<const int*>(meta + a.off_flags);
    for (int p = t; p < a.window; p += kThreads) {
      const int f = flags[p];
      const long long q = static_cast<long long>(s) * a.window + p;
      a.is_ref[q] = f & 1;
      a.is_noop[q] = 1 - ((f >> 1) & 1);
    }
  }
  __syncthreads();
  for (int j = t; j < here * 6; j += kThreads) {
    a.nblocks[g0 * 6 + j] = nb[j];
    a.intra_blk[g0 * 6 + j] = intra[j];
  }
  int4* dst = reinterpret_cast<int4*>(a.coeffs + g0 * kMbWords);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int j = t; j < here * (kMbWords / 4); j += kThreads)
    if (coded[j >> 4]) dst[j] = zero;
}

// Launch A: grid (metadata tiles + main tiles + escape tiles, streams).
__global__ void __launch_bounds__(kThreads)
densify_sums_kernel(MtDensifyArgs a, int mb_tiles, int main_tiles,
                    int esc_tiles) {
  __shared__ uint32_t red[kWarps];
  const int s = blockIdx.y;
  const uint8_t* meta = a.meta + s * a.meta_stride;
  int x = blockIdx.x;
  if (x < mb_tiles) {
    unpack_tile(a, meta, s, x);
    return;
  }
  x -= mb_tiles;
  const bool main_lane = x < main_tiles;
  const int tile = main_lane ? x : x - main_tiles;
  const int count = main_lane ? a.kt : a.ke;
  const int* rec = reinterpret_cast<const int*>(a.main + s * a.main_stride);
  const uint16_t* didx =
      reinterpret_cast<const uint16_t*>(meta + a.off_esc_didx);
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int r = tile * kTile + i * kThreads + threadIdx.x;
    if (r < count)
      sum += main_lane ? (static_cast<uint32_t>(rec[r]) & 0xFFFFu) : didx[r];
  }
  sum = block_sum(sum, red);
  if (threadIdx.x == 0)
    a.sums[static_cast<long long>(s) * (main_tiles + esc_tiles) + x] = sum;
}

// Launch B: grid (main tiles + escape tiles, streams).
__global__ void __launch_bounds__(kThreads)
densify_scatter_kernel(MtDensifyArgs a, int main_tiles, int esc_tiles) {
  __shared__ uint32_t red[kWarps];
  __shared__ uint32_t warp_total[kWarps];
  __shared__ int premult[64];
  const int s = blockIdx.y, t = threadIdx.x, w = t >> 5, l = t & 31;
  const bool main_lane = blockIdx.x < main_tiles;
  const int tile = main_lane ? blockIdx.x : blockIdx.x - main_tiles;
  const int count = main_lane ? a.kt : a.ke;
  const uint8_t* meta = a.meta + s * a.meta_stride;
  const int* rec = reinterpret_cast<const int*>(a.main + s * a.main_stride);
  const uint16_t* didx =
      reinterpret_cast<const uint16_t*>(meta + a.off_esc_didx);
  const int* esc_val = reinterpret_cast<const int*>(meta + a.off_esc_val);
  if (t < 64) premult[t] = a.premult[t];

  // This warp's 512 records, lane l holding records l, l + 32, ... of them.
  uint32_t d[kPerLane];
  int v[kPerLane];
  uint32_t mine = 0;
  const int first = tile * kTile + w * kWarpRecords + l;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int r = first + i * 32;
    d[i] = 0;
    v[i] = 0;
    if (r < count) {
      if (main_lane) {
        const int x = rec[r];
        d[i] = static_cast<uint32_t>(x) & 0xFFFFu;
        v[i] = x >> 16;                        // the int16 quotient
      } else {
        d[i] = didx[r];
        v[i] = esc_val[r];
      }
    }
    mine += d[i];
  }
  mine = warp_sum(mine);
  if (l == 0) warp_total[w] = mine;

  // The lane's tiles before this one (the barriers inside also publish
  // premult and warp_total).
  const unsigned int* sums = a.sums +
      static_cast<long long>(s) * (main_tiles + esc_tiles) +
      (main_lane ? 0 : main_tiles);
  uint32_t run = 0;
  for (int j = t; j < tile; j += kThreads) run += sums[j];
  run = block_sum(run, red);
  for (int k = 0; k < w; ++k) run += warp_total[k];

  const int n = a.window * a.mb * kMbWords;
  int* out = a.coeffs + static_cast<long long>(s) * n;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    uint32_t inc = d[i];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, inc, o);
      if (l >= o) inc += y;
    }
    int idx = static_cast<int>(run + inc);
    run += __shfl_sync(kFull, inc, 31);
    if (idx > n - 1) idx = n - 1;
    const int val = main_lane
        ? static_cast<int>(static_cast<uint32_t>(v[i]) *
                           static_cast<uint32_t>(premult[idx & 63]))
        : v[i];
    if (idx < 0) idx += n;
    if (idx >= 0 && val != 0) atomicAdd(out + idx, val);
  }
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

}  // namespace

extern "C" {

int mt_densify_args_bytes() { return static_cast<int>(sizeof(MtDensifyArgs)); }

// Words of the scratch `sums` a call of S streams of kt main and ke escape
// records needs: one a record tile of 4,096.
long long mt_densify_scratch_words(int streams, int kt, int ke) {
  return static_cast<long long>(streams) * (tiles(kt) + tiles(ke));
}

// K5 over S streams' window blobs: launch A, then launch B when there are
// records.  Arguments the wrapper refuses are refused here too, as
// cudaErrorInvalidValue, and nothing launches: the blob's pointers, strides
// and field offsets must keep its int32 fields 4-byte aligned, coeffs must
// be 16-byte aligned, and a stream's span must stay below 2^31 entries.
int mt_densify_unpack(const MtDensifyArgs* args, void* stream) {
  const MtDensifyArgs& a = *args;
  const long long n = static_cast<long long>(a.window) * a.mb * kMbWords;
  const int offs = a.off_flags | a.off_mv_h | a.off_mv_v | a.off_nbcls |
                   a.off_mbmisc | a.off_esc_didx | a.off_esc_val;
  const bool ok =
      a.streams > 0 && a.streams <= 65535 && a.window > 0 && a.mb > 0 &&
      n < (1LL << 31) && a.kt >= 0 && a.kt <= kMaxRecords && a.ke >= 0 &&
      a.ke <= kMaxRecords && offs >= 0 && (offs & 3) == 0 &&
      aligned(a.meta, 4) && aligned(a.main, 4) && (a.meta_stride & 3) == 0 &&
      (a.main_stride & 3) == 0 && aligned(a.coeffs, 16) && a.premult &&
      a.nb_class_rep && a.nblocks && a.intra_blk && a.src_sel && a.mv_h &&
      a.mv_v && a.is_ref && a.is_noop && a.sums;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mb_tiles = (a.window * a.mb + kMbTile - 1) / kMbTile;
  const int main_tiles = tiles(a.kt), esc_tiles = tiles(a.ke);
  densify_sums_kernel<<<dim3(mb_tiles + main_tiles + esc_tiles, a.streams),
                        kThreads, 0, st>>>(a, mb_tiles, main_tiles, esc_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || main_tiles + esc_tiles == 0)
    return static_cast<int>(err);
  densify_scatter_kernel<<<dim3(main_tiles + esc_tiles, a.streams), kThreads,
                           0, st>>>(a, main_tiles, esc_tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
