// K5: the window densify and metadata unpack on Hopper, three launches a
// call; each coded block is assembled on chip and written once.
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
// first nonzero CUDA error code of its set-up and launches, and the number
// of kernels it enqueued.
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
// coded block written; the integer work is a few operations a byte.  The
// coded blocks are most of it (851 of 955 MB in a 64-stream round of I and
// P pictures), so the design writes each of them once, from shared memory,
// and touches no coded block in device memory before that.
//
// Design: own by output.  A chain is sorted (its indices never decrease)
// unless its 64-bit sum reaches 2^31 and the int32 wraps, which only a
// malformed blob does; so a sorted lane's records of a granule of kGranule
// (4) macroblocks are one run of it, [rows[g], rows[g + 1]).  Three
// launches of 256 threads, the second and third started early by
// programmatic dependent launch (each waits with griddepcontrol.wait where
// it first reads what the launch before wrote); no CTA waits for another
// CTA of its grid:
// - Launch A, a grid of (record tiles, streams): each tile of 4,096
//   records of one lane writes its entry: its delta sum (exact in 32 bits),
//   the offset of its last record whose value is not 0 (or -1), its value
//   sum and its first delta.
// - Launch B, a grid of (record tiles, streams).  Each CTA reads its lane's
//   whole tile table: the 64-bit sum of the tiles before its own, the
//   lane's 64-bit total (the lane wraps if it reaches 2^31: tile 0 writes
//   that flag, and a wrapping lane has no rows) and the lane's end, one
//   past its last record whose value is not 0 (the pads of a bucketed lane
//   sit at its last index: without the end one granule would own millions
//   of them).  Each warp holds 512 records, 16 a lane, and scans them in 16
//   rounds of a 5-step shuffle scan; a record r below the end whose index
//   passes granule starts g * 4 * 384 after record r - 1's writes rows[g] =
//   (r, the chain before r) for each (record 0 from granule 0), a lane a
//   few rows itself and the warp each lane's longer run in turn.  The CTA
//   holding the lane's last record below the end writes the lane's tail
//   (the first granule past that record, the end, the chain through it),
//   which stands for every row past it.  Every row is written exactly once,
//   from the prefix alone.
// - Launch C, a persistent grid of 3 CTAs a SM; each warp works alone,
//   with its own 6 KB slice of shared memory.  Before its wait (so
//   overlapping launches A and B) a warp unpacks the metadata of batches
//   of 32 consecutive granules, a granule a lane, a word a lane a store.
//   After it, the warp takes batches of 32 granules spread over the call
//   (runs of heavy granules go to many warps): each lane finds its
//   granule's coded blocks and loads its rows and the lanes' descriptors;
//   then the warp takes the granules with coded blocks in turn, the first
//   64 records of each loaded while the one before it is added.  For a
//   sorted lane it rescans the granule's records from the stored chain
//   (clamp, premultiply, fix-up, drop, as above), sums each run of equal
//   indices among its 32 records and adds a run with one plain shared add:
//   no other warp touches the slice, and no two runs of a round share an
//   index.  A wrapping lane is sorted between the points where its 64-bit
//   chain crosses a multiple of 2^31: launch A's entries let the warp skip
//   a tile that misses the granule, add at once a tile that clamps onto
//   one index in it, and scan the rest, each run one shared-memory
//   atomicAdd (int32 adds commute: the result does not depend on their
//   order); chosen by the flag on the card, no host sync.  Last, the warp
//   writes the granule's coded blocks from shared memory with 16-byte
//   stores, half a warp a block, in output order, and zeroes the blocks
//   its records touched.
// No launch zeroes the span and none adds into device memory.  Offsets into
// the outputs are int64 (8 streams of 16 1080p pictures are 1.6 GB of
// coefficients); a stream's span stays below 2^31 entries, as the int32
// chain needs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
  unsigned int* scratch;     // mt_densify_scratch_words(S, window, mb, kt, ke)
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
constexpr int kPerLane = 16;                  // records a lane holds (B)
constexpr int kWarpRecords = 32 * kPerLane;   // 512 consecutive records a warp
constexpr int kTile = kThreads * kPerLane;    // 4,096 records a record tile
constexpr int kGranule = 4;                   // macroblocks a warp owns (C)
constexpr int kFirst = 2;                     // rounds of 32 records a lane
constexpr int kRound = 4;                     // prefetches, then loads (C)
constexpr int kWrapBatch = 8;                 // records a lane loads (C)
constexpr int kMbWords = 6 * 64;              // coefficients a macroblock
constexpr int kGranuleWords = kGranule * kMbWords;
constexpr int kAccBytes = kWarps * kGranuleWords * 4;
constexpr int kAsmCtasPerSm = 3;              // launch C CTAs a SM
constexpr int kMaxRecords = 1 << 30;          // a lane, at most
constexpr int kOwnRows = 4;                   // rows a lane writes itself (B)
constexpr unsigned kFull = 0xffffffffu;
static_assert(kGranule == 4, "a granule's mbmisc is one word");

__host__ __device__ int tiles(int records) {
  return (records + kTile - 1) / kTile;
}

// Granules of a stream of `total` macroblocks.
__host__ __device__ int granules(int total) {
  return (total + kGranule - 1) / kGranule;
}

// The scratch of a call, in 32-bit words, in this order:
// - lanes [S][2][4]: 1 if the lane's 64-bit chain reaches 2^31 (tile 0 of
//   launch B writes it), then its tail (the CTA holding its last record
//   below the end writes it): the first granule past that record, the
//   end and the chain through it;
// - tiles [S][main tiles + escape tiles]: launch A's entries (delta sum,
//   offset of the last record whose value is not 0 or -1, value sum,
//   first delta);
// - rows [S][2][granules + 1]: (record, chain before it) at each granule's
//   first macroblock, g * kGranule, the last one at the span's end
//   (launch B's, those before the tail only).
struct Scratch {
  uint4* lanes;
  uint4* tiles;
  uint2* rows;
};

__host__ __device__ long long scratch_words(int streams, int window, int mb,
                                            int kt, int ke) {
  return static_cast<long long>(streams) *
         (8 + 4LL * (tiles(kt) + tiles(ke)) +
          4LL * (granules(window * mb) + 1));
}

__device__ Scratch scratch_of(const MtDensifyArgs& a) {
  const long long t = 8LL * a.streams;
  const long long r = t + 4LL * a.streams * (tiles(a.kt) + tiles(a.ke));
  return {reinterpret_cast<uint4*>(a.scratch),
          reinterpret_cast<uint4*>(a.scratch + t),
          reinterpret_cast<uint2*>(a.scratch + r)};   // offsets: 16 B
}

// One lane of stream s: the main records (an int32 each) or the escapes (a
// uint16 delta and an int32 value).
struct Lane {
  const int* rec;
  const uint16_t* didx;
  const int* val;
  int count;
  bool is_main;

  __device__ void load(int r, uint32_t& d, int& v) const {
    if (is_main) {
      const int x = rec[r];
      d = static_cast<uint32_t>(x) & 0xFFFFu;
      v = x >> 16;                             // the int16 quotient
    } else {
      d = didx[r];
      v = val[r];
    }
  }
};

__device__ Lane lane_of(const MtDensifyArgs& a, int s, bool is_main) {
  const uint8_t* meta = a.meta + s * a.meta_stride;
  return {reinterpret_cast<const int*>(a.main + s * a.main_stride),
          reinterpret_cast<const uint16_t*>(meta + a.off_esc_didx),
          reinterpret_cast<const int*>(meta + a.off_esc_val),
          is_main ? a.kt : a.ke, is_main};
}

// A record's index from the chain through it: the int32, clamped to n - 1.
__device__ __forceinline__ int span_index(uint32_t chain, int n) {
  const int idx = static_cast<int>(chain);
  return idx > n - 1 ? n - 1 : idx;
}

// Its value: the main lane's quotient times premult[idx & 63] (wrapping).
__device__ __forceinline__ uint32_t record_value(bool is_main, int v,
                                                 int idx,
                                                 const int* premult) {
  return is_main ? static_cast<uint32_t>(v) *
                       static_cast<uint32_t>(premult[idx & 63])
                 : static_cast<uint32_t>(v);
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

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t x) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (l >= o) x += y;
  }
  return x;
}

// Sums v over each run of consecutive lanes with equal keys; returns true
// on a run's first lane, whose v is then the run's sum.
__device__ __forceinline__ bool run_head(int key, uint32_t& v) {
  const int l = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, key, 1);
  const int next = __shfl_down_sync(kFull, key, 1);
  bool last = l == 31 || next != key;          // the run's last lane
  if (__any_sync(kFull, !last)) {
    // Segmented suffix sums: (v, last) of lanes [l, l + 2o) from those of
    // [l, l + o) and [l + o, l + 2o).  Lane 31 ends every run, so a lane
    // still open has l + o < 32.
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_down_sync(kFull, v, o);
      const int y_last = __shfl_down_sync(kFull, static_cast<int>(last), o);
      if (!last) {
        v += y;
        last = y_last;
      }
    }
  }
  return l == 0 || prev != key;
}

// Launch A: grid (main tiles + escape tiles, streams).  Each tile's
// entry: its delta sum, the offset of its last record whose value is not
// 0 (or -1), the sum of its values (wrapping; the main lane's quotients)
// and its first record's delta.
__global__ void __launch_bounds__(kThreads)
densify_tiles_kernel(MtDensifyArgs a, int main_tiles, int esc_tiles) {
  __shared__ uint32_t red_sum[kWarps], red_val[kWarps];
  __shared__ int red_last[kWarps];
  grid_launch_dependents();
  const int s = blockIdx.y, t = threadIdx.x, w = t >> 5, l = t & 31;
  const int x = blockIdx.x;
  if (x >= main_tiles + esc_tiles) return;
  const bool main_lane = x < main_tiles;
  const int tile = main_lane ? x : x - main_tiles;
  const Lane lane = lane_of(a, s, main_lane);
  uint32_t sum = 0, vals = 0, first = 0;
  int last = -1;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int r = tile * kTile + i * kThreads + t;
    if (r < lane.count) {
      uint32_t d;
      int v;
      lane.load(r, d, v);
      sum += d;
      vals += static_cast<uint32_t>(v);
      if (i == 0 && t == 0) first = d;
      if (v != 0) last = r - tile * kTile;
    }
  }
  sum = warp_sum(sum);
  vals = warp_sum(vals);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, o));
  if (l == 0) {
    red_sum[w] = sum;
    red_val[w] = vals;
    red_last[w] = last;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 1; k < kWarps; ++k) {
      sum += red_sum[k];
      vals += red_val[k];
      last = max(last, red_last[k]);
    }
    scratch_of(a).tiles[s * (main_tiles + esc_tiles) + x] =
        make_uint4(sum, static_cast<uint32_t>(last), vals, first);
  }
}

// Launch B's rows [lo, hi] of each lane of the warp, all set to that
// lane's row: a lane writes a few rows itself, and the warp writes each
// lane's longer run (a gap over uncoded macroblocks) in turn.
__device__ __forceinline__ void write_rows(uint2* rows, int lo, int hi,
                                           uint2 row) {
  const int l = threadIdx.x & 31;
  const bool own = hi - lo < kOwnRows;
  if (own)
    for (int g = lo; g <= hi; ++g) rows[g] = row;
  unsigned todo = __ballot_sync(kFull, !own);
  while (todo) {
    const int o = __ffs(todo) - 1;
    todo &= todo - 1;
    const int from = __shfl_sync(kFull, lo, o);
    const int to = __shfl_sync(kFull, hi, o);
    const uint2 r = make_uint2(__shfl_sync(kFull, row.x, o),
                               __shfl_sync(kFull, row.y, o));
    for (int g = from + l; g <= to; g += 32) rows[g] = r;
  }
}

// Launch B: grid (main tiles + escape tiles, streams).
__global__ void __launch_bounds__(kThreads)
densify_rows_kernel(MtDensifyArgs a, int main_tiles, int esc_tiles) {
  __shared__ uint32_t warp_total[kWarps];
  __shared__ unsigned long long red_before[kWarps], red_total[kWarps];
  __shared__ int red_end[kWarps];
  grid_launch_dependents();
  const int s = blockIdx.y, t = threadIdx.x, w = t >> 5, l = t & 31;
  const int x = blockIdx.x;
  if (x >= main_tiles + esc_tiles) {
    grid_wait();
    return;
  }
  const bool main_lane = x < main_tiles;
  const int tile = main_lane ? x : x - main_tiles;
  const int lane_tiles = main_lane ? main_tiles : esc_tiles;
  const Lane lane = lane_of(a, s, main_lane);

  // This warp's 512 records' deltas, lane l holding records l, l + 32, ...
  // of them: inputs, loaded before the wait.
  uint32_t d[kPerLane];
  uint32_t mine = 0;
  const int first = tile * kTile + w * kWarpRecords + l;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int r = first + i * 32;
    int v;
    d[i] = 0;
    if (r < lane.count) lane.load(r, d[i], v);
    mine += d[i];
  }
  mine = warp_sum(mine);
  if (l == 0) warp_total[w] = mine;

  grid_wait();
  const Scratch sc = scratch_of(a);
  const uint4* tab = sc.tiles + s * (main_tiles + esc_tiles) +
                     (main_lane ? 0 : main_tiles);
  // The lane's end: one past its last record whose value is not 0.
  unsigned long long before = 0, total = 0;
  int end = 0;
  for (int j = t; j < lane_tiles; j += kThreads) {
    const uint4 e = tab[j];
    total += e.x;
    if (j < tile) before += e.x;
    if (static_cast<int>(e.y) >= 0)
      end = j * kTile + static_cast<int>(e.y) + 1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_xor_sync(kFull, before, o);
    total += __shfl_xor_sync(kFull, total, o);
    end = max(end, __shfl_xor_sync(kFull, end, o));
  }
  if (l == 0) {
    red_before[w] = before;
    red_total[w] = total;
    red_end[w] = end;
  }
  __syncthreads();
  before = total = 0;
  end = 0;
  for (int k = 0; k < kWarps; ++k) {
    before += red_before[k];
    total += red_total[k];
    end = max(end, red_end[k]);
  }
  const bool wraps = total >= (1ull << 31);
  const int which = s * 2 + (main_lane ? 0 : 1);
  unsigned* desc = reinterpret_cast<unsigned*>(sc.lanes + which);
  if (tile == 0 && t == 0) desc[0] = wraps;
  if (wraps) return;                     // launch C scans this lane whole

  const int n = a.window * a.mb * kMbWords;
  uint2* rows = sc.rows +
                static_cast<long long>(which) * (granules(a.window * a.mb) + 1);
  if (tile * kTile >= end) {             // past the lane's last value
    if (tile == 0 && t == 0) {           // no value at all: all tail
      desc[1] = 0;
      desc[2] = 0;
      desc[3] = 0;
    }
    return;
  }

  uint32_t run = static_cast<uint32_t>(before);   // below 2^31: no wrap
  for (int k = 0; k < w; ++k) run += warp_total[k];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const uint32_t inc = warp_inclusive(d[i]);
    const uint32_t through = run + inc;            // the chain through r
    const uint32_t prev = through - d[i];          // and before it
    run += __shfl_sync(kFull, inc, 31);
    const int r = first + i * 32;
    // The granules whose first macroblock is past record r - 1's and at or
    // before record r's start at r.
    int lo = 0, hi = -1;
    if (r < end) {
      const int mb = span_index(through, n) / kMbWords;
      lo = r == 0 ? 0 : span_index(prev, n) / kMbWords / kGranule + 1;
      hi = mb / kGranule;
      if (r == end - 1) {
        desc[1] = hi + 1;
        desc[2] = end;
        desc[3] = through;
      }
    }
    write_rows(rows, lo, hi, make_uint2(r, prev));
  }
}

// Launch C: R rounds of records of a lane, lane l holding records
// r0 + l, r0 + 32 + l, ... below `end` (0 past it).
template <int R>
__device__ __forceinline__ void load_rounds(const Lane& lane, int r0, int end,
                                            uint32_t (&d)[R], int (&v)[R]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i * 32 + l;
    d[i] = 0;
    v[i] = 0;
    if (r < end) lane.load(r, d[i], v[i]);
  }
}

// Launch C, a sorted lane: adds R rounds of records [r0, ...) below `end`
// from the chain before r0.  Every index lands in the warp's own
// macroblocks, and no two runs of a round share one, so each run is one
// plain shared add.
template <int R>
__device__ __forceinline__ void add_rounds(bool is_main, int r0, int end,
                                           uint32_t& chain,
                                           const uint32_t (&d)[R],
                                           const int (&v)[R], uint32_t* acc,
                                           int base, int span, int n,
                                           const int* premult,
                                           unsigned& touched) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (r0 + i * 32 >= end) break;
    const uint32_t inc = warp_inclusive(d[i]);
    const uint32_t through = chain + inc;
    chain += __shfl_sync(kFull, inc, 31);
    // Past `end` a lane adds 0 at the index before it: its run's.
    const int idx = span_index(through, n);
    uint32_t val = record_value(is_main, v[i], idx, premult);
    const int o = idx - base;
    if (run_head(idx, val) && val != 0 &&
        static_cast<unsigned>(o) < static_cast<unsigned>(span)) {
      acc[o] += val;
      touched |= 1u << (o >> 6);
    }
    __syncwarp();
  }
}

// Launch C, a sorted lane: the warp's records [from, end), whose first
// kFirst rounds are in (d0, v0), from the chain before `from`; each next
// batch of kRound rounds is loaded before the one in hand is added.
__device__ void add_sorted(const Lane& lane, int from, int end,
                           uint32_t chain, const uint32_t (&d0)[kFirst],
                           const int (&v0)[kFirst], uint32_t* acc, int base,
                           int span, int n, const int* premult,
                           unsigned& touched) {
  add_rounds<kFirst>(lane.is_main, from, end, chain, d0, v0, acc, base, span,
                     n, premult, touched);
  int r0 = from + 32 * kFirst;
  if (r0 >= end) return;
  uint32_t d[kRound];
  int v[kRound];
  load_rounds<kRound>(lane, r0, end, d, v);
  for (; r0 < end; r0 += 32 * kRound) {
    uint32_t dn[kRound];
    int vn[kRound];
    load_rounds<kRound>(lane, r0 + 32 * kRound, end, dn, vn);
    add_rounds<kRound>(lane.is_main, r0, end, chain, d, v, acc, base, span,
                       n, premult, touched);
#pragma unroll
    for (int i = 0; i < kRound; ++i) {
      d[i] = dn[i];
      v[i] = vn[i];
    }
  }
}

// Launch C, a wrapping lane: the records of it that land in the warp's
// span [base, base + span).  Such a lane is sorted between the points where
// its 64-bit chain crosses a multiple of 2^31, and its final index (clamp,
// then + n below 0, dropped if still below 0) is monotone there.  So from
// launch A's entries a tile of records is skipped when its indices all
// miss the span (the two pieces of one the chain passes 2^31 in, each),
// added at once (its value sum times the premultiplier) when they all
// clamp onto one index in it, and scanned otherwise: lane l
// holding 8 consecutive records of 256, its chain from a warp scan of the
// lanes' sums, each run of equal indices one shared-memory atomicAdd
// (equal indices need not be neighbours in such a lane).
__device__ __forceinline__ long long final_index(unsigned long long chain,
                                                 int n) {
  int idx = span_index(static_cast<uint32_t>(chain), n);
  return idx < 0 ? static_cast<long long>(idx) + n : idx;  // < 0: dropped
}

__device__ void add_wrapping(const Lane& lane, const uint4* tab,
                             uint32_t* acc, int base, int span, int n,
                             const int* premult, unsigned& touched) {
  const int l = threadIdx.x & 31;
  const int lane_tiles = tiles(lane.count);
  unsigned long long before = 0;         // the 64-bit chain before the tile
  for (int t0 = 0; t0 < lane_tiles; t0 += 32) {
    // 32 tiles' entries at once, and their chains by a warp scan.
    const uint4 e = t0 + l < lane_tiles ? tab[t0 + l] : make_uint4(0, 0, 0, 0);
    unsigned long long inc = e.x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, inc, o);
      if (l >= o) inc += y;
    }
    const unsigned long long lo = before + inc - e.x + e.w;   // first record
    const unsigned long long hi = before + inc;               // last record
    before += __shfl_sync(kFull, inc, 31);
    // Where the tile's indices fall: one sorted piece unless [lo, hi]
    // holds a multiple of 2^31 (one at most: a tile's sum is below 2^28),
    // else two, split there.
    const unsigned long long cut = ((lo >> 31) + 1) << 31;
    const bool piece = hi < cut;
    const long long f_lo = final_index(lo, n), f_hi = final_index(hi, n);
    const bool one = piece && f_lo == f_hi && f_lo >= 0;
    const bool miss = piece
        ? f_hi < base || f_lo >= base + span
        : (final_index(cut - 1, n) < base || f_lo >= base + span) &&
              (f_hi < base || final_index(cut, n) >= base + span);
    if (t0 + l < lane_tiles && one && f_lo >= base && f_lo < base + span) {
      const int idx = static_cast<int>(f_lo);
      const uint32_t sum = lane.is_main
          ? e.z * static_cast<uint32_t>(premult[
                span_index(static_cast<uint32_t>(lo), n) & 63])
          : e.z;
      if (sum) {
        atomicAdd(acc + (idx - base), sum);
        touched |= 1u << ((idx - base) >> 6);
      }
    }
    unsigned scan = __ballot_sync(kFull, t0 + l < lane_tiles && !one &&
                                             !miss);
    while (scan) {
      const int j = __ffs(scan) - 1;
      scan &= scan - 1;
      const int tile = t0 + j;
      uint32_t chain = static_cast<uint32_t>(__shfl_sync(kFull, hi, j) -
                                             __shfl_sync(kFull, e.x, j));
      const int end = min((tile + 1) * kTile, lane.count);
      for (int r0 = tile * kTile; r0 < end; r0 += 32 * kWrapBatch) {
        uint32_t d[kWrapBatch];
        int v[kWrapBatch];
        uint32_t mine = 0;
#pragma unroll
        for (int i = 0; i < kWrapBatch; ++i) {
          const int r = r0 + l * kWrapBatch + i;
          d[i] = 0;
          v[i] = 0;
          if (r < end) lane.load(r, d[i], v[i]);
          mine += d[i];
        }
        const uint32_t inc32 = warp_inclusive(mine);
        uint32_t c = chain + inc32 - mine;
        chain += __shfl_sync(kFull, inc32, 31);
        int key = -1;
        uint32_t sum = 0;
#pragma unroll
        for (int i = 0; i < kWrapBatch; ++i) {
          c += d[i];
          int idx = span_index(c, n);
          const uint32_t val = record_value(lane.is_main, v[i], idx, premult);
          if (idx < 0) idx += n;
          const int o = idx - base;
          if (idx < 0 || val == 0 ||
              static_cast<unsigned>(o) >= static_cast<unsigned>(span))
            continue;
          if (o != key) {
            if (key >= 0) atomicAdd(acc + key, sum);
            key = o;
            sum = 0;
          }
          sum += val;
          touched |= 1u << (o >> 6);
        }
        if (key >= 0) atomicAdd(acc + key, sum);
      }
    }
  }
}

// Launch C: the metadata of the warp's 32 consecutive granules, lane l's
// `item` (none past `items`), loaded a granule a lane and stored a word a
// lane, each element from the lane that holds it.
__device__ void unpack_granules(const MtDensifyArgs& a, int item, int items,
                                int per) {
  const int l = threadIdx.x & 31;
  const int total = a.window * a.mb;
  int here = 0;
  long long first = 0;                   // the granule's first macroblock
  uint32_t cls[2] = {0, 0}, misc = 0, mvh[2] = {0, 0}, mvv[2] = {0, 0};
  if (item < items) {
    const int s = item / per, m0 = (item % per) * kGranule;
    here = min(kGranule, total - m0);
    first = static_cast<long long>(s) * total + m0;
    const uint8_t* meta = a.meta + s * a.meta_stride;
    // Whole words of the 4-byte aligned fields, none past a field's pad.
    misc = *reinterpret_cast<const uint32_t*>(meta + a.off_mbmisc + m0);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (2 * k < here) {
        cls[k] = *reinterpret_cast<const uint32_t*>(
            meta + a.off_nbcls + 2 * (m0 + 2 * k));
        mvh[k] = *reinterpret_cast<const uint32_t*>(
            meta + a.off_mv_h + 2 * (m0 + 2 * k));
        mvv[k] = *reinterpret_cast<const uint32_t*>(
            meta + a.off_mv_v + 2 * (m0 + 2 * k));
      }
    }
  }
  // nblocks and intra_blk: 24 words a granule, element j of the 768 from
  // lane j / 24.
#pragma unroll 4
  for (int j = l; j < 32 * 6 * kGranule; j += 32) {
    const int src = j / (6 * kGranule), m = (j / 6) % kGranule, b = j % 6;
    const int h = __shfl_sync(kFull, here, src);
    const long long f = __shfl_sync(kFull, first, src);
    const uint32_t c0 = __shfl_sync(kFull, cls[0], src);
    const uint32_t c1 = __shfl_sync(kFull, cls[1], src);
    const uint32_t c = m < 2 ? c0 : c1;
    const uint32_t x = __shfl_sync(kFull, misc, src);
    if (m < h) {
      const long long at = (f + m) * 6 + b;
      a.nblocks[at] = a.nb_class_rep[(c >> (16 * (m & 1) + 2 * b)) & 3];
      a.intra_blk[at] = (x >> (8 * m + b)) & 1;
    }
  }
  // src_sel, mv_h, mv_v: a word a macroblock, element j of the 128 from
  // lane j / 4.
#pragma unroll
  for (int j = l; j < 32 * kGranule; j += 32) {
    const int src = j / kGranule, m = j % kGranule;
    const int h = __shfl_sync(kFull, here, src);
    const long long f = __shfl_sync(kFull, first, src);
    const uint32_t x = __shfl_sync(kFull, misc, src);
    const uint32_t h0 = __shfl_sync(kFull, mvh[0], src);
    const uint32_t h1 = __shfl_sync(kFull, mvh[1], src);
    const uint32_t v0 = __shfl_sync(kFull, mvv[0], src);
    const uint32_t v1 = __shfl_sync(kFull, mvv[1], src);
    const uint32_t vh = m < 2 ? h0 : h1, vv = m < 2 ? v0 : v1;
    if (m < h) {
      a.src_sel[f + m] = (x >> (8 * m + 6)) & 3;
      a.mv_h[f + m] = static_cast<int16_t>(vh >> (16 * (m & 1)));
      a.mv_v[f + m] = static_cast<int16_t>(vv >> (16 * (m & 1)));
    }
  }
}

// Launch C: granule g's coded blocks of stream s, bit 6 m + b for block b
// of its macroblock m.
__device__ unsigned granule_coded(const MtDensifyArgs& a, int s, int g) {
  const int total = a.window * a.mb;
  const int m0 = g * kGranule, here = min(kGranule, total - m0);
  const uint8_t* nbcls = a.meta + s * a.meta_stride + a.off_nbcls;
  uint32_t cls[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)      // whole words, none past the field's pad
    cls[k] = 2 * k < here
        ? *reinterpret_cast<const uint32_t*>(nbcls + 2 * (m0 + 2 * k)) : 0;
  unsigned coded = 0;
#pragma unroll
  for (int m = 0; m < kGranule; ++m) {
    const int c = m < here ? (cls[m >> 1] >> (16 * (m & 1))) & 0xFFF : 0;
#pragma unroll
    for (int b = 0; b < 6; ++b)
      coded |= (((c >> (2 * b)) & 3) != 0 ? 1u : 0u) << (6 * m + b);
  }
  return coded;
}

// Launch C: what a warp needs of one granule before its records.
struct Granule {
  int s, g;                  // stream, granule
  unsigned coded;            // bit 6 m + b: block b of its macroblock m
  unsigned wraps;            // bit k: lane k wraps
  uint2 from[2];             // a sorted lane's first record and the chain
  int end[2];                // before it; one past its last record
};

// Granule `item` (stream item / per), as its lane of the warp loads it
// after the wait.
__device__ Granule granule_heads(const Scratch& sc, const MtDensifyArgs& a,
                                 int item, int per) {
  Granule h = {};
  h.s = item / per;
  h.g = item % per;
  h.coded = granule_coded(a, h.s, h.g);
  const uint4 desc[2] = {sc.lanes[h.s * 2], sc.lanes[h.s * 2 + 1]};
  const int count[2] = {a.kt, a.ke};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint2* rows =
        sc.rows + static_cast<long long>(h.s * 2 + k) * (per + 1);
    // Rows past a lane's tail are loaded, not used.
    const uint2 lo = rows[h.g], hi = rows[h.g + 1];  // the span's end last
    const uint2 past = make_uint2(desc[k].z, desc[k].w);
    h.from[k] = make_uint2(0, 0);
    h.end[k] = 0;
    if (count[k] && desc[k].x) {
      h.wraps |= 1u << k;
    } else if (count[k]) {
      h.from[k] = h.g >= static_cast<int>(desc[k].y) ? past : lo;
      h.end[k] = static_cast<int>(
          h.g + 1 >= static_cast<int>(desc[k].y) ? past.x : hi.x);
    }
  }
  return h;
}

// Lane j's Granule, to every lane of the warp.
__device__ __forceinline__ Granule shfl_granule(const Granule& h, int j) {
  Granule o;
  o.s = __shfl_sync(kFull, h.s, j);
  o.g = __shfl_sync(kFull, h.g, j);
  o.coded = __shfl_sync(kFull, h.coded, j);
  o.wraps = __shfl_sync(kFull, h.wraps, j);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    o.from[k] = make_uint2(__shfl_sync(kFull, h.from[k].x, j),
                           __shfl_sync(kFull, h.from[k].y, j));
    o.end[k] = __shfl_sync(kFull, h.end[k], j);
  }
  return o;
}

// Launch C: the first rounds of both lanes of the granule whose heads lane
// j holds (none for j < 0).
__device__ __forceinline__ void load_first(const MtDensifyArgs& a,
                                           const Granule& mine, int j,
                                           uint32_t (&dm)[kFirst],
                                           int (&vm)[kFirst],
                                           uint32_t (&de)[kFirst],
                                           int (&ve)[kFirst]) {
  const int src = j < 0 ? 0 : j;
  const int s = __shfl_sync(kFull, mine.s, src);
  int from[2], end[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    from[k] = static_cast<int>(__shfl_sync(kFull, mine.from[k].x, src));
    end[k] = j < 0 ? 0 : __shfl_sync(kFull, mine.end[k], src);
  }
  load_rounds<kFirst>(lane_of(a, s, true), from[0], end[0], dm, vm);
  load_rounds<kFirst>(lane_of(a, s, false), from[1], end[1], de, ve);
}

// Launch C, one granule, by one warp: macroblocks [m0, m0 + kGranule) of
// stream h.s (fewer at the span's end) into acc, the warp's kGranuleWords
// words of shared memory (zero on entry and on return), then their coded
// blocks out.  (dm, vm) and (de, ve) hold the first rounds of its sorted
// lanes.
__device__ void assemble_granule(const MtDensifyArgs& a, const Scratch& sc,
                                 int main_tiles, int esc_tiles,
                                 const Granule& h,
                                 const uint32_t (&dm)[kFirst],
                                 const int (&vm)[kFirst],
                                 const uint32_t (&de)[kFirst],
                                 const int (&ve)[kFirst], uint32_t* acc,
                                 const int* premult) {
  const int l = threadIdx.x & 31;
  const int total = a.window * a.mb;
  const int m0 = h.g * kGranule, here = min(kGranule, total - m0);
  const int n = total * kMbWords;
  const int base = m0 * kMbWords, span = here * kMbWords;
  unsigned touched = 0;                  // blocks a lane added to
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const Lane lane = lane_of(a, h.s, k == 0);
    if ((h.wraps >> k) & 1)
      add_wrapping(lane,
                   sc.tiles + h.s * (main_tiles + esc_tiles) +
                       (k ? main_tiles : 0),
                   acc, base, span, n, premult, touched);
    else
      add_sorted(lane, h.from[k].x, h.end[k], h.from[k].y, k ? de : dm,
                 k ? ve : vm, acc, base, span, n, premult, touched);
    __syncwarp();
  }
  // The coded blocks out, 16 bytes a lane, half a warp a block, two
  // blocks a step; the blocks added to zeroed behind them.
  int4* acc4 = reinterpret_cast<int4*>(acc);
  int4* dst = reinterpret_cast<int4*>(
      a.coeffs + (static_cast<long long>(h.s) * total + m0) * kMbWords);
  unsigned todo = h.coded | __reduce_or_sync(kFull, touched);
  while (todo) {
    const int b0 = __ffs(todo) - 1;
    todo &= todo - 1;
    const int b1 = todo ? __ffs(todo) - 1 : -1;
    todo &= todo - 1;
    const int b = l < 16 ? b0 : b1;
    if (b >= 0) {
      const int j = b * 16 + (l & 15);
      if ((h.coded >> b) & 1) dst[j] = acc4[j];
      acc4[j] = make_int4(0, 0, 0, 0);
    }
  }
  __syncwarp();
}

// Launch C: a persistent grid of kAsmCtasPerSm CTAs a SM (at most a warp
// a granule); each warp on its own, with its own kGranuleWords of the
// kAccBytes of dynamic shared memory.  Before the wait on launch B, warp w
// of W unpacks the metadata of batches w, w + W, ... of 32 consecutive
// granules over all streams.  Then it takes granules w + 32 W k + W l,
// lane l the l-th of each 32 (spread, so that runs of heavy granules go to
// many warps): each lane its granule's heads (coded blocks, rows and lane
// descriptors), then the warp the coded ones in turn, the first rounds of
// each one's records loaded while the one before it is added.
__global__ void __launch_bounds__(kThreads, kAsmCtasPerSm)
densify_assemble_kernel(MtDensifyArgs a, int main_tiles, int esc_tiles) {
  extern __shared__ int4 acc4[];
  __shared__ int premult[64];
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  int4* mine = acc4 + w * (kGranuleWords / 4);
  for (int j = l; j < kGranuleWords / 4; j += 32)
    mine[j] = make_int4(0, 0, 0, 0);
  if (t < 64) premult[t] = a.premult[t];
  // The metadata, before the wait: the pictures' flags, then the granules'.
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads + t;
       q < static_cast<long long>(a.streams) * a.window;
       q += static_cast<long long>(gridDim.x) * kThreads) {
    const int s = static_cast<int>(q / a.window);
    const int f = reinterpret_cast<const int*>(
        a.meta + s * a.meta_stride + a.off_flags)[q % a.window];
    a.is_ref[q] = f & 1;
    a.is_noop[q] = 1 - ((f >> 1) & 1);
  }
  const int per = granules(a.window * a.mb);
  const int items = a.streams * per;
  const int warps = gridDim.x * kWarps;
  const int gw = blockIdx.x * kWarps + w;
  for (int first = gw * 32; first < items; first += 32 * warps)
    unpack_granules(a, first + l, items, per);
  __syncthreads();                       // premult
  grid_wait();                           // launch B's rows and lanes
  const Scratch sc = scratch_of(a);
  for (int first = gw; first < items; first += 32 * warps) {
    const int item = first + l * warps;
    Granule mine_h = {};
    if (item < items) mine_h = granule_heads(sc, a, item, per);
    unsigned todo = __ballot_sync(kFull, mine_h.coded != 0);
    if (!todo) continue;
    // The granules in turn, by the lane that holds each one's heads.
    int j = __ffs(todo) - 1;
    todo &= todo - 1;
    uint32_t dm[kFirst], de[kFirst];
    int vm[kFirst], ve[kFirst];
    load_first(a, mine_h, j, dm, vm, de, ve);
    while (true) {
      const int jn = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      uint32_t dmn[kFirst], den[kFirst];
      int vmn[kFirst], ven[kFirst];
      load_first(a, mine_h, jn, dmn, vmn, den, ven);
      assemble_granule(a, sc, main_tiles, esc_tiles, shfl_granule(mine_h, j),
                       dm, vm, de, ve, reinterpret_cast<uint32_t*>(mine),
                       premult);
      if (jn < 0) break;
      j = jn;
#pragma unroll
      for (int i = 0; i < kFirst; ++i) {
        dm[i] = dmn[i];
        vm[i] = vmn[i];
        de[i] = den[i];
        ve[i] = ven[i];
      }
    }
  }
}

bool aligned(const void* p, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0;
}

// Launches `kernel` on `grid` so that it may start while the kernel before
// it in the stream still runs (it waits for that kernel's writes itself).
cudaError_t launch_overlapped(void (*kernel)(MtDensifyArgs, int, int),
                              dim3 grid, int smem, cudaStream_t st,
                              const MtDensifyArgs& a, int main_tiles,
                              int esc_tiles) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, main_tiles, esc_tiles);
}

// Once a device, the first time a call runs on it: the SM count, and the
// functions' attributes: one shared-memory carveout for the three, so that
// launch C's CTAs can sit beside A's and B's on a SM while they wait, and
// launch C's dynamic shared memory (kAccBytes, 48 KB, over the default
// limit of 48 KB less its static premult table).  0 until set.
constexpr int kMaxDevices = 64;
std::atomic<int> device_sms[kMaxDevices];

cudaError_t sms_of_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && (*sms = device_sms[dev].load(std::memory_order_relaxed)))
    return cudaSuccess;
  const void* kernels[3] = {
      reinterpret_cast<const void*>(densify_tiles_kernel),
      reinterpret_cast<const void*>(densify_rows_kernel),
      reinterpret_cast<const void*>(densify_assemble_kernel)};
  for (const void* k : kernels)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(densify_assemble_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kAccBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && cached)
    device_sms[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

}  // namespace

extern "C" {

int mt_densify_args_bytes() { return static_cast<int>(sizeof(MtDensifyArgs)); }

// Macroblocks a launch C warp owns at a time (a granule).
int mt_densify_granule_mbs() { return kGranule; }

// Words of the scratch a call of S streams of `window` pictures of `mb`
// macroblocks, kt main and ke escape records needs (see Scratch), a
// stream: eight (four a lane), four a record tile of 4,096 of either lane,
// and four a granule of 4 macroblocks and one more (a (record, chain) pair
// a lane).
long long mt_densify_scratch_words(int streams, int window, int mb, int kt,
                                   int ke) {
  return scratch_words(streams, window, mb, kt, ke);
}

// K5 over S streams' window blobs: launches A, B and C, always all three
// (A and B of one idle CTA a stream when there are no records); *launched
// is set to the number of them that were enqueued.  Arguments the wrapper
// refuses are refused here too, as cudaErrorInvalidValue, and nothing
// launches: the blob's pointers, strides and field offsets must keep its
// int32 fields 4-byte aligned, coeffs and the scratch must be 16-byte
// aligned, and a stream's span must stay below 2^31 entries.
int mt_densify_unpack(const MtDensifyArgs* args, void* stream,
                      int* launched) {
  const MtDensifyArgs& a = *args;
  *launched = 0;
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
      a.mv_v && a.is_ref && a.is_noop && a.scratch && aligned(a.scratch, 16);
  if (!ok || static_cast<long long>(a.streams) *
                 granules(a.window * a.mb) >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int main_tiles = tiles(a.kt), esc_tiles = tiles(a.ke);
  const dim3 records(main_tiles + esc_tiles > 0 ? main_tiles + esc_tiles : 1,
                     a.streams);
  int sms = 0;
  cudaError_t err = sms_of_device(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  densify_tiles_kernel<<<records, kThreads, 0, st>>>(a, main_tiles,
                                                     esc_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  err = launch_overlapped(densify_rows_kernel, records, 0, st, a, main_tiles,
                          esc_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 2;
  const long long ctas = (static_cast<long long>(a.streams) *
                              granules(a.window * a.mb) + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * kAsmCtasPerSm;
  err = launch_overlapped(densify_assemble_kernel,
                          dim3(static_cast<unsigned>(ctas < cap ? ctas : cap)),
                          kAccBytes, st, a, main_tiles, esc_tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 3;
  return static_cast<int>(cudaGetLastError());
}

const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
