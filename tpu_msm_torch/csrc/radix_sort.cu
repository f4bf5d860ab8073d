// The sort stage's stable digit sort for Hopper (sm_90a): each row of a
// (G, n) int32 key array sorted by an LSD radix sort, one C call for a
// group of G windows, giving each row's int32 permutation and, where asked,
// its sorted keys.
//
// Replaces no Pallas kernel: the JAX package left this sort to XLA,
// `jax.lax.sort_key_val(digits, idx0)` at tpu_msm/ops/pippenger.py:291 (the
// "rank" layout of `_sorted_scan_inputs`) and :514 (the per-window route).
// The port called torch.sort(stable=True) there, whose int64 indices the
// scan then read.
//
// The function. keys (G, n) hold window digits in [0, 2^key_bits),
// key_bits <= 18 (c = 16 unsigned: 0..65535 and the padding sentinel
// 65536, 17 bits; c = 16 signed: 16 bits; any c of 1-17 at most 18).
// perm[g, p] is the index of row g's p-th key in the stable order, which is
// unique, so the result equals torch.sort(stable=True)'s indices exactly on
// every run; sorted[g, p] = keys[g, perm[g, p]] where asked. A key outside
// [0, 2^key_bits) is sorted by its low key_bits bits (never the caller's
// case: its digits are in range by construction).
//
// What bounds it: bytes. The function reads the keys once and writes the
// permutation once: 8 bytes a key, 128 MiB at (16, 2^20), 0.040 ms at
// 3.35 TB/s (the sorted keys, where asked, 4 more). This design moves 32
// bytes a key in two passes: each pass counts its input's digits (4 bytes
// read) and scatters it (pass 1 reads the keys and writes keys and indices,
// 12 bytes; pass 2 reads both and writes the permutation, 12), 512 MiB and
// 0.160 ms at (16, 2^20), besides its tile counts (0.5 bytes a key a pass).
// A pass's counts cannot come from the first read of the keys: they are
// the counts of each tile of that pass's input, which for the second pass
// is the first pass's output.
//
// The design. ceil(key_bits / 9) passes of at most 9 bits (512 bins), the
// low bits first: 17 bits sort as 8 + 9, 16 as 8 + 8, 9 in one pass. A pass
// is three launches, each over tiles of kTile consecutive keys of a row:
// - count: a block counts its tile's digits into shared memory and writes
//   them as counts[g][tile][bin];
// - scan: a block a window turns the counts, in (bin, tile) order, into
//   exclusive offsets in place: the position of bin b's first key of tile t
//   in the pass's output. Thread (part, bin) walks a run of tiles (so a
//   warp reads 32 consecutive bins of one tile), then the bins are scanned
//   by one warp;
// - scatter: a block ranks its tile's keys stably, then writes them by
//   offset plus rank. Warp w holds keys [512 w, 512 w + 512) of the tile,
//   32 consecutive ones at each of its 16 items, so the items in order are
//   the keys in order. For each item the warp finds each lane's peers (the
//   lanes with its digit): one ballot a digit bit, each lane keeping the
//   lanes that agree with it on every bit. (__match_any_sync, which
//   csrc/hist.cu measured at about 55 clocks a warp on the H100, made the
//   sort 0.51-0.52 ms at (16, 2^20) against the ballots' 0.43, PERF.md
//   §6.) A peer group's highest lane
//   advances the warp's count of that digit in shared memory; a key's rank
//   in its warp is the count before the item plus its lower peers. The
//   warps' counts are then combined in warp order, so a key's rank in the
//   tile is its bin's start in the tile, plus the counts of earlier warps,
//   plus its rank in the warp. Each key and its index are staged at that
//   rank in shared memory (the tile sorted by the digit), and the block
//   writes the staged tile in order: consecutive threads write consecutive
//   positions of a bin's run, each run a contiguous stretch of the output.
//   No atomic decides a position; the counts' atomics add counts only.
// The first pass's values are the keys' indices in the row (computed, not
// read). A two-pass sort keeps the first pass's keys and indices in the
// scratch, after the counts: tpu_msm_digit_sort_scratch gives its size in
// int32 words. The last pass writes the permutation, and the sorted keys
// only where out_keys is not null (the tuned row's "hist" segment starts
// count the unsorted digits).
//
// ptxas for sm_90a (CUDA 12.8): the scatter kernels 64 registers and
// 36,864 bytes of shared memory (4 blocks an SM), count 40, scan 28, no
// spills. On the H100 the sort takes about 0.43 ms at (16, 2^20) with 17
// bits, a third of torch.sort's time, and about 10.6 times its bound; its
// two scatters take three quarters of that (PERF.md §6). Three variants of
// the scatter measured slower there: launch bounds for 5 or 6 blocks an SM
// (51 or 40 registers), the bins' combination as one scan over the block
// in place of one warp's, and the tile's offsets read ahead of the ranking.
//
// The wrapper (ops/sort.py, `digit_sort`) allocates the outputs and the
// scratch. The kernels allocate nothing and do not synchronise; the C entry
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // keys a thread
constexpr int kTile = kThreads * kItems;  // keys a block: 4096
constexpr int kWarpKeys = 32 * kItems;    // consecutive keys a warp: 512
constexpr int kMaxBits = 9;               // digit bits a pass
constexpr int kMaxBins = 1 << kMaxBits;
constexpr int kMaxKeyBits = 2 * kMaxBits;
constexpr int kScanThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kNoDigit = kMaxBins;  // the digit of a key past the row
static_assert(kWarps * kMaxBins == kTile,
              "the warps' counts share the staged keys' shared memory");

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of the warp whose digit equals this lane's: a digit below
// 2^kMaxBits, or kNoDigit. All 32 lanes call it together.
__device__ __forceinline__ unsigned peers(unsigned digit) {
  const bool live = digit != kNoDigit;
  const unsigned alive = __ballot_sync(kAll, live);
  unsigned same = live ? alive : ~alive;
  // Bits from `bits` up are 0 in every digit: their ballots change nothing,
  // and a fixed count of them unrolls.
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b) {
    const bool set = (digit >> b) & 1u;
    const unsigned ones = __ballot_sync(kAll, set);
    same &= set ? ones : ~ones;
  }
  return same;
}

// An exclusive scan of v[0, count) in place by the 32 lanes of one warp;
// count <= kMaxBins.
__device__ __forceinline__ void warp_exclusive_scan(int* v, int count,
                                                    int lane) {
  const int per = (count + 31) / 32;
  const int b0 = lane * per;
  int local = 0;
  for (int k = 0; k < per; ++k)
    if (b0 + k < count) local += v[b0 + k];
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += up;
  }
  int run = incl - local;
  for (int k = 0; k < per; ++k) {
    if (b0 + k < count) {
      const int c = v[b0 + k];
      v[b0 + k] = run;
      run += c;
    }
  }
}

// Grid: x = tile, y = window. counts[(g * tiles + tile) * kMaxBins + b] =
// the keys of the tile whose digit (key >> shift) & (2^bits - 1) is b, for
// b < 2^bits. Each key adds itself: a warp whose keys share a digit
// serialises its adds, at worst 32-fold where all keys are equal.
__global__ void __launch_bounds__(kThreads)
    radix_count_kernel(const int* __restrict__ keys, int* __restrict__ counts,
                       int n, int tiles, int shift, int bits) {
  __shared__ int hist[kMaxBins];
  const int bins = 1 << bits;
  const unsigned mask = bins - 1;
  const int warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
  const int* row = keys + (size_t)blockIdx.y * n;
  const int first =
      blockIdx.x * kTile + warp * kWarpKeys + (int)(threadIdx.x & 31);
  unsigned digit[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * 32;
    digit[j] = i < n ? ((unsigned)__ldg(row + i) >> shift) & mask : kNoDigit;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (digit[j] != kNoDigit) atomicAdd(&hist[digit[j]], 1);
  __syncthreads();
  int* out = counts + ((size_t)blockIdx.y * tiles + blockIdx.x) * kMaxBins;
  for (int b = threadIdx.x; b < bins; b += kThreads) out[b] = hist[b];
}

// Grid: x = window. Turns window g's counts into exclusive offsets in
// (bin, tile) order, in place.
__global__ void __launch_bounds__(kScanThreads)
    radix_scan_kernel(int* __restrict__ counts, int tiles, int bits) {
  __shared__ int part_sum[kScanThreads];
  __shared__ int bin_base[kMaxBins];
  const int bins = 1 << bits;
  const int parts = kScanThreads / bins;
  const int b = threadIdx.x % bins, part = threadIdx.x / bins;
  const int per = (tiles + parts - 1) / parts;
  const int t0 = min(tiles, part * per), t1 = min(tiles, t0 + per);
  int* c = counts + (size_t)blockIdx.x * tiles * kMaxBins + b;
  int sum = 0;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) sum += c[(size_t)t * kMaxBins];
  part_sum[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < bins) {  // thread b: each part's start in bin b
    int run = 0;
    for (int p = 0; p < parts; ++p) {
      const int v = part_sum[p * bins + b];
      part_sum[p * bins + b] = run;
      run += v;
    }
    bin_base[b] = run;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_exclusive_scan(bin_base, bins, threadIdx.x);
  __syncthreads();
  int run = bin_base[b] + part_sum[threadIdx.x];
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const int v = c[(size_t)t * kMaxBins];
    c[(size_t)t * kMaxBins] = run;
    run += v;
  }
}

// Grid: x = tile, y = window. One pass's scatter of each tile by digit
// (key >> shift) & (2^bits - 1): keys_out and vals_out at the offsets the
// scan left in `offsets`. kFirst: the values are the keys' indices in the
// row (vals_in unread); kKeys: keys_out is written.
template <bool kFirst, bool kKeys>
__global__ void __launch_bounds__(kThreads)
    radix_scatter_kernel(const int* __restrict__ keys_in,
                         const int* __restrict__ vals_in,
                         const int* __restrict__ offsets,
                         int* __restrict__ keys_out,
                         int* __restrict__ vals_out, int n, int tiles,
                         int shift, int bits) {
  // While ranking, staged_keys holds the warps' counts, [warp][bin].
  __shared__ int staged_keys[kTile];
  __shared__ int staged_vals[kTile];
  __shared__ int bin_start[kMaxBins];  // a bin's first rank in the tile
  __shared__ int bin_shift[kMaxBins];  // output position less rank
  int* warp_counts = staged_keys;
  const int bins = 1 << bits;
  const unsigned mask = bins - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.y * n;
  const int tile0 = blockIdx.x * kTile;
  const int first = tile0 + warp * kWarpKeys + lane;

  for (int i = threadIdx.x; i < kTile; i += kThreads) warp_counts[i] = 0;
  int key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * 32;
    key[j] = i < n ? __ldg(keys_in + row + i) : 0;
  }
  __syncthreads();

  // Each key's rank among its warp's keys of its digit.
  int* counts = warp_counts + warp * kMaxBins;
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned d =
        first + j * 32 < n ? ((unsigned)key[j] >> shift) & mask : kNoDigit;
    const unsigned same = peers(d);
    const int top = 31 - __clz(same);
    int before = 0;
    if (lane == top && d != kNoDigit) before = counts[d];
    before = __shfl_sync(kAll, before, top);
    rank[j] = before + __popc(same & lanemask_lt());
    if (lane == top && d != kNoDigit) counts[d] = before + __popc(same);
    __syncwarp();
  }
  __syncthreads();

  // The warps combined in order: warp_counts[w][b] becomes the keys of
  // digit b in warps before w, bin_start[b] the tile's keys of digit b.
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int v = warp_counts[w * kMaxBins + b];
      warp_counts[w * kMaxBins + b] = run;
      run += v;
    }
    bin_start[b] = run;
  }
  __syncthreads();
  if (warp == 0) warp_exclusive_scan(bin_start, bins, lane);
  __syncthreads();
  const int* tile_offsets =
      offsets + ((size_t)blockIdx.y * tiles + blockIdx.x) * kMaxBins;
  for (int b = threadIdx.x; b < bins; b += kThreads)
    bin_shift[b] = __ldg(tile_offsets + b) - bin_start[b];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (first + j * 32 < n) {
      const unsigned d = ((unsigned)key[j] >> shift) & mask;
      rank[j] += bin_start[d] + counts[d];
    }
  }
  __syncthreads();  // every warp count read before the keys are staged

  // The values are read only now, so that they hold no registers while
  // the keys rank.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * 32;
    if (i < n) {
      staged_keys[rank[j]] = key[j];
      staged_vals[rank[j]] = kFirst ? i : __ldg(vals_in + row + i);
    }
  }
  __syncthreads();
  const int count = min(kTile, n - tile0);
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int k = staged_keys[i];
    const size_t at = row + (bin_shift[((unsigned)k >> shift) & mask] + i);
    vals_out[at] = staged_vals[i];
    if constexpr (kKeys) keys_out[at] = k;
  }
}

int passes_for(int key_bits) { return (key_bits + kMaxBits - 1) / kMaxBits; }

long long count_words(int windows, long long n) {
  return (long long)windows * ((n + kTile - 1) / kTile) * kMaxBins;
}

cudaError_t scatter(bool first, bool keys, dim3 grid, cudaStream_t s,
                    const int* keys_in, const int* vals_in,
                    const int* offsets, int* keys_out, int* vals_out, int n,
                    int tiles, int shift, int bits) {
  if (first && keys)
    radix_scatter_kernel<true, true><<<grid, kThreads, 0, s>>>(
        keys_in, vals_in, offsets, keys_out, vals_out, n, tiles, shift, bits);
  else if (first)
    radix_scatter_kernel<true, false><<<grid, kThreads, 0, s>>>(
        keys_in, vals_in, offsets, keys_out, vals_out, n, tiles, shift, bits);
  else if (keys)
    radix_scatter_kernel<false, true><<<grid, kThreads, 0, s>>>(
        keys_in, vals_in, offsets, keys_out, vals_out, n, tiles, shift, bits);
  else
    radix_scatter_kernel<false, false><<<grid, kThreads, 0, s>>>(
        keys_in, vals_in, offsets, keys_out, vals_out, n, tiles, shift, bits);
  return cudaGetLastError();
}

int sort(const int* keys, int* perm, int* out_keys, int* scratch,
         int windows, int n, int key_bits, cudaStream_t s) {
  const int passes = passes_for(key_bits);
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)tiles, (unsigned)windows);
  int* counts = scratch;
  int* mid_keys = scratch + count_words(windows, n);
  int* mid_vals = mid_keys + (size_t)windows * n;
  const int low_bits = key_bits / passes;
  for (int p = 0; p < passes; ++p) {
    const bool first = p == 0, last = p == passes - 1;
    const int shift = p * low_bits;
    const int bits = last ? key_bits - shift : low_bits;
    const int* in = first ? keys : mid_keys;
    radix_count_kernel<<<grid, kThreads, 0, s>>>(in, counts, n, tiles, shift,
                                                 bits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    radix_scan_kernel<<<windows, kScanThreads, 0, s>>>(counts, tiles, bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = scatter(first, !last || out_keys != nullptr, grid, s, in,
                          mid_vals, counts, last ? out_keys : mid_keys,
                          last ? perm : mid_vals, n, tiles, shift, bits);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

bool valid(int windows, long long n, int key_bits) {
  return windows > 0 && windows <= 65535 && n > 0 && n <= INT_MAX - kTile &&
         key_bits >= 1 && key_bits <= kMaxKeyBits;
}

}  // namespace

extern "C" {

// The scratch tpu_msm_digit_sort needs, in int32 words: the tile counts,
// and for a two-pass sort the first pass's keys and indices. -1 where the
// arguments are outside what the sort takes.
long long tpu_msm_digit_sort_scratch(int windows, long long n, int key_bits) {
  if (!valid(windows, n, key_bits)) return -1;
  return count_words(windows, n) +
         (passes_for(key_bits) > 1 ? 2 * (long long)windows * n : 0);
}

// keys, perm and out_keys (null: not written): (windows, n) int32; scratch:
// tpu_msm_digit_sort_scratch(windows, n, key_bits) words.
int tpu_msm_digit_sort(const int* keys, int* perm, int* out_keys,
                       int* scratch, int windows, long long n, int key_bits,
                       void* stream) {
  if (!valid(windows, n, key_bits) || keys == nullptr || perm == nullptr ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return sort(keys, perm, out_keys, scratch, windows, (int)n, key_bits, s);
}

}  // extern "C"
