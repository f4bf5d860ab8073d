// Digit histograms of the MSM main path for Hopper (sm_90a): one launch
// counts a group of G windows' digits, (G, n) -> (G, nbins).
//
// Replaces the Pallas TPU kernels tpu_msm/ops/hist.py digit_hist_pallas2 and
// digit_hist_pallas (the same function from two input views). On the TPU the
// histogram was a one-hot matrix product on the MXU; here each block counts a
// contiguous chunk of one window's digits into a private histogram in shared
// memory, then flushes every non-zero bin into the int32 output with one
// global atomic add. The counts are exact in any order of the input.
//
// What bounds it: bytes, then the shared-memory atomics and the flush. 16
// windows of 2^20 digits are 64 MB, read once (0.0213 ms at 3.35 TB/s with
// the 4.3 MB of counts). Atomics resolve in shared memory, so L2 sees one
// atomic per non-zero bin and block instead of one per digit. Skew is the
// risk there (sorted digits, or a window of mostly equal digits, send every
// lane of a warp to one address): where a lane repeats its neighbour's
// digit, the warp groups its lanes by digit with __match_any_sync and one
// leader adds each group's count; elsewhere each lane adds alone. On the
// H100 __match_any_sync costs more than the rest of a digit's work:
// grouping every warp took 0.175 ms at (16, 2^20) with 16-bit counters,
// against 0.065 ms grouping only runs.
//
// Only bins [0, held) with held = min(nbins, m + 2) can be hit by the
// pipeline's digits (at most m + 1, the padding sentinel); those are the
// bins held in shared memory. A digit in [held, nbins) is still counted, by
// a global atomic straight away (never on the pipeline's path). Digits
// >= nbins are not counted. The regime follows the held bins:
//   * held * 4 bytes fit in one block's 227 KB of dynamic shared memory
//     (every c <= 15, and c = 16 signed: m = 32768, 131 KB): int32
//     counters, one part;
//   * they do not (c = 16 unsigned: m = 65535, 262 KB; c = 17), and the
//     windows are many: two 16-bit counters a word (kU16), a chunk of at
//     most 65,535 digits so that none overflows (one part of 131 KB at
//     m = 65535; 0.065 ms at (16, 2^20), where split bins took 0.073);
//   * they do not, and the windows are few: the bin range is split into
//     `parts` ranges of `part_bins` int32 counters, one per block, and
//     each block reads its whole chunk and counts the digits of its range
//     (2 parts of 131 KB at m = 65535), which cuts a window into more
//     blocks than 65,535-digit chunks would.
// `ops/hist.py` (`plan`) chooses the regime, the parts and the chunk: one
// wave of blocks over the card, and a chunk of at least a quarter of a
// block's bins, so that its flush reads at most four counters a digit.
//
// The wrapper zeroes `out`. The kernel allocates nothing and does not
// synchronise; the C entry launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
// Loads in flight per thread: 16 x 4 B x 1024 threads = 64 KB an SM (split
// bins, which read each chunk twice, gained 13 % over 4 at (16, 2^20)).
constexpr int kUnroll = 16;
constexpr int kMaxSharedBytes = 232448;
constexpr uint32_t kNone = 0xffffffffu;  // a key no counted digit has

// Grid: x = chunk * parts + part, y = window (row). Block (c, p) of row g
// counts the digits [c * chunk, (c + 1) * chunk) of row g that fall in bins
// [p * part_bins, (p + 1) * part_bins) ∩ [0, held); part 0 also counts the
// digits in [held, nbins) by global atomics.
template <bool kU16>
__global__ void __launch_bounds__(kThreads)
    digit_hist_kernel(const uint32_t* __restrict__ digits, long long n,
                      int* __restrict__ out, int nbins, int held,
                      int part_bins, int parts, long long chunk) {
  extern __shared__ uint32_t counts[];
  const int part = blockIdx.x % parts;
  const long long c0 = (long long)(blockIdx.x / parts) * chunk;
  const long long c1 = c0 + chunk < n ? c0 + chunk : n;
  const uint32_t lo = (uint32_t)part * part_bins;
  const uint32_t top = lo + part_bins < (uint32_t)held ? lo + part_bins
                                                        : (uint32_t)held;
  const uint32_t hi = top > lo ? top : lo;
  const int bins = (int)(hi - lo);
  const int words = kU16 ? (bins + 1) / 2 : bins;
  const uint32_t* row = digits + (size_t)blockIdx.y * n;
  int* hist = out + (size_t)blockIdx.y * nbins;
  const bool direct_part = part == 0;
  const unsigned lane = threadIdx.x & 31u;

  for (int i = threadIdx.x; i < words; i += kThreads) counts[i] = 0;
  __syncthreads();

  // `base` is uniform across the block, so all 32 lanes of a warp run every
  // iteration together, as __match_any_sync requires.
  for (long long base = c0; base < c1; base += kThreads * kUnroll) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + j * kThreads + threadIdx.x;
      v[j] = i < c1 ? __ldg(row + i) : kNone;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const uint32_t d = v[j];
      const bool in_shared = d >= lo && d < hi;
      const bool direct = direct_part && d >= (uint32_t)held &&
                          d < (uint32_t)nbins;
      const uint32_t key = in_shared || direct ? d : kNone;
      // Group only where a lane repeats its neighbour's digit (sorted
      // input, a heavy bin); elsewhere each lane adds alone.
      const uint32_t left = __shfl_up_sync(0xffffffffu, key, 1);
      const bool runs =
          __any_sync(0xffffffffu, lane > 0 && key != kNone && key == left);
      const unsigned peers =
          runs ? __match_any_sync(0xffffffffu, key) : 1u << lane;
      if (key != kNone && lane == (unsigned)(__ffs(peers) - 1)) {
        const unsigned k = __popc(peers);
        if (in_shared) {
          const uint32_t b = d - lo;
          if (kU16)
            atomicAdd(&counts[b >> 1], k << (16 * (b & 1)));
          else
            atomicAdd(&counts[b], k);
        } else {
          atomicAdd(&hist[d], (int)k);
        }
      }
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < bins; b += kThreads) {
    const uint32_t k =
        kU16 ? (counts[b >> 1] >> (16 * (b & 1))) & 0xffffu : counts[b];
    if (k) atomicAdd(&hist[lo + b], (int)k);
  }
}

template <bool kU16>
int launch(const uint32_t* digits, int rows, long long n, int* out,
           int nbins, int held, int part_bins, int parts, long long chunk,
           size_t smem, cudaStream_t stream) {
  // Above 48 KB a block takes dynamic shared memory only after this
  // attribute is raised; once per kernel and process.
  static const cudaError_t attr = cudaFuncSetAttribute(
      digit_hist_kernel<kU16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSharedBytes);
  if (attr != cudaSuccess) return (int)attr;
  const long long chunks = (n + chunk - 1) / chunk;
  const dim3 grid((unsigned)(chunks * parts), (unsigned)rows);
  digit_hist_kernel<kU16><<<grid, kThreads, smem, stream>>>(
      digits, n, out, nbins, held, part_bins, parts, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tpu_msm_digit_hist(const uint32_t* digits, int rows,
                                  long long n, int* out, int nbins, int held,
                                  int part_bins, int parts, long long chunk,
                                  int u16, void* stream) {
  const size_t smem =
      u16 ? (size_t)(part_bins + 1) / 2 * 4 : (size_t)part_bins * 4;
  if (rows <= 0 || n <= 0 || chunk <= 0 || parts <= 0 || part_bins <= 0 ||
      smem > (size_t)kMaxSharedBytes || (u16 && chunk > 0xffff))
    return (int)cudaErrorInvalidValue;
  return u16 ? launch<true>(digits, rows, n, out, nbins, held, part_bins,
                            parts, chunk, smem, (cudaStream_t)stream)
             : launch<false>(digits, rows, n, out, nbins, held, part_bins,
                             parts, chunk, smem, (cudaStream_t)stream);
}
