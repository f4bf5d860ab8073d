// Digit histogram of the MSM main path for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_msm/ops/hist.py digit_hist_pallas2 (and
// digit_hist_pallas, the same function from two input views). On the TPU the
// histogram was a one-hot matrix product on the MXU; here each digit is one
// integer atomic add, and the counts are exact whatever the order.
//
// What bounds it on the card: atomics and bytes. 2^20 digits are 4 MB read
// once; the 34,816 bins at m = 2^15 (136 KB) stay in the 50 MB L2, where the
// atomics resolve. Skew is the risk (a window of mostly equal digits sends
// every atomic to one address), so each warp first groups its lanes by digit
// with __match_any_sync and one leader adds the group's count: a warp of
// equal digits costs one atomic instead of 32. A per-block shared-memory
// histogram would need the full 136 KB of bins per block and a flush larger
// than the input at this n, so this first version uses global atomics.
//
// The wrapper zeroes `out`; digits >= nbins are not counted (the pipeline's
// digits are at most m+1, below nbins). The kernel allocates nothing and
// does not synchronise; the C entry launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
    digit_hist_kernel(const uint32_t* __restrict__ digits, long long n,
                      int* __restrict__ out, long long nbins) {
  const unsigned lane = threadIdx.x & 31u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // `base` is uniform across the block, so all 32 lanes of a warp run every
  // iteration together, as __match_any_sync requires.
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const uint32_t d = i < n ? digits[i] : 0xffffffffu;
    const bool valid = i < n && (long long)d < nbins;
    const uint32_t key = valid ? d : 0xffffffffu;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (valid && lane == (unsigned)(__ffs(peers) - 1))
      atomicAdd(&out[d], __popc(peers));
  }
}

}  // namespace

extern "C" int tpu_msm_digit_hist(const uint32_t* digits, long long n, int* out,
                                  long long nbins, void* stream) {
  long long want = (n + kThreads - 1) / kThreads;
  unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  if (blocks == 0) blocks = 1;
  digit_hist_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      digits, n, out, nbins);
  return (int)cudaGetLastError();
}
