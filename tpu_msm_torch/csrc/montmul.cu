// Chained Montgomery-multiply microbenchmark kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of benches/montmul_benchmark.py (`run`,
// built by `_build_kernel`): per lane, `steps` x `chain` dependent Montgomery
// products a <- a * x * 2^-256 mod P with the accumulator resident across the
// TPU grid's steps. With ilp > 1 each step starts `ilp` independent chains
// from limb rotations of the accumulator (chain k sees limb i of the
// accumulator at limb (i - k) mod 16, the TPU body's `rows[k:] + rows[:k]`)
// and XOR-folds them at the step's end, as the TPU body does. On the card the
// TPU grid's step axis becomes a loop inside the thread; a and x are read
// once, the accumulator and the chains never leave registers, and the result
// is written once.
//
// What bounds it: the integer multiply pipe, once enough products run side
// by side. The kernel's body is the field product (bn254.cuh fp_mont_mul,
// the CIOS product on PTX carry chains), so its design is the product's:
// each row is two independent carry chains of multiply-adds, and the
// reduction's chains overlap them. In the built SASS for sm_90a (CUDA
// 12.8) one product is 119 wide IMADs (IMAD.WIDE.U32, most with the carry
// in), 9 IMAD.HI and 9 narrow IMADs, the carries between pairs of words in
// IADD3.X. A wide IMAD holds the multiply pipe for two issue slots (the
// card shows it: PERF.md §7), so a product asks 265 slots of a pipe that
// takes 64 lanes' worth an SM clock; profiling.py's model counts 264 (two
// for each of the 128 wide products and one for each of the 8 m).
// Against 128 bytes of u16 rows in and 64 out per lane for the whole chain
// the bytes are nothing.
//
// Latency binds at ilp 1 on few lanes: one dependent product took 0.69 µs
// with the 64-bit accumulator of the old core and takes about half a
// microsecond now. Throughput needs independent products in flight: one
// thread per lane, and ilp > 1 adds independent chains inside each thread.
// The launch: 65,536 lanes are 512 blocks of kThreads = 128, about four
// blocks (16 warps, 4 a scheduler) on each of 132 SMs, all resident in one
// wave. ptxas (sm_90a, CUDA 12.8) gives the kernel 40 registers at ilp 1 and
// 94 at ilp 8, no spills: five blocks an SM fit at every ilp, more than the
// grid brings, so no minimum of blocks is set. (A minimum of four let ptxas
// take up to 128 registers, and it spilled 8 bytes at ilp 8.) The kernel is
// what the roofline (utils/profiling.py) measures the field core against.
//
// A rotated or XOR-folded accumulator may be >= P. The product still ends
// canonical for a < 2^256 and b = x < P: every row keeps the running value
// below b + P < 2P, so the final conditional subtract suffices.
//
// The kernel allocates nothing and does not synchronise. The C entry
// launches on the caller's stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an ilp outside 1..8.

#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 128;

// The 256-bit value rotated right by 16k bits: limb i of the result is limb
// (i + k) mod 16 of a. Word w is the high half of word w + k/2 and the low
// half of word w + k/2 + 1 when k is odd.
__device__ __forceinline__ Fp rotate_limbs(const Fp& a, int k) {
  const int q = k >> 1;
  Fp r;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint32_t lo = a.w[(w + q) & 7];
    const uint32_t hi = a.w[(w + q + 1) & 7];
    r.w[w] = (k & 1) ? __funnelshift_r(lo, hi, 16) : lo;
  }
  return r;
}

// a, x, out: (16, n) u16 rows. Lane i runs steps x chain products on each of
// ILP chains.
template <int ILP>
__global__ void __launch_bounds__(kThreads)
    montmul_chain_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ x,
                         uint32_t* __restrict__ out, long long n, int chain,
                         int steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fp acc = load_u16_rows(a, n, i);
  const Fp xv = load_u16_rows(x, n, i);
  for (int s = 0; s < steps; ++s) {
    Fp c[ILP];
#pragma unroll
    for (int k = 0; k < ILP; ++k) c[k] = rotate_limbs(acc, k);
#pragma unroll 1
    for (int j = 0; j < chain; ++j) {
#pragma unroll
      for (int k = 0; k < ILP; ++k) c[k] = fp_mont_mul(c[k], xv);
    }
    acc = c[0];
#pragma unroll
    for (int k = 1; k < ILP; ++k) {
#pragma unroll
      for (int w = 0; w < 8; ++w) acc.w[w] ^= c[k].w[w];
    }
  }
  store_u16_rows(out, n, i, acc);
}

template <int ILP>
void launch(const uint32_t* a, const uint32_t* x, uint32_t* out, long long n,
            int chain, int steps, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  montmul_chain_kernel<ILP>
      <<<blocks, kThreads, 0, stream>>>(a, x, out, n, chain, steps);
}

}  // namespace

extern "C" int tpu_msm_montmul_chain(const uint32_t* a, const uint32_t* x,
                                     uint32_t* out, long long n, int chain,
                                     int steps, int ilp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (ilp) {
    case 1: launch<1>(a, x, out, n, chain, steps, s); break;
    case 2: launch<2>(a, x, out, n, chain, steps, s); break;
    case 3: launch<3>(a, x, out, n, chain, steps, s); break;
    case 4: launch<4>(a, x, out, n, chain, steps, s); break;
    case 5: launch<5>(a, x, out, n, chain, steps, s); break;
    case 6: launch<6>(a, x, out, n, chain, steps, s); break;
    case 7: launch<7>(a, x, out, n, chain, steps, s); break;
    case 8: launch<8>(a, x, out, n, chain, steps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
