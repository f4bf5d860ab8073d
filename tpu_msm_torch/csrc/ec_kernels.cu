// EC kernels for Hopper (sm_90a), one thread per lane or element.
//
// Replace the Pallas TPU kernels of tpu_msm/ops/pallas_curve.py:
//   tpu_msm_scan_madd       <- scan_madd_packed_u16_f15d (and its aliases
//                              scan_madd_packed_u16, _u16_f15, _u16_mxu)
//   tpu_msm_padd            <- padd_packed
//   tpu_msm_fold_add        <- fold_add_packed
//   tpu_msm_pmadd           <- pmadd_packed
//   tpu_msm_jac_madd        <- madd_packed
//   tpu_msm_jac_add         <- add_packed
//   tpu_msm_scan_madd_rows  <- scan_madd_packed
//
// What bounds them on the card: 32-bit integer multiplies. A Montgomery
// product is 128 32x32->64 multiplies (two IMADs each), and a mixed add is 11
// of them, against 256 bytes moved per scan step and lane. So the design keeps
// every intermediate in registers and reads each operand once: the TPU grid's
// sequential step axis becomes a loop inside the thread, and the accumulator
// (24 words) never leaves registers. Lanes are contiguous in memory, so each
// warp's loads and stores of one limb row coalesce into 128-byte lines.
//
// Known limit: at the tuned 4096 scan lanes the scan runs 32 blocks of 128
// threads, which leaves 100 of the H100's 132 SMs idle. The config is kept
// as it is for the first port; the occupancy is a question for PERF.md.
//
// The elementwise kernels (padd, pmadd, jac_madd, jac_add) read their
// operands once and write the sum once: 320-384 bytes of u16 rows in and
// 192 out per element against 11-20 Montgomery products, so they are bound
// by the multiplies too once N fills the card; at the per-window path's
// 16384 lanes a pmadd launch is 128 blocks, one wave. The Jacobian adders
// compute their doubling fallback only on the lanes that take it (P == Q),
// a rare divergent branch, where the TPU kernels computed it on every lane
// and selected.
//
// The kernels allocate nothing and do not synchronise. Each C entry launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 128;

// Inclusive per-lane prefix sum over the step axis by complete mixed add.
// gx, gy: (8, steps, lanes) packed affine words, (0, 0) = infinity.
// out: (48, steps, lanes) canonical u16 rows X || Y || Z of the running sums.
__global__ void __launch_bounds__(kThreads)
    scan_madd_kernel(const uint32_t* __restrict__ gx,
                     const uint32_t* __restrict__ gy,
                     uint32_t* __restrict__ out, int steps, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t plane = (size_t)steps * lanes;
  Proj acc = proj_infinity();
  for (int k = 0; k < steps; ++k) {
    const size_t off = (size_t)k * lanes + lane;
    Fp qx, qy;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qx.w[i] = gx[i * plane + off];
      qy.w[i] = gy[i * plane + off];
    }
    acc = proj_madd_complete(acc, qx, qy);
    store_u16_rows(out, plane, off, acc.x);
    store_u16_rows(out + 16 * plane, plane, off, acc.y);
    store_u16_rows(out + 32 * plane, plane, off, acc.z);
  }
}

// Elementwise complete projective add of (16, n) u16-row operands.
__global__ void __launch_bounds__(kThreads)
    padd_kernel(const uint32_t* __restrict__ ax, const uint32_t* __restrict__ ay,
                const uint32_t* __restrict__ az, const uint32_t* __restrict__ bx,
                const uint32_t* __restrict__ by, const uint32_t* __restrict__ bz,
                uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                uint32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj p, q;
  p.x = load_u16_rows(ax, n, i);
  p.y = load_u16_rows(ay, n, i);
  p.z = load_u16_rows(az, n, i);
  q.x = load_u16_rows(bx, n, i);
  q.y = load_u16_rows(by, n, i);
  q.z = load_u16_rows(bz, n, i);
  const Proj r = proj_add(p, q);
  store_u16_rows(ox, n, i, r.x);
  store_u16_rows(oy, n, i, r.y);
  store_u16_rows(oz, n, i, r.z);
}

// Per-lane EC sum over the step axis: (16, steps, lanes) -> (16, lanes),
// accumulator starting at infinity.
__global__ void __launch_bounds__(kThreads)
    fold_add_kernel(const uint32_t* __restrict__ bx,
                    const uint32_t* __restrict__ by,
                    const uint32_t* __restrict__ bz, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    int steps, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t plane = (size_t)steps * lanes;
  Proj acc = proj_infinity();
  for (int k = 0; k < steps; ++k) {
    const size_t off = (size_t)k * lanes + lane;
    Proj b;
    b.x = load_u16_rows(bx, plane, off);
    b.y = load_u16_rows(by, plane, off);
    b.z = load_u16_rows(bz, plane, off);
    acc = proj_add(acc, b);
  }
  store_u16_rows(ox, lanes, lane, acc.x);
  store_u16_rows(oy, lanes, lane, acc.y);
  store_u16_rows(oz, lanes, lane, acc.z);
}

// The prefix scan of scan_madd_kernel on unpacked (16, steps, lanes) u16-row
// affine inputs, with X, Y and Z as three (16, steps, lanes) outputs.
__global__ void __launch_bounds__(kThreads)
    scan_madd_rows_kernel(const uint32_t* __restrict__ gx,
                          const uint32_t* __restrict__ gy,
                          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                          uint32_t* __restrict__ oz, int steps, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t plane = (size_t)steps * lanes;
  Proj acc = proj_infinity();
  for (int k = 0; k < steps; ++k) {
    const size_t off = (size_t)k * lanes + lane;
    acc = proj_madd_complete(acc, load_u16_rows(gx, plane, off),
                             load_u16_rows(gy, plane, off));
    store_u16_rows(ox, plane, off, acc.x);
    store_u16_rows(oy, plane, off, acc.y);
    store_u16_rows(oz, plane, off, acc.z);
  }
}

// Elementwise projective + affine mixed add of (16, n) u16-row operands.
__global__ void __launch_bounds__(kThreads)
    pmadd_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                 const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                 const uint32_t* __restrict__ qy, uint32_t* __restrict__ ox,
                 uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj p;
  p.x = load_u16_rows(px, n, i);
  p.y = load_u16_rows(py, n, i);
  p.z = load_u16_rows(pz, n, i);
  const Proj r =
      proj_madd_complete(p, load_u16_rows(qx, n, i), load_u16_rows(qy, n, i));
  store_u16_rows(ox, n, i, r.x);
  store_u16_rows(oy, n, i, r.y);
  store_u16_rows(oz, n, i, r.z);
}

// Elementwise Jacobian + affine mixed add of (16, n) u16-row operands.
__global__ void __launch_bounds__(kThreads)
    jac_madd_kernel(const uint32_t* __restrict__ px,
                    const uint32_t* __restrict__ py,
                    const uint32_t* __restrict__ pz,
                    const uint32_t* __restrict__ qx,
                    const uint32_t* __restrict__ qy, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p;
  p.x = load_u16_rows(px, n, i);
  p.y = load_u16_rows(py, n, i);
  p.z = load_u16_rows(pz, n, i);
  const Jac r = jac_madd(p, load_u16_rows(qx, n, i), load_u16_rows(qy, n, i));
  store_u16_rows(ox, n, i, r.x);
  store_u16_rows(oy, n, i, r.y);
  store_u16_rows(oz, n, i, r.z);
}

// Elementwise Jacobian + Jacobian add of (16, n) u16-row operands.
__global__ void __launch_bounds__(kThreads)
    jac_add_kernel(const uint32_t* __restrict__ ax,
                   const uint32_t* __restrict__ ay,
                   const uint32_t* __restrict__ az,
                   const uint32_t* __restrict__ bx,
                   const uint32_t* __restrict__ by,
                   const uint32_t* __restrict__ bz, uint32_t* __restrict__ ox,
                   uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                   long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p, q;
  p.x = load_u16_rows(ax, n, i);
  p.y = load_u16_rows(ay, n, i);
  p.z = load_u16_rows(az, n, i);
  q.x = load_u16_rows(bx, n, i);
  q.y = load_u16_rows(by, n, i);
  q.z = load_u16_rows(bz, n, i);
  const Jac r = jac_add(p, q);
  store_u16_rows(ox, n, i, r.x);
  store_u16_rows(oy, n, i, r.y);
  store_u16_rows(oz, n, i, r.z);
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int tpu_msm_scan_madd(const uint32_t* gx, const uint32_t* gy, uint32_t* out,
                      int steps, int lanes, void* stream) {
  scan_madd_kernel<<<blocks_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      gx, gy, out, steps, lanes);
  return (int)cudaGetLastError();
}

int tpu_msm_padd(const uint32_t* ax, const uint32_t* ay, const uint32_t* az,
                 const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                 uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n,
                 void* stream) {
  padd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      ax, ay, az, bx, by, bz, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

int tpu_msm_fold_add(const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                     uint32_t* ox, uint32_t* oy, uint32_t* oz, int steps,
                     int lanes, void* stream) {
  fold_add_kernel<<<blocks_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      bx, by, bz, ox, oy, oz, steps, lanes);
  return (int)cudaGetLastError();
}

int tpu_msm_scan_madd_rows(const uint32_t* gx, const uint32_t* gy,
                           uint32_t* ox, uint32_t* oy, uint32_t* oz, int steps,
                           int lanes, void* stream) {
  scan_madd_rows_kernel<<<blocks_for(lanes), kThreads, 0,
                          (cudaStream_t)stream>>>(gx, gy, ox, oy, oz, steps,
                                                  lanes);
  return (int)cudaGetLastError();
}

int tpu_msm_pmadd(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                  const uint32_t* qx, const uint32_t* qy, uint32_t* ox,
                  uint32_t* oy, uint32_t* oz, long long n, void* stream) {
  pmadd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      px, py, pz, qx, qy, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

int tpu_msm_jac_madd(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                     const uint32_t* qx, const uint32_t* qy, uint32_t* ox,
                     uint32_t* oy, uint32_t* oz, long long n, void* stream) {
  jac_madd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      px, py, pz, qx, qy, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

int tpu_msm_jac_add(const uint32_t* ax, const uint32_t* ay, const uint32_t* az,
                    const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                    uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n,
                    void* stream) {
  jac_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      ax, ay, az, bx, by, bz, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
