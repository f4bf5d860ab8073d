// The sort stage's layout for Hopper (sm_90a): each window's points, in the
// order of its stable digit sort, gathered from the point-major table of
// packed words into the scan kernel's lane-major (G, 8, steps, lanes)
// blocks, one launch for a group of G windows.
//
// Replaces no Pallas kernel: the JAX package left this stage to XLA
// (tpu_msm/ops/pippenger.py:271-307, `_sorted_scan_inputs`). This kernel is
// that function's "rank" strategy (:289-297) after its sort: one gather of
// the point-major (n, 16) table, a 64-byte row a point, and the transposes
// into the scan's layout, in one pass.
//
// The function. perm (G, n_pad) int32 holds each window's stable sort
// permutation (csrc/radix_sort.cu); rows the packed words of every point,
// (n_pad, 16) int32 [x 0-7 | y 0-7] where the digits are unsigned and negm
// is null, (n_pad, 24) with -y's words at 16-23 where they are signed and
// negm (G, n_pad) holds the negation masks (one byte each). With steps =
// n_pad / lanes, column k * lanes + l of window g takes the point src =
// perm[g, l * steps + k]:
//   sgx[g, :, k, l] = rows[src, 0:8]
//   sgy[g, :, k, l] = rows[src, 16:24] if negm[g, src], else rows[src, 8:16]
// An index outside [0, n_pad) gives the (0, 0) infinity and reads nothing.
//
// What bounds it: bytes. It does no arithmetic: a column reads 4 bytes of
// perm and 64 of rows (its x half-row and its y or -y half-row), and writes
// 64. The torch formulation it replaces gathered (G, 8, n_pad) words one
// 4-byte word at a time from the planar (8, n_pad) x and y, so each read
// pulled in its own 32-byte sector, eight sectors a half-row. Here a half-row
// is one aligned 32-byte sector (rows of 64 or 96 bytes, the table's base
// 16-byte aligned at least, 512-byte as PyTorch allocates it), read as two
// 16-byte loads.
//
// The design. A block takes a tile of one window, 32 lanes x 32 steps:
// - it reads the tile's perm into shared memory (for a fixed lane the steps
//   are consecutive in perm, so a warp reads 128 contiguous bytes), stored
//   as [step][lane] with a padded row, so that neither the stores nor the
//   reads below conflict on a bank;
// - warp w then takes steps w, w + 8, w + 16 and w + 24 of the tile, thread
//   t lane t: it reads the four columns' masks, then their 16 half-row
//   loads, all in flight together;
// - it writes each column's 8 + 8 words, so that a warp writes 128
//   contiguous bytes of each (plane, step) row.
// negm is n_pad bytes a window (1 MiB at 2^20) and stays in L2; the table
// (64 or 96 MiB at 2^20) does not, and each window reads it again, in its
// own random order.
//
// The wrapper (ops/cuda_curve.py, `scan_layout`) allocates sgx and sgy. The
// kernel allocates nothing and does not synchronise; the C entry launches on
// the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTileLanes = 32;  // a warp's lanes
constexpr int kTileSteps = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kTileLanes * kWarps;
constexpr int kColumns = kTileSteps / kWarps;  // columns a thread

// The eight words of v to p[0], p[plane], ..., p[7 * plane].
__device__ __forceinline__ void store8(int* p, size_t plane,
                                       const int4 (&v)[2]) {
  p[0] = v[0].x;
  p[plane] = v[0].y;
  p[2 * plane] = v[0].z;
  p[3 * plane] = v[0].w;
  p[4 * plane] = v[1].x;
  p[5 * plane] = v[1].y;
  p[6 * plane] = v[1].z;
  p[7 * plane] = v[1].w;
}

// Grid: x = tile of lanes, y = tile of steps, z = window.
template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
    scan_layout_kernel(const int* __restrict__ perm,
                       const int4* __restrict__ rows,
                       const uint8_t* __restrict__ negm,
                       int* __restrict__ sgx, int* __restrict__ sgy,
                       long long n_pad, int steps, int lanes) {
  constexpr int kRowVecs = kSigned ? 6 : 4;  // int4s a row: 24 or 16 words
  __shared__ int tile[kTileSteps][kTileLanes + 1];
  const long long g = blockIdx.z;
  const int l0 = blockIdx.x * kTileLanes;
  const int k0 = blockIdx.y * kTileSteps;
  const int* wperm = perm + g * n_pad;

  for (int i = threadIdx.x; i < kTileLanes * kTileSteps; i += kThreads) {
    const int li = i / kTileSteps, ki = i % kTileSteps;
    const int l = l0 + li, k = k0 + ki;
    int src = -1;
    if (l < lanes && k < steps) {
      const int s = __ldg(wperm + (long long)l * steps + k);
      if (s >= 0 && s < n_pad) src = s;
    }
    tile[ki][li] = src;
  }
  __syncthreads();

  const int lane = threadIdx.x % kTileLanes;
  const int warp = threadIdx.x / kTileLanes;
  int src[kColumns];
  int yo[kColumns];  // the int4 of the column's y half-row: 2, or 4 for -y
#pragma unroll
  for (int j = 0; j < kColumns; ++j) {
    src[j] = tile[warp + j * kWarps][lane];
    yo[j] = 2;
    if (kSigned && src[j] >= 0 && __ldg(negm + g * n_pad + src[j])) yo[j] = 4;
  }
  int4 x[kColumns][2], y[kColumns][2];
#pragma unroll
  for (int j = 0; j < kColumns; ++j) {
    x[j][0] = x[j][1] = y[j][0] = y[j][1] = make_int4(0, 0, 0, 0);
    if (src[j] >= 0) {
      const int4* r = rows + (size_t)src[j] * kRowVecs;
      x[j][0] = __ldg(r);
      x[j][1] = __ldg(r + 1);
      y[j][0] = __ldg(r + yo[j]);
      y[j][1] = __ldg(r + yo[j] + 1);
    }
  }

  const int l = l0 + lane;
  const size_t plane = (size_t)steps * lanes;
#pragma unroll
  for (int j = 0; j < kColumns; ++j) {
    const int k = k0 + warp + j * kWarps;
    if (l < lanes && k < steps) {
      const size_t at = ((size_t)g * 8 * steps + k) * lanes + l;
      store8(sgx + at, plane, x[j]);
      store8(sgy + at, plane, y[j]);
    }
  }
}

}  // namespace

// rows holds 24 words a point where negm is given, else 16.
extern "C" int tpu_msm_scan_layout(const int* perm, const int* rows,
                                   const uint8_t* negm, int* sgx, int* sgy,
                                   int windows, long long n_pad, int lanes,
                                   void* stream) {
  if (windows <= 0 || lanes <= 0 || n_pad <= 0 || n_pad % lanes ||
      n_pad > INT_MAX || reinterpret_cast<uintptr_t>(rows) % sizeof(int4))
    return (int)cudaErrorInvalidValue;
  const long long steps = n_pad / lanes;
  const dim3 grid((unsigned)((lanes + kTileLanes - 1) / kTileLanes),
                  (unsigned)((steps + kTileSteps - 1) / kTileSteps),
                  (unsigned)windows);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const int4* table = reinterpret_cast<const int4*>(rows);
  const cudaStream_t s = (cudaStream_t)stream;
  if (negm != nullptr)
    scan_layout_kernel<true><<<grid, kThreads, 0, s>>>(
        perm, table, negm, sgx, sgy, n_pad, (int)steps, lanes);
  else
    scan_layout_kernel<false><<<grid, kThreads, 0, s>>>(
        perm, table, negm, sgx, sgy, n_pad, (int)steps, lanes);
  return (int)cudaGetLastError();
}
