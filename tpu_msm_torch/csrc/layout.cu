// The fused route's two layouts for Hopper (sm_90a): the point-major table
// of packed words that the scan reads (`pack_rows_kernel`, at the end of
// this file), and the sort stage's layout (`scan_layout_kernel`): each
// window's points, in the order of its stable digit sort, gathered from
// that table into the scan kernel's lane-major (G, 8, steps, lanes)
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

// ---------------------------------------------------------------------------
// The point-major table of packed words (`ops/cuda_curve.py` `pack_rows`).
//
// Replaces no Pallas kernel: the JAX package builds this table with XLA
// (tpu_msm/ops/pippenger.py:633-636, `pack_u16_rows` at :663, and the
// concatenation and transpose at :292). The port's torch formulation
// (`pack_rows_plain`) widened each limb half to int64 and took some 18
// launches and about 11 bytes moved for each byte of the table.
//
// The function. coords are 2 or 3 (16, n) int32 arrays of u16 limbs: x, y
// and, for signed digits, -y. Row p of the (n_pad, 8 * coords) int32 table
// holds word j of coordinate c at column 8 c + j:
//   rows[p, 8 c + j] = coord_c[2 j, p] | coord_c[2 j + 1, p] << 16
// as a u32 bit pattern, and rows[p, :] = 0 for n <= p < n_pad (the (0, 0)
// point, which the scan skips).
//
// What bounds it: bytes. A point reads 64 bytes a coordinate and writes 32
// a coordinate; at (2, 16, 2^22) that is 805 MB, 0.24 ms at 3.35 TB/s.
//
// The design. A block takes a tile of 256 points, a thread a point:
// - it reads the point's limbs, each limb row coalesced along n (a warp
//   reads 128 contiguous bytes a row), all 32 or 48 loads in flight;
// - it packs the limb pairs into words in registers and stages its row in
//   shared memory, each row padded by one int4, so that the 16-byte stores
//   of eight threads fall on distinct banks;
// - the block then writes the tile's rows, contiguous in the table, as
//   16-byte stores in order, so that a warp writes 512 contiguous bytes.
// One pass over the inputs; the wrapper allocates the table, the kernel
// nothing.

namespace {

constexpr int kPackPoints = 256;  // points a block, a thread a point

template <int kCoords>
__global__ void __launch_bounds__(kPackPoints)
    pack_rows_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                     const int* __restrict__ c2, int4* __restrict__ rows,
                     long long n, long long n_pad) {
  constexpr int kVecs = 2 * kCoords;  // int4s a row: 16 or 24 words
  constexpr int kStaged = kVecs + 1;  // int4s a staged row
  __shared__ int4 tile[kPackPoints * kStaged];
  const long long p0 = (long long)blockIdx.x * kPackPoints;
  const long long p = p0 + threadIdx.x;
  const int* const coords[3] = {c0, c1, c2};

  unsigned limb[kCoords][16];
#pragma unroll
  for (int c = 0; c < kCoords; ++c)
#pragma unroll
    for (int r = 0; r < 16; ++r)
      limb[c][r] = p < n ? (unsigned)__ldg(coords[c] + r * n + p) : 0u;
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const unsigned* l = limb[v / 2] + 8 * (v % 2);
    tile[threadIdx.x * kStaged + v] =
        make_int4((int)(l[0] | l[1] << 16), (int)(l[2] | l[3] << 16),
                  (int)(l[4] | l[5] << 16), (int)(l[6] | l[7] << 16));
  }
  __syncthreads();

  const long long left = n_pad - p0;
  const int vecs = (int)(left < kPackPoints ? left : kPackPoints) * kVecs;
  int4* out = rows + p0 * kVecs;
  for (int i = threadIdx.x; i < vecs; i += kPackPoints)
    out[i] = tile[(i / kVecs) * kStaged + i % kVecs];
}

}  // namespace

// y_neg null: a (n_pad, 16) table of x and y; else (n_pad, 24) with -y.
extern "C" int tpu_msm_pack_rows(const int* x, const int* y,
                                 const int* y_neg, int* rows, long long n,
                                 long long n_pad, void* stream) {
  const long long blocks = (n_pad + kPackPoints - 1) / kPackPoints;
  if (n < 0 || n_pad < n || n_pad <= 0 || blocks > INT_MAX ||
      reinterpret_cast<uintptr_t>(rows) % sizeof(int4))
    return (int)cudaErrorInvalidValue;
  int4* table = reinterpret_cast<int4*>(rows);
  const cudaStream_t s = (cudaStream_t)stream;
  if (y_neg != nullptr)
    pack_rows_kernel<3><<<(unsigned)blocks, kPackPoints, 0, s>>>(
        x, y, y_neg, table, n, n_pad);
  else
    pack_rows_kernel<2><<<(unsigned)blocks, kPackPoints, 0, s>>>(
        x, y, nullptr, table, n, n_pad);
  return (int)cudaGetLastError();
}
