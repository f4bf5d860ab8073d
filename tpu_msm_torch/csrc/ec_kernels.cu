// EC kernels for Hopper (sm_90a), one thread per lane or element, or one
// group of eight lanes per dependent chain of adds.
//
// Replace the Pallas TPU kernels of tpu_msm/ops/pallas_curve.py:
//   tpu_msm_scan_madd       <- scan_madd_packed_u16_f15d (and its aliases
//                              scan_madd_packed_u16, _u16_f15, _u16_mxu)
//   tpu_msm_padd,           <- padd_packed
//   tpu_msm_padd_group
//   tpu_msm_window_tail     <- padd_packed, as tpu_msm/ops/pippenger.py
//                              calls it for M·X(n) - sum X(s_b)
//   tpu_msm_horner          <- padd_packed, as pippenger.horner_fold calls
//                              it (curve.proj_double is proj_add(p, p))
//   tpu_msm_fold_add,       <- fold_add_packed
//   tpu_msm_fold_add_group
//   tpu_msm_pmadd,          <- pmadd_packed
//   tpu_msm_pmadd_group
//   tpu_msm_jac_madd        <- madd_packed
//   tpu_msm_jac_add         <- add_packed
//   tpu_msm_scan_madd_rows  <- scan_madd_packed
//   tpu_msm_scan_madd_sorted <- scan_madd_packed_u16_f15d with the sort
//                              stage's layout before it (no pallas_call:
//                              tpu_msm/ops/pippenger.py:271-307,
//                              `_sorted_scan_inputs`); the main path's scan
//
// What bounds them on the card: the integer multiply pipe. A Montgomery
// product (bn254.cuh, on PTX carry chains) is 128 wide 32x32->64 products
// and 8 low ones, 264 issue slots of the pipe (a wide IMAD takes two), and
// a mixed add is 11 products, against 256 bytes moved per scan step and
// lane. So the design keeps every intermediate in registers and reads each
// operand once: the TPU grid's sequential step axis becomes a loop inside
// the thread, and the accumulator (24 words) never leaves registers. Lanes are contiguous in memory, so each
// warp's loads and stores of one limb row coalesce into 128-byte lines.
//
// The scan. Each thread runs a dependent chain of mixed adds whose CIOS
// carry chains (bn254.cuh) stall it between instructions, so the
// multipliers stay fed only with several warps on each SM scheduler. One
// window at the tuned 8192 lanes is 64 blocks of 128 threads: 68 of the 132
// SMs idle and one warp per scheduler on the rest. So the grid spans a group
// of G windows (blockIdx.y, G derived in ops/pippenger.py from the card's
// memory; all 16 at 2^20): 1024 blocks, two waves over every SM, and
// __launch_bounds__(kThreads, kScanMinBlocks) keeps the registers low
// enough for kScanMinBlocks blocks on each SM. The step's eleven products
// call one out-of-line copy of the product (fp_mont_mul_outlined): eleven
// inlined copies outgrow the instruction caches and take more registers.
// ptxas for sm_90a (CUDA 12.8): 116 registers, no spills, no stack, so 4
// blocks (16 warps, 4 a scheduler) an SM. The other mixed-add kernels
// (pmadd, scan_madd_rows) call the same copy and gain as well.
//
// The serial tail: M·X(n) - sum X(s_b) per window (window_tail) and the
// Horner fold of the window sums (horner) are chains of 16-31 and
// (W - 1)(c + 1) dependent complete adds, 286 at the main path's c = 16
// unsigned. As one padd launch per add, each add cost a host-side launch
// and one thread's twelve products in sequence. Here each chain is one
// launch, and each add is proj_add_group: eight lanes share its twelve
// products, six at a time, so an add waits on two products and on the
// linear steps between them. The chains are bound by that latency (one
// product's is measured by montmul_chain on one lane), not by the card's
// throughput; on the H100 an add takes about 3.6 product latencies (4.4
// with the product on a 64-bit accumulator, before the carry chains).
//
// padd and fold_add (the sides stage's reduction: the lane-carry scan, the
// query adds, the rolled tree and the fold). Each computes proj_add, and
// what bounds it depends on the width.
// - Widths that fill the card (the query adds at W·(m + 1) = 1,048,576
//   elements, the lane scan at W·lanes = 131,072): the multiplies, read
//   once and written once per element (384 bytes of u16 rows in, 192 out,
//   against twelve products). One thread an element (padd_kernel,
//   fold_add_kernel), the twelve products through fp_mont_mul_outlined as
//   in the scan, __launch_bounds__(kThreads, kAddMinBlocks). ptxas for
//   sm_90a (CUDA 12.8): padd_kernel 120 registers, fold_add_kernel 118
//   (144 and 142 with the products inline), no spills or stack, so 4
//   blocks (16 warps) an SM, not 3. (jac_add_kernel 168 and jac_madd_kernel
//   127 registers, no spills: they inline fp_mont_mul.)
// - Widths that leave the card short of warps (the rolled tree at
//   W·fanout = 16,384 elements, the fold's 16,384 chains of 64 adds: 128
//   blocks, one warp a scheduler): latency. One thread an element takes
//   about 9 µs an add at any width up to there. The group kernels
//   (padd_group_kernel, fold_add_group_kernel, and pmadd_group_kernel for
//   the mixed add) give each element to eight lanes calling
//   proj_add_group (proj_madd_group): eight times the warps, and a chain waits
//   on two products an add, not twelve, but every lane repeats the linear
//   steps, the selects and the exchanges, about 2.2 times the instructions
//   of one thread an element. So the group kernels win only well below a
//   full card: cuda_curve.kernel_path takes them below GROUP_BELOW_PER_SM
//   (80) elements an SM, near the crossover measured for all three (83-89
//   elements an SM, about 11,000-11,800 on 132 SMs). The main path's
//   widths all lie above it, and so does the per-window route's scan step
//   (pmadd at 16,384 lanes); that route's rolled tree (2048) and fold (2048
//   lanes) lie below.
// - The group kernels' loads: rank r loads word r of each coordinate (two
//   limb rows) and the group exchanges the words by __shfl_sync, six loads
//   a lane for a point, not 48; rank r stores word r. Against every lane
//   loading the whole point, this took both group kernels 10-25 % faster,
//   and the fold's prefetch of the next step's operand to three registers,
//   which ended fold_add_group_kernel's 60-byte spill (128 -> 113
//   registers then; 97 now, padd_group_kernel 92, pmadd_group_kernel
//   122).
// - Two or three products interleaved in one out-of-line call (more
//   independent work for the latency-bound widths) did not help: the fold
//   at 16,384 lanes 1-4 % faster, the lane scan at 131,072 2-5 % slower.
//
// pmadd, jac_madd and jac_add read their operands once and write the sum
// once, 11-20 products an element, bound by the multiplies once N fills
// the card. At the per-window path's 16384 lanes a pmadd_kernel launch is
// 128 blocks, one warp a scheduler, and waits on its eleven products in
// sequence; the group kernel waits on two levels of them (five, then six)
// but repeats the linear steps on eight lanes, and loses there on the H100
// (PERF.md §6). The Jacobian adders compute their doubling fallback
// only on the lanes that take it (P == Q), a rare divergent branch, where
// the TPU kernels computed it on every lane and selected.
//
// scan_madd_rows has no window axis to spread over, and its 4096 lanes at
// (16, 256, 4096) as one thread a lane filled 32 of the 132 SMs with one
// warp a scheduler, each step's eleven products in series. So it is a
// reduce-then-scan over K chunks of the step axis (K from
// cuda_curve.scan_rows_chunks: the least that fills the card), three
// launches from one C entry:
// 1. scan_madd_rows_totals_kernel: thread (lane, k) sums chunk k's points,
//    k = 0 .. K-2, reading them once and storing only the total;
// 2. scan_madd_rows_prefix_kernel: each lane's K - 2 dependent adds that
//    turn the totals into running sums, eight lanes an add (proj_add_group)
//    as fold_add_group_kernel runs its chain: `lanes` chains leave the card
//    short of warps;
// 3. scan_madd_rows_kernel: thread (lane, k) starts from the sum of the
//    chunks before k and runs chunk k, storing every running sum.
// Chunk 0 is the serial scan's bits, later chunks the same points in other
// projective coordinates; K = 1 is phase 3 alone, the serial scan. The
// redesign does the mixed adds twice (phases 1 and 3) for K times the
// threads.
//
// The kernels allocate nothing and do not synchronise. Each C entry launches
// on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "bn254.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 128;
constexpr int kScanMinBlocks = 4;
constexpr int kAddMinBlocks = 4;
constexpr int kGroupMinBlocks = 4;
// The tail kernels' blocks: one warp's first kAddGroup lanes.
constexpr unsigned kGroupMask = (1u << kAddGroup) - 1u;
// The group kernels' blocks: kThreads / kAddGroup groups, whole warps.
constexpr unsigned kWarpMask = 0xffffffffu;

// Inclusive per-lane prefix sum over the step axis by complete mixed add,
// for a group of windows. gx, gy: (G, 8, steps, lanes) packed affine words,
// (0, 0) = infinity. out: (G, 48, steps, lanes) canonical u16 rows
// X || Y || Z of the running sums. blockIdx.y is the window.
__global__ void __launch_bounds__(kThreads, kScanMinBlocks)
    scan_madd_kernel(const uint32_t* __restrict__ gx,
                     const uint32_t* __restrict__ gy,
                     uint32_t* __restrict__ out, int steps, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t plane = (size_t)steps * lanes;
  gx += blockIdx.y * 8 * plane;
  gy += blockIdx.y * 8 * plane;
  out += blockIdx.y * 48 * plane;
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

// The sorted scan (scan_madd_sorted_kernel): scan_madd_kernel's per-lane
// prefix sum, each step's operand read from the point-major table in sort
// order, so that the sort stage's layout (csrc/layout.cu) is never written.
// Grid, launch bounds, step body and output as scan_madd_kernel; lane l of
// window g (blockIdx.y) takes at step k the point src = perm[g, l * steps
// + k], its x half-row rows[src, 0:8] and its y half-row rows[src, 8:16],
// or -y, rows[src, 16:24], where negm[g, src]; an index outside [0, n_pad)
// is the (0, 0) infinity and reads nothing.
//
// Each step's operand is 64 bytes of a random row of the table (64 or 96
// MiB at 2^20, past the 50 MB L2): about a microsecond of latency against
// a step of about 15 us of mixed add. The scan has no registers to spare
// for operands in flight (116 of the 128 that kScanMinBlocks allows), so
// they go to shared memory: each thread keeps kSortedDepth steps in flight
// in its own slots of a ring, each step four 16-byte cp.async copies (the
// two aligned 32-byte sectors of its half-rows; zero-filled, with no read,
// for an index outside the table) and one commit group, and waits for the
// oldest group before its step reads the slot. The ring is laid out
// [step][int4][thread], so that a warp's copies and reads of one int4 touch
// 512 consecutive bytes, without bank conflicts: 32 KiB a block at depth 4.
// A thread reads only the slots it filled, so no barrier is needed. The
// permutation (8 bytes a step, a lane's steps consecutive) is read one step
// ahead of the copies into registers, the negation byte (1 MiB a window,
// L2-resident) once the index is known, after the step's add. ptxas for
// sm_90a (CUDA 12.8): 122 registers (120 with signed digits), 32768 bytes
// of shared memory, no spills or stack, so 4 blocks an SM as the scan. On
// the H100 it runs at scan_madd_kernel's own speed on the same shapes, about
// 0.8 of the time of scan_layout and scan_madd_kernel together (PERF.md §6).
constexpr int kSortedDepth = 4;
constexpr int kStepVecs = 4;  // int4s a step: the x and the y half-row

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's commit groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <bool kSigned>
__global__ void __launch_bounds__(kThreads, kScanMinBlocks)
    scan_madd_sorted_kernel(const long long* __restrict__ perm,
                            const int4* __restrict__ rows,
                            const uint8_t* __restrict__ negm,
                            uint32_t* __restrict__ out, long long n_pad,
                            int steps, int lanes) {
  constexpr int kRowVecs = kSigned ? 6 : 4;  // int4s a row: 24 or 16 words
  __shared__ int4 ring[kSortedDepth][kStepVecs][kThreads];
  const int t = threadIdx.x;
  const int lane = blockIdx.x * kThreads + t;
  if (lane >= lanes) return;
  const size_t plane = (size_t)steps * lanes;
  const long long* lperm = perm + blockIdx.y * n_pad + (long long)lane * steps;
  const uint8_t* wneg = kSigned ? negm + blockIdx.y * n_pad : nullptr;
  out += blockIdx.y * 48 * plane;

  // Step k's row of the table, or -1: past the last step, or outside it.
  const auto point = [&](long long s) -> int {
    return s >= 0 && s < n_pad ? (int)s : -1;
  };
  const auto index = [&](int k) -> long long {
    return k < steps ? __ldg(lperm + k) : -1;
  };
  // The int4 of the row where the step's y (2) or -y (4) half-row starts.
  const auto y_vec = [&](int src) -> int {
    if constexpr (kSigned) return src >= 0 && __ldg(wneg + src) ? 4 : 2;
    return 2;
  };
  const auto fetch = [&](int slot, int src, int yv) {
    const int4* r = rows + (size_t)(src < 0 ? 0 : src) * kRowVecs;
    const int bytes = src < 0 ? 0 : 16;
    cp_async_16(&ring[slot][0][t], r, bytes);
    cp_async_16(&ring[slot][1][t], r + 1, bytes);
    cp_async_16(&ring[slot][2][t], r + yv, bytes);
    cp_async_16(&ring[slot][3][t], r + yv + 1, bytes);
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < kSortedDepth - 1; ++k) {
    const int src = point(index(k));
    fetch(k, src, y_vec(src));
  }
  int next = point(index(kSortedDepth - 1));
  int next_y = y_vec(next);
  Proj acc = proj_infinity();
  for (int k = 0; k < steps; ++k) {
    // Step k + depth - 1 into the slot step k - 1 read (a group is
    // committed every step, empty of reads past the last one).
    fetch((k + kSortedDepth - 1) % kSortedDepth, next, next_y);
    const long long ahead = index(k + kSortedDepth);
    cp_async_wait<kSortedDepth - 1>();  // step k's group has landed
    const int slot = k % kSortedDepth;
    const int4 v0 = ring[slot][0][t], v1 = ring[slot][1][t];
    const int4 v2 = ring[slot][2][t], v3 = ring[slot][3][t];
    const Fp qx = {{(uint32_t)v0.x, (uint32_t)v0.y, (uint32_t)v0.z,
                    (uint32_t)v0.w, (uint32_t)v1.x, (uint32_t)v1.y,
                    (uint32_t)v1.z, (uint32_t)v1.w}};
    const Fp qy = {{(uint32_t)v2.x, (uint32_t)v2.y, (uint32_t)v2.z,
                    (uint32_t)v2.w, (uint32_t)v3.x, (uint32_t)v3.y,
                    (uint32_t)v3.z, (uint32_t)v3.w}};
    acc = proj_madd_complete(acc, qx, qy);
    next = point(ahead);
    next_y = y_vec(next);
    const size_t off = (size_t)k * lanes + lane;
    store_u16_rows(out, plane, off, acc.x);
    store_u16_rows(out + 16 * plane, plane, off, acc.y);
    store_u16_rows(out + 32 * plane, plane, off, acc.z);
  }
  cp_async_wait<0>();
}

// Element i of three (16, stride) u16-row coordinate arrays.
__device__ __forceinline__ Proj load_proj(const uint32_t* __restrict__ x,
                                          const uint32_t* __restrict__ y,
                                          const uint32_t* __restrict__ z,
                                          size_t stride, size_t i) {
  Proj p;
  p.x = load_u16_rows(x, stride, i);
  p.y = load_u16_rows(y, stride, i);
  p.z = load_u16_rows(z, stride, i);
  return p;
}

// Elementwise complete projective add of (16, n) u16-row operands, one
// thread an element: the path for widths that fill the card.
__global__ void __launch_bounds__(kThreads, kAddMinBlocks)
    padd_kernel(const uint32_t* __restrict__ ax, const uint32_t* __restrict__ ay,
                const uint32_t* __restrict__ az, const uint32_t* __restrict__ bx,
                const uint32_t* __restrict__ by, const uint32_t* __restrict__ bz,
                uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                uint32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Proj r =
      proj_add(load_proj(ax, ay, az, n, i), load_proj(bx, by, bz, n, i));
  store_u16_rows(ox, n, i, r.x);
  store_u16_rows(oy, n, i, r.y);
  store_u16_rows(oz, n, i, r.z);
}

// Word `rank` of each coordinate of element i, as load_proj reads them.
struct Words3 {
  uint32_t x, y, z;
};

__device__ __forceinline__ Words3 load_words(const uint32_t* __restrict__ x,
                                             const uint32_t* __restrict__ y,
                                             const uint32_t* __restrict__ z,
                                             size_t stride, size_t i,
                                             int rank) {
  return {load_u16_word(x, stride, i, rank), load_u16_word(y, stride, i, rank),
          load_u16_word(z, stride, i, rank)};
}

// The point whose words the group's lanes hold (load_words), on every lane.
__device__ __forceinline__ Proj proj_from_group_words(const Words3& w) {
  Proj p;
  p.x = fp_from_group_words(kWarpMask, w.x);
  p.y = fp_from_group_words(kWarpMask, w.y);
  p.z = fp_from_group_words(kWarpMask, w.z);
  return p;
}

// The same add, one group of kAddGroup lanes an element (proj_add_group):
// the path for widths that leave the card short of warps. Rank r loads and
// stores word r of each coordinate (six loads a lane, and one load of a
// warp reads eight rows of four neighbouring elements); the group exchanges
// the loaded words. The spare groups of a ragged last block add element
// n - 1 again and store nothing, so every lane of a warp takes part in the
// exchanges.
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks)
    padd_group_kernel(const uint32_t* __restrict__ ax,
                      const uint32_t* __restrict__ ay,
                      const uint32_t* __restrict__ az,
                      const uint32_t* __restrict__ bx,
                      const uint32_t* __restrict__ by,
                      const uint32_t* __restrict__ bz,
                      uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                      uint32_t* __restrict__ oz, long long n) {
  const long long e =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kAddGroup;
  const int rank = threadIdx.x % kAddGroup;
  const long long i = e < n ? e : n - 1;
  const Words3 wa = load_words(ax, ay, az, n, i, rank);
  const Words3 wb = load_words(bx, by, bz, n, i, rank);
  const Proj r = proj_add_group(proj_from_group_words(wa),
                                proj_from_group_words(wb), rank, kWarpMask);
  if (e >= n) return;
  store_u16_rows_rank(ox, n, i, r.x, rank);
  store_u16_rows_rank(oy, n, i, r.y, rank);
  store_u16_rows_rank(oz, n, i, r.z, rank);
}

// Window sums M·X(n) - sum X(s_b) from (16, W) u16 rows of X(n) (nx, ny, nz)
// and of sum X(s_b) (sx, sy, sz), one window per block of kAddGroup lanes.
// M·X(n) is 2^(c-1)·X(n) by c - 1 doublings (signed digits) or
// (2^c - 1)·X(n) by c - 1 rounds of acc = 2·acc + X(n) (unsigned), each
// doubling the complete add of a point to itself.
__global__ void __launch_bounds__(kAddGroup)
    window_tail_kernel(const uint32_t* __restrict__ nx,
                       const uint32_t* __restrict__ ny,
                       const uint32_t* __restrict__ nz,
                       const uint32_t* __restrict__ sx,
                       const uint32_t* __restrict__ sy,
                       const uint32_t* __restrict__ sz,
                       uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                       uint32_t* __restrict__ oz, int w, int c,
                       int signed_digits) {
  const int win = blockIdx.x;
  const int rank = threadIdx.x;
  Proj xn;
  xn.x = load_u16_rows(nx, w, win);
  xn.y = load_u16_rows(ny, w, win);
  xn.z = load_u16_rows(nz, w, win);
  Proj acc = xn;
  for (int k = 1; k < c; ++k) {
    acc = proj_add_group(acc, acc, rank, kGroupMask);
    if (!signed_digits) acc = proj_add_group(acc, xn, rank, kGroupMask);
  }
  Proj neg;  // -sum X(s_b) = (X : -Y : Z), with -0 = 0
  neg.x = load_u16_rows(sx, w, win);
  neg.y = fp_sub(fp_zero(), load_u16_rows(sy, w, win));
  neg.z = load_u16_rows(sz, w, win);
  acc = proj_add_group(acc, neg, rank, kGroupMask);
  if (rank == 0) {
    store_u16_rows(ox, w, win, acc.x);
    store_u16_rows(oy, w, win, acc.y);
    store_u16_rows(oz, w, win, acc.z);
  }
}

// The Horner fold of (W, 16, 1) window sums into the (16, 1) MSM result:
// from the top window down, c doublings, then the next window's sum; one
// block of kAddGroup lanes.
__global__ void __launch_bounds__(kAddGroup)
    horner_kernel(const uint32_t* __restrict__ wx,
                  const uint32_t* __restrict__ wy,
                  const uint32_t* __restrict__ wz, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int w,
                  int c) {
  const int rank = threadIdx.x;
  Proj acc;
  acc.x = load_u16_rows(wx + 16 * (w - 1), 1, 0);
  acc.y = load_u16_rows(wy + 16 * (w - 1), 1, 0);
  acc.z = load_u16_rows(wz + 16 * (w - 1), 1, 0);
  for (int win = w - 2; win >= 0; --win) {
    for (int k = 0; k < c; ++k)
      acc = proj_add_group(acc, acc, rank, kGroupMask);
    Proj s;
    s.x = load_u16_rows(wx + 16 * win, 1, 0);
    s.y = load_u16_rows(wy + 16 * win, 1, 0);
    s.z = load_u16_rows(wz + 16 * win, 1, 0);
    acc = proj_add_group(acc, s, rank, kGroupMask);
  }
  if (rank == 0) {
    store_u16_rows(ox, 1, 0, acc.x);
    store_u16_rows(oy, 1, 0, acc.y);
    store_u16_rows(oz, 1, 0, acc.z);
  }
}

// Per-lane EC sum over the step axis: (16, steps, lanes) -> (16, lanes),
// accumulator starting at infinity, steps added in order. One thread a lane:
// the path for lane counts that fill the card.
__global__ void __launch_bounds__(kThreads, kAddMinBlocks)
    fold_add_kernel(const uint32_t* __restrict__ bx,
                    const uint32_t* __restrict__ by,
                    const uint32_t* __restrict__ bz, uint32_t* __restrict__ ox,
                    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                    int steps, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t plane = (size_t)steps * lanes;
  Proj acc = proj_infinity();
  for (int k = 0; k < steps; ++k)
    acc = proj_add(acc, load_proj(bx, by, bz, plane, (size_t)k * lanes + lane));
  store_u16_rows(ox, lanes, lane, acc.x);
  store_u16_rows(oy, lanes, lane, acc.y);
  store_u16_rows(oz, lanes, lane, acc.z);
}

// The same sum, one group of kAddGroup lanes a lane's chain
// (proj_add_group), loads and stores as in padd_group_kernel: the path for
// lane counts that leave the card short of warps. The next step's words
// (three registers a lane) are loaded before this step's add, so that
// their latency hides behind the add.
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks)
    fold_add_group_kernel(const uint32_t* __restrict__ bx,
                          const uint32_t* __restrict__ by,
                          const uint32_t* __restrict__ bz,
                          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                          uint32_t* __restrict__ oz, int steps, int lanes) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kAddGroup;
  const int rank = threadIdx.x % kAddGroup;
  const int lane = g < lanes ? g : lanes - 1;
  const size_t plane = (size_t)steps * lanes;
  Proj acc = proj_infinity();
  Words3 w = load_words(bx, by, bz, plane, lane, rank);
  for (int k = 0; k < steps; ++k) {
    const int next = k + 1 < steps ? k + 1 : k;
    const Words3 nw =
        load_words(bx, by, bz, plane, (size_t)next * lanes + lane, rank);
    acc = proj_add_group(acc, proj_from_group_words(w), rank, kWarpMask);
    w = nw;
  }
  if (g >= lanes) return;
  store_u16_rows_rank(ox, lanes, lane, acc.x, rank);
  store_u16_rows_rank(oy, lanes, lane, acc.y, rank);
  store_u16_rows_rank(oz, lanes, lane, acc.z, rank);
}

// scan_madd_rows: the prefix scan of scan_madd_kernel on unpacked (16, steps,
// lanes) u16-row affine inputs, with X, Y and Z as three (16, steps, lanes)
// outputs, as a reduce-then-scan over K chunks of the step axis (see the
// note at the top). The steps split into chunks of len = ceil(steps / K);
// chunks 0 .. K-2 are whole, the last may be shorter. `sums` is (K - 1, 48,
// lanes) u16 rows X || Y || Z: phase 1 writes chunk k's total to slot k,
// phase 2 turns slot k into the sum of totals 0 .. k, the prefix of chunk
// k + 1, and phase 3 reads it.

// Slot k of `sums`: its X rows; Y and Z follow at 16 and 32 rows.
template <typename Word>
__device__ __forceinline__ Word* sums_slot(Word* sums, int k, int lanes) {
  return sums + (size_t)k * 48 * lanes;
}

// Phase 1: thread (lane, k) sums chunk k's points from infinity and stores
// only the total. blockIdx.y is k, 0 .. K - 2.
__global__ void __launch_bounds__(kThreads, kScanMinBlocks)
    scan_madd_rows_totals_kernel(const uint32_t* __restrict__ gx,
                                 const uint32_t* __restrict__ gy,
                                 uint32_t* __restrict__ sums, int steps,
                                 int lanes, int len) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t plane = (size_t)steps * lanes;
  const int begin = blockIdx.y * len;
  Proj acc = proj_infinity();
  for (int k = begin; k < begin + len; ++k) {
    const size_t off = (size_t)k * lanes + lane;
    acc = proj_madd_complete(acc, load_u16_rows(gx, plane, off),
                             load_u16_rows(gy, plane, off));
  }
  uint32_t* slot = sums_slot(sums, blockIdx.y, lanes);
  store_u16_rows(slot, lanes, lane, acc.x);
  store_u16_rows(slot + 16 * lanes, lanes, lane, acc.y);
  store_u16_rows(slot + 32 * lanes, lanes, lane, acc.z);
}

// Phase 2: the running sums of the `totals` chunk totals of each lane, in
// place (slot k becomes slot 0 + ... + slot k), one group of kAddGroup
// lanes a lane's chain over proj_add_group, loads, prefetch and stores as
// in fold_add_group_kernel. Each slot is read by the lanes that later
// overwrite it, one add before. The spare groups of a ragged last block
// run lane lanes - 1 again and store nothing.
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks)
    scan_madd_rows_prefix_kernel(uint32_t* __restrict__ sums, int totals,
                                 int lanes) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kAddGroup;
  const int rank = threadIdx.x % kAddGroup;
  const int lane = g < lanes ? g : lanes - 1;
  const auto words = [&](int k) {
    const uint32_t* slot = sums_slot(sums, k, lanes);
    return load_words(slot, slot + 16 * lanes, slot + 32 * lanes, lanes,
                      lane, rank);
  };
  Proj acc = proj_from_group_words(words(0));
  Words3 w = words(1);
  for (int k = 1; k < totals; ++k) {
    const Words3 nw = words(k + 1 < totals ? k + 1 : k);
    acc = proj_add_group(acc, proj_from_group_words(w), rank, kWarpMask);
    w = nw;
    if (g < lanes) {
      uint32_t* slot = sums_slot(sums, k, lanes);
      store_u16_rows_rank(slot, lanes, lane, acc.x, rank);
      store_u16_rows_rank(slot + 16 * lanes, lanes, lane, acc.y, rank);
      store_u16_rows_rank(slot + 32 * lanes, lanes, lane, acc.z, rank);
    }
  }
}

// Phase 3: thread (lane, k) starts from chunk k's prefix (slot k - 1 of
// `sums`; infinity for chunk 0), runs the chunk's steps and stores every
// running sum. blockIdx.y is k, 0 .. K - 1. With K = 1 this is the whole
// serial scan.
__global__ void __launch_bounds__(kThreads, kScanMinBlocks)
    scan_madd_rows_kernel(const uint32_t* __restrict__ gx,
                          const uint32_t* __restrict__ gy,
                          const uint32_t* __restrict__ sums,
                          uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                          uint32_t* __restrict__ oz, int steps, int lanes,
                          int len) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t plane = (size_t)steps * lanes;
  const int begin = blockIdx.y * len;
  const int end = begin + len < steps ? begin + len : steps;
  Proj acc = proj_infinity();
  if (blockIdx.y > 0) {
    const uint32_t* slot = sums_slot(sums, blockIdx.y - 1, lanes);
    acc = load_proj(slot, slot + 16 * lanes, slot + 32 * lanes, lanes, lane);
  }
  for (int k = begin; k < end; ++k) {
    const size_t off = (size_t)k * lanes + lane;
    acc = proj_madd_complete(acc, load_u16_rows(gx, plane, off),
                             load_u16_rows(gy, plane, off));
    store_u16_rows(ox, plane, off, acc.x);
    store_u16_rows(oy, plane, off, acc.y);
    store_u16_rows(oz, plane, off, acc.z);
  }
}

// Elementwise projective + affine mixed add of (16, n) u16-row operands,
// one thread an element: the path for widths that fill the card.
__global__ void __launch_bounds__(kThreads)
    pmadd_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                 const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                 const uint32_t* __restrict__ qy, uint32_t* __restrict__ ox,
                 uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Proj r = proj_madd_complete(load_proj(px, py, pz, n, i),
                                    load_u16_rows(qx, n, i),
                                    load_u16_rows(qy, n, i));
  store_u16_rows(ox, n, i, r.x);
  store_u16_rows(oy, n, i, r.y);
  store_u16_rows(oz, n, i, r.z);
}

// The same add, one group of kAddGroup lanes an element (proj_madd_group):
// the path for widths that leave the card short of warps. Loads and stores
// as in padd_group_kernel: rank r loads word r of P's three coordinates and
// of Q's two (five loads a lane) and stores word r of each coordinate of
// the sum; the spare groups of a ragged last block add element n - 1 again
// and store nothing.
__global__ void __launch_bounds__(kThreads, kGroupMinBlocks)
    pmadd_group_kernel(const uint32_t* __restrict__ px,
                       const uint32_t* __restrict__ py,
                       const uint32_t* __restrict__ pz,
                       const uint32_t* __restrict__ qx,
                       const uint32_t* __restrict__ qy,
                       uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                       uint32_t* __restrict__ oz, long long n) {
  const long long e =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kAddGroup;
  const int rank = threadIdx.x % kAddGroup;
  const long long i = e < n ? e : n - 1;
  const Words3 wp = load_words(px, py, pz, n, i, rank);
  const uint32_t wx = load_u16_word(qx, n, i, rank);
  const uint32_t wy = load_u16_word(qy, n, i, rank);
  const Proj r = proj_madd_group(proj_from_group_words(wp),
                                 fp_from_group_words(kWarpMask, wx),
                                 fp_from_group_words(kWarpMask, wy), rank,
                                 kWarpMask);
  if (e >= n) return;
  store_u16_rows_rank(ox, n, i, r.x, rank);
  store_u16_rows_rank(oy, n, i, r.y, rank);
  store_u16_rows_rank(oz, n, i, r.z, rank);
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

// Blocks for n elements at kAddGroup lanes an element.
unsigned group_blocks_for(long long n) { return blocks_for(n * kAddGroup); }

}  // namespace

extern "C" {

int tpu_msm_scan_madd(const uint32_t* gx, const uint32_t* gy, uint32_t* out,
                      int windows, int steps, int lanes, void* stream) {
  const dim3 grid(blocks_for(lanes), (unsigned)windows);
  scan_madd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(gx, gy, out,
                                                                steps, lanes);
  return (int)cudaGetLastError();
}

// rows: (n_pad, 24) words [x | y | -y] where negm is given, else (n_pad,
// 16) [x | y], 16-byte aligned; perm and negm: (windows, n_pad); out:
// (windows, 48, n_pad / lanes, lanes).
int tpu_msm_scan_madd_sorted(const long long* perm, const int* rows,
                             const uint8_t* negm, uint32_t* out, int windows,
                             long long n_pad, int lanes, void* stream) {
  if (windows <= 0 || windows > 65535 || lanes <= 0 || n_pad <= 0 ||
      n_pad % lanes || n_pad > INT_MAX ||
      reinterpret_cast<uintptr_t>(rows) % sizeof(int4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for(lanes), (unsigned)windows);
  const int steps = (int)(n_pad / lanes);
  const int4* table = reinterpret_cast<const int4*>(rows);
  const cudaStream_t s = (cudaStream_t)stream;
  if (negm != nullptr)
    scan_madd_sorted_kernel<true><<<grid, kThreads, 0, s>>>(
        perm, table, negm, out, n_pad, steps, lanes);
  else
    scan_madd_sorted_kernel<false><<<grid, kThreads, 0, s>>>(
        perm, table, negm, out, n_pad, steps, lanes);
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

int tpu_msm_padd_group(const uint32_t* ax, const uint32_t* ay,
                       const uint32_t* az, const uint32_t* bx,
                       const uint32_t* by, const uint32_t* bz, uint32_t* ox,
                       uint32_t* oy, uint32_t* oz, long long n, void* stream) {
  padd_group_kernel<<<group_blocks_for(n), kThreads, 0,
                      (cudaStream_t)stream>>>(ax, ay, az, bx, by, bz, ox, oy,
                                              oz, n);
  return (int)cudaGetLastError();
}

int tpu_msm_window_tail(const uint32_t* nx, const uint32_t* ny,
                        const uint32_t* nz, const uint32_t* sx,
                        const uint32_t* sy, const uint32_t* sz, uint32_t* ox,
                        uint32_t* oy, uint32_t* oz, int w, int c,
                        int signed_digits, void* stream) {
  window_tail_kernel<<<(unsigned)w, kAddGroup, 0, (cudaStream_t)stream>>>(
      nx, ny, nz, sx, sy, sz, ox, oy, oz, w, c, signed_digits);
  return (int)cudaGetLastError();
}

int tpu_msm_horner(const uint32_t* wx, const uint32_t* wy, const uint32_t* wz,
                   uint32_t* ox, uint32_t* oy, uint32_t* oz, int w, int c,
                   void* stream) {
  horner_kernel<<<1, kAddGroup, 0, (cudaStream_t)stream>>>(wx, wy, wz, ox, oy,
                                                           oz, w, c);
  return (int)cudaGetLastError();
}

int tpu_msm_fold_add(const uint32_t* bx, const uint32_t* by, const uint32_t* bz,
                     uint32_t* ox, uint32_t* oy, uint32_t* oz, int steps,
                     int lanes, void* stream) {
  fold_add_kernel<<<blocks_for(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      bx, by, bz, ox, oy, oz, steps, lanes);
  return (int)cudaGetLastError();
}

int tpu_msm_fold_add_group(const uint32_t* bx, const uint32_t* by,
                           const uint32_t* bz, uint32_t* ox, uint32_t* oy,
                           uint32_t* oz, int steps, int lanes, void* stream) {
  fold_add_group_kernel<<<group_blocks_for(lanes), kThreads, 0,
                          (cudaStream_t)stream>>>(bx, by, bz, ox, oy, oz,
                                                  steps, lanes);
  return (int)cudaGetLastError();
}

// chunks: K, from cuda_curve.scan_rows_chunks or the caller, with no empty
// chunk (ceil(steps / ceil(steps / K)) == K); sums: (K - 1, 48, lanes)
// scratch. Phases 1 and 2 run only where there is a total to compute and
// a sum to chain.
int tpu_msm_scan_madd_rows(const uint32_t* gx, const uint32_t* gy,
                           uint32_t* ox, uint32_t* oy, uint32_t* oz,
                           uint32_t* sums, int steps, int lanes, int chunks,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int len = (steps + chunks - 1) / chunks;
  if (chunks > 1)
    scan_madd_rows_totals_kernel<<<dim3(blocks_for(lanes), chunks - 1),
                                   kThreads, 0, s>>>(gx, gy, sums, steps,
                                                     lanes, len);
  if (chunks > 2)
    scan_madd_rows_prefix_kernel<<<group_blocks_for(lanes), kThreads, 0, s>>>(
        sums, chunks - 1, lanes);
  scan_madd_rows_kernel<<<dim3(blocks_for(lanes), chunks), kThreads, 0, s>>>(
      gx, gy, sums, ox, oy, oz, steps, lanes, len);
  return (int)cudaGetLastError();
}

int tpu_msm_pmadd(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                  const uint32_t* qx, const uint32_t* qy, uint32_t* ox,
                  uint32_t* oy, uint32_t* oz, long long n, void* stream) {
  pmadd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      px, py, pz, qx, qy, ox, oy, oz, n);
  return (int)cudaGetLastError();
}

int tpu_msm_pmadd_group(const uint32_t* px, const uint32_t* py,
                        const uint32_t* pz, const uint32_t* qx,
                        const uint32_t* qy, uint32_t* ox, uint32_t* oy,
                        uint32_t* oz, long long n, void* stream) {
  pmadd_group_kernel<<<group_blocks_for(n), kThreads, 0,
                       (cudaStream_t)stream>>>(px, py, pz, qx, qy, ox, oy,
                                               oz, n);
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
