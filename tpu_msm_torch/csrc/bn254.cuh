// BN254 base field and complete projective G1 formulas for one CUDA thread.
//
// One field core for every kernel of the port: 8 x u32 little-endian words,
// CIOS Montgomery multiplication with R = 2^256, every result reduced to the
// canonical range [0, P). The JAX package ran four cores for the TPU
// (pallas_curve.mont_mul on u16 rows, f15.mont_mul_cios on 15-bit rows, the
// DualField pairing and the MXU-REDC core); all compute a*b*2^-256 mod P, and
// canonical outputs of the same formula sequence are bit-identical to each of
// them and to the plain torch field (ops/field.py).
//
// The word layout is the packed wire format of tpu_msm's scan kernel: packed
// row i = limb 2i | limb 2i+1 << 16 is exactly word i.
//
// Constants: P, -P^-1 mod 2^32 and R mod P, derived in
// tpu_msm_torch/models/bn254.py (a CPU test checks these literals).
#pragma once

#include <cstdint>

namespace bn254 {

struct Fp {
  uint32_t w[8];
};

__device__ __constant__ static const uint32_t kP[8] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// -P^-1 mod 2^32
static constexpr uint32_t kPInvNeg = 0xe4866389u;
// R mod P: Montgomery one
__device__ __constant__ static const uint32_t kOneMont[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0u;
  return r;
}

__device__ __forceinline__ Fp fp_one_mont() {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = kOneMont[i];
  return r;
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i];
  return acc == 0u;
}

// t - P if t >= P, else t; t < 2P.
__device__ __forceinline__ Fp fp_cond_sub_p(const Fp& t) {
  Fp d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)t.w[i] - kP[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 32) & 1u;
  }
  return borrow ? t : d;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp s;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a.w[i] + b.w[i] + carry;
    s.w[i] = (uint32_t)v;
    carry = v >> 32;
  }
  // a + b < 2P < 2^255: no carry out of the top word.
  return fp_cond_sub_p(s);
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t v = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 32) & 1u;
  }
  if (borrow) {
    uint64_t carry = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t v = (uint64_t)d.w[i] + kP[i] + carry;
      d.w[i] = (uint32_t)v;
      carry = v >> 32;
    }
  }
  return d;
}

__device__ __forceinline__ Fp fp_dbl(const Fp& a) { return fp_add(a, a); }

// 9a mod P (b3 = 3b = 9 for BN254), the add chain of ec_rows.py.
__device__ __forceinline__ Fp fp_mul9(const Fp& a) {
  return fp_add(fp_dbl(fp_dbl(fp_dbl(a))), a);
}

// CIOS Montgomery product a*b*2^-256 mod P, canonical. Each outer step adds
// a_i*b and then one multiple of P that clears the low word; with P < 2^254
// the running value stays < 2P, so nine words hold it.
__device__ __forceinline__ Fp fp_mont_mul(const Fp& a, const Fp& b) {
  uint32_t t[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.w[i] * b.w[j] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    // The value is now < 2P + 2^32*P < 2^287, so the top word is < 2^31.
    uint64_t top = (uint64_t)t[8] + c;
    uint32_t m = t[0] * kPInvNeg;
    c = ((uint64_t)m * kP[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * kP[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    top += c;
    t[7] = (uint32_t)top;
    t[8] = (uint32_t)(top >> 32);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = t[i];
  return fp_cond_sub_p(r);
}

// fp_mont_mul out of line: one copy of its code in the kernel however many
// products call it. A step of eleven inlined products (the scan's mixed add)
// outgrows the instruction caches; called, it runs faster on the H100
// (PERF.md §6). proj_madd and proj_add call it, and so every kernel that
// runs one thread an add (the scans, pmadd, padd_kernel, fold_add_kernel);
// the cooperative proj_add_group inlines its two products. The operands
// pass by value, in registers: by reference they would go through a stack
// frame in local memory. Two or three products interleaved in one call
// were no faster on the H100 (PERF.md §6).
static __device__ __noinline__ Fp fp_mont_mul_outlined(Fp a, Fp b) {
  return fp_mont_mul(a, b);
}

struct Proj {
  Fp x, y, z;
};

__device__ __forceinline__ Proj proj_infinity() {
  Proj p;
  p.x = fp_zero();
  p.y = fp_one_mont();
  p.z = fp_zero();
  return p;
}

// Complete projective P + Q (RCB Algorithm 7, a = 0, b3 = 9), the exact
// field-op sequence of ec_rows.proj_add. Its twelve products call
// fp_mont_mul_outlined.
__device__ __forceinline__ Proj proj_add(const Proj& p, const Proj& q) {
  Fp t0 = fp_mont_mul_outlined(p.x, q.x);
  Fp t1 = fp_mont_mul_outlined(p.y, q.y);
  Fp t2 = fp_mont_mul_outlined(p.z, q.z);
  Fp a = fp_mont_mul_outlined(fp_add(p.x, p.y), fp_add(q.x, q.y));
  Fp b = fp_mont_mul_outlined(fp_add(p.x, p.z), fp_add(q.x, q.z));
  Fp c = fp_mont_mul_outlined(fp_add(p.y, p.z), fp_add(q.y, q.z));
  Fp t3 = fp_sub(fp_sub(a, t0), t1);
  Fp t4 = fp_sub(fp_sub(c, t1), t2);
  Fp y3t = fp_sub(fp_sub(b, t0), t2);
  t0 = fp_add(fp_dbl(t0), t0);
  t2 = fp_mul9(t2);
  Fp z3t = fp_add(t1, t2);
  t1 = fp_sub(t1, t2);
  Fp y3p = fp_mul9(y3t);
  Proj r;
  r.x = fp_sub(fp_mont_mul_outlined(t3, t1), fp_mont_mul_outlined(t4, y3p));
  r.y = fp_add(fp_mont_mul_outlined(t1, z3t), fp_mont_mul_outlined(y3p, t0));
  r.z = fp_add(fp_mont_mul_outlined(z3t, t4), fp_mont_mul_outlined(t0, t3));
  return r;
}

// The cooperative complete add below runs on groups of kAddGroup lanes.
constexpr int kAddGroup = 8;

__device__ __forceinline__ Fp fp_select(bool c, const Fp& a, const Fp& b) {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}

// v[r] for the group rank r (v0 for ranks 6 and 7), by word selects.
__device__ __forceinline__ Fp fp_pick6(int r, const Fp& v0, const Fp& v1,
                                       const Fp& v2, const Fp& v3,
                                       const Fp& v4, const Fp& v5) {
  Fp o = fp_select(r == 1, v1, v0);
  o = fp_select(r == 2, v2, o);
  o = fp_select(r == 3, v3, o);
  o = fp_select(r == 4, v4, o);
  return fp_select(r == 5, v5, o);
}

// `a` as held by rank `src` of the caller's group.
__device__ __forceinline__ Fp fp_from_rank(unsigned mask, const Fp& a,
                                           int src) {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.w[i] = __shfl_sync(mask, a.w[i], src, kAddGroup);
  return r;
}

// proj_add by a group of kAddGroup consecutive warp lanes that all hold the
// same P and Q; `rank` is the lane's index in its group and `mask` names
// every lane of the warp that calls it. The twelve products of Algorithm 7
// come in two levels of six independent ones: rank r < 6 computes the r-th
// product of a level, and every lane gets all six by __shfl_sync. The
// linear steps between the levels are computed by every lane alike, so a
// dependent chain of adds waits on two products an add, not twelve, and
// on two exchanges. Ranks 6 and 7 compute rank 0's product and are never
// read. The field ops and their order are those of proj_add, so every lane
// ends with proj_add's bits.
__device__ __forceinline__ Proj proj_add_group(const Proj& p, const Proj& q,
                                               int rank, unsigned mask) {
  // Level 1: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (X1+Z1)(X2+Z2), (Y1+Z1)(Y2+Z2).
  const Fp ps = fp_add(fp_select(rank == 5, p.y, p.x),
                       fp_select(rank == 3, p.y, p.z));
  const Fp qs = fp_add(fp_select(rank == 5, q.y, q.x),
                       fp_select(rank == 3, q.y, q.z));
  const Fp m1 = fp_mont_mul(fp_pick6(rank, p.x, p.y, p.z, ps, ps, ps),
                            fp_pick6(rank, q.x, q.y, q.z, qs, qs, qs));
  Fp t0 = fp_from_rank(mask, m1, 0);
  Fp t1 = fp_from_rank(mask, m1, 1);
  Fp t2 = fp_from_rank(mask, m1, 2);
  const Fp a = fp_from_rank(mask, m1, 3);
  const Fp b = fp_from_rank(mask, m1, 4);
  const Fp c = fp_from_rank(mask, m1, 5);
  const Fp t3 = fp_sub(fp_sub(a, t0), t1);
  const Fp t4 = fp_sub(fp_sub(c, t1), t2);
  const Fp y3t = fp_sub(fp_sub(b, t0), t2);
  t0 = fp_add(fp_dbl(t0), t0);
  t2 = fp_mul9(t2);
  const Fp z3t = fp_add(t1, t2);
  t1 = fp_sub(t1, t2);
  const Fp y3p = fp_mul9(y3t);
  // Level 2: the six products of X3 = t3·t1 - t4·y3p, Y3 = t1·z3t + y3p·t0,
  // Z3 = z3t·t4 + t0·t3.
  const Fp m2 = fp_mont_mul(fp_pick6(rank, t3, t4, t1, y3p, z3t, t0),
                            fp_pick6(rank, t1, y3p, z3t, t0, t4, t3));
  Proj r;
  r.x = fp_sub(fp_from_rank(mask, m2, 0), fp_from_rank(mask, m2, 1));
  r.y = fp_add(fp_from_rank(mask, m2, 2), fp_from_rank(mask, m2, 3));
  r.z = fp_add(fp_from_rank(mask, m2, 4), fp_from_rank(mask, m2, 5));
  return r;
}

// Complete projective P + affine Q (RCB Algorithm 8, a = 0), the sequence of
// ec_rows.proj_madd without its trailing select: proj_madd_complete below
// skips the add for the (0, 0) infinity sentinel, which leaves P unchanged
// just the same. Its eleven products call fp_mont_mul_outlined.
__device__ __forceinline__ Proj proj_madd(const Proj& p, const Fp& x2,
                                          const Fp& y2) {
  Fp t0 = fp_mont_mul_outlined(p.x, x2);
  Fp t1 = fp_mont_mul_outlined(p.y, y2);
  Fp a = fp_mont_mul_outlined(fp_add(p.x, p.y), fp_add(x2, y2));
  Fp d = fp_mont_mul_outlined(y2, p.z);
  Fp e = fp_mont_mul_outlined(x2, p.z);
  Fp t3 = fp_sub(fp_sub(a, t0), t1);
  Fp t4 = fp_add(d, p.y);
  Fp y3t = fp_add(e, p.x);
  t0 = fp_add(fp_dbl(t0), t0);
  Fp t2 = fp_mul9(p.z);
  Fp z3t = fp_add(t1, t2);
  t1 = fp_sub(t1, t2);
  Fp y3p = fp_mul9(y3t);
  Proj r;
  r.x = fp_sub(fp_mont_mul_outlined(t3, t1),
               fp_mont_mul_outlined(t4, y3p));
  r.y = fp_add(fp_mont_mul_outlined(t1, z3t),
               fp_mont_mul_outlined(y3p, t0));
  r.z = fp_add(fp_mont_mul_outlined(z3t, t4),
               fp_mont_mul_outlined(t0, t3));
  return r;
}

// P + affine Q for the (0, 0) infinity sentinel as well: the select that
// ec_rows.proj_madd ends with.
__device__ __forceinline__ Proj proj_madd_complete(const Proj& p, const Fp& x2,
                                                   const Fp& y2) {
  if (fp_is_zero(x2) && fp_is_zero(y2)) return p;
  return proj_madd(p, x2, y2);
}

// Jacobian coordinates (X, Y, Z), a point (X / Z^2, Y / Z^3); Z = 0 is
// infinity. The formulas below are the sequences of ec_rows.jac_dbl_core,
// jac_madd and jac_add (the Pallas row bodies _dbl_core, _madd_rows and
// _add_rows), so their canonical outputs are the same bits.
struct Jac {
  Fp x, y, z;
};

// dbl-2009-l (a = 0): the fallback both adders take when P == Q.
__device__ __forceinline__ Jac jac_dbl_core(const Jac& p) {
  const Fp xx = fp_mont_mul(p.x, p.x);
  const Fp yy = fp_mont_mul(p.y, p.y);
  const Fp yyyy = fp_mont_mul(yy, yy);
  const Fp xpyy = fp_add(p.x, yy);
  const Fp t = fp_mont_mul(xpyy, xpyy);
  const Fp d = fp_dbl(fp_sub(fp_sub(t, xx), yyyy));
  const Fp e = fp_add(fp_dbl(xx), xx);
  const Fp f = fp_mont_mul(e, e);
  Jac r;
  r.x = fp_sub(f, fp_dbl(d));
  r.y = fp_sub(fp_mont_mul(e, fp_sub(d, r.x)), fp_dbl(fp_dbl(fp_dbl(yyyy))));
  r.z = fp_mont_mul(fp_dbl(p.y), p.z);
  return r;
}

// The select order of _finalize: P == Q doubles (the doubling is computed
// only on such lanes, which gives the same bits as computing it everywhere
// and selecting), P == -Q sets Z = 0, then an infinite Q returns P and an
// infinite P returns Q.
__device__ __forceinline__ Jac jac_finalize(const Jac& raw, const Jac& p,
                                            const Jac& q, bool inf_p,
                                            bool inf_q, bool h_zero,
                                            bool r_zero) {
  Jac o = raw;
  if (h_zero && r_zero && !inf_p && !inf_q) o = jac_dbl_core(p);
  if (h_zero && !r_zero && !inf_p && !inf_q) o.z = fp_zero();
  if (inf_q) o = p;
  if (inf_p) o = q;
  return o;
}

// Jacobian P + affine Q, madd-2007-bl. Q = (0, 0) is infinity; it lifts to
// (0, 0, 0), and to (x2, y2, Montgomery one) otherwise.
__device__ __forceinline__ Jac jac_madd(const Jac& p, const Fp& x2,
                                        const Fp& y2) {
  const bool inf_q = fp_is_zero(x2) && fp_is_zero(y2);
  const bool inf_p = fp_is_zero(p.z);
  const Fp z1z1 = fp_mont_mul(p.z, p.z);
  const Fp u2 = fp_mont_mul(x2, z1z1);
  const Fp s2 = fp_mont_mul(y2, fp_mont_mul(p.z, z1z1));
  const Fp h = fp_sub(u2, p.x);
  const Fp rhalf = fp_sub(s2, p.y);
  const Fp r = fp_dbl(rhalf);
  const Fp hh = fp_mont_mul(h, h);
  const Fp i = fp_dbl(fp_dbl(hh));
  const Fp j = fp_mont_mul(h, i);
  const Fp v = fp_mont_mul(p.x, i);
  const Fp rr = fp_mont_mul(r, r);
  Jac raw;
  raw.x = fp_sub(fp_sub(rr, j), fp_dbl(v));
  raw.y = fp_sub(fp_mont_mul(r, fp_sub(v, raw.x)),
                 fp_dbl(fp_mont_mul(p.y, j)));
  const Fp zph = fp_add(p.z, h);
  raw.z = fp_sub(fp_sub(fp_mont_mul(zph, zph), z1z1), hh);
  Jac q;
  q.x = x2;
  q.y = y2;
  q.z = inf_q ? fp_zero() : fp_one_mont();
  return jac_finalize(raw, p, q, inf_p, inf_q, fp_is_zero(h),
                      fp_is_zero(rhalf));
}

// Jacobian P + Q, add-2007-bl.
__device__ __forceinline__ Jac jac_add(const Jac& p, const Jac& q) {
  const bool inf_p = fp_is_zero(p.z);
  const bool inf_q = fp_is_zero(q.z);
  const Fp z1z1 = fp_mont_mul(p.z, p.z);
  const Fp z2z2 = fp_mont_mul(q.z, q.z);
  const Fp u1 = fp_mont_mul(p.x, z2z2);
  const Fp u2 = fp_mont_mul(q.x, z1z1);
  const Fp s1 = fp_mont_mul(p.y, fp_mont_mul(q.z, z2z2));
  const Fp s2 = fp_mont_mul(q.y, fp_mont_mul(p.z, z1z1));
  const Fp h = fp_sub(u2, u1);
  const Fp rhalf = fp_sub(s2, s1);
  const Fp r = fp_dbl(rhalf);
  const Fp h2 = fp_dbl(h);
  const Fp i = fp_mont_mul(h2, h2);
  const Fp j = fp_mont_mul(h, i);
  const Fp v = fp_mont_mul(u1, i);
  const Fp rr = fp_mont_mul(r, r);
  Jac raw;
  raw.x = fp_sub(fp_sub(rr, j), fp_dbl(v));
  raw.y = fp_sub(fp_mont_mul(r, fp_sub(v, raw.x)),
                 fp_dbl(fp_mont_mul(s1, j)));
  const Fp zs = fp_add(p.z, q.z);
  const Fp zh = fp_sub(fp_sub(fp_mont_mul(zs, zs), z1z1), z2z2);
  raw.z = fp_mont_mul(zh, h);
  return jac_finalize(raw, p, q, inf_p, inf_q, fp_is_zero(h),
                      fp_is_zero(rhalf));
}

// Word k of element i of a (16, plane) u16-row array: limb rows 2k and
// 2k + 1; `stride` is the plane size (distance between two limb rows).
__device__ __forceinline__ uint32_t load_u16_word(
    const uint32_t* __restrict__ rows, size_t stride, size_t i, int k) {
  return (rows[(2 * k) * stride + i] & 0xffffu) |
         (rows[(2 * k + 1) * stride + i] << 16);
}

// Element i of a (16, plane) u16-row array -> words.
__device__ __forceinline__ Fp load_u16_rows(const uint32_t* __restrict__ rows,
                                            size_t stride, size_t i) {
  Fp r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = load_u16_word(rows, stride, i, k);
  return r;
}

// The element whose word r rank r of the caller's group of kAddGroup lanes
// holds in `w`, on every lane of the group: a group loads an element with
// one word a lane (load_u16_word at k = rank) and eight exchanges, not
// eight words a lane.
__device__ __forceinline__ Fp fp_from_group_words(unsigned mask, uint32_t w) {
  Fp r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.w[k] = __shfl_sync(mask, w, k, kAddGroup);
  return r;
}

__device__ __forceinline__ void store_u16_rows(uint32_t* __restrict__ rows,
                                               size_t stride, size_t i,
                                               const Fp& a) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    rows[(2 * k) * stride + i] = a.w[k] & 0xffffu;
    rows[(2 * k + 1) * stride + i] = a.w[k] >> 16;
  }
}

// store_u16_rows by a group of kAddGroup lanes that all hold `a`: rank r
// writes limb rows 2r and 2r + 1 (word r), so each lane stores two rows, not
// sixteen, and one store of a warp covers eight rows of its four elements.
static_assert(kAddGroup == 8, "one word of the eight per rank");
__device__ __forceinline__ void store_u16_rows_rank(uint32_t* __restrict__ rows,
                                                    size_t stride, size_t i,
                                                    const Fp& a, int rank) {
  uint32_t w = a.w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) w = rank == k ? a.w[k] : w;
  rows[(2 * rank) * stride + i] = w & 0xffffu;
  rows[(2 * rank + 1) * stride + i] = w >> 16;
}

}  // namespace bn254
