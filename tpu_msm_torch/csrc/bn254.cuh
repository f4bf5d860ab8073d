// BN254 base field and complete projective G1 formulas for one CUDA thread.
//
// One field core for every kernel of the port: 8 x u32 little-endian words,
// CIOS Montgomery multiplication with R = 2^256 on PTX carry chains, every
// result reduced to the canonical range [0, P). The JAX package ran four
// cores for the TPU (pallas_curve.mont_mul on u16 rows, f15.mont_mul_cios
// on 15-bit rows, the DualField pairing and the MXU-REDC core); all compute
// a*b*2^-256 mod P, and canonical outputs of the same formula sequence are
// bit-identical to each of them and to the plain torch field (ops/field.py).
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

// ---- The carry chains ----
//
// The field core runs on the PTX carry flag (add.cc, addc, sub.cc, subc,
// mad.lo.cc, madc.lo, madc.hi). Each asm statement below is one whole carry
// chain: its first instruction sets the flag without reading it and its
// last reads it without setting it, so no carry crosses from one statement
// to the next and the statements need no `volatile`: the compiler and
// ptxas may schedule them like any other instructions. A chain updates its
// words in place ("+r"), and its one other output ("=r", sub8's borrow) is
// written by its last instruction, so no output can share a register with
// an input read after it. Where a chain's last instruction drops a carry,
// the comment states the bound that makes that carry 0.
// tests/test_torch_fieldcore.py reads these asm strings from this file and
// runs them, instruction by instruction, on a Python model of the flag.

// d -= b over eight words; returns the borrow out as an all-ones or
// all-zeros word.
__device__ __forceinline__ uint32_t sub8(Fp& d, const Fp& b) {
  uint32_t borrow;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]),
        "+r"(d.w[4]), "+r"(d.w[5]), "+r"(d.w[6]), "+r"(d.w[7]),
        "=r"(borrow)
      : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]),
        "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
  return borrow;
}

// s += b over eight words, the last carry dropped: fp_add's and
// fp_mont_mul's sums are below 2^256 (a + b < 2P < 2^255; R < 2P), and
// fp_sub's add-back of P wraps past 2^256 on purpose.
__device__ __forceinline__ void add8(Fp& s, const Fp& b) {
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(s.w[0]), "+r"(s.w[1]), "+r"(s.w[2]), "+r"(s.w[3]),
        "+r"(s.w[4]), "+r"(s.w[5]), "+r"(s.w[6]), "+r"(s.w[7])
      : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]),
        "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
}

// t - P if t >= P, else t; canonical for t < 2P.
__device__ __forceinline__ Fp fp_cond_sub_p(const Fp& t) {
  Fp d = t, p;
#pragma unroll
  for (int i = 0; i < 8; ++i) p.w[i] = kP[i];
  const uint32_t borrow = sub8(d, p);
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = borrow ? t.w[i] : d.w[i];
  return r;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp s = a;
  add8(s, b);
  return fp_cond_sub_p(s);
}

// a - b mod P: P masked by the borrow of a - b is added back.
__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d = a, pm;
  const uint32_t borrow = sub8(d, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) pm.w[i] = kP[i] & borrow;
  add8(d, pm);
  return d;
}

__device__ __forceinline__ Fp fp_dbl(const Fp& a) { return fp_add(a, a); }

// 9a mod P (b3 = 3b = 9 for BN254), the add chain of ec_rows.py.
__device__ __forceinline__ Fp fp_mul9(const Fp& a) {
  return fp_add(fp_dbl(fp_dbl(fp_dbl(a))), a);
}

// ---- The Montgomery product ----
//
// CIOS Montgomery product a*b*2^-256 mod P, canonical for a < 2^256 and
// b < P (the XOR-folded accumulators of montmul.cu are such an a).
//
// Row i (i = 0..7) adds a_i·b to the running value T, then m·P with
// m = T_0·(-P^-1) mod 2^32, which clears T's low word, and shifts T one word
// down. T < b + P before a row gives T < (b + P + (2^32 - 1)(b + P)) / 2^32
// = b + P after it, so T < b + P < 2P < 2^255 between rows, and the result
// needs one conditional subtraction.
//
// The layout follows supranational/sppark (ff/mont_t.cuh: mul_n, cmad_n,
// madc_n_rshift). T is held in two accumulators, T = E + 2^32·O, so that
// no two products of a row land on the same words of one accumulator: E
// takes a_i·b_j for even j at its words (j, j + 1), O takes those for odd j
// at its words (j - 1, j). A row is then two independent chains of eight
// multiply-adds, low and high halves alternating on the carry flag, where
// a 64-bit accumulator made one chain of sixteen; the reduction's two
// chains start as soon as E's word 0 is known and overlap the tails of the
// row's chains, and the next row waits only on the reduction's low words.
//
// Bounds, with P < 2^254 and b < P (two spare bits):
// - E: nine words. It enters a row below 2^256 and gains a_i·b_even +
//   m·p_even < 2·2^32·2^254 = 2^287, so E < 2^288: word 8 takes the carries
//   of both even chains (mac_even), and stays below 2^31 + 1.
// - O: eight words, no ninth. It enters a row at most T / 2^32 < 2^223 and
//   gains a_i·b_odd/2^32 + m·p_odd/2^32 < 2·2^254, so O < 2^256: the last
//   carry of each odd chain is 0 and is dropped (mac_odd, mac_odd_shift).
// - The shift: after the reduction E's word 0 is 0 and T / 2^32 =
//   (e_1..e_8) + (o_0..o_7). The next row's E is (o_0 + e_1, o_1..o_7) and
//   its O is (e_2..e_8, 0) plus the carry of o_0 + e_1, which enters the
//   odd chain's first multiply-add (mac_odd_shift).
// - The result (e_1..e_8) + (o_0..o_7) = T < 2P < 2^255: one add chain with
//   no carry out (add8), then fp_cond_sub_p.

// e[0..7] += x·(w0, w2, w4, w6) at words (0, 1), (2, 3), (4, 5), (6, 7), and
// the carry out into e[8]: a row's even products (x = a_i, the w the even
// words of b) or its reduction's (x = m, the even words of P).
__device__ __forceinline__ void mac_even(uint32_t (&e)[9], uint32_t x,
                                         uint32_t w0, uint32_t w2,
                                         uint32_t w4, uint32_t w6) {
  asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8])
      : "r"(x), "r"(w0), "r"(w2), "r"(w4), "r"(w6));
}

// o[0..7] += x·(w1, w3, w5, w7) at words (0, 1), (2, 3), (4, 5), (6, 7): the
// reduction's odd products (x = m, the odd words of P). The last carry is 0
// (O < 2^256) and dropped.
__device__ __forceinline__ void mac_odd(uint32_t (&o)[8], uint32_t x,
                                        uint32_t w1, uint32_t w3,
                                        uint32_t w5, uint32_t w7) {
  asm("mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
      "madc.lo.cc.u32 %4, %8, %11, %4;\n\t"
      "madc.hi.cc.u32 %5, %8, %11, %5;\n\t"
      "madc.lo.cc.u32 %6, %8, %12, %6;\n\t"
      "madc.hi.u32 %7, %8, %12, %7;"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
        "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
      : "r"(x), "r"(w1), "r"(w3), "r"(w5), "r"(w7));
}

// The shift into row i > 0 and the row's odd products, one chain: e0 (o_0
// on entry) += e1 gives the new E's word 0, and its carry enters o[0..7]
// (e_2..e_8, 0 on entry) += a_i·(b1, b3, b5, b7). The last carry is 0
// (O < 2^256) and dropped.
__device__ __forceinline__ void mac_odd_shift(uint32_t (&o)[8], uint32_t& e0,
                                              uint32_t e1, uint32_t x,
                                              const Fp& b) {
  asm("add.cc.u32 %8, %8, %9;\n\t"
      "madc.lo.cc.u32 %0, %10, %11, %0;\n\t"
      "madc.hi.cc.u32 %1, %10, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %10, %14, %6;\n\t"
      "madc.hi.u32 %7, %10, %14, %7;"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
        "+r"(o[5]), "+r"(o[6]), "+r"(o[7]), "+r"(e0)
      : "r"(e1), "r"(x), "r"(b.w[1]), "r"(b.w[3]), "r"(b.w[5]),
        "r"(b.w[7]));
}

// The reduction of a row: m·P added with m = e_0·(-P^-1) mod 2^32, which
// leaves E's word 0 at 0.
__device__ __forceinline__ void redc_row(uint32_t (&e)[9], uint32_t (&o)[8]) {
  const uint32_t m = e[0] * kPInvNeg;
  mac_even(e, m, kP[0], kP[2], kP[4], kP[6]);
  mac_odd(o, m, kP[1], kP[3], kP[5], kP[7]);
}

__device__ __forceinline__ Fp fp_mont_mul(const Fp& a, const Fp& b) {
  uint32_t e[9], o[8];
  // Row 0: the products land on zero words, so they need no carries.
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    e[j] = a.w[0] * b.w[j];
    e[j + 1] = __umulhi(a.w[0], b.w[j]);
    o[j] = a.w[0] * b.w[j + 1];
    o[j + 1] = __umulhi(a.w[0], b.w[j + 1]);
  }
  e[8] = 0u;
  redc_row(e, o);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    uint32_t ne[9], no[8];
    ne[0] = o[0];
#pragma unroll
    for (int k = 0; k < 7; ++k) no[k] = e[k + 2];
    no[7] = 0u;
    mac_odd_shift(no, ne[0], e[1], a.w[i], b);
#pragma unroll
    for (int k = 1; k < 8; ++k) ne[k] = o[k];
    ne[8] = 0u;
    mac_even(ne, a.w[i], b.w[0], b.w[2], b.w[4], b.w[6]);
    redc_row(ne, no);
#pragma unroll
    for (int k = 0; k < 9; ++k) e[k] = ne[k];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = no[k];
  }
  Fp r, ov;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    r.w[k] = e[k + 1];
    ov.w[k] = o[k];
  }
  add8(r, ov);
  return fp_cond_sub_p(r);
}

// fp_mont_mul out of line: one copy of its code in the kernel however many
// products call it. A step of eleven inlined products (the scan's mixed add)
// outgrows the instruction caches; called, it runs faster on the H100
// (PERF.md §6). proj_madd and proj_add call it, and so every kernel that
// runs one thread an add (the scans, pmadd, padd_kernel, fold_add_kernel);
// the cooperative proj_add_group and proj_madd_group inline their two. The
// operands pass by value, in registers: by reference they would go through
// a stack frame in local memory. Two or three products interleaved in one
// call were no faster on the H100 (PERF.md §6).
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

// proj_madd_complete by a group of kAddGroup consecutive warp lanes that all
// hold the same P and Q, as proj_add_group runs proj_add. Algorithm 8's
// eleven products come in two levels: five independent ones (X1·x2,
// Y1·y2, (X1+Y1)(x2+y2), Z1·y2, Z1·x2), then the six of Algorithm 7's
// second level. Rank r < 5, then r < 6, computes the r-th product of a
// level and every lane gets them all by __shfl_sync; the linear steps
// between the levels and the final select for the (0, 0) sentinel are
// computed by every lane alike (a select, not a branch: the whole warp
// takes part in every exchange). The other ranks compute rank 0's product
// and are never read. The field ops and their order are those of
// proj_madd (a Montgomery product's canonical result does not depend on
// the order of its operands), so every lane ends with proj_madd_complete's
// bits.
__device__ __forceinline__ Proj proj_madd_group(const Proj& p, const Fp& x2,
                                                const Fp& y2, int rank,
                                                unsigned mask) {
  const Fp ps = fp_add(p.x, p.y);
  const Fp qs = fp_add(x2, y2);
  const Fp m1 = fp_mont_mul(fp_pick6(rank, p.x, p.y, ps, p.z, p.z, p.x),
                            fp_pick6(rank, x2, y2, qs, y2, x2, x2));
  Fp t0 = fp_from_rank(mask, m1, 0);
  Fp t1 = fp_from_rank(mask, m1, 1);
  const Fp a = fp_from_rank(mask, m1, 2);
  const Fp d = fp_from_rank(mask, m1, 3);
  const Fp e = fp_from_rank(mask, m1, 4);
  const Fp t3 = fp_sub(fp_sub(a, t0), t1);
  const Fp t4 = fp_add(d, p.y);
  const Fp y3t = fp_add(e, p.x);
  t0 = fp_add(fp_dbl(t0), t0);
  const Fp t2 = fp_mul9(p.z);
  const Fp z3t = fp_add(t1, t2);
  t1 = fp_sub(t1, t2);
  const Fp y3p = fp_mul9(y3t);
  const Fp m2 = fp_mont_mul(fp_pick6(rank, t3, t4, t1, y3p, z3t, t0),
                            fp_pick6(rank, t1, y3p, z3t, t0, t4, t3));
  Proj r;
  r.x = fp_sub(fp_from_rank(mask, m2, 0), fp_from_rank(mask, m2, 1));
  r.y = fp_add(fp_from_rank(mask, m2, 2), fp_from_rank(mask, m2, 3));
  r.z = fp_add(fp_from_rank(mask, m2, 4), fp_from_rank(mask, m2, 5));
  const bool inf_q = fp_is_zero(x2) && fp_is_zero(y2);
  r.x = fp_select(inf_q, p.x, r.x);
  r.y = fp_select(inf_q, p.y, r.y);
  r.z = fp_select(inf_q, p.z, r.z);
  return r;
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
