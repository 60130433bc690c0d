// Complete projective point addition (Renes-Costello-Batina 2015,
// Algorithm 7, a = 0) on 32-bit words, shared by K4 (ec_add_complete), K4a
// (ec_bucket_accumulate) and K6 (ec_bucket_merge), on the word arithmetic
// of field.cuh.
//
// The formula needs 12 products: the six of layer 1 each take one
// Montgomery reduction; the six of layer 3 pair up into X3, Y3, Z3 =
// a*b + c*d, so each pair takes two wide products and ONE reduction (12
// products, 9 reductions).  K4a adds points with Z2 = 1
// (rcb_add_mixed, Algorithm 8: 11 products, 8 reductions; at 12 words
// rcb_add_mixed_staged) and takes two cases of the formula apart: a bucket
// at the identity (rcb_first_hit, 2 products) and the identity added to a
// bucket (rcb_add_identity, 3).  Each gives the field values of rcb_add on
// the same inputs, so the same canonical words.
//
// Lazy reduction: the functions below need p < R/5 (BN254's Fq: p < 0.19 R
// at L = 16; the BLS12 base fields at L = 24: 0.102 R and 0.007 R; the
// wrappers check it, _cuda.ec_field_consts).  Then a product of two
// values below 2p, reduced without the final subtraction, is below
// (2p)^2/R + p < 2p, so inside the formula values live in [0, 2p) and
// additions reduce by 2p; a layer-3 sum of two such products is below
// 8p^2/R + p < 2.52p and two subtractions of p make it canonical (the
// interleaved sums of rcb_add_staged hold below (2^32 + 1) 5p in NW + 1
// words, field.cuh's mont_row).  Inputs and outputs of every add below are
// canonical (< p).
#pragma once

#include "field.cuh"

namespace zk {
namespace ecw {

// r = 2p - a for a <= 2p (congruent to -a, in (0, 2p])
template <int L>
__device__ __forceinline__ void neg2p(uint32_t r[L / 2], const uint32_t a[L / 2],
                                      const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  r[0] = ptx::sub_cc(fc.p2[0], a[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r[j] = ptx::subc_cc(fc.p2[j], a[j]);
  r[NW - 1] = ptx::subc(fc.p2[NW - 1], a[NW - 1]);
}

// r = p - a for a canonical, with 0 -> 0 (the negation of fields/device.py)
template <int L>
__device__ __forceinline__ void neg_canon(uint32_t r[L / 2], const uint32_t a[L / 2],
                                          const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t nz = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) nz |= a[j];
  uint32_t d[NW];
  d[0] = ptx::sub_cc(fc.p[0], a[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) d[j] = ptx::subc_cc(fc.p[j], a[j]);
  d[NW - 1] = ptx::subc(fc.p[NW - 1], a[NW - 1]);
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = nz ? d[j] : 0u;
}

// r = v * x mod 2p for x < 2p and a small integer v >= 0 (double-and-add)
template <int L>
__device__ __forceinline__ void mul_small2p(uint32_t r[L / 2], const uint32_t x[L / 2], int v,
                                            const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = v ? x[j] : 0u;
  for (int bit = 30 - __clz(v > 0 ? v : 1); bit >= 0; --bit) {
    add_mod<NW>(acc, acc, acc, fc.p2);
    if ((v >> bit) & 1) add_mod<NW>(acc, acc, x, fc.p2);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = acc[j];
}

// r = (a*b + c*d) * R^-1 mod p, canonical, for a, b, c, d <= 2p
template <int L>
__device__ __forceinline__ void sop_canon(uint32_t r[L / 2], const uint32_t a[L / 2],
                                          const uint32_t b[L / 2], const uint32_t c[L / 2],
                                          const uint32_t d[L / 2], const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t T[2 * NW], U[2 * NW];
  wide_mul<NW>(T, a, b);
  wide_mul<NW>(U, c, d);
  T[0] = ptx::add_cc(T[0], U[0]);
#pragma unroll
  for (int j = 1; j < 2 * NW - 1; ++j) T[j] = ptx::addc_cc(T[j], U[j]);
  T[2 * NW - 1] = ptx::addc(T[2 * NW - 1], U[2 * NW - 1]);
  redc<L>(r, T, fc);  // < 8p^2/R + p < 2.52p
  csub<NW>(r, r, fc.p);
  csub<NW>(r, r, fc.p);
}

// Layers 2 and 3 of rcb_add from layer 1's values, each below 2p: t0 =
// X1X2, t1 = Y1Y2, t2 = Z1Z2, t3 = X1Y2 + X2Y1, t4 = Y1Z2 + Y2Z1, t5 =
// X1Z2 + X2Z1 (all clobbered).  Outputs canonical.
template <int L>
__device__ __forceinline__ void rcb_finish(uint32_t X3[L / 2], uint32_t Y3[L / 2],
                                           uint32_t Z3[L / 2], uint32_t t0[L / 2],
                                           uint32_t t1[L / 2], uint32_t t2[L / 2],
                                           uint32_t t3[L / 2], uint32_t t4[L / 2],
                                           uint32_t t5[L / 2], int b3, const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t u[NW], v[NW];
  // layer 2: the curve constant and the small multiples
  mul_small2p<L>(t2, t2, b3, fc);  // 3b Z1Z2
  mul_small2p<L>(t5, t5, b3, fc);  // 3b (X1Z2 + X2Z1)
  add_mod<NW>(u, t0, t0, fc.p2);
  add_mod<NW>(t0, u, t0, fc.p2);   // 3 X1X2
  add_mod<NW>(u, t1, t2, fc.p2);   // zs = Y1Y2 + 3b Z1Z2
  sub_mod<NW>(v, t1, t2, fc.p2);   // td = Y1Y2 - 3b Z1Z2
  neg2p<L>(t1, t5, fc);            // -3b (X1Z2 + X2Z1)
  // layer 3: three sums of two products, one reduction each
  sop_canon<L>(X3, t3, v, t4, t1, fc);  // t3 td - t4 b3t5
  sop_canon<L>(Y3, t5, t0, v, u, fc);   // b3t5 m3t0 + td zs
  sop_canon<L>(Z3, u, t4, t0, t3, fc);  // zs t4 + m3t0 t3
}

// (X3 : Y3 : Z3) = (X1 : Y1 : Z1) + (X2 : Y2 : Z2), every coordinate
// canonical.  Montgomery-consistent: with inputs x*R the outputs are x*R;
// with inputs x (no R) they are x * R^-3.  b3 = 3b as a small integer.
template <int L>
__device__ __forceinline__ void rcb_add(uint32_t X3[L / 2], uint32_t Y3[L / 2], uint32_t Z3[L / 2],
                                        const uint32_t X1[L / 2], const uint32_t Y1[L / 2],
                                        const uint32_t Z1[L / 2], const uint32_t X2[L / 2],
                                        const uint32_t Y2[L / 2], const uint32_t Z2[L / 2],
                                        int b3, const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], t5[NW], u[NW], v[NW];
  // layer 1: six products of values below 2p, each below 2p
  mont<L>(t0, X1, X2, fc);
  mont<L>(t1, Y1, Y2, fc);
  mont<L>(t2, Z1, Z2, fc);
  add_nr<NW>(u, X1, Y1);
  add_nr<NW>(v, X2, Y2);
  mont<L>(t3, u, v, fc);  // (X1+Y1)(X2+Y2)
  add_nr<NW>(u, Y1, Z1);
  add_nr<NW>(v, Y2, Z2);
  mont<L>(t4, u, v, fc);  // (Y1+Z1)(Y2+Z2)
  add_nr<NW>(u, X1, Z1);
  add_nr<NW>(v, X2, Z2);
  mont<L>(t5, u, v, fc);  // (X1+Z1)(X2+Z2)
  sub_mod<NW>(t3, t3, t0, fc.p2);
  sub_mod<NW>(t3, t3, t1, fc.p2);  // X1Y2 + X2Y1
  sub_mod<NW>(t4, t4, t1, fc.p2);
  sub_mod<NW>(t4, t4, t2, fc.p2);  // Y1Z2 + Y2Z1
  sub_mod<NW>(t5, t5, t0, fc.p2);
  sub_mod<NW>(t5, t5, t2, fc.p2);  // X1Z2 + X2Z1
  rcb_finish<L>(X3, Y3, Z3, t0, t1, t2, t3, t4, t5, b3, fc);
}

// rcb_add with Z2 = 1 (RCB 2015, Algorithm 8): t2 = Z1Z2 is Z1, and the
// cross sums X1Z2 + X2Z1 and Y1Z2 + Y2Z1 are X1 + X2Z1 and Y1 + Y2Z1, so
// layer 1 takes five products and layers 2-3 are rcb_add's (11 products,
// 8 reductions).  The same field values as rcb_add(P, (X2 : Y2 : 1)),
// hence the same canonical words; Z2 is never read.
template <int L>
__device__ __forceinline__ void rcb_add_mixed(uint32_t X3[L / 2], uint32_t Y3[L / 2],
                                              uint32_t Z3[L / 2], const uint32_t X1[L / 2],
                                              const uint32_t Y1[L / 2], const uint32_t Z1[L / 2],
                                              const uint32_t X2[L / 2], const uint32_t Y2[L / 2],
                                              int b3, const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], t5[NW], u[NW], v[NW];
  mont<L>(t4, Y2, Z1, fc);
  add_mod<NW>(t4, t4, Y1, fc.p2);  // Y1 + Y2Z1
  mont<L>(t5, X2, Z1, fc);
  add_mod<NW>(t5, t5, X1, fc.p2);  // X1 + X2Z1
  mont<L>(t0, X1, X2, fc);
  mont<L>(t1, Y1, Y2, fc);
  add_nr<NW>(u, X1, Y1);
  add_nr<NW>(v, X2, Y2);
  mont<L>(t3, u, v, fc);  // (X1+Y1)(X2+Y2)
  sub_mod<NW>(t3, t3, t0, fc.p2);
  sub_mod<NW>(t3, t3, t1, fc.p2);  // X1Y2 + X2Y1
  copy_w<NW>(t2, Z1);
  rcb_finish<L>(X3, Y3, Z3, t0, t1, t2, t3, t4, t5, b3, fc);
}

// r = a*b*R^-1 mod p, canonical, for canonical a and b: K4a's step forms.
// At 12 words the product is interleaved with its reduction (mont_cios: 13
// words of sum, not 24 of product and 24 of reduction), so that those forms
// fit the registers of the staged mixed add beside them; the same words.
template <int L>
__device__ __forceinline__ void mont_canon(uint32_t r[L / 2], const uint32_t a[L / 2],
                                           const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  if constexpr (L == 24) {
    mont_cios<L>(r, a, b, fc);
  } else {
    mont<L>(r, a, b, fc);
  }
  csub<L / 2>(r, r, fc.p);
}

// (0 : 1 : 0) + (X2 : Y2 : 1) under rcb_add: t0 = t2 = t5 = 0, t1 = Y2,
// t3 = X2, t4 = 1, so (X2Y2 : Y2^2 : Y2) — two products, and the bucket
// need not be read.  Canonical inputs and outputs.
template <int L>
__device__ __forceinline__ void rcb_first_hit(uint32_t X3[L / 2], uint32_t Y3[L / 2],
                                              uint32_t Z3[L / 2], const uint32_t X2[L / 2],
                                              const uint32_t Y2[L / 2], const FieldConsts<L>& fc) {
  mont_canon<L>(X3, X2, Y2, fc);
  mont_canon<L>(Y3, Y2, Y2, fc);
  copy_w<L / 2>(Z3, Y2);
}

// (X1 : Y1 : Z1) + (0 : +-1 : 0) under rcb_add: t0 = t2 = t5 = 0,
// t1 = +-Y1, t3 = +-X1, t4 = +-Z1, so (X1Y1 : Y1^2 : Y1Z1) for either
// sign — three products; the identity plus itself stays (0 : 1 : 0).
template <int L>
__device__ __forceinline__ void rcb_add_identity(uint32_t X3[L / 2], uint32_t Y3[L / 2],
                                                 uint32_t Z3[L / 2], const uint32_t X1[L / 2],
                                                 const uint32_t Y1[L / 2],
                                                 const uint32_t Z1[L / 2],
                                                 const FieldConsts<L>& fc) {
  mont_canon<L>(X3, X1, Y1, fc);
  mont_canon<L>(Y3, Y1, Y1, fc);
  mont_canon<L>(Z3, Y1, Z1, fc);
}

// Field values staged in shared memory for one thread: quad q (words 4q ..
// 4q+3) of value v at base[(v * NW/4 + q) * stride].  With stride = the
// block's thread count, a warp's 32 threads read 32 consecutive quads, 512
// contiguous bytes, with no bank conflict.
template <int NW>
struct Staged {
  uint4* base;
  int stride;

  __device__ __forceinline__ uint4* quad(int v, int q) const {
    return base + (v * (NW / 4) + q) * stride;
  }

  __device__ __forceinline__ void load(int v, uint32_t w[NW]) const {
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const uint4 x = ptx::ld_shared_v4(quad(v, q));
      w[4 * q] = x.x;
      w[4 * q + 1] = x.y;
      w[4 * q + 2] = x.z;
      w[4 * q + 3] = x.w;
    }
  }

  __device__ __forceinline__ void store(int v, const uint32_t w[NW]) const {
#pragma unroll
    for (int q = 0; q < NW / 4; ++q)
      ptx::st_shared_v4(quad(v, q), make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]));
  }
};

// r = (a*b [+ c*d]) * R^-1 mod p lazily (field.cuh, mont_row), with the
// row operands a and c read from the staged values ia and ic, one quad
// (four rows) per iteration of a loop that is not unrolled: the compiler
// cannot interleave the rows of different products, so a product holds
// only its sum, b, d and one quad of a and c in registers.  UNROLL unrolls
// the loop, for a caller with registers to spare (rcb_add_mixed_staged).
template <int L, bool SUM, bool UNROLL = false>
__device__ __forceinline__ void mont_staged(uint32_t r[L / 2], const Staged<L / 2>& S, int ia,
                                            const uint32_t b[L / 2], int ic,
                                            const uint32_t d[L / 2], const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t t[NW + 1];
#pragma unroll
  for (int j = 0; j <= NW; ++j) t[j] = 0u;
  auto rows = [&](int q) {
    const uint4 a = ptx::ld_shared_v4(S.quad(ia, q));
    uint4 c = a;
    if constexpr (SUM) c = ptx::ld_shared_v4(S.quad(ic, q));
    mont_row<L, SUM>(t, a.x, b, c.x, d, fc);
    mont_row<L, SUM>(t, a.y, b, c.y, d, fc);
    mont_row<L, SUM>(t, a.z, b, c.z, d, fc);
    mont_row<L, SUM>(t, a.w, b, c.w, d, fc);
  };
  if constexpr (UNROLL) {
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) rows(q);
  } else {
#pragma unroll 1
    for (int q = 0; q < NW / 4; ++q) rows(q);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = t[j];
}

// r1 = a1*b1 and r2 = a2*b2, R^-1 mod p lazily, the row operands staged in
// ia and ic: mont_staged twice with the rows of the two products taken in
// turns, so that the scheduler has two independent carry chains at a time
template <int L>
__device__ __forceinline__ void mont_staged_pair(uint32_t r1[L / 2], int ia, const uint32_t b1[L / 2],
                                                 uint32_t r2[L / 2], int ic, const uint32_t b2[L / 2],
                                                 const Staged<L / 2>& S, const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t t[NW + 1], u[NW + 1];
#pragma unroll
  for (int j = 0; j <= NW; ++j) t[j] = u[j] = 0u;
#pragma unroll 1
  for (int q = 0; q < NW / 4; ++q) {
    const uint4 a = ptx::ld_shared_v4(S.quad(ia, q));
    const uint4 c = ptx::ld_shared_v4(S.quad(ic, q));
    mont_row<L, false>(t, a.x, b1, 0u, b1, fc);
    mont_row<L, false>(u, c.x, b2, 0u, b2, fc);
    mont_row<L, false>(t, a.y, b1, 0u, b1, fc);
    mont_row<L, false>(u, c.y, b2, 0u, b2, fc);
    mont_row<L, false>(t, a.z, b1, 0u, b1, fc);
    mont_row<L, false>(u, c.z, b2, 0u, b2, fc);
    mont_row<L, false>(t, a.w, b1, 0u, b1, fc);
    mont_row<L, false>(u, c.w, b2, 0u, b2, fc);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    r1[j] = t[j];
    r2[j] = u[j];
  }
}

// Layers 2 and 3 of rcb_add_staged and rcb_add_mixed_staged from layer
// 1's values, each below 2p: t0 = X1X2, t1 = Y1Y2, t2 = Z1Z2, t3 = X1Y2 +
// X2Y1, t4 = Y1Z2 + Y2Z1, t5 = X1Z2 + X2Z1 (all clobbered).  Layer 3's six
// operands go to staged values 0-5, over the inputs, each loaded into
// registers only for the product that takes it whole; each output leaves
// through emit(c, w) as soon as it is canonical.  UNROLL as mont_staged's.
template <int L, bool UNROLL, class Emit>
__device__ __forceinline__ void rcb_finish_staged(const Staged<L / 2>& S, uint32_t t0[L / 2],
                                                  uint32_t t1[L / 2], uint32_t t2[L / 2],
                                                  uint32_t t3[L / 2], uint32_t t4[L / 2],
                                                  uint32_t t5[L / 2], int b3,
                                                  const FieldConsts<L>& fc, Emit&& emit) {
  constexpr int NW = L / 2;
  // layer 2: the curve constant and the small multiples
  mul_small2p<L>(t2, t2, b3, fc);  // 3b Z1Z2
  mul_small2p<L>(t5, t5, b3, fc);  // 3b (X1Z2 + X2Z1)
  {
    uint32_t u[NW];
    add_mod<NW>(u, t0, t0, fc.p2);
    add_mod<NW>(t0, u, t0, fc.p2);   // 3 X1X2
    add_mod<NW>(u, t1, t2, fc.p2);   // zs = Y1Y2 + 3b Z1Z2
    sub_mod<NW>(t1, t1, t2, fc.p2);  // td = Y1Y2 - 3b Z1Z2
    copy_w<NW>(t2, u);
  }
  // layer 3: three sums of two products, one reduction each, below
  // 8p^2/R + p < 2.52p; two subtractions of p make each canonical.  The
  // operands go to the input slots: 0 m3t0, 1 td, 2 zs, 3 t3, 4 t4, 5 b3t5.
  S.store(0, t0);
  S.store(1, t1);
  S.store(2, t2);
  S.store(3, t3);
  S.store(4, t4);
  S.store(5, t5);
  // emit(c, (a*b + c*d) R^-1) for the slots ia, ib, ic, id; d negated
  auto sum = [&](int c, int ia, int ib, int ic, int id, bool neg_d) {
    uint32_t b[NW], d[NW], r[NW];
    S.load(ib, b);
    S.load(id, d);
    if (neg_d) neg2p<L>(d, d, fc);  // in (0, 2p]
    mont_staged<L, true, UNROLL>(r, S, ia, b, ic, d, fc);
    csub<NW>(r, r, fc.p);
    csub<NW>(r, r, fc.p);
    emit(c, r);
  };
  sum(0, 3, 1, 4, 5, true);   // X3 = t3 td - t4 b3t5
  sum(1, 5, 0, 1, 2, false);  // Y3 = b3t5 m3t0 + td zs
  sum(2, 2, 4, 0, 3, false);  // Z3 = zs t4 + m3t0 t3
}

// Staged values of rcb_add_staged: the inputs P = (X1 : Y1 : Z1) in 0-2
// and Q = (X2 : Y2 : Z2) in 3-5, a sum of two coordinates in 6
constexpr int STAGED_VALUES = 7;

// rcb_add for the 12-word fields, shaped for the register file: the same
// formula and the same canonical outputs, with
// * the six input coordinates staged in shared memory and loaded where a
//   product needs them, instead of 72 words held in registers until layer
//   1's last product;
// * every product interleaved with its reduction (mont_row: 13 words of
//   sum, no 2*NW-word product arrays), its row operands read from shared
//   memory a quad at a time (mont_staged);
// * layers 2 and 3 as rcb_finish_staged.
// Layer 1 holds at most five 12-word products and one sum in registers;
// layer 3 two operands and a sum.  UNROLL, for a caller with registers to
// spare (the group merge, ec_bucket_merge.cu), runs X1X2 and Y1Y2 as a pair
// (mont_staged_pair) and unrolls the other products' loops, as
// rcb_add_mixed_staged does; the same canonical outputs.
template <int L, bool UNROLL = false, class Emit>
__device__ __forceinline__ void rcb_add_staged(const Staged<L / 2>& S, int b3,
                                               const FieldConsts<L>& fc, Emit&& emit) {
  constexpr int NW = L / 2;
  constexpr int SUMV = 6;
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], t5[NW];
  // layer 1: six products of values below 2p, each below 2p
  auto same = [&](uint32_t r[NW], int i) {  // P_i Q_i
    uint32_t b[NW];
    S.load(3 + i, b);
    mont_staged<L, false, UNROLL>(r, S, i, b, i, b, fc);
  };
  auto cross = [&](uint32_t r[NW], int i, int j) {  // (P_i + P_j)(Q_i + Q_j)
    uint32_t x[NW], y[NW], v[NW];
    S.load(i, x);
    S.load(j, y);
    add_nr<NW>(v, x, y);
    S.store(SUMV, v);
    S.load(3 + i, x);
    S.load(3 + j, y);
    add_nr<NW>(v, x, y);
    mont_staged<L, false, UNROLL>(r, S, SUMV, v, SUMV, v, fc);
  };
  if constexpr (UNROLL) {
    uint32_t x2[NW], y2[NW];
    S.load(3, x2);
    S.load(4, y2);
    mont_staged_pair<L>(t0, 0, x2, t1, 1, y2, S, fc);  // X1 X2, Y1 Y2
  } else {
    same(t0, 0);
    same(t1, 1);
  }
  same(t2, 2);
  cross(t3, 0, 1);
  cross(t4, 1, 2);
  cross(t5, 0, 2);
  sub_mod<NW>(t3, t3, t0, fc.p2);
  sub_mod<NW>(t3, t3, t1, fc.p2);  // X1Y2 + X2Y1
  sub_mod<NW>(t4, t4, t1, fc.p2);
  sub_mod<NW>(t4, t4, t2, fc.p2);  // Y1Z2 + Y2Z1
  sub_mod<NW>(t5, t5, t0, fc.p2);
  sub_mod<NW>(t5, t5, t2, fc.p2);  // X1Z2 + X2Z1
  rcb_finish_staged<L, UNROLL>(S, t0, t1, t2, t3, t4, t5, b3, fc, emit);
}

// Staged values of rcb_add_mixed_staged: P = (X1 : Y1 : Z1) in 0-2, Q's
// x and y in 3-4, a sum of two coordinates in 5
constexpr int MIXED_STAGED_VALUES = 6;

// rcb_add_mixed for the 12-word fields, shaped as rcb_add_staged is: layer
// 1's five products (t2 = Z1, X1 + X2Z1, Y1 + Y2Z1) interleaved with their
// reductions, row operands from shared memory, then rcb_finish_staged (11
// products, 8 reductions).  It has registers to spare at K4a's residency
// (3 blocks of 128 per SM), so X1X2 with Y1Y2 and Z1Y2 with Z1X2 run as
// pairs (mont_staged_pair) and the other products' loops are unrolled:
// K4a at L = 24 took 8.6 ms at the prover's batch of one where one product
// at a time, in loops not unrolled, took 9.4 (PERF.md).  The same
// canonical outputs as rcb_add_mixed.
template <int L, class Emit>
__device__ __forceinline__ void rcb_add_mixed_staged(const Staged<L / 2>& S, int b3,
                                                     const FieldConsts<L>& fc, Emit&& emit) {
  constexpr int NW = L / 2;
  constexpr int SUMV = 5;
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], t5[NW];
  // layer 1: five products of values below 2p, each below 2p
  {
    uint32_t x2[NW], y2[NW];
    S.load(3, x2);
    S.load(4, y2);
    mont_staged_pair<L>(t0, 0, x2, t1, 1, y2, S, fc);  // X1 X2, Y1 Y2
  }
  {
    uint32_t x[NW], y[NW], v[NW];
    S.load(0, x);
    S.load(1, y);
    add_nr<NW>(v, x, y);
    S.store(SUMV, v);
    S.load(3, x);
    S.load(4, y);
    add_nr<NW>(v, x, y);
    mont_staged<L, false, true>(t3, S, SUMV, v, SUMV, v, fc);  // (X1+Y1)(X2+Y2)
  }
  sub_mod<NW>(t3, t3, t0, fc.p2);
  sub_mod<NW>(t3, t3, t1, fc.p2);  // X1Y2 + X2Y1
  {
    uint32_t w[NW], x2[NW];
    S.load(4, w);
    S.load(3, x2);
    mont_staged_pair<L>(t4, 2, w, t5, 2, x2, S, fc);  // Z1 Y2, Z1 X2
    S.load(1, w);
    add_mod<NW>(t4, t4, w, fc.p2);  // Y1 + Y2Z1
    S.load(0, w);
    add_mod<NW>(t5, t5, w, fc.p2);  // X1 + X2Z1
  }
  S.load(2, t2);  // Z1
  rcb_finish_staged<L, true>(S, t0, t1, t2, t3, t4, t5, b3, fc, emit);
}

// 16-byte loads and stores of NW packed words (16-byte aligned)
template <int NW>
__device__ __forceinline__ void load_words(uint32_t w[NW], const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) {
    uint4 q = v[k];
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
}

template <int NW>
__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t w[NW]) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) v[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

}  // namespace ecw
}  // namespace zk
