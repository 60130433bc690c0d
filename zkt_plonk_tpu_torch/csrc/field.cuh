// Prime-field arithmetic shared by the port's CUDA kernels.
//
// Boundary layout (the JAX package's convention): a field element is L
// canonical 16-bit limbs, little-endian, one per int32 word, so an element
// occupies 4*L bytes and tensors are (..., L) int32.  Inside a kernel the
// element is repacked into NW = L/2 32-bit words and multiplied in
// Montgomery form (R = 2^(32*NW)); add and sub work on canonical words.
//
// A kernel never leaves Montgomery form visible: a canonical product is
// mont(mont(a, b), R^2) = a*b, and longer chains either convert once on
// entry (x*R = mont(x, R^2)) and once on exit (mont(x, 1)), or track the
// power of R^-1 they accumulate and cancel it with one multiply by R^k.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace zk {

template <int L>
struct FieldConsts {
  static constexpr int NW = L / 2;
  uint32_t p[NW];   // modulus
  uint32_t r2[NW];  // R^2 mod p
  uint32_t r4[NW];  // R^4 mod p
  uint32_t pinv;    // -p^-1 mod 2^32
  uint32_t p2[NW];  // 2p (below R for every field the kernels take)
  uint32_t rm[NW];  // R mod p, the Montgomery form of 1
};

// Host helper: the wrapper passes p, R^2, R^4 (NW words each), pinv, 2p
// and R mod p (NW words each) as one flat uint32 array.
template <int L>
inline FieldConsts<L> consts_from_host(const uint32_t* h) {
  constexpr int NW = L / 2;
  FieldConsts<L> fc;
  for (int i = 0; i < NW; ++i) {
    fc.p[i] = h[i];
    fc.r2[i] = h[NW + i];
    fc.r4[i] = h[2 * NW + i];
    fc.p2[i] = h[3 * NW + 1 + i];
    fc.rm[i] = h[4 * NW + 1 + i];
  }
  fc.pinv = h[3 * NW];
  return fc;
}

// Broadcast indexing: up to MAXD outer dims; strides in ELEMENTS (units of
// the element size, L int32 for a field element, 3L for a point).
constexpr int MAXD = 6;
struct Bcast {
  int nd;
  long long shape[MAXD];
  long long sa[MAXD];
  long long sb[MAXD];
};

inline Bcast bcast_from_host(int nd, const long long* shape, const long long* sa,
                             const long long* sb) {
  Bcast bc;
  bc.nd = nd;
  for (int d = 0; d < MAXD; ++d) {
    bc.shape[d] = d < nd ? shape[d] : 1;
    bc.sa[d] = d < nd ? sa[d] : 0;
    bc.sb[d] = d < nd ? sb[d] : 0;
  }
  return bc;
}

__device__ __forceinline__ void bcast_offsets(const Bcast& bc, long long i,
                                              long long& oa, long long& ob) {
  oa = 0;
  ob = 0;
  long long rem = i;
  for (int d = bc.nd - 1; d >= 0; --d) {
    long long s = bc.shape[d];
    long long idx = rem % s;
    rem /= s;
    oa += idx * bc.sa[d];
    ob += idx * bc.sb[d];
  }
}

// ---------------------------------------------------------------------------
// load / store between 16-bit-limb int32 layout and 32-bit words
// ---------------------------------------------------------------------------

template <int L>
__device__ __forceinline__ void load_elem(uint32_t w[L / 2], const int32_t* src) {
  const int4* v = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int k = 0; k < L / 4; ++k) {
    int4 q = v[k];
    w[2 * k] = (uint32_t)q.x | ((uint32_t)q.y << 16);
    w[2 * k + 1] = (uint32_t)q.z | ((uint32_t)q.w << 16);
  }
}

template <int L>
__device__ __forceinline__ void store_elem(int32_t* dst, const uint32_t w[L / 2]) {
  int4* v = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int k = 0; k < L / 4; ++k) {
    int4 q;
    q.x = (int32_t)(w[2 * k] & 0xFFFFu);
    q.y = (int32_t)(w[2 * k] >> 16);
    q.z = (int32_t)(w[2 * k + 1] & 0xFFFFu);
    q.w = (int32_t)(w[2 * k + 1] >> 16);
    v[k] = q;
  }
}

// ---------------------------------------------------------------------------
// word arithmetic, the one set every kernel uses
//
// Sums, differences and the reductions' final sums are carry chains in
// inline PTX (ptx.cuh).  Word products are 64-bit multiply-adds in C, which
// ptxas issues as IMAD.WIDE; the same products written as PTX mad.lo.cc /
// madc.hi.cc chains compiled to a multiply plus a carry add per word and
// made the EC kernels take 11-17% longer (PERF.md).  A Montgomery product is
// a full 2*NW-word product (wide_mul) and a separate reduction (redc), so a
// sum of two products can share one reduction (ec.cuh), or, where registers
// are short (the EC kernels at 12 words), the same product interleaved with
// its reduction row by row (mont_row).  Every field the kernels take has
// 2p < R (checked by the wrappers, _cuda.field_consts).
// ---------------------------------------------------------------------------

template <int NW>
__device__ __forceinline__ void copy_w(uint32_t r[NW], const uint32_t a[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = a[j];
}

// r = a + b; the caller guarantees a + b < 2^(32*NW)
template <int NW>
__device__ __forceinline__ void add_nr(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  r[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r[j] = ptx::addc_cc(a[j], b[j]);
  r[NW - 1] = ptx::addc(a[NW - 1], b[NW - 1]);
}

// r = x - m if x >= m, else x; r may alias x
template <int NW>
__device__ __forceinline__ void csub(uint32_t r[NW], const uint32_t x[NW], const uint32_t m[NW]) {
  uint32_t d[NW];
  d[0] = ptx::sub_cc(x[0], m[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = ptx::subc_cc(x[j], m[j]);
  const uint32_t under = ptx::subc(0, 0);  // all ones if x < m
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = under ? x[j] : d[j];
}

// r = a + b mod m for a, b < m and 2m <= 2^(32*NW); r may alias a or b
template <int NW>
__device__ __forceinline__ void add_mod(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW],
                                        const uint32_t m[NW]) {
  uint32_t s[NW];
  add_nr<NW>(s, a, b);
  csub<NW>(r, s, m);
}

// r = a - b mod m for a, b < m; r may alias a or b
template <int NW>
__device__ __forceinline__ void sub_mod(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW],
                                        const uint32_t m[NW]) {
  uint32_t d[NW];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = ptx::subc_cc(a[j], b[j]);
  const uint32_t under = ptx::subc(0, 0);
  r[0] = ptx::add_cc(d[0], m[0] & under);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r[j] = ptx::addc_cc(d[j], m[j] & under);
  r[NW - 1] = ptx::addc(d[NW - 1], m[NW - 1] & under);
}

// T = a * b, 2*NW words, by rows: each word product is one 32x32+32+32
// -> 64-bit multiply-add (IMAD.WIDE), which cannot overflow
template <int NW>
__device__ __forceinline__ void wide_mul(uint32_t T[2 * NW], const uint32_t a[NW],
                                         const uint32_t b[NW]) {
  // row 0 on its own: folding it into the loop below as "+ (i ? T[i + j] :
  // 0)" made ptxas emit ~10% more instructions
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t s = (uint64_t)a[0] * b[j] + c;
    T[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  T[NW] = c;
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = (uint64_t)a[i] * b[j] + T[i + j] + c;
      T[i + j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    T[i + NW] = c;
  }
}

// r = T * R^-1 mod p without the final subtraction: r < T/R + p.  Needs
// T/R + p < R.
template <int L>
__device__ __forceinline__ void redc(uint32_t r[L / 2], const uint32_t T[L],
                                     const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  // u = T_lo + M*p, M chosen word by word so that u's low half is zero;
  // after row i, u < R + p*2^(32(i+1)) fits words 0 .. i+NW
  uint32_t u[2 * NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) u[j] = T[j];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = u[i] * fc.pinv;
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = (uint64_t)m * fc.p[j] + u[i + j] + c;
      u[i + j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    u[i + NW] = c;
  }
  // r = T_hi + u_hi = (T + M*p) / R
  r[0] = ptx::add_cc(T[NW], u[NW]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r[j] = ptx::addc_cc(T[NW + j], u[NW + j]);
  r[NW - 1] = ptx::addc(T[2 * NW - 1], u[2 * NW - 1]);
}

// Montgomery products interleaved with their reduction row by row (CIOS)
// on NW + 1 words of sum t: no 2*NW-word product array, so a 12-word
// product holds 13 words of sum beside its operands.  Row i adds a_i*b
// [+ c_i*d] and then the multiple m*p that clears word 0, and shifts t
// down one word; a sum of two products takes one reduction.  Bounds, for
// a, c < R and b, d <= 2p: before row i, t < b + d + p, and a row adds
// below 2^32 (b + d + p), so NW + 1 words hold it while 5p < R (checked by
// _cuda.ec_field_consts).  After NW rows t = (a*b + c*d + M*p) / R < (a*b +
// c*d)/R + p, for the one M < R that makes the sum divisible by R: word
// for word redc(wide_mul(a, b) [+ wide_mul(c, d)]), below (2p)^2/R + p < 2p
// for one product of values below 2p, below 8p^2/R + p for a sum.
template <int L, bool SUM>
__device__ __forceinline__ void mont_row(uint32_t t[L / 2 + 1], uint32_t ai,
                                         const uint32_t b[L / 2], uint32_t ci,
                                         const uint32_t d[L / 2], const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t cy = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t s = (uint64_t)ai * b[j] + t[j] + cy;
    t[j] = (uint32_t)s;
    cy = (uint32_t)(s >> 32);
  }
  t[NW] += cy;
  if constexpr (SUM) {
    cy = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = (uint64_t)ci * d[j] + t[j] + cy;
      t[j] = (uint32_t)s;
      cy = (uint32_t)(s >> 32);
    }
    t[NW] += cy;
  }
  const uint32_t m = t[0] * fc.pinv;
  cy = (uint32_t)(((uint64_t)m * fc.p[0] + t[0]) >> 32);
#pragma unroll
  for (int j = 1; j < NW; ++j) {
    const uint64_t s = (uint64_t)m * fc.p[j] + t[j] + cy;
    t[j - 1] = (uint32_t)s;
    cy = (uint32_t)(s >> 32);
  }
  const uint64_t s = (uint64_t)t[NW] + cy;
  t[NW - 1] = (uint32_t)s;
  t[NW] = (uint32_t)(s >> 32);
}

// r = a * b * R^-1 mod p lazily (r < 2p for a, b < 2p), by rows
template <int L>
__device__ __forceinline__ void mont_cios(uint32_t r[L / 2], const uint32_t a[L / 2],
                                          const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t t[NW + 1];
#pragma unroll
  for (int j = 0; j <= NW; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) mont_row<L, false>(t, a[i], b, 0u, b, fc);
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = t[j];
}

// r = a * b * R^-1 mod p, lazily: r < a*b/R + p (< 2p for a*b < pR);
// r may alias a or b
template <int L>
__device__ __forceinline__ void mont(uint32_t r[L / 2], const uint32_t a[L / 2],
                                     const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  uint32_t T[L];
  wide_mul<L / 2>(T, a, b);
  redc<L>(r, T, fc);
}

// r = a * b * R^-1 mod p, canonical, for a*b < pR (a, b canonical); r may
// alias a or b
template <int L>
__device__ __forceinline__ void mont_mul(uint32_t r[L / 2], const uint32_t a[L / 2],
                                         const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  mont<L>(r, a, b, fc);
  csub<L / 2>(r, r, fc.p);
}

// The two reduction modes of K2 and K3.  Lazy (STRICT = false, for 4p < R:
// BN254's Fr, BLS12-377's Fr): values below 2p, products without the final
// subtraction, sums reduced by 2p.  Strict (STRICT = true, for a field with
// 2p < R <= 4p: BLS12-381's Fr, where (2p)^2 >= pR): values below p, every
// product and sum brought below p.  mont_mode is the product of the mode.
template <int L, bool STRICT>
__device__ __forceinline__ void mont_mode(uint32_t r[L / 2], const uint32_t a[L / 2],
                                          const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  if constexpr (STRICT) {
    mont_mul<L>(r, a, b, fc);
  } else {
    mont<L>(r, a, b, fc);
  }
}

// r = a + b mod p (a, b canonical); r may alias a or b
template <int L>
__device__ __forceinline__ void fadd(uint32_t r[L / 2], const uint32_t a[L / 2],
                                     const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  add_mod<L / 2>(r, a, b, fc.p);
}

// r = a - b mod p (a, b canonical); 0 - 0 = 0
template <int L>
__device__ __forceinline__ void fsub(uint32_t r[L / 2], const uint32_t a[L / 2],
                                     const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  sub_mod<L / 2>(r, a, b, fc.p);
}

// canonical a*b mod p
template <int L>
__device__ __forceinline__ void fmul(uint32_t r[L / 2], const uint32_t a[L / 2],
                                     const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  uint32_t t[L / 2];
  mont_mul<L>(t, a, b, fc);
  mont_mul<L>(r, t, fc.r2, fc);
}

}  // namespace zk
