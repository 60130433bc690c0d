// Prime-field arithmetic shared by the port's CUDA kernels.
//
// Boundary layout (the JAX package's convention): a field element is L
// canonical 16-bit limbs, little-endian, one per int32 word, so an element
// occupies 4*L bytes and tensors are (..., L) int32.  Inside a kernel the
// element is repacked into NW = L/2 32-bit words and multiplied with
// Montgomery CIOS (R = 2^(32*NW)); add and sub work on canonical words.
//
// A kernel never leaves Montgomery form visible: a canonical product is
// mont(mont(a, b), R^2) = a*b, and longer chains either convert once on
// entry (x*R = mont(x, R^2)) and once on exit (mont(x, 1)), or track the
// power of R^-1 they accumulate and cancel it with one multiply by R^k.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zk {

template <int L>
struct FieldConsts {
  static constexpr int NW = L / 2;
  uint32_t p[NW];   // modulus
  uint32_t r2[NW];  // R^2 mod p
  uint32_t r4[NW];  // R^4 mod p
  uint32_t pinv;    // -p^-1 mod 2^32
};

// Host helper: the wrapper passes p, R^2, R^4 (NW words each) and pinv
// as one flat uint32 array.
template <int L>
inline FieldConsts<L> consts_from_host(const uint32_t* h) {
  constexpr int NW = L / 2;
  FieldConsts<L> fc;
  for (int i = 0; i < NW; ++i) {
    fc.p[i] = h[i];
    fc.r2[i] = h[NW + i];
    fc.r4[i] = h[2 * NW + i];
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
// word arithmetic
// ---------------------------------------------------------------------------

template <int NW>
__device__ __forceinline__ void copy_w(uint32_t r[NW], const uint32_t a[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = a[j];
}

// d = a - b, returns the borrow out (0/1)
template <int NW>
__device__ __forceinline__ uint32_t sub_words(uint32_t d[NW], const uint32_t a[NW],
                                              const uint32_t b[NW]) {
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a[j] - (uint64_t)b[j] - (uint64_t)br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  return br;
}

// d = a + b, returns the carry out (0/1)
template <int NW>
__device__ __forceinline__ uint32_t add_words(uint32_t d[NW], const uint32_t a[NW],
                                              const uint32_t b[NW]) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a[j] + (uint64_t)b[j] + (uint64_t)c;
    d[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  return c;
}

// r = a + b mod p (a, b canonical); r may alias a or b
template <int L>
__device__ __forceinline__ void fadd(uint32_t r[L / 2], const uint32_t a[L / 2],
                                     const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t s[NW], d[NW];
  uint32_t c = add_words<NW>(s, a, b);
  uint32_t br = sub_words<NW>(d, s, fc.p);
  bool ge = c || !br;
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = ge ? d[j] : s[j];
}

// r = a - b mod p (a, b canonical); 0 - 0 = 0
template <int L>
__device__ __forceinline__ void fsub(uint32_t r[L / 2], const uint32_t a[L / 2],
                                     const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t d[NW], e[NW];
  uint32_t br = sub_words<NW>(d, a, b);
  add_words<NW>(e, d, fc.p);
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = br ? e[j] : d[j];
}

// r = a * b * R^-1 mod p (CIOS), for a, b < p; r may alias a or b
template <int L>
__device__ __forceinline__ void mont_mul(uint32_t r[L / 2], const uint32_t a[L / 2],
                                         const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a[i] * b[j] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + carry;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * fc.pinv;
    s = (uint64_t)m * fc.p[0] + t[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * fc.p[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = s >> 32;
    }
    s = (uint64_t)t[NW] + carry;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  // t < 2p: one conditional subtraction
  uint32_t d[NW];
  uint32_t br = sub_words<NW>(d, t, fc.p);
  bool ge = (t[NW] != 0) || !br;
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = ge ? d[j] : t[j];
}

// canonical a*b mod p
template <int L>
__device__ __forceinline__ void fmul(uint32_t r[L / 2], const uint32_t a[L / 2],
                                     const uint32_t b[L / 2], const FieldConsts<L>& fc) {
  uint32_t t[L / 2];
  mont_mul<L>(t, a, b, fc);
  mont_mul<L>(r, t, fc.r2, fc);
}

// r = v * x mod p for a small non-negative integer v (double-and-add)
template <int L>
__device__ __forceinline__ void fmul_small(uint32_t r[L / 2], const uint32_t x[L / 2], int v,
                                           const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = 0;
  int top = 31 - __clz(v > 0 ? v : 1);
  for (int bit = top; bit >= 0; --bit) {
    fadd<L>(acc, acc, acc, fc);
    if ((v >> bit) & 1) fadd<L>(acc, acc, x, fc);
  }
  copy_w<NW>(r, acc);
}

inline int launch_blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace zk
