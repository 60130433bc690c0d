// K2 fp_pow_chain: elementwise a^e for a fixed exponent e >= 1 (0 -> 0).
//
// Replaces the Pallas kernel zkt_plonk_tpu/fields/pallas.py:_pow_kernel
// (via pow_chain), the square-and-multiply chain behind every Fermat
// inversion (fd.inv, the batch inverse of the prover's z round).
//
// What bounds it on the H100: the latency of one dependent chain.  The
// prover calls it on a single element (the batch inverse's total), so the
// whole cost is one thread's chain of Montgomery products; only wide inputs
// are integer-multiply-bound.  Design, for the length of that chain:
// - a left-to-right sliding window: the wrapper cuts e into odd digits of at
//   most W bits (fields/cuda.py:window_schedule) and passes the schedule by
//   value: the table x, x^3, ..., one multiply per digit and the squarings
//   between digits.  For e = p - 2 of BN254 (W = 4) that is 253 squarings,
//   ~50 multiplies and 8 table products, against 253 + 126 for the binary
//   chain;
// - squarings by a dedicated product (36 word products instead of 64);
// - values lazily below 2p through the chain (p < R/4, checked by the
//   wrapper), one canonicalization at the end; one conversion into
//   Montgomery form on entry (x*R) and one out (mont(acc, 1));
// - a strict instance (STRICT = true) for a field with 2p < R <= 4p
//   (BLS12-381's Fr, 0.453 R), where a product of two values below 2p can
//   exceed pR and the lazy bound fails: every product and squaring is
//   brought below p (one conditional subtraction each), so the table and
//   the accumulator stay canonical.  The wrapper picks the instance from
//   the modulus (fields/cuda.py:pow_chain);
// - a 12-word lazy instance (L = 24) for the BLS12 base fields (4p < R:
//   0.102 R and 0.007 R), whose one call is the inversion of a key's Z
//   column when ops/ec.py normalize builds its Z = 1 copy.
#include "field.cuh"

namespace zk {

constexpr int POW_MAX_STEPS = 512;
constexpr int POW_MAX_TABLE = 16;  // odd powers x^1 .. x^31 (W <= 5)

struct PowSchedule {
  int ntab;    // table entries x^(2i+1), i < ntab
  int first;   // table index of the leading digit
  int nsteps;  // digits after the first
  int tail;    // squarings after the last digit
  uint16_t sq[POW_MAX_STEPS];  // squarings before digit i
  uint8_t dig[POW_MAX_STEPS];  // table index of digit i
};

// T = a^2, 2*NW words: the NW(NW-1)/2 cross products once, doubled, plus the
// NW squares on the diagonal
template <int NW>
__device__ __forceinline__ void wide_sqr(uint32_t T[2 * NW], const uint32_t a[NW]) {
  uint32_t c = 0;
  T[0] = 0;
#pragma unroll
  for (int j = 1; j < NW; ++j) {
    const uint64_t s = (uint64_t)a[0] * a[j] + c;
    T[j] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  T[NW] = c;
#pragma unroll
  for (int i = 1; i < NW - 1; ++i) {
    c = 0;
#pragma unroll
    for (int j = i + 1; j < NW; ++j) {
      const uint64_t s = (uint64_t)a[i] * a[j] + T[i + j] + c;
      T[i + j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    T[i + NW] = c;
  }
  // double the cross products (they are below 2^(64 NW - 1))
  T[2 * NW - 1] = T[2 * NW - 2] >> 31;
#pragma unroll
  for (int k = 2 * NW - 2; k > 0; --k) T[k] = __funnelshift_l(T[k - 1], T[k], 1);
  // T[0] stays 0; add the squares a[i]^2 at words 2i, 2i+1
  uint64_t d = (uint64_t)a[0] * a[0];
  T[0] = ptx::add_cc(T[0], (uint32_t)d);
  T[1] = ptx::addc_cc(T[1], (uint32_t)(d >> 32));
#pragma unroll
  for (int i = 1; i < NW - 1; ++i) {
    d = (uint64_t)a[i] * a[i];
    T[2 * i] = ptx::addc_cc(T[2 * i], (uint32_t)d);
    T[2 * i + 1] = ptx::addc_cc(T[2 * i + 1], (uint32_t)(d >> 32));
  }
  d = (uint64_t)a[NW - 1] * a[NW - 1];
  T[2 * NW - 2] = ptx::addc_cc(T[2 * NW - 2], (uint32_t)d);
  T[2 * NW - 1] = ptx::addc(T[2 * NW - 1], (uint32_t)(d >> 32));
}

// r = a^2 R^-1 mod p: lazily (< 2p for a < 2p, p < R/4), or canonical in
// the STRICT mode (a < p, 2p < R); r may alias a
template <int L, bool STRICT>
__device__ __forceinline__ void mont_sqr(uint32_t r[L / 2], const uint32_t a[L / 2],
                                         const FieldConsts<L>& fc) {
  uint32_t T[L];
  wide_sqr<L / 2>(T, a);
  redc<L>(r, T, fc);
  if constexpr (STRICT) csub<L / 2>(r, r, fc.p);
}

template <int L, bool STRICT>
__global__ void fp_pow_chain_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                    long long n, PowSchedule e, FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t x[NW], acc[NW], x2[NW];
    uint32_t tab[POW_MAX_TABLE][NW];  // x^(2k+1) R, below 2p (below p if STRICT)
    load_elem<L>(x, a + i * L);
    mont_mode<L, STRICT>(tab[0], x, fc.r2, fc);  // x * R
    if (e.ntab > 1) mont_sqr<L, STRICT>(x2, tab[0], fc);
    for (int k = 1; k < e.ntab; ++k) mont_mode<L, STRICT>(tab[k], tab[k - 1], x2, fc);
    copy_w<NW>(acc, tab[e.first]);
    for (int s = 0; s < e.nsteps; ++s) {
      for (int q = e.sq[s]; q > 0; --q) mont_sqr<L, STRICT>(acc, acc, fc);
      mont_mode<L, STRICT>(acc, acc, tab[e.dig[s]], fc);
    }
    for (int q = e.tail; q > 0; --q) mont_sqr<L, STRICT>(acc, acc, fc);
    uint32_t one[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) one[j] = j == 0 ? 1u : 0u;
    mont<L>(acc, acc, one, fc);  // leave Montgomery form: <= p
    csub<NW>(acc, acc, fc.p);
    store_elem<L>(out + i * L, acc);
  }
}

}  // namespace zk

extern "C" int zk_fp_pow_chain(int L, const void* a, void* out, long long n, int ntab, int first,
                               int nsteps, int tail, const unsigned short* sq,
                               const unsigned char* dig, int strict, const unsigned* consts,
                               void* stream) {
  if (n <= 0) return 0;
  if (ntab < 1 || ntab > zk::POW_MAX_TABLE || first < 0 || first >= ntab || nsteps < 0 ||
      nsteps > zk::POW_MAX_STEPS || tail < 0)
    return (int)cudaErrorInvalidValue;
  zk::PowSchedule e;
  e.ntab = ntab;
  e.first = first;
  e.nsteps = nsteps;
  e.tail = tail;
  for (int s = 0; s < zk::POW_MAX_STEPS; ++s) {
    e.sq[s] = s < nsteps ? sq[s] : 0;
    e.dig[s] = s < nsteps ? dig[s] : 0;
    if (e.dig[s] >= ntab) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int threads = n < 128 ? 32 : 128;
  long long want = (n + threads - 1) / threads;
  int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  const int32_t* pa = static_cast<const int32_t*>(a);
  int32_t* po = static_cast<int32_t*>(out);
  const uint32_t* hc = reinterpret_cast<const uint32_t*>(consts);
  if (L == 16) {
    zk::FieldConsts<16> fc = zk::consts_from_host<16>(hc);
    if (strict) {
      zk::fp_pow_chain_kernel<16, true><<<blocks, threads, 0, s>>>(pa, po, n, e, fc);
    } else {
      zk::fp_pow_chain_kernel<16, false><<<blocks, threads, 0, s>>>(pa, po, n, e, fc);
    }
  } else if (L == 24 && !strict) {
    zk::fp_pow_chain_kernel<24, false>
        <<<blocks, threads, 0, s>>>(pa, po, n, e, zk::consts_from_host<24>(hc));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
