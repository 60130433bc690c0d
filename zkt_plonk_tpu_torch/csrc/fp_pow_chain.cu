// K2 fp_pow_chain: elementwise a^e for a fixed exponent e >= 1 (0 -> 0).
//
// Replaces the Pallas kernel zkt_plonk_tpu/fields/pallas.py:_pow_kernel
// (via pow_chain), the square-and-multiply chain behind every Fermat
// inversion (fd.inv, the batch inverse of the prover's z round).
//
// What bounds it on the H100: arithmetic latency.  The chain is ~380
// dependent Montgomery products per element and the prover calls it on a
// single element (the batch inverse's total), so one thread's dependency
// chain is the whole cost; on wide inputs it is integer-multiply-bound.
// Design: one thread per element, the exponent's bits passed by value as
// kernel arguments (no memory traffic), the chain run in Montgomery form
// with one conversion on entry and one on exit.
#include "field.cuh"

namespace zk {

struct ExpBits {
  uint32_t w[16];  // exponent words, little-endian (up to 512 bits)
  int nbits;       // bit length of the exponent
};

template <int L>
__global__ void fp_pow_chain_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                    long long n, ExpBits e, FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t x[NW], xm[NW], acc[NW];
    load_elem<L>(x, a + i * L);
    mont_mul<L>(xm, x, fc.r2, fc);  // x * R
    copy_w<NW>(acc, xm);            // top bit of e is 1
    for (int bit = e.nbits - 2; bit >= 0; --bit) {
      mont_mul<L>(acc, acc, acc, fc);
      if ((e.w[bit >> 5] >> (bit & 31)) & 1u) mont_mul<L>(acc, acc, xm, fc);
    }
    uint32_t one[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) one[j] = j == 0 ? 1u : 0u;
    mont_mul<L>(acc, acc, one, fc);  // leave Montgomery form
    store_elem<L>(out + i * L, acc);
  }
}

}  // namespace zk

extern "C" int zk_fp_pow_chain(int L, const void* a, void* out, long long n,
                               const unsigned* exp_words, int nbits, const unsigned* consts,
                               void* stream) {
  if (n <= 0) return 0;
  if (nbits < 1 || nbits > 512) return (int)cudaErrorInvalidValue;
  zk::ExpBits e;
  for (int k = 0; k < 16; ++k) e.w[k] = k * 32 < nbits ? exp_words[k] : 0u;
  e.nbits = nbits;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 128;
  long long want = (n + threads - 1) / threads;
  int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  if (L == 16) {
    zk::FieldConsts<16> fc = zk::consts_from_host<16>(reinterpret_cast<const uint32_t*>(consts));
    zk::fp_pow_chain_kernel<16><<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(a), static_cast<int32_t*>(out), n, e, fc);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
