// K4 ec_add_complete: complete projective point addition, a = 0 curves.
//
// Replaces the Pallas kernel zkt_plonk_tpu/ops/ec_pallas.py:_add_call
// (body _add_lm_body) wherever the port adds point tensors outside the MSM's
// bucket accumulation (group merges, suffix scans, fixed-base MSM); the
// accumulation itself is K4a (ec_bucket_accumulate.cu), on the same
// arithmetic.  Renes-Costello-Batina 2015, Algorithm 7 with a = 0, valid for
// every input pair (identity, doubling, P + (-P)).  Points are (X : Y : Z)
// with canonical 16-bit limbs, (..., 3, L) int32; the output is the same
// projective limbs as zkt_plonk_tpu/ops/ec.py:add, because every coordinate
// is the same canonical field element.
//
// What bounds it on the H100: integer multiplies.  One addition moves
// 2 x 192 B in and 192 B out and needs 12 products and 9 reductions
// (~2,760 32-bit multiplies), ~5 multiplies per byte, far right of the
// ridge.  Design: one thread per point pair with every intermediate in
// registers, the shared rcb_add of ec.cuh (the word arithmetic of
// field.cuh, lazy reduction, layer 3 as three sums of products with one
// reduction each), and no Montgomery conversion of the six inputs: rcb_add
// on canonical values returns the coordinates times R^-3, and one product
// by R^4 per coordinate cancels it (15 products, 12 reductions).  3b is a
// small integer (9 on BN254, 12 on BLS12-381, 3 on BLS12-377) applied by
// double-and-add.  Two instances: L = 16 (BN254's Fq, 8 words) and L = 24
// (the BLS12 base fields, 12 words; their p/R is 0.102 and 0.007 at
// R = 2^384, below BN254's 0.189, so ec.cuh's lazy bounds hold for them).
// The 12-word one stages its two points in shared memory and runs ec.cuh's
// rcb_add_staged (products interleaved with their reductions, row operands
// read from shared memory in a loop that is not unrolled), and the R^4
// products interleaved too (mont_cios): at __launch_bounds__(128, 4) ptxas
// fits it in 128 registers with no spills, 4 blocks per SM, where the
// register form took 188 and 2 blocks (PERF.md).
#include "ec.cuh"

namespace zk {

constexpr int ADD_THREADS = 128;

// The 12-word instance stages the two input points in shared memory
// (ecw::rcb_add_staged); the 8-word one keeps them in registers.
template <int L>
constexpr bool add_staged = L == 24;

template <int L>
__global__ void __launch_bounds__(ADD_THREADS)
    ec_add_complete_kernel(const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                           int32_t* __restrict__ out, long long n, Bcast bc, int b3,
                           FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long oa, ob;
    bcast_offsets(bc, i, oa, ob);
    const int32_t* P = pa + oa * 3 * L;
    const int32_t* Q = pb + ob * 3 * L;
    uint32_t X1[NW], Y1[NW], Z1[NW], X2[NW], Y2[NW], Z2[NW];
    load_elem<L>(X1, P);
    load_elem<L>(Y1, P + L);
    load_elem<L>(Z1, P + 2 * L);
    load_elem<L>(X2, Q);
    load_elem<L>(Y2, Q + L);
    load_elem<L>(Z2, Q + 2 * L);
    uint32_t X3[NW], Y3[NW], Z3[NW];
    ecw::rcb_add<L>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, b3, fc);
    // times R^4: below p^2/R + p < 2p, one subtraction makes it canonical
    mont_mul<L>(X1, X3, fc.r4, fc);
    store_elem<L>(out + i * 3 * L, X1);
    mont_mul<L>(Y1, Y3, fc.r4, fc);
    store_elem<L>(out + i * 3 * L + L, Y1);
    mont_mul<L>(Z1, Z3, fc.r4, fc);
    store_elem<L>(out + i * 3 * L + 2 * L, Z1);
  }
}

template <int L>
__global__ void __launch_bounds__(ADD_THREADS, 4)
    ec_add_staged_kernel(const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                         int32_t* __restrict__ out, long long n, Bcast bc, int b3,
                         FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  __shared__ uint4 stage[ecw::STAGED_VALUES * (NW / 4) * ADD_THREADS];
  const ecw::Staged<NW> st{stage + threadIdx.x, ADD_THREADS};
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long oa, ob;
    bcast_offsets(bc, i, oa, ob);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t w[NW];
      load_elem<L>(w, pa + (oa * 3 + c) * L);
      st.store(c, w);
      load_elem<L>(w, pb + (ob * 3 + c) * L);
      st.store(3 + c, w);
    }
    int32_t* o = out + i * 3 * L;
    ecw::rcb_add_staged<L>(st, b3, fc, [&](int c, const uint32_t* w) {
      uint32_t r[NW];  // times R^4, as in ec_add_complete_kernel
      mont_cios<L>(r, w, fc.r4, fc);
      csub<NW>(r, r, fc.p);
      store_elem<L>(o + c * L, r);
    });
  }
}

// the add kernel of the instance at L limbs
template <int L>
auto add_kernel() {
  if constexpr (add_staged<L>) {
    return ec_add_staged_kernel<L>;
  } else {
    return ec_add_complete_kernel<L>;
  }
}

template <int L>
int launch_add(const int32_t* p, const int32_t* q, int32_t* out, long long n, const Bcast& bc,
               int b3, const uint32_t* consts, cudaStream_t s) {
  FieldConsts<L> fc = consts_from_host<L>(consts);
  long long want = (n + ADD_THREADS - 1) / ADD_THREADS;
  int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  add_kernel<L>()<<<blocks, ADD_THREADS, 0, s>>>(p, q, out, n, bc, b3, fc);
  return (int)cudaGetLastError();
}

template <int L>
int occupancy(int* blocks, int* registers) {
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, add_kernel<L>(), ADD_THREADS, 0);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, add_kernel<L>());
  if (e == cudaSuccess) *registers = attr.numRegs;
  return (int)e;
}

}  // namespace zk

// resident blocks of ADD_THREADS threads per SM, and registers per thread,
// of the add kernel at L limbs
extern "C" int zk_ec_add_complete_occupancy(int L, int* blocks, int* registers) {
  if (L == 16) return zk::occupancy<16>(blocks, registers);
  if (L == 24) return zk::occupancy<24>(blocks, registers);
  return (int)cudaErrorInvalidValue;
}

extern "C" int zk_ec_add_complete(int L, const void* p, const void* q, void* out, long long n,
                                  int nd, const long long* shape, const long long* sa,
                                  const long long* sb, int b3, const unsigned* consts,
                                  void* stream) {
  if (n <= 0) return 0;
  if (nd < 1 || nd > zk::MAXD || b3 < 0 || b3 > 255) return (int)cudaErrorInvalidValue;
  zk::Bcast bc = zk::bcast_from_host(nd, shape, sa, sb);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* pp = static_cast<const int32_t*>(p);
  const int32_t* pq = static_cast<const int32_t*>(q);
  int32_t* po = static_cast<int32_t*>(out);
  const uint32_t* hc = reinterpret_cast<const uint32_t*>(consts);
  if (L == 16) return zk::launch_add<16>(pp, pq, po, n, bc, b3, hc, s);
  if (L == 24) return zk::launch_add<24>(pp, pq, po, n, bc, b3, hc, s);
  return (int)cudaErrorInvalidValue;
}
