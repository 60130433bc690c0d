// K6 ec_bucket_merge: the MSM's group merge, each bucket column summed over
// its groups by one thread.
//
// Replaces the pairwise-halving merge of zkt_plonk_tpu/ops/msm.py:72-88
// (_tree_reduce_points), each of whose log2 G levels is a call of the
// Pallas add zkt_plonk_tpu/ops/ec_pallas.py:_add_call, written out and read
// back by the next level.
//
// In: (G, BW, K, 3, L) buckets of canonical 16-bit limbs, as K4a writes
// them.  Out: (C, BW, K, 3, L), where chunk j of C holds, for each bucket
// column (bw, k >= 1), the sum of the column's groups floor(j G / C) ..
// floor((j + 1) G / C) - 1, added in group order; row k = 0, which the MSM
// never weights, is written as the identity and never read.  The wrapper
// (ops/msm.py bucket_merge) launches it with C chunks and, where C > 1, once
// more with one chunk over the C partial sums.
//
// No Montgomery conversion.  The complete add on a = 0 curves (ec.cuh
// rcb_add) is homogeneous, and canonical words read as Montgomery words
// are the coordinates times R^-1: the same projective point.  So a chain
// adds the buckets' words as they are, 12 products and 9 reductions an add
// (K4 adds the R^4 fix-up that makes each of its outputs the canonical
// limbs of the formula, 15 and 12), and writes the canonical words of its
// sum: another representative of the same point, all that the suffix scan
// after it needs.  ops/msm.py bucket_merge_plain computes the same words.
//
// What bounds it on the H100: integer multiplies.  An add reads one bucket,
// 192 B at L = 16 and 288 B at L = 24, against ~2,760 and ~6,156 32-bit
// multiplies, far right of the ridge.  Design:
// * a thread owns one column of one chunk and keeps its running sum on the
//   SM (in registers at 8 words, in its shared-memory stage at 12), so each
//   bucket is read once and each sum written once, in one launch;
// * thread t takes column t mod BW (K - 1) of chunk t / BW (K - 1): a warp's
//   lanes take neighbouring columns of one group, so a step's loads of the
//   warp lie in one contiguous run of 32 buckets, and its lanes share their
//   chain length;
// * the chunk count C (ops/msm.py merge_chunks) fills one wave of the
//   instance's resident threads (164 and 158 registers, 3 blocks of 128
//   per SM), or is sqrt(G) where the columns are few; the second launch
//   chains C - 1 adds a column;
// * the 12-word instance (the BLS12 base fields) stages the sum and the
//   bucket in shared memory and runs ec.cuh's rcb_add_staged with its
//   first two products paired and the others unrolled, as K4a's staged
//   mixed add does.
#include "ec.cuh"

namespace zk {

constexpr int MERGE_THREADS = 128;

// The 12-word instance stages its operands in shared memory
template <int L>
constexpr bool merge_staged = L == 24;

// (0 : 1 : 0) as canonical limbs
template <int L>
__device__ __forceinline__ void store_identity(int32_t* dst) {
  int4* v = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < 3 * L / 4; ++q) v[q] = make_int4(q == L / 4 ? 1 : 0, 0, 0, 0);
}

// the sum of the n points at src, src + stride, ... (canonical limbs, in
// that order) written to dst, with the sum in registers
template <int L>
__device__ __forceinline__ void merge_chain(const int32_t* src, long long stride, int n,
                                            int32_t* dst, int b3, const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t X[NW], Y[NW], Z[NW];
  load_elem<L>(X, src);
  load_elem<L>(Y, src + L);
  load_elem<L>(Z, src + 2 * L);
  for (int i = 1; i < n; ++i) {
    src += stride;
    uint32_t X2[NW], Y2[NW], Z2[NW], X3[NW], Y3[NW], Z3[NW];
    load_elem<L>(X2, src);
    load_elem<L>(Y2, src + L);
    load_elem<L>(Z2, src + 2 * L);
    ecw::rcb_add<L>(X3, Y3, Z3, X, Y, Z, X2, Y2, Z2, b3, fc);
    copy_w<NW>(X, X3);
    copy_w<NW>(Y, Y3);
    copy_w<NW>(Z, Z3);
  }
  store_elem<L>(dst, X);
  store_elem<L>(dst + L, Y);
  store_elem<L>(dst + 2 * L, Z);
}

// merge_chain with the sum in staged values 0-2 and the bucket in 3-5
// (ecw::rcb_add_staged's slots)
template <int L>
__device__ __forceinline__ void merge_chain_staged(const int32_t* src, long long stride, int n,
                                                   int32_t* dst, int b3,
                                                   const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  constexpr int SPARE = ecw::STAGED_VALUES - 1;  // the sum slot of layer 1, free in layer 3
  __shared__ uint4 stage[ecw::STAGED_VALUES * (NW / 4) * MERGE_THREADS];
  const ecw::Staged<NW> st{stage + threadIdx.x, MERGE_THREADS};
  auto load = [&](int v) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t w[NW];
      load_elem<L>(w, src + c * L);
      st.store(v + c, w);
    }
  };
  load(0);
  for (int i = 1; i < n; ++i) {
    src += stride;
    load(3);
    // The sum back into values 0-2.  rcb_finish_staged emits X3 while layer
    // 3 still reads value 0, so X3 waits in the spare value; Y3 and Z3 go
    // straight to 1 and 2, which nothing reads after their own emission.
    ecw::rcb_add_staged<L, true>(st, b3, fc, [&](int c, const uint32_t* w) {
      st.store(c == 0 ? SPARE : c, w);
    });
#pragma unroll
    for (int q = 0; q < NW / 4; ++q)
      ptx::st_shared_v4(st.quad(0, q), ptx::ld_shared_v4(st.quad(SPARE, q)));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    uint32_t w[NW];
    st.load(c, w);
    store_elem<L>(dst + c * L, w);
  }
}

// the kernel's name is what device traces of K6 match
template <int L>
__global__ void __launch_bounds__(MERGE_THREADS, 3)
    ec_bucket_merge_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int G,
                           int C, int BW, int K, int b3, FieldConsts<L> fc) {
  constexpr int SLOT = 3 * L;
  const long long cols = (long long)BW * (K - 1);
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= C * cols) return;
  const int j = (int)(t / cols);
  const long long col = t - j * cols;
  const int bw = (int)(col / (K - 1));
  const int k = 1 + (int)(col - (long long)bw * (K - 1));
  const int g0 = (int)((long long)j * G / C);
  const int g1 = (int)((long long)(j + 1) * G / C);
  const long long stride = (long long)BW * K * SLOT;  // one group
  const int32_t* src = in + g0 * stride + ((long long)bw * K + k) * SLOT;
  int32_t* dst = out + (((long long)j * BW + bw) * K + k) * SLOT;
  if (k == 1) store_identity<L>(dst - SLOT);
  if constexpr (merge_staged<L>) {
    merge_chain_staged<L>(src, stride, g1 - g0, dst, b3, fc);
  } else {
    merge_chain<L>(src, stride, g1 - g0, dst, b3, fc);
  }
}

}  // namespace zk

// in (G, BW, K, 3, L) canonical limbs -> out (C, BW, K, 3, L), 1 <= C <= G
extern "C" int zk_ec_bucket_merge(int L, const void* in, void* out, int G, int C, int BW, int K,
                                  int b3, const unsigned* consts, void* stream) {
  if (G < 1 || C < 1 || C > G || BW < 1 || K < 2 || b3 < 0 || b3 > 255 ||
      (L != 16 && L != 24))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      ((long long)C * BW * (K - 1) + zk::MERGE_THREADS - 1) / zk::MERGE_THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* src = static_cast<const int32_t*>(in);
  int32_t* dst = static_cast<int32_t*>(out);
  const uint32_t* hc = reinterpret_cast<const uint32_t*>(consts);
  if (L == 16) {
    zk::ec_bucket_merge_kernel<16><<<(unsigned)blocks, zk::MERGE_THREADS, 0, s>>>(
        src, dst, G, C, BW, K, b3, zk::consts_from_host<16>(hc));
  } else {
    zk::ec_bucket_merge_kernel<24><<<(unsigned)blocks, zk::MERGE_THREADS, 0, s>>>(
        src, dst, G, C, BW, K, b3, zk::consts_from_host<24>(hc));
  }
  return (int)cudaGetLastError();
}

namespace zk {

template <int L>
int merge_occupancy(int* blocks, int* registers) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ec_bucket_merge_kernel<L>, MERGE_THREADS, 0);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ec_bucket_merge_kernel<L>);
  if (e == cudaSuccess) *registers = attr.numRegs;
  return (int)e;
}

}  // namespace zk

// resident blocks of MERGE_THREADS threads per SM, and registers per
// thread, of the merge kernel at L limbs
extern "C" int zk_ec_bucket_merge_occupancy(int L, int* blocks, int* registers) {
  if (L == 16) return zk::merge_occupancy<16>(blocks, registers);
  if (L == 24) return zk::merge_occupancy<24>(blocks, registers);
  return (int)cudaErrorInvalidValue;
}
