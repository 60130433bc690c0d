// K4a ec_bucket_accumulate: the MSM's grouped bucket accumulation for a
// batch of scalar vectors over one point set, in one launch.
//
// Replaces the Pallas kernel zkt_plonk_tpu/ops/ec_pallas.py:_add_call as
// driven by the fori_loop of zkt_plonk_tpu/ops/msm.py:_accumulate (lines
// 235-252): each of G groups owns a private row of K buckets per window;
// step j adds point j*G + g, negated for a negative digit, into bucket
// |digit| of row (g, bw).  Here one thread owns one row (g, bw) and walks
// the S = n_pad / G steps itself: it loads its digit and point, adds into
// its bucket, and writes the bucket back in place.  Rows are disjoint, so
// there are no atomics and no ordering between threads, and the steps run
// in the reference's order, so the buckets are bit for bit the ones of the
// per-step loop (msm.bucket_accumulate_plain).
//
// What bounds it on the H100: integer multiplies (12 products and 9
// reductions per add, B*W*n_pad adds).  Design:
// * the whole accumulation is Montgomery form: a first kernel converts the
//   points once to packed NW-word Montgomery values (identity rows for the
//   padding), the buckets start as the Montgomery identity, and the shared
//   rcb_add of ec.cuh needs no R^4 corrections (12 products, 9
//   reductions); each thread converts its row to canonical 16-bit limbs
//   after its last step, in place;
// * a bucket lives in its output slot of 3*L words, the Montgomery words in
//   the first half, so the packed form halves the bytes per add (96 B read
//   and written per bucket, 96 B per point) and no scratch is allocated for
//   the buckets;
// * g varies fastest across a warp: the 32 threads read 32 consecutive
//   points (3 KB, coalesced) and 32 consecutive int16 digits; their bucket
//   accesses are scattered whatever the order, since the digits differ.
//   With bw fastest the point read would be a broadcast, but the digits
//   (BW, n_pad) would be 32 separate rows;
// * digits are int16 codes: |d| for d >= 0 and ~|d| for a negative digit,
//   so a negative zero (a window of 2^c after the carry) keeps its sign;
// * a step loads its bucket only after the previous step stored it, so
//   equal digits on consecutive steps need no forwarding; the step's loads
//   are short next to its twelve products, and other warps cover them;
// * __launch_bounds__(128) with no minimum of blocks: ptxas gives the
//   8-word instance 142 registers and no spills (3 blocks per SM); asking
//   for 4 blocks makes it spill;
// * the 12-word instance (the BLS12 base fields) runs the formula shaped
//   for the register file, ec.cuh's rcb_add_staged: the step's bucket and
//   point go to shared memory (7 values of 48 B per thread with the
//   formula's scratch, 42 KB per block), each product is interleaved with
//   its reduction and reads its row operands from there a quad at a time,
//   in a loop the compiler does not unroll.  ptxas gives it 126 registers
//   and no spills, so 4 blocks fit on an SM (the same code held in
//   registers took 240 and 2 blocks); the same staging at 8 words took
//   longer than the register form, so that instance keeps it (PERF.md).
#include "ec.cuh"

namespace zk {

constexpr int ACC_THREADS = 128;

// pm[i] = Montgomery form of point i (canonical words), identity for i >= n
template <int L>
__global__ void to_montgomery_kernel(const int32_t* __restrict__ pts, long long n,
                                     long long n_pad, uint32_t* __restrict__ pm,
                                     FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < 3 * n_pad;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t x[NW], y[NW];
    if (i < 3 * n) {
      load_elem<L>(x, pts + i * L);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) x[j] = (j == 0 && i % 3 == 1) ? 1u : 0u;  // (0 : 1 : 0)
    }
    mont_mul<L>(y, x, fc.r2, fc);  // x*R
    ecw::store_words<NW>(pm + i * NW, y);
  }
}

// The 12-word instance stages each step's bucket and point in shared memory
// (ecw::rcb_add_staged); the 8-word one keeps them in registers.
template <int L>
constexpr bool acc_staged = L == 24;

template <int L>
__global__ void __launch_bounds__(ACC_THREADS)
    bucket_accumulate_kernel(const uint32_t* __restrict__ pm, const int16_t* __restrict__ digits,
                             int32_t* __restrict__ out, int G, int BW, int K, long long S, int b3,
                             FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  constexpr int SLOT = 3 * L;  // words per bucket slot of the output
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= (long long)G * BW) return;
  const int g = (int)(row % G);
  const int bw = (int)(row / G);
  const long long n_pad = S * G;
  uint32_t* buckets = reinterpret_cast<uint32_t*>(out) + ((long long)g * BW + bw) * K * SLOT;
  const int16_t* drow = digits + (long long)bw * n_pad + g;
  const uint32_t* pcol = pm + (long long)g * 3 * NW;

  uint32_t zero[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) zero[j] = 0u;
  for (int k = 0; k < K; ++k) {  // the identity (0 : 1 : 0) in Montgomery form
    ecw::store_words<NW>(buckets + k * SLOT, zero);
    ecw::store_words<NW>(buckets + k * SLOT + NW, fc.rm);
    ecw::store_words<NW>(buckets + k * SLOT + 2 * NW, zero);
  }

  if constexpr (acc_staged<L>) {
    // this thread's bucket (values 0-2) and point (3-5), and rcb_add_staged's
    // scratch value
    __shared__ uint4 stage[ecw::STAGED_VALUES * (NW / 4) * ACC_THREADS];
    const ecw::Staged<NW> st{stage + threadIdx.x, ACC_THREADS};
    for (long long j = 0; j < S; ++j) {
      const int code = drow[j * G];
      const int k = code < 0 ? ~code : code;
      const uint4* q = reinterpret_cast<const uint4*>(pcol + j * G * 3 * NW);
      uint32_t* b = buckets + k * SLOT;
      const uint4* bv = reinterpret_cast<const uint4*>(b);
#pragma unroll
      for (int i = 0; i < 3 * (NW / 4); ++i) {
        ptx::st_shared_v4(st.quad(0, i), bv[i]);
        ptx::st_shared_v4(st.quad(3, i), q[i]);
      }
      if (code < 0) {  // -P = (X : -Y : Z)
        uint32_t y[NW];
        st.load(4, y);
        ecw::neg_canon<L>(y, y, fc);
        st.store(4, y);
      }
      ecw::rcb_add_staged<L>(st, b3, fc, [&](int c, const uint32_t* w) {
        ecw::store_words<NW>(b + c * NW, w);
      });
    }
  } else {
    for (long long j = 0; j < S; ++j) {
      const int code = drow[j * G];
      const int k = code < 0 ? ~code : code;
      const uint32_t* q = pcol + j * G * 3 * NW;
      uint32_t X2[NW], Y2[NW], Z2[NW];
      ecw::load_words<NW>(X2, q);
      ecw::load_words<NW>(Y2, q + NW);
      ecw::load_words<NW>(Z2, q + 2 * NW);
      if (code < 0) ecw::neg_canon<L>(Y2, Y2, fc);  // -P = (X : -Y : Z)
      uint32_t* b = buckets + k * SLOT;
      uint32_t X1[NW], Y1[NW], Z1[NW];
      ecw::load_words<NW>(X1, b);
      ecw::load_words<NW>(Y1, b + NW);
      ecw::load_words<NW>(Z1, b + 2 * NW);
      uint32_t X3[NW], Y3[NW], Z3[NW];
      ecw::rcb_add<L>(X3, Y3, Z3, X1, Y1, Z1, X2, Y2, Z2, b3, fc);
      ecw::store_words<NW>(b, X3);
      ecw::store_words<NW>(b + NW, Y3);
      ecw::store_words<NW>(b + 2 * NW, Z3);
    }
  }

  // out of Montgomery form, into the slot's canonical 16-bit limbs
  for (int k = 0; k < K; ++k) {
    uint32_t* b = buckets + k * SLOT;
    uint32_t w[3][NW];
#pragma unroll
    for (int c = 0; c < 3; ++c) ecw::load_words<NW>(w[c], b + c * NW);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t T[L], r[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        T[j] = w[c][j];
        T[NW + j] = 0u;
      }
      redc<L>(r, T, fc);  // x*R/R: below p + 1, and equal to p only for x = 0
      csub<NW>(r, r, fc.p);
      store_elem<L>(reinterpret_cast<int32_t*>(b) + c * L, r);
    }
  }
}

template <int L>
int launch_accumulate(const int32_t* points, long long n, uint32_t* pm, const int16_t* digits,
                      int32_t* out, int G, int BW, int K, long long S, int b3,
                      const uint32_t* consts, cudaStream_t s) {
  FieldConsts<L> fc = consts_from_host<L>(consts);
  const long long n_pad = S * G;
  long long want = (3 * n_pad + 255) / 256;
  int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  to_montgomery_kernel<L><<<blocks, 256, 0, s>>>(points, n, n_pad, pm, fc);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long rows = (long long)G * BW;
  bucket_accumulate_kernel<L><<<(unsigned)((rows + ACC_THREADS - 1) / ACC_THREADS), ACC_THREADS,
                                0, s>>>(pm, digits, out, G, BW, K, S, b3, fc);
  return (int)cudaGetLastError();
}

template <int L>
int occupancy(int* blocks, int* registers) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bucket_accumulate_kernel<L>, ACC_THREADS, 0);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, bucket_accumulate_kernel<L>);
  if (e == cudaSuccess) *registers = attr.numRegs;
  return (int)e;
}

}  // namespace zk

// resident blocks of ACC_THREADS threads per SM, and registers per thread,
// of the accumulation kernel at L limbs
extern "C" int zk_ec_bucket_accumulate_occupancy(int L, int* blocks, int* registers) {
  if (L == 16) return zk::occupancy<16>(blocks, registers);
  if (L == 24) return zk::occupancy<24>(blocks, registers);
  return (int)cudaErrorInvalidValue;
}

extern "C" int zk_ec_bucket_accumulate(int L, const void* points, long long n, void* pm,
                                       const void* digits, void* out, int G, int BW, int K,
                                       long long S, int b3, const unsigned* consts,
                                       void* stream) {
  if (n < 0 || G < 1 || BW < 1 || K < 1 || S < 1 || n > S * G || b3 < 0 || b3 > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* pts = static_cast<const int32_t*>(points);
  uint32_t* pmw = static_cast<uint32_t*>(pm);
  const int16_t* dg = static_cast<const int16_t*>(digits);
  int32_t* o = static_cast<int32_t*>(out);
  const uint32_t* hc = reinterpret_cast<const uint32_t*>(consts);
  if (L == 16) return zk::launch_accumulate<16>(pts, n, pmw, dg, o, G, BW, K, S, b3, hc, s);
  if (L == 24) return zk::launch_accumulate<24>(pts, n, pmw, dg, o, G, BW, K, S, b3, hc, s);
  return (int)cudaErrorInvalidValue;
}
