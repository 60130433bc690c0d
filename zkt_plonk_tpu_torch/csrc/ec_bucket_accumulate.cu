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
// The points have Z = 1 (ops/msm.py: a CommitPoints, the copy that
// commit_points makes); Z is never read.
//
// What bounds it on the H100: integer multiplies.  Design:
// * the whole accumulation is Montgomery form: a first kernel converts x
//   and y of the points once to packed NW-word Montgomery values (64 B a
//   point at 8 words), and each thread converts its row to canonical
//   16-bit limbs after its last step, in place;
// * a bucket lives in its output slot of 3*L words, the Montgomery words in
//   the first half, so the packed form halves the bytes per step and no
//   scratch is allocated for the buckets;
// * a step into a bucket that already holds a point is a mixed add
//   (ecw::rcb_add_mixed, RCB 2015 Algorithm 8: 11 products and 8
//   reductions); a step into a bucket that still holds the identity is a
//   first hit, (x y : y^2 : y) (ecw::rcb_first_hit, 2 products, no bucket
//   read); and a padding step (j*G + g >= n, the identity with digit 0)
//   adds the identity, (X1 Y1 : Y1^2 : Y1 Z1) (ecw::rcb_add_identity, 3
//   products), or nothing to a bucket still at the identity.  All three
//   give the complete add's canonical words (ecw::rcb_add, Algorithm 7);
// * no init pass writing K identity slots per row: a mask of K bits per
//   thread in shared memory says which buckets were hit, and the buckets
//   never hit are written as the canonical identity at the end (at 12
//   words a warp's rows one after another, so that its lanes touch
//   neighbouring slots);
// * g varies fastest across a warp: the 32 threads read 32 consecutive
//   points (coalesced) and 32 consecutive int16 digits; their bucket
//   accesses are scattered whatever the order, since the digits differ.
//   With bw fastest the point read would be a broadcast, but the digits
//   (BW, n_pad) would be 32 separate rows;
// * digits are int16 codes: |d| for d >= 0 and ~|d| for a negative digit,
//   so a negative zero (a window of 2^c after the carry) keeps its sign;
// * a step loads its bucket only after the previous step stored it, so
//   equal digits on consecutive steps need no forwarding; the step's loads
//   are short next to its products, and other warps cover them.
//
// Registers: ptxas gives the 8-word instance 168 and no spills at 3 blocks
// of 128 per SM.  Held to 128 for 4 blocks it spills 76 B and took 8-10%
// longer at every batch; and at the prover's G's a batch of one fills only
// about 2 blocks per SM (PERF.md).
//
// The 12-word instance (the BLS12 base fields) runs its repeat hits shaped
// for the register file: the bucket and the point go to shared memory and
// ecw::rcb_add_mixed_staged (products interleaved with their reductions,
// row operands from shared memory) writes the sum back; 6 values of 48 B
// per thread, 36 KB a block beside the masks (5 KB at c = 8).  Its first
// hits and padding steps keep their operands in registers, each product
// interleaved with its reduction (ecw::mont_canon).  It too runs at 3
// blocks per SM: held to 128 registers for 4 it spilled 104 B (PERF.md).
//
// A warp's 32 rows hit their buckets' first time at different steps, and a
// warp runs a branch's two sides one after the other, so first hits taken
// where they fall would cost a mixed add's time almost every step.  The
// first hits of a row commute with its other steps (no earlier step touched
// that bucket), so they run in a pass of their own ahead of the rest:
// pass 1 walks the row and writes each bucket's first hit; pass 2 walks it
// again and adds every later hit.  In each pass a thread runs ahead over
// the steps the pass skips (a digit and a mask bit each) to its next step
// of work, so the warp's threads meet at the products.  Then the padding
// steps, the row's last, in order.  Each pass loads the next step's digit
// before the current step's products.  Without pass 1 (an init pass, every
// step a mixed add) the kernel took 6-16% longer (PERF.md).
#include "ec.cuh"

namespace zk {

constexpr int ACC_THREADS = 128;

// A bucket slot of 3*L words out of Montgomery form, in place: its packed
// Montgomery words (the first 3*NW) become the canonical 16-bit limbs of
// the three coordinates
template <int L>
__device__ __forceinline__ void bucket_out(uint32_t* b, const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
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

// The 12-word instance stages its repeat hits in shared memory
template <int L>
constexpr bool acc_staged = L == 24;

// the two K-bit masks of a block's threads, in bytes
inline size_t mask_bytes(int K) {
  return 2 * (size_t)((K + 31) / 32) * ACC_THREADS * sizeof(uint32_t);
}
// the staged values of the 12-word instance's repeat hits, in bytes
template <int L>
constexpr size_t stage_bytes =
    acc_staged<L> ? (size_t)ecw::MIXED_STAGED_VALUES * (L / 2) * sizeof(uint32_t) * ACC_THREADS : 0;
// shared memory of a block without an opt-in: the masks and the stage
constexpr size_t ACC_SMEM_MAX = 48 * 1024;

// one thread's K-bit mask: word w at base[w * ACC_THREADS], so a warp's
// 32 threads touch 32 banks whatever their buckets
struct BucketMask {
  uint32_t* base;

  __device__ __forceinline__ bool test(int k) const {
    return (base[(k >> 5) * ACC_THREADS] >> (k & 31)) & 1u;
  }
  // sets bit k; returns whether it was set
  __device__ __forceinline__ bool test_and_set(int k) const {
    uint32_t* w = base + (k >> 5) * ACC_THREADS;
    const uint32_t bit = 1u << (k & 31);
    const uint32_t old = *w;
    *w = old | bit;
    return old & bit;
  }
};

// pa[2i + c] = Montgomery form of coordinate c (x, y) of point i < n
template <int L>
__global__ void to_montgomery_xy_kernel(const int32_t* __restrict__ pts, long long n,
                                        uint32_t* __restrict__ pa, FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < 2 * n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t x[NW];
    load_elem<L>(x, pts + (i / 2 * 3 + i % 2) * L);
    mont_mul<L>(x, x, fc.r2, fc);  // x*R
    ecw::store_words<NW>(pa + i * NW, x);
  }
}

// The 12-word instance's repeat hit: bucket b plus the point (x, y) at q,
// negated for a negative digit, written back to b
template <int L>
__device__ __forceinline__ void mixed_step_staged(uint32_t* b, const uint32_t* q, bool negate,
                                                  int b3, const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  __shared__ uint4 stage[ecw::MIXED_STAGED_VALUES * (NW / 4) * ACC_THREADS];
  const ecw::Staged<NW> st{stage + threadIdx.x, ACC_THREADS};
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  const uint4* xv = reinterpret_cast<const uint4*>(q);
#pragma unroll
  for (int i = 0; i < 3 * (NW / 4); ++i) ptx::st_shared_v4(st.quad(0, i), bv[i]);
#pragma unroll
  for (int i = 0; i < NW / 4; ++i) ptx::st_shared_v4(st.quad(3, i), xv[i]);
  uint32_t y[NW];
  ecw::load_words<NW>(y, q + NW);
  if (negate) ecw::neg_canon<L>(y, y, fc);  // -P = (x : -y : 1)
  st.store(4, y);
  ecw::rcb_add_mixed_staged<L>(st, b3, fc, [&](int c, const uint32_t* w) {
    ecw::store_words<NW>(b + c * NW, w);
  });
}

// One row's steps into its buckets, in Montgomery form: pass 1, pass 2 and
// the padding steps (see the note above)
template <int L>
__device__ __forceinline__ void accumulate_row(const uint32_t* __restrict__ pa,
                                               const int16_t* __restrict__ digits,
                                               uint32_t* buckets, long long n, int g, int bw,
                                               int G, long long S, int b3, const BucketMask& hit,
                                               const BucketMask& seen, const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  constexpr int SLOT = 3 * L;
  const int16_t* drow = digits + (long long)bw * S * G + g;
  const uint32_t* prow = pa + (long long)g * 2 * NW;
  const long long pstep = (long long)G * 2 * NW;
  // steps 0 .. steps-1 have a point (j*G + g < n); the rest are padding
  const long long steps = n > g ? (n - g + G - 1) / G : 0;
  auto mag = [](int code) { return code < 0 ? ~code : code; };
  auto digit = [&](long long j) { return j < steps ? (int)drow[j * G] : 0; };
  auto load_point = [&](uint32_t x[NW], uint32_t y[NW], long long j, int code) {
    ecw::load_words<NW>(x, prow + j * pstep);
    ecw::load_words<NW>(y, prow + j * pstep + NW);
    if (code < 0) ecw::neg_canon<L>(y, y, fc);  // -P = (x : -y : 1)
  };

  {
    // pass 1: each bucket's first hit
    long long j = 0;
    int code = digit(0);
    for (;;) {
      int k = mag(code);
      while (j < steps && hit.test_and_set(k)) {  // a repeat: pass 2's
        code = digit(++j);
        k = mag(code);
      }
      if (j >= steps) break;
      const int next = digit(j + 1);
      uint32_t x[NW], y[NW], X3[NW], Y3[NW], Z3[NW];
      load_point(x, y, j, code);
      ecw::rcb_first_hit<L>(X3, Y3, Z3, x, y, fc);
      uint32_t* b = buckets + k * SLOT;
      ecw::store_words<NW>(b, X3);
      ecw::store_words<NW>(b + NW, Y3);
      ecw::store_words<NW>(b + 2 * NW, Z3);
      code = next;
      ++j;
    }
  }
  {
    // pass 2: every later hit, in step order
    long long j = 0;
    int code = digit(0);
    for (;;) {
      int k = mag(code);
      while (j < steps && !seen.test_and_set(k)) {  // a first hit: pass 1's
        code = digit(++j);
        k = mag(code);
      }
      if (j >= steps) break;
      const int next = digit(j + 1);
      uint32_t* b = buckets + k * SLOT;
      if constexpr (acc_staged<L>) {
        mixed_step_staged<L>(b, prow + j * pstep, code < 0, b3, fc);
      } else {
        uint32_t X1[NW], Y1[NW], Z1[NW], x[NW], y[NW], X3[NW], Y3[NW], Z3[NW];
        ecw::load_words<NW>(X1, b);
        ecw::load_words<NW>(Y1, b + NW);
        ecw::load_words<NW>(Z1, b + 2 * NW);
        load_point(x, y, j, code);
        ecw::rcb_add_mixed<L>(X3, Y3, Z3, X1, Y1, Z1, x, y, b3, fc);
        ecw::store_words<NW>(b, X3);
        ecw::store_words<NW>(b + NW, Y3);
        ecw::store_words<NW>(b + 2 * NW, Z3);
      }
      code = next;
      ++j;
    }
  }
  // the padding steps: the identity added to a bucket already hit
  for (long long j = steps; j < S; ++j) {
    const int k = mag(drow[j * G]);
    if (!hit.test(k)) continue;
    uint32_t* b = buckets + k * SLOT;
    uint32_t X1[NW], Y1[NW], Z1[NW], X3[NW], Y3[NW], Z3[NW];
    ecw::load_words<NW>(X1, b);
    ecw::load_words<NW>(Y1, b + NW);
    ecw::load_words<NW>(Z1, b + 2 * NW);
    ecw::rcb_add_identity<L>(X3, Y3, Z3, X1, Y1, Z1, fc);
    ecw::store_words<NW>(b, X3);
    ecw::store_words<NW>(b + NW, Y3);
    ecw::store_words<NW>(b + 2 * NW, Z3);
  }
}

// bucket slot b out: from Montgomery form if its bucket was hit, else the
// identity
template <int L>
__device__ __forceinline__ void slot_out(uint32_t* b, bool hit, const FieldConsts<L>& fc) {
  if (hit) {
    bucket_out<L>(b, fc);
  } else {
    int4* v = reinterpret_cast<int4*>(b);
#pragma unroll
    for (int q = 0; q < 3 * L / 4; ++q) v[q] = make_int4(q == L / 4 ? 1 : 0, 0, 0, 0);
  }
}

// the kernel's name is what device traces of K4a match (it takes affine
// points, Z = 1)
template <int L>
__global__ void __launch_bounds__(ACC_THREADS, 3)
    bucket_accumulate_affine_kernel(const uint32_t* __restrict__ pa,
                                    const int16_t* __restrict__ digits, int32_t* __restrict__ out,
                                    long long n, int G, int BW, int K, long long S, int b3,
                                    FieldConsts<L> fc) {
  constexpr int SLOT = 3 * L;
  extern __shared__ uint32_t masks[];
  const long long rows = (long long)G * BW;
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  // the 8-word instance's lanes work alone; the 12-word one's meet at its out pass
  if constexpr (!acc_staged<L>) {
    if (row >= rows) return;
  }
  auto row_buckets = [&](long long r) {
    return reinterpret_cast<uint32_t*>(out) + ((r % G) * BW + r / G) * K * SLOT;
  };
  const int words = (K + 31) / 32;
  const BucketMask hit{masks + threadIdx.x};                        // written in pass 1
  const BucketMask seen{masks + words * ACC_THREADS + threadIdx.x};  // written in pass 2
  for (int w = 0; w < words; ++w) {
    hit.base[w * ACC_THREADS] = 0u;
    seen.base[w * ACC_THREADS] = 0u;
  }
  if (row < rows)
    accumulate_row<L>(pa, digits, row_buckets(row), n, (int)(row % G), (int)(row / G), G, S, b3,
                      hit, seen, fc);
  if constexpr (acc_staged<L>) {
    // out, the warp's rows one after another: lane i takes buckets i,
    // i + 32, ... of the row, so that the warp reads and writes neighbouring
    // slots (at 12 words 3-11% off the kernel, at 8 words 1-2% on it:
    // PERF.md)
    __syncwarp();
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < 32; ++r) {
      const long long rr = row - lane + r;
      if (rr >= rows) break;
      uint32_t* rb = row_buckets(rr);
      const BucketMask rhit{masks + (threadIdx.x - lane + r)};
      for (int k = lane; k < K; k += 32) slot_out<L>(rb + k * SLOT, rhit.test(k), fc);
    }
  } else {
    uint32_t* buckets = row_buckets(row);
    for (int k = 0; k < K; ++k) slot_out<L>(buckets + k * SLOT, hit.test(k), fc);
  }
}

template <int L>
int launch_accumulate(const int32_t* points, long long n, uint32_t* pa, const int16_t* digits,
                      int32_t* out, int G, int BW, int K, long long S, int b3,
                      const uint32_t* consts, cudaStream_t s) {
  FieldConsts<L> fc = consts_from_host<L>(consts);
  if (n > 0) {
    long long want = (2 * n + 255) / 256;
    int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
    to_montgomery_xy_kernel<L><<<blocks, 256, 0, s>>>(points, n, pa, fc);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const long long rows = (long long)G * BW;
  bucket_accumulate_affine_kernel<L>
      <<<(unsigned)((rows + ACC_THREADS - 1) / ACC_THREADS), ACC_THREADS, mask_bytes(K),
         s>>>(pa, digits, out, n, G, BW, K, S, b3, fc);
  return (int)cudaGetLastError();
}

template <class Kernel>
int occupancy(Kernel kernel, size_t smem, int* blocks, int* registers) {
  cudaFuncAttributes attr;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, ACC_THREADS, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) *registers = attr.numRegs;
  return (int)e;
}

}  // namespace zk

// resident blocks of ACC_THREADS threads per SM, and registers per thread,
// of the accumulation kernel at L limbs, with the masks of c = 8 (K = 129),
// the window of every commit above 2^12 points
extern "C" int zk_ec_bucket_accumulate_occupancy(int L, int* blocks, int* registers) {
  if (L == 16)
    return zk::occupancy(zk::bucket_accumulate_affine_kernel<16>, zk::mask_bytes(129), blocks,
                         registers);
  if (L == 24)
    return zk::occupancy(zk::bucket_accumulate_affine_kernel<24>, zk::mask_bytes(129), blocks,
                         registers);
  return (int)cudaErrorInvalidValue;
}

// points (n, 3, L) with Z = 1 (Z is not read); pa scratch of 2*n*L/2 words
extern "C" int zk_ec_bucket_accumulate(int L, const void* points, long long n, void* pa,
                                       const void* digits, void* out, int G, int BW, int K,
                                       long long S, int b3, const unsigned* consts,
                                       void* stream) {
  if (n < 0 || G < 1 || BW < 1 || K < 1 || S < 1 || n > S * G || b3 < 0 || b3 > 255 ||
      (L != 16 && L != 24))
    return (int)cudaErrorInvalidValue;
  const size_t stage = L == 24 ? zk::stage_bytes<24> : zk::stage_bytes<16>;
  if (zk::mask_bytes(K) + stage > zk::ACC_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* hc = reinterpret_cast<const uint32_t*>(consts);
  const int32_t* pts = static_cast<const int32_t*>(points);
  uint32_t* paw = static_cast<uint32_t*>(pa);
  const int16_t* dg = static_cast<const int16_t*>(digits);
  int32_t* o = static_cast<int32_t*>(out);
  if (L == 16) return zk::launch_accumulate<16>(pts, n, paw, dg, o, G, BW, K, S, b3, hc, s);
  return zk::launch_accumulate<24>(pts, n, paw, dg, o, G, BW, K, S, b3, hc, s);
}
