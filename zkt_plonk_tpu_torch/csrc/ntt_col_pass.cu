// K3 ntt_col_pass: one fused radix-F pass of the mixed-radix NTT.
//
// Replaces the Pallas kernels zkt_plonk_tpu/ops/ntt_mr.py:_col_pass_pallas
// (the F-point DIT NTT down the columns, rows taken in bit-reversed order)
// and _mul3d (the prologue / inter-pass / epilogue table multiplies), and
// the transposes the JAX transform does between passes (ntt_mr.py transform).
// Pass d of a transform of nb polynomials of size n = F * M:
//   1. loads its F rows in bit-reversed order: pass 1 straight from the
//      caller's (nb, n, L) limbs (element (t, b, m) at x[b, t*M + m]), a
//      later pass from the previous pass's (F, nb, M) packed words;
//   2. multiplies by the prologue table tin[t][m] (pass 1 of a coset
//      forward transform; t is the natural row);
//   3. runs all log2 F DIT stages (stage twiddles of ntt_mr._stage_tws,
//      row 2^s + j = w^(j F/2^(s+1)), in Montgomery form w*R);
//   4. multiplies by tout[k][m] (the inter-pass twiddles, or the epilogue
//      on the last pass);
//   5. stores in the next pass's layout: with m = q*P + p and q = fn*Qn + qn,
//      row k goes to row fn, column (b, qn, k, p) of (Fn, nb, Qn*F*P); the
//      last pass writes the caller's (nb, n, L) canonical limbs at
//      y[b, k*M + m].
//
// What bounds it on the H100: 32-bit integer multiplies (about 3.5
// Montgomery products per element at F = 128 with one table, ~925 multiplies
// against 64 bytes moved).  What the design does about it:
// - values stay in the canonical domain and lazily below 2p (p < R/4, the
//   wrapper checks it): twiddles and tables are stored once per plan as
//   w*R mod p, so mont(v, w*R) = v*w < 2p without a final subtraction, and a
//   butterfly reduces by 2p; only the last pass's store makes them canonical;
// - a strict instance (STRICT = true) serves a field with 2p < R <= 4p
//   (BLS12-381's Fr, 0.453 R), where a product of two values below 2p can
//   exceed pR: there every product is brought below p (mont_mode) and every
//   butterfly reduces by p, so values, the words between passes included,
//   stay canonical.  The wrapper picks the instance from the modulus
//   (ops/ntt_mr.py:fused_pass);
// - between passes an element is 8 packed words (32 B), not 16 int32 limbs;
// - a thread holds E = 4 elements of one column and runs up to two stages
//   (a radix-4 step) in registers between two barriers; F = 128 takes steps
//   of 2, 2, 2 and 1 stages and three exchanges through shared memory.
//   Radix-8 steps (E = 8) held 130-140 registers, one block of 8 warps per
//   SM at F = 128, and took twice as long; 16 columns per block instead of 8
//   took 6-7% longer (PERF.md);
// - the unit twiddles of the first step are skipped at compile time;
// - the first step takes its elements straight from device memory and the
//   last stores straight to it; shared memory holds only the exchanges,
//   word-major ([NW][tile]), with the rows of a line swizzled so that the
//   32 lanes of a warp (8 columns x 4 threads of a column) hit 32 banks.
#include "field.cuh"

namespace zk {

constexpr int NTT_CPB = 8;        // columns per block (a warp: 8 columns x 4 threads)
constexpr int NTT_MAX_LOGF = 8;   // factorize never exceeds F = 256
constexpr int NTT_MAX_LOGE = 2;   // a thread holds up to 2^2 elements: radix-4 steps

template <int LOGF>
struct NttShape {
  static constexpr int F = 1 << LOGF;
  static constexpr int LOGE = LOGF < NTT_MAX_LOGE ? LOGF : NTT_MAX_LOGE;
  static constexpr int E = 1 << LOGE;  // elements per thread
  static constexpr int TPC = F / E;    // threads per column
  static constexpr int THREADS = TPC * NTT_CPB;
  static constexpr int TILE = F * NTT_CPB;
  static constexpr int NSTEPS = LOGF == 0 ? 0 : (LOGF + NTT_MAX_LOGE - 1) / NTT_MAX_LOGE;
  static constexpr size_t SMEM = NSTEPS > 1 ? (size_t)TILE * 8 * sizeof(uint32_t) : 0;
};

struct NttPassArgs {
  const void* x;           // pass 1: (nb, n, L) int32 limbs; later: (F, nb, M) x NW words
  void* y;                 // last pass: (nb, n, L) int32 limbs; else (Fn, nb, Mn) x NW words
  const uint32_t* tw;      // (F, NW) stage twiddles, Montgomery form
  const uint32_t* tin;     // (F, M, NW) prologue table or nullptr
  const uint32_t* tout;    // (F, M, NW) inter-pass / epilogue table or nullptr
  long long nb, M;
  int logP, logQn;
  int first, last;
};

// element t of a column at step (S0, R): thread tau, register slot i
template <int LOGE, int S0, int R>
__device__ __forceinline__ int step_row(int tau, int i) {
  const int v = i >> R;
  const int k = i & ((1 << R) - 1);
  const int u = tau * (1 << (LOGE - R)) + v;
  const int j = u & ((1 << S0) - 1);
  const int g = u >> S0;
  return (g << (S0 + R)) | (k << S0) | j;
}

// shared-memory slot of element (t, c) within a word plane: four rows share
// a line of 32 words (one per bank), and the quarter of the line a row takes
// is t mod 4 XOR the other bit pairs of t.  At every radix-4 step the four
// threads of a column in one warp hold rows that differ in bits (0, 1),
// (1, 2) or (2, 3) of t, which this map sends to four different quarters.
__device__ __forceinline__ int smem_slot(int t, int c) {
  const int quarter = (t ^ (t >> 2) ^ (t >> 4) ^ (t >> 6)) & 3;
  return ((t >> 2) << 5) | (quarter << 3) | c;
}

template <int NW>
__device__ __forceinline__ void ldg_words(uint32_t w[NW], const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) {
    const uint4 q = __ldg(v + k);
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
}

template <int NW>
__device__ __forceinline__ void st_words(uint32_t* dst, const uint32_t w[NW]) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) v[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// lo, hi = lo + hi, lo - hi: reduced by 2p (lazy, values below 2p) or by p
// (STRICT, values below p)
template <int L, bool STRICT>
__device__ __forceinline__ void butterfly(uint32_t lo[L / 2], uint32_t hi[L / 2],
                                          const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  uint32_t s[NW];
  if constexpr (STRICT) {
    add_mod<NW>(s, lo, hi, fc.p);
    sub_mod<NW>(hi, lo, hi, fc.p);
  } else {
    add_mod<NW>(s, lo, hi, fc.p2);
    sub_mod<NW>(hi, lo, hi, fc.p2);
  }
  copy_w<NW>(lo, s);
}

// one step of R DIT stages S0 .. S0+R-1 on the thread's E elements, which
// form E / 2^R independent groups of 2^R
template <int L, bool STRICT, int LOGF, int S0, int R>
__device__ __forceinline__ void radix_step(uint32_t (&xr)[NttShape<LOGF>::E][L / 2], int tau,
                                           const uint32_t* __restrict__ tw,
                                           const FieldConsts<L>& fc) {
  constexpr int NW = L / 2;
  constexpr int LOGE = NttShape<LOGF>::LOGE;
  constexpr int GROUPS = 1 << (LOGE - R);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int H = 1 << a;
#pragma unroll
    for (int v = 0; v < GROUPS; ++v) {
      const int j = (tau * GROUPS + v) & ((1 << S0) - 1);
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) {
        if (k & H) continue;
        uint32_t* lo = xr[(v << R) | k];
        uint32_t* hi = xr[(v << R) | k | H];
        // stage 0, and the first twiddle of each stage in the first step,
        // multiply by 1
        if (S0 + a > 0 && !(S0 == 0 && (k & (H - 1)) == 0)) {
          // twiddle of stage s = S0 + a for index t mod 2^s
          uint32_t w[NW];
          ldg_words<NW>(w, tw + (size_t)((1 << (S0 + a)) + (((k & (H - 1)) << S0) | j)) * NW);
          mont_mode<L, STRICT>(hi, hi, w, fc);  // < 2p (< p if STRICT)
        }
        butterfly<L, STRICT>(lo, hi, fc);
      }
    }
  }
}

// hand the elements from the ownership of step (S0, R) to that of (S1, R1)
template <int L, int LOGF, int S0, int R, int S1, int R1>
__device__ __forceinline__ void exchange(uint32_t (&xr)[NttShape<LOGF>::E][L / 2], uint32_t* smem,
                                         int tau, int c) {
  constexpr int NW = L / 2;
  constexpr int LOGE = NttShape<LOGF>::LOGE;
  constexpr int E = NttShape<LOGF>::E;
  constexpr int TILE = NttShape<LOGF>::TILE;
  if (S0 > 0) __syncthreads();  // the previous exchange's reads are done
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int slot = smem_slot(step_row<LOGE, S0, R>(tau, i), c);
#pragma unroll
    for (int w = 0; w < NW; ++w) smem[w * TILE + slot] = xr[i][w];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int slot = smem_slot(step_row<LOGE, S1, R1>(tau, i), c);
#pragma unroll
    for (int w = 0; w < NW; ++w) xr[i][w] = smem[w * TILE + slot];
  }
}

template <int L, bool STRICT, int LOGF, int S0>
__device__ __forceinline__ void ntt_steps(uint32_t (&xr)[NttShape<LOGF>::E][L / 2], uint32_t* smem,
                                          int tau, int c, const uint32_t* __restrict__ tw,
                                          const FieldConsts<L>& fc) {
  constexpr int R = LOGF - S0 < NTT_MAX_LOGE ? LOGF - S0 : NTT_MAX_LOGE;
  radix_step<L, STRICT, LOGF, S0, R>(xr, tau, tw, fc);
  if constexpr (S0 + R < LOGF) {
    constexpr int S1 = S0 + R;
    constexpr int R1 = LOGF - S1 < NTT_MAX_LOGE ? LOGF - S1 : NTT_MAX_LOGE;
    exchange<L, LOGF, S0, R, S1, R1>(xr, smem, tau, c);
    ntt_steps<L, STRICT, LOGF, S1>(xr, smem, tau, c, tw, fc);
  }
}

template <int L, bool STRICT, int LOGF>
__global__ void __launch_bounds__(NttShape<LOGF>::THREADS)
ntt_fused_pass_kernel(NttPassArgs a, FieldConsts<L> fc) {
  using S = NttShape<LOGF>;
  constexpr int NW = L / 2;
  constexpr int E = S::E;
  constexpr int LOGE = S::LOGE;
  // the last step's (S0, R): steps of NTT_MAX_LOGE stages, the remainder last
  constexpr int SL = LOGF == 0 ? 0 : NTT_MAX_LOGE * ((LOGF - 1) / NTT_MAX_LOGE);
  constexpr int RL = LOGF - SL;
  extern __shared__ uint4 smem_raw[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem_raw);

  const int c = threadIdx.x % NTT_CPB;
  const int tau = threadIdx.x / NTT_CPB;
  const long long b = blockIdx.x % a.nb;
  const long long m = (blockIdx.x / a.nb) * NTT_CPB + c;
  const long long M = a.M;
  const bool live = m < M;
  const long long n = M << LOGF;

  uint32_t xr[E][NW];
  // 1-2. load row bitrev(t) into slot of row t; prologue at the natural row
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int t = step_row<LOGE, 0, LOGE>(tau, i);
    const int src = LOGF ? (int)(__brev((unsigned)t) >> (32 - LOGF)) : 0;
    if (!live) {
#pragma unroll
      for (int w = 0; w < NW; ++w) xr[i][w] = 0;
      continue;
    }
    if (a.first) {
      load_elem<L>(xr[i], static_cast<const int32_t*>(a.x) + (b * n + src * M + m) * L);
    } else {
      ldg_words<NW>(xr[i], static_cast<const uint32_t*>(a.x) + ((src * a.nb + b) * M + m) * NW);
    }
    if (a.tin != nullptr) {
      uint32_t w[NW];
      ldg_words<NW>(w, a.tin + (src * M + m) * NW);
      mont_mode<L, STRICT>(xr[i], xr[i], w, fc);
    }
  }
  // 3. the DIT stages
  if constexpr (LOGF > 0) ntt_steps<L, STRICT, LOGF, 0>(xr, smem, tau, c, a.tw, fc);
  if (!live) return;
  // 4-5. output table, store in the next layout
  const long long P = 1LL << a.logP;
  const long long q = m >> a.logP;
  const long long p = m & (P - 1);
  const long long Qn = 1LL << a.logQn;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int k = step_row<LOGE, SL, RL>(tau, i);
    if (a.tout != nullptr) {
      uint32_t w[NW];
      ldg_words<NW>(w, a.tout + (k * M + m) * NW);
      mont_mode<L, STRICT>(xr[i], xr[i], w, fc);
    }
    if (a.last) {
      csub<NW>(xr[i], xr[i], fc.p);
      store_elem<L>(static_cast<int32_t*>(a.y) + (b * n + k * M + m) * L, xr[i]);
    } else {
      const long long fn = q >> a.logQn;
      const long long qn = q & (Qn - 1);
      const long long Mn = (Qn << LOGF) * P;
      const long long dst = (fn * a.nb + b) * Mn + ((qn << LOGF) + k) * P + p;
      st_words<NW>(static_cast<uint32_t*>(a.y) + dst * NW, xr[i]);
    }
  }
}

template <int L, bool STRICT, int LOGF>
int launch_fused_pass(const NttPassArgs& a, const FieldConsts<L>& fc, cudaStream_t s) {
  using S = NttShape<LOGF>;
  if (S::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ntt_fused_pass_kernel<L, STRICT, LOGF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = a.nb * ((a.M + NTT_CPB - 1) / NTT_CPB);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  ntt_fused_pass_kernel<L, STRICT, LOGF><<<(int)blocks, S::THREADS, S::SMEM, s>>>(a, fc);
  return (int)cudaGetLastError();
}

template <int L, bool STRICT>
int dispatch_fused_pass(int logF, const NttPassArgs& a, const FieldConsts<L>& fc, cudaStream_t s) {
  switch (logF) {
    case 0: return launch_fused_pass<L, STRICT, 0>(a, fc, s);
    case 1: return launch_fused_pass<L, STRICT, 1>(a, fc, s);
    case 2: return launch_fused_pass<L, STRICT, 2>(a, fc, s);
    case 3: return launch_fused_pass<L, STRICT, 3>(a, fc, s);
    case 4: return launch_fused_pass<L, STRICT, 4>(a, fc, s);
    case 5: return launch_fused_pass<L, STRICT, 5>(a, fc, s);
    case 6: return launch_fused_pass<L, STRICT, 6>(a, fc, s);
    case 7: return launch_fused_pass<L, STRICT, 7>(a, fc, s);
    case 8: return launch_fused_pass<L, STRICT, 8>(a, fc, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace zk

extern "C" int zk_ntt_fused_pass(int L, const void* x, void* y, int logF, long long nb,
                                 long long M, int logP, int logQn, int first, int last,
                                 const void* tw, const void* tin, const void* tout, int strict,
                                 const unsigned* consts, void* stream) {
  if (nb <= 0 || M <= 0) return 0;
  if (logF < 0 || logF > zk::NTT_MAX_LOGF) return (int)cudaErrorInvalidValue;
  zk::NttPassArgs a;
  a.x = x;
  a.y = y;
  a.tw = static_cast<const uint32_t*>(tw);
  a.tin = static_cast<const uint32_t*>(tin);
  a.tout = static_cast<const uint32_t*>(tout);
  a.nb = nb;
  a.M = M;
  a.logP = logP;
  a.logQn = logQn;
  a.first = first;
  a.last = last;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (L != 16) return (int)cudaErrorInvalidValue;
  zk::FieldConsts<16> fc = zk::consts_from_host<16>(reinterpret_cast<const uint32_t*>(consts));
  if (strict) return zk::dispatch_fused_pass<16, true>(logF, a, fc, s);
  return zk::dispatch_fused_pass<16, false>(logF, a, fc, s);
}
