// K3 ntt_col_pass: one radix-F pass of the mixed-radix NTT.
//
// Replaces the Pallas kernel zkt_plonk_tpu/ops/ntt_mr.py:_col_pass_pallas:
// for every column m of an (F, M) array of field elements, the F-point DIT
// NTT along the row axis, rows taken in bit-reversed order, with the
// (F, L) stage twiddles of ntt_mr._stage_tws (row 2^s + j = w^(j F/2^(s+1))).
// The row gather that the JAX driver does before each pass (ntt_mr.py
// transform, jnp.take of plan.bitrevs) happens here, on the load.
//
// What bounds it on the H100: integer multiplies.  A pass reads and writes
// each element once (128 B) and does up to (log2 F)/2 Montgomery products
// per element (F = 128: at most 3.5 x 264 32-bit multiplies), up to ~7
// multiplies per byte.  Design: a block owns TILE = 1024 elements (1024/F columns); it loads
// them once into shared memory as 32-bit words (32 KB), converts the F
// stage twiddles to Montgomery form once (so mont(v, w*R) = v*w stays
// canonical), runs all log2 F butterfly stages with a barrier between
// stages, and writes the columns back in natural row order.  Table
// multiplies between passes stay separate K1 launches.
#include "field.cuh"

namespace zk {

constexpr int NTT_TILE = 1024;    // elements per block in shared memory
constexpr int NTT_MAX_LOGF = 8;   // F <= 256 (factorize never exceeds it)
constexpr int NTT_THREADS = 256;

template <int L>
__global__ void __launch_bounds__(NTT_THREADS)
ntt_col_pass_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y, int logF, long long M,
                    const int32_t* __restrict__ tw, FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  __shared__ uint32_t sdata[NTT_TILE][NW];
  __shared__ uint32_t stw[1 << NTT_MAX_LOGF][NW];

  const int F = 1 << logF;
  const int cpb = NTT_TILE >> logF;  // columns per block
  const long long c0 = (long long)blockIdx.x * cpb;

  // stage twiddles -> Montgomery form (row 0 is unused)
  for (int t = threadIdx.x; t < F; t += blockDim.x) {
    uint32_t w[NW];
    load_elem<L>(w, tw + (long long)t * L);
    mont_mul<L>(stw[t], w, fc.r2, fc);
  }
  // load: shared row t <- global row bitrev(t)
  for (int e = threadIdx.x; e < NTT_TILE; e += blockDim.x) {
    int t = e / cpb;
    int c = e - t * cpb;
    long long m = c0 + c;
    if (m < M) {
      int src = logF ? (int)(__brev((unsigned)t) >> (32 - logF)) : 0;
      load_elem<L>(sdata[e], x + ((long long)src * M + m) * L);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j) sdata[e][j] = 0;
    }
  }
  __syncthreads();

  const int nbf = (F >> 1) * cpb;  // butterflies per stage in this block
  for (int s = 0; s < logF; ++s) {
    const int H = 1 << s;
    for (int k = threadIdx.x; k < nbf; k += blockDim.x) {
      int bfly = k / cpb;  // butterfly index within the column
      int c = k - bfly * cpb;
      int g = bfly >> s;
      int j = bfly & (H - 1);
      int i0 = ((g << (s + 1)) + j) * cpb + c;
      int i1 = i0 + H * cpb;
      uint32_t u[NW], v[NW];
      copy_w<NW>(u, sdata[i0]);
      copy_w<NW>(v, sdata[i1]);
      if (s > 0) mont_mul<L>(v, v, stw[H + j], fc);
      fadd<L>(sdata[i0], u, v, fc);
      fsub<L>(sdata[i1], u, v, fc);
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < NTT_TILE; e += blockDim.x) {
    int t = e / cpb;
    int c = e - t * cpb;
    long long m = c0 + c;
    if (m < M) store_elem<L>(y + ((long long)t * M + m) * L, sdata[e]);
  }
}

}  // namespace zk

extern "C" int zk_ntt_col_pass(int L, const void* x, void* y, int logF, long long M,
                               const void* tw, const unsigned* consts, void* stream) {
  if (M <= 0) return 0;
  if (logF < 0 || logF > zk::NTT_MAX_LOGF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int cpb = zk::NTT_TILE >> logF;
  long long blocks = (M + cpb - 1) / cpb;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (L == 16) {
    zk::FieldConsts<16> fc = zk::consts_from_host<16>(reinterpret_cast<const uint32_t*>(consts));
    zk::ntt_col_pass_kernel<16><<<(int)blocks, zk::NTT_THREADS, 0, s>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(y), logF, M,
        static_cast<const int32_t*>(tw), fc);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
