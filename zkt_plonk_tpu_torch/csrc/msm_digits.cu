// K5 msm_digits: the MSM's signed c-bit recoding of a commit batch's
// scalars into the int16 digit rows that K4a reads.
//
// Replaces no Pallas kernel.  The JAX package recodes with jnp
// (zkt_plonk_tpu/ops/msm.py:171 signed_window_digits), which XLA fuses into
// one pass; the port's plain version (ops/msm.py signed_digit_codes, then
// digit_rows' transpose and pad) runs op by op in eager PyTorch, about ten
// int64 elementwise kernels a window over every scalar.
//
// What bounds it on the H100: bytes.  It reads each scalar's Lr int32 limbs
// once and writes its W int16 codes once: B*n*Lr*4 + B*W*n_pad*2 bytes over
// 3.35 TB/s, 0.060 ms at B = 6, n = 2^18 + 4, Lr = 16, W = 32; the
// arithmetic is a few integer operations a code.
//
// Design: one thread per two adjacent columns j, j + 1 of one scalar
// vector b (blockIdx.y).  It loads both columns' limbs into registers (four
// 16-byte loads a column where Lr = 16 and the rows are 16-byte aligned)
// and streams them, limb by limb, through a 32-bit bit buffer per column: a
// window of c <= 15 bits spans at most two limbs, and the buffer never
// holds more than c - 1 + 16 bits.  At each window it adds the carry and
// codes the digit as ops/msm.py does: a raw digit d > 2^(c-1) becomes
// d - 2^c with a carry of 1, a magnitude m is coded m when positive and ~m
// when negative, so a negative zero keeps its sign.  Both columns' codes go
// to row b*W + w as one 32-bit store (two 16-bit stores where n_pad is
// odd), so consecutive threads write 128 contiguous bytes of each row.
// Columns n <= j < n_pad are zero scalars and come out as zero codes, so
// the rows need no separate pad.
#include <cstdint>
#include <cuda_runtime.h>

namespace zk {

constexpr int DIGIT_THREADS = 256;
constexpr int DIGIT_MAX_LIMBS = 16;
constexpr int DIGIT_MAX_C = 15;

// column j's Lr limbs (zero past Lr), or zeros for a padding column
template <bool VEC>
__device__ __forceinline__ void load_scalar(uint32_t (&x)[DIGIT_MAX_LIMBS],
                                            const int32_t* __restrict__ src, int Lr, bool live) {
  if (!live) {
#pragma unroll
    for (int i = 0; i < DIGIT_MAX_LIMBS; ++i) x[i] = 0;
  } else if (VEC) {
    const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int i = 0; i < DIGIT_MAX_LIMBS / 4; ++i) {
      const int4 v = __ldg(s + i);
      x[4 * i] = (uint32_t)v.x;
      x[4 * i + 1] = (uint32_t)v.y;
      x[4 * i + 2] = (uint32_t)v.z;
      x[4 * i + 3] = (uint32_t)v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DIGIT_MAX_LIMBS; ++i) x[i] = i < Lr ? (uint32_t)__ldg(src + i) : 0u;
  }
}

// the next window of ``buf`` plus ``carry`` as a 16-bit code; updates both
__device__ __forceinline__ uint32_t next_code(uint32_t& buf, uint32_t& carry, int c) {
  const uint32_t full = 1u << c;
  const uint32_t d = (buf & (full - 1)) + carry;
  buf >>= c;
  carry = d > (full >> 1);
  return (carry ? d - full - 1 : d) & 0xFFFFu;
}

// scalars (B, n, Lr) int32 canonical 16-bit limbs -> out (B*W, n_pad) int16
template <bool VEC>
__global__ void __launch_bounds__(DIGIT_THREADS)
    msm_digits_kernel(const int32_t* __restrict__ scalars, int16_t* __restrict__ out,
                      long long n, long long n_pad, int Lr, int c, int W) {
  const long long j = 2 * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
  if (j >= n_pad) return;
  const long long b = blockIdx.y;
  const int32_t* src = scalars + (b * n + j) * Lr;
  uint32_t x0[DIGIT_MAX_LIMBS], x1[DIGIT_MAX_LIMBS];
  load_scalar<VEC>(x0, src, Lr, j < n);
  load_scalar<VEC>(x1, src + Lr, Lr, j + 1 < n);
  int16_t* row = out + b * W * n_pad + j;
  const bool packed = (n_pad & 1) == 0;
  const bool second = j + 1 < n_pad;
  uint32_t buf0 = 0, buf1 = 0, carry0 = 0, carry1 = 0;
  int bits = 0, w = 0;
  auto emit = [&]() {
    const uint32_t lo = next_code(buf0, carry0, c);
    const uint32_t hi = next_code(buf1, carry1, c);
    int16_t* dst = row + w * n_pad;
    if (packed) {
      *reinterpret_cast<uint32_t*>(dst) = lo | (hi << 16);
    } else {
      dst[0] = (int16_t)lo;
      if (second) dst[1] = (int16_t)hi;
    }
    ++w;
  };
#pragma unroll
  for (int i = 0; i < DIGIT_MAX_LIMBS; ++i) {
    if (i < Lr && w < W) {
      buf0 |= x0[i] << bits;
      buf1 |= x1[i] << bits;
      bits += 16;
      for (; bits >= c && w < W; bits -= c) emit();
    }
  }
  // windows past the limbs read zeros
  while (w < W) emit();
}

}  // namespace zk

extern "C" int zk_msm_digits(const void* scalars, void* out, int B, long long n, int Lr,
                             long long n_pad, int c, int W, void* stream) {
  if (B < 0 || n < 0 || n > n_pad || Lr < 1 || Lr > zk::DIGIT_MAX_LIMBS || c < 1 ||
      c > zk::DIGIT_MAX_C || W < 1 || B > 65535 || (reinterpret_cast<uintptr_t>(out) & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || n_pad == 0) return 0;
  const long long blocks = ((n_pad + 1) / 2 + zk::DIGIT_THREADS - 1) / zk::DIGIT_THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* src = static_cast<const int32_t*>(scalars);
  int16_t* dst = static_cast<int16_t*>(out);
  if (Lr == zk::DIGIT_MAX_LIMBS && (reinterpret_cast<uintptr_t>(scalars) & 15) == 0) {
    zk::msm_digits_kernel<true><<<grid, zk::DIGIT_THREADS, 0, s>>>(src, dst, n, n_pad, Lr, c, W);
  } else {
    zk::msm_digits_kernel<false><<<grid, zk::DIGIT_THREADS, 0, s>>>(src, dst, n, n_pad, Lr, c, W);
  }
  return (int)cudaGetLastError();
}
