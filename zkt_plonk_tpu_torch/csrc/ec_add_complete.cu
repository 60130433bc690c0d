// K4 ec_add_complete: complete projective point addition, a = 0 curves.
//
// Replaces the Pallas kernel zkt_plonk_tpu/ops/ec_pallas.py:_add_call
// (body _add_lm_body): Renes-Costello-Batina 2015, Algorithm 7 with a = 0,
// valid for every input pair (identity, doubling, P + (-P)).  Points are
// (X : Y : Z) with canonical 16-bit limbs, (..., 3, L) int32; the output is
// the same projective limbs as zkt_plonk_tpu/ops/ec.py:add, because every
// coordinate is the same canonical field element.
//
// What bounds it on the H100: integer multiplies.  One addition moves
// 2 x 192 B in and 192 B out and does 15 Montgomery products (~2,000 32-bit
// multiplies), ~3.5 multiplies per byte, far right of the ridge.  Design:
// one thread per point pair with every intermediate in registers, and no
// Montgomery conversion of the inputs: the first-layer products carry R^-1,
// the third-layer products R^-3, and one multiply by R^4 per output
// coordinate cancels it (12 + 3 products instead of 12 + 9).  3b is a small
// integer (9 on BN254) applied by double-and-add.
#include "field.cuh"

namespace zk {

template <int L>
__global__ void ec_add_complete_kernel(const int32_t* __restrict__ pa,
                                       const int32_t* __restrict__ pb, int32_t* __restrict__ out,
                                       long long n, Bcast bc, int b3, FieldConsts<L> fc) {
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

    // layer 1 (each product scaled by R^-1)
    uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], t5[NW], u[NW], v[NW];
    mont_mul<L>(t0, X1, X2, fc);
    mont_mul<L>(t1, Y1, Y2, fc);
    mont_mul<L>(t2, Z1, Z2, fc);
    fadd<L>(u, X1, Y1, fc);
    fadd<L>(v, X2, Y2, fc);
    mont_mul<L>(t3, u, v, fc);  // (X1+Y1)(X2+Y2)
    fadd<L>(u, Y1, Z1, fc);
    fadd<L>(v, Y2, Z2, fc);
    mont_mul<L>(t4, u, v, fc);  // (Y1+Z1)(Y2+Z2)
    fadd<L>(u, X1, Z1, fc);
    fadd<L>(v, X2, Z2, fc);
    mont_mul<L>(t5, u, v, fc);  // (X1+Z1)(X2+Z2)

    fsub<L>(t3, t3, t0, fc);
    fsub<L>(t3, t3, t1, fc);  // X1Y2 + X2Y1
    fsub<L>(t4, t4, t1, fc);
    fsub<L>(t4, t4, t2, fc);  // Y1Z2 + Y2Z1
    fsub<L>(t5, t5, t0, fc);
    fsub<L>(t5, t5, t2, fc);  // X1Z2 + X2Z1

    // layer 2: the curve constant 3b (linear, keeps the R^-1 scale)
    uint32_t b3t2[NW], b3t5[NW], m3t0[NW], zs[NW], td[NW];
    fmul_small<L>(b3t2, t2, b3, fc);
    fmul_small<L>(b3t5, t5, b3, fc);
    fadd<L>(m3t0, t0, t0, fc);
    fadd<L>(m3t0, m3t0, t0, fc);  // 3 X1X2
    fadd<L>(zs, t1, b3t2, fc);    // Y1Y2 + 3b Z1Z2
    fsub<L>(td, t1, b3t2, fc);    // Y1Y2 - 3b Z1Z2

    // layer 3 (scale R^-3), then one product by R^4 per coordinate
    uint32_t o[NW];
    mont_mul<L>(u, t3, td, fc);
    mont_mul<L>(v, t4, b3t5, fc);
    fsub<L>(o, u, v, fc);
    mont_mul<L>(o, o, fc.r4, fc);
    store_elem<L>(out + i * 3 * L, o);  // X3 = t3 td - t4 b3t5

    mont_mul<L>(u, b3t5, m3t0, fc);
    mont_mul<L>(v, td, zs, fc);
    fadd<L>(o, u, v, fc);
    mont_mul<L>(o, o, fc.r4, fc);
    store_elem<L>(out + i * 3 * L + L, o);  // Y3 = b3t5 m3t0 + td zs

    mont_mul<L>(u, zs, t4, fc);
    mont_mul<L>(v, m3t0, t3, fc);
    fadd<L>(o, u, v, fc);
    mont_mul<L>(o, o, fc.r4, fc);
    store_elem<L>(out + i * 3 * L + 2 * L, o);  // Z3 = zs t4 + m3t0 t3
  }
}

}  // namespace zk

extern "C" int zk_ec_add_complete(int L, const void* p, const void* q, void* out, long long n,
                                  int nd, const long long* shape, const long long* sa,
                                  const long long* sb, int b3, const unsigned* consts,
                                  void* stream) {
  if (n <= 0) return 0;
  if (nd < 1 || nd > zk::MAXD || b3 < 0 || b3 > 255) return (int)cudaErrorInvalidValue;
  zk::Bcast bc = zk::bcast_from_host(nd, shape, sa, sb);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 128;
  long long want = (n + threads - 1) / threads;
  int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  if (L == 16) {
    zk::FieldConsts<16> fc = zk::consts_from_host<16>(reinterpret_cast<const uint32_t*>(consts));
    zk::ec_add_complete_kernel<16><<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(p), static_cast<const int32_t*>(q),
        static_cast<int32_t*>(out), n, bc, b3, fc);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
