// K1 fp_binop: elementwise modular mul / add / sub on canonical limbs.
//
// Replaces the Pallas kernels of zkt_plonk_tpu/fields/pallas.py:_kernel_fn
// (ops "mul", "add", "sub") and ops/ntt_mr.py:_mul3d, which is this same
// product on the NTT's table operands; the script prototypes of the same
// modmul (scripts/proto_pallas_mul.py, scripts/mxu_fold_experiment.py) have
// no other counterpart.
//
// What bounds it on the H100: a mul reads 2 x 64 B and writes 64 B per
// element and does two 8-word Montgomery products (~2 x 136 32-bit integer
// multiplies), about 1.4 integer multiplies per byte moved, so at full
// occupancy it sits near the memory/integer ridge; add and sub are purely
// memory-bound.  Design: one thread per output element, 16-byte vector
// loads of the 64-byte element (96 bytes at L = 24, the BLS12 base fields;
// L = 16 is every scalar field and BN254's base field), the Montgomery
// form kept private to the thread (in: canonical, out: canonical), and
// broadcasting by stride-0 operands so a (1, M) twiddle table or an (L,)
// scalar is never expanded in memory.
#include "field.cuh"

namespace zk {

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

template <int L, int OP>
__global__ void fp_binop_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, long long n, Bcast bc,
                                FieldConsts<L> fc) {
  constexpr int NW = L / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long oa, ob;
    bcast_offsets(bc, i, oa, ob);
    uint32_t x[NW], y[NW], z[NW];
    load_elem<L>(x, a + oa * L);
    load_elem<L>(y, b + ob * L);
    if (OP == OP_MUL) {
      fmul<L>(z, x, y, fc);
    } else if (OP == OP_ADD) {
      fadd<L>(z, x, y, fc);
    } else {
      fsub<L>(z, x, y, fc);
    }
    store_elem<L>(out + i * L, z);
  }
}

template <int L>
int launch_binop(int op, const int32_t* a, const int32_t* b, int32_t* out, long long n,
                 const Bcast& bc, const uint32_t* consts, cudaStream_t stream) {
  FieldConsts<L> fc = consts_from_host<L>(consts);
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  int blocks = (int)(want < (1LL << 20) ? want : (1LL << 20));
  if (op == OP_MUL) {
    fp_binop_kernel<L, OP_MUL><<<blocks, threads, 0, stream>>>(a, b, out, n, bc, fc);
  } else if (op == OP_ADD) {
    fp_binop_kernel<L, OP_ADD><<<blocks, threads, 0, stream>>>(a, b, out, n, bc, fc);
  } else if (op == OP_SUB) {
    fp_binop_kernel<L, OP_SUB><<<blocks, threads, 0, stream>>>(a, b, out, n, bc, fc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace zk

extern "C" int zk_fp_binop(int L, int op, const void* a, const void* b, void* out, long long n,
                           int nd, const long long* shape, const long long* sa,
                           const long long* sb, const unsigned* consts, void* stream) {
  if (n <= 0) return 0;
  if (nd < 1 || nd > zk::MAXD) return (int)cudaErrorInvalidValue;
  zk::Bcast bc = zk::bcast_from_host(nd, shape, sa, sb);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* pa = static_cast<const int32_t*>(a);
  const int32_t* pb = static_cast<const int32_t*>(b);
  int32_t* po = static_cast<int32_t*>(out);
  const uint32_t* hc = reinterpret_cast<const uint32_t*>(consts);
  if (L == 16) return zk::launch_binop<16>(op, pa, pb, po, n, bc, hc, s);
  if (L == 24) return zk::launch_binop<24>(op, pa, pb, po, n, bc, hc, s);
  return (int)cudaErrorInvalidValue;
}
