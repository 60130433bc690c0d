// 32-bit carry-chain primitives in inline PTX for multi-word additions and
// subtractions, and 16-byte shared-memory loads and stores that the
// compiler keeps where they are written.
//
// Each function is one PTX instruction.  The carry flag (CC) passes from a
// ".cc" instruction to the next "c" instruction, so a chain must be a run
// of these calls with nothing that touches CC in between; the asm
// statements are volatile so that the compiler keeps them in program order
// (it does not know of the flag, and emits no CC instructions itself).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zk {
namespace ptx {

#define ZK_PTX2(name, op)                                                        \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {             \
    uint32_t r;                                                                  \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));                  \
    return r;                                                                    \
  }

ZK_PTX2(add_cc, "add.cc.u32")      // a + b, carry out
ZK_PTX2(addc_cc, "addc.cc.u32")    // a + b + carry in, carry out
ZK_PTX2(addc, "addc.u32")          // a + b + carry in
ZK_PTX2(sub_cc, "sub.cc.u32")      // a - b, borrow out
ZK_PTX2(subc_cc, "subc.cc.u32")    // a - b - borrow in, borrow out
ZK_PTX2(subc, "subc.u32")          // a - b - borrow in

#undef ZK_PTX2

// A value staged in shared memory is read back where the arithmetic needs
// it: as volatile asm these loads are neither merged with an earlier load
// of the same address nor hoisted above the earlier asm, so the compiler
// does not keep the value in registers in between (ec.cuh, Staged).
__device__ __forceinline__ uint4 ld_shared_v4(const uint4* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint4* p, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(v.x), "r"(v.y), "r"(v.z),
                  "r"(v.w));
}

}  // namespace ptx
}  // namespace zk
