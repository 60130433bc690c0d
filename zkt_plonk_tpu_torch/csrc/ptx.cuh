// 32-bit carry-chain primitives in inline PTX for multi-word additions and
// subtractions.
//
// Each function is one PTX instruction.  The carry flag (CC) passes from a
// ".cc" instruction to the next "c" instruction, so a chain must be a run
// of these calls with nothing that touches CC in between; the asm
// statements are volatile so that the compiler keeps them in program order
// (it does not know of the flag, and emits no CC instructions itself).
#pragma once

#include <cstdint>

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

}  // namespace ptx
}  // namespace zk
