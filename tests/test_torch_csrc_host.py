"""The kernels' own word arithmetic, compiled for the host.

``zkt_plonk_tpu_torch/csrc/field.cuh`` and ``csrc/ec.cuh`` are the
arithmetic of kernels K4 and K4a.  Here they are built with ``g++`` beside
a host ``ptx.cuh`` (each PTX carry primitive on one carry flag, the
shared-memory loads and stores as plain ones) and a stub
``cuda_runtime.h``, and called through ctypes:

* ``mont_cios`` (a product interleaved with its reduction),
  ``mont_staged`` (the same with its row operands in shared memory, for a
  product and for a sum of two, its loop unrolled or not) and
  ``mont_staged_pair`` (two products, rows in turns) against Python ints,
  word for word, at
  operands 0, 1, p - 1, p, 2p - 1 and 2p (the lazy bounds) and random ones
  below 2p;
* ``rcb_add`` (registers, the 8-word instance's form) and
  ``rcb_add_staged`` (inputs staged in shared memory, the 12-word
  instances' form) on BN254's Fq (L = 16, 3b = 9), BLS12-381's Fq (L = 24,
  3b = 12) and BLS12-377's Fq (L = 24, 3b = 3), in Montgomery form, against
  ``ops.ec_cuda.add_plain`` bit for bit after conversion out of Montgomery
  form: the identity, doublings, P + (-P), random projective pairs of
  curve points, and coordinates at 0, 1 and p - 1;
* K4a's step forms (points with Z = 1) against ``add_plain`` bit for
  bit in the same way, on the three curves: ``rcb_add_mixed`` (registers,
  the 8-word instance's repeat hits) and ``rcb_add_mixed_staged`` (inputs
  staged in shared memory, the 12-word instance's) on Q with Z = 1 (random
  pairs, P + P, P + (-P), the bucket at the identity, coordinates at 0, 1
  and p - 1), ``rcb_first_hit`` (the identity plus Q with Z = 1) and
  ``rcb_add_identity`` (P plus the identity, and plus its negation
  (0 : -1 : 0)), the last two at 12 words through ``mont_canon``'s
  interleaved products;
* kernel K2's chain (the device part of ``csrc/fp_pow_chain.cu``, run as
  one thread) against Python's ``pow``, e = p - 2 and 5, in each of its
  instances: lazy at L = 16 (BN254's Fr), strict at L = 16 (BLS12-381's
  Fr) and lazy at L = 24 (BLS12-381's and BLS12-377's Fq);
* kernel K5's recoding (the device part of ``csrc/msm_digits.cu``, its
  grid of blocks and threads run one thread after another) against
  ``ops/msm.digit_rows``' plain version, code for code: both load paths
  (16-byte vectors and single limbs), packed and unpacked stores (n_pad
  even and odd), windows of 4, 5, 8 and 11 bits (spanning two limbs and
  running past the limbs), 14 and 16 limbs, on 0, 1, r - 1, runs of
  2^(c-1), 2^(c-1) + 1 and 2^c - 1 windows and random scalars;
* kernel K6's group merge (the device part of ``csrc/ec_bucket_merge.cu``,
  its grid run one thread after another, the 12-word instance's stage a
  static array) against ``ops/msm.bucket_merge_plain``, limb for limb, on
  the three curves at 1, 2 and 3 chunks a column (the second launch over
  the partial sums included).

Without ``g++`` the module's fixtures skip.
"""

import ctypes
import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from zkt_plonk_tpu_torch import _cuda
from zkt_plonk_tpu_torch.curves import curve_host as ch
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.fields import cuda as fc
from zkt_plonk_tpu_torch.fields import make_spec
from zkt_plonk_tpu_torch.fields.limbs import array_to_ints, ints_to_array
from zkt_plonk_tpu_torch.fields.params import BLS12_377_FQ, BLS12_381_FQ, BLS12_381_FR, BN254_FR
from zkt_plonk_tpu_torch.ops import ec, ec_cuda, msm

CSRC = Path(__file__).resolve().parents[1] / "zkt_plonk_tpu_torch" / "csrc"

HOST_PTX = r"""
#pragma once
#include <cstdint>
#include <cuda_runtime.h>
namespace zk {
namespace ptx {
inline uint32_t& carry() {
  static thread_local uint32_t flag = 0;
  return flag;
}
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a + b;
  carry() = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  const uint64_t s = (uint64_t)a + b + carry();
  carry() = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + carry(); }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
  const uint64_t d = (uint64_t)a - b;
  carry() = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  const uint64_t d = (uint64_t)a - b - carry();
  carry() = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - carry(); }
inline uint4 ld_shared_v4(const uint4* p) { return *p; }
inline void st_shared_v4(uint4* p, uint4 v) { *p = v; }
}  // namespace ptx
}  // namespace zk
"""

CUDA_STUB = r"""
#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return uint4{x, y, z, w}; }
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
// one block of one thread
struct uint3 { unsigned x, y, z; };
static const uint3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1}, gridDim{1, 1, 1};
"""

SHIM = r"""
#include "ec.cuh"
using namespace zk;

template <int L>
static void mont_n(int mode, const uint32_t* h, const uint32_t* a, const uint32_t* b,
                   const uint32_t* c, const uint32_t* d, uint32_t* out, long n) {
  constexpr int NW = L / 2;
  const FieldConsts<L> fc = consts_from_host<L>(h);
  uint4 buf[2 * NW / 4];
  const ecw::Staged<NW> st{buf, 1};
  for (long i = 0; i < n; ++i) {
    const long o = i * NW;
    st.store(0, a + o);
    st.store(1, c + o);
    if (mode == 0) mont_cios<L>(out + o, a + o, b + o, fc);
    if (mode == 1) ecw::mont_staged<L, false>(out + o, st, 0, b + o, 0, b + o, fc);
    if (mode == 2) ecw::mont_staged<L, true>(out + o, st, 0, b + o, 1, d + o, fc);
    if (mode == 3 || mode == 4) {
      uint32_t r1[NW], r2[NW];
      ecw::mont_staged_pair<L>(r1, 0, b + o, r2, 1, d + o, st, fc);
      for (int j = 0; j < NW; ++j) out[o + j] = mode == 3 ? r1[j] : r2[j];
    }
    if (mode == 5) ecw::mont_staged<L, true, true>(out + o, st, 0, b + o, 1, d + o, fc);
  }
}

template <int L>
static void rcb_n(int staged, const uint32_t* h, const uint32_t* P, const uint32_t* Q, int b3,
                  uint32_t* out, long n) {
  constexpr int NW = L / 2;
  const FieldConsts<L> fc = consts_from_host<L>(h);
  for (long i = 0; i < n; ++i) {
    const uint32_t* p = P + i * 3 * NW;
    const uint32_t* q = Q + i * 3 * NW;
    uint32_t* o = out + i * 3 * NW;
    if (!staged) {
      ecw::rcb_add<L>(o, o + NW, o + 2 * NW, p, p + NW, p + 2 * NW, q, q + NW, q + 2 * NW, b3, fc);
      continue;
    }
    uint4 buf[ecw::STAGED_VALUES * NW / 4];
    const ecw::Staged<NW> st{buf, 1};
    for (int c = 0; c < 3; ++c) {
      st.store(c, p + c * NW);
      st.store(3 + c, q + c * NW);
    }
    ecw::rcb_add_staged<L>(st, b3, fc, [&](int c, const uint32_t* w) {
      for (int j = 0; j < NW; ++j) o[c * NW + j] = w[j];
    });
  }
}

template <int L>
static void forms_n(int form, const uint32_t* h, const uint32_t* P, const uint32_t* Q, int b3,
                    uint32_t* out, long n) {
  constexpr int NW = L / 2;
  const FieldConsts<L> fc = consts_from_host<L>(h);
  for (long i = 0; i < n; ++i) {
    const uint32_t* p = P + i * 3 * NW;
    const uint32_t* q = Q + i * 3 * NW;
    uint32_t* o = out + i * 3 * NW;
    if (form == 0)
      ecw::rcb_add_mixed<L>(o, o + NW, o + 2 * NW, p, p + NW, p + 2 * NW, q, q + NW, b3, fc);
    if (form == 1) ecw::rcb_first_hit<L>(o, o + NW, o + 2 * NW, q, q + NW, fc);
    if (form == 2) ecw::rcb_add_identity<L>(o, o + NW, o + 2 * NW, p, p + NW, p + 2 * NW, fc);
    if (form == 3) {
      uint4 buf[ecw::MIXED_STAGED_VALUES * NW / 4];
      const ecw::Staged<NW> st{buf, 1};
      for (int c = 0; c < 3; ++c) st.store(c, p + c * NW);
      st.store(3, q);
      st.store(4, q + NW);
      ecw::rcb_add_mixed_staged<L>(st, b3, fc, [&](int c, const uint32_t* w) {
        for (int j = 0; j < NW; ++j) o[c * NW + j] = w[j];
      });
    }
  }
}

// form 0: P + Q for Q with Z = 1; 1: the identity + Q (P unread); 2: P + the
// identity; 3: form 0 staged
extern "C" void host_rcb_form(int L, int form, const uint32_t* h, const uint32_t* P,
                              const uint32_t* Q, int b3, uint32_t* out, long n) {
  if (L == 16) forms_n<16>(form, h, P, Q, b3, out, n);
  if (L == 24) forms_n<24>(form, h, P, Q, b3, out, n);
}

extern "C" void host_mont(int L, int mode, const uint32_t* h, const uint32_t* a, const uint32_t* b,
                          const uint32_t* c, const uint32_t* d, uint32_t* out, long n) {
  if (L == 16) mont_n<16>(mode, h, a, b, c, d, out, n);
  if (L == 24) mont_n<24>(mode, h, a, b, c, d, out, n);
}

extern "C" void host_rcb(int L, int staged, const uint32_t* h, const uint32_t* P,
                         const uint32_t* Q, int b3, uint32_t* out, long n) {
  if (L == 16) rcb_n<16>(staged, h, P, Q, b3, out, n);
  if (L == 24) rcb_n<24>(staged, h, P, Q, b3, out, n);
}
"""

CURVES = ("bn254", "bls12_381", "bls12_377")


POW_SHIM = r"""
#include "pow_chain.cuh"
using namespace zk;

extern "C" void host_pow_chain(int L, int strict, const uint32_t* h, const int32_t* a,
                               int32_t* out, long long n, int ntab, int first, int nsteps,
                               int tail, const uint16_t* sq, const uint8_t* dig) {
  PowSchedule e{};
  e.ntab = ntab;
  e.first = first;
  e.nsteps = nsteps;
  e.tail = tail;
  for (int s = 0; s < nsteps; ++s) {
    e.sq[s] = sq[s];
    e.dig[s] = dig[s];
  }
  if (L == 16 && strict) fp_pow_chain_kernel<16, true>(a, out, n, e, consts_from_host<16>(h));
  if (L == 16 && !strict) fp_pow_chain_kernel<16, false>(a, out, n, e, consts_from_host<16>(h));
  if (L == 24 && !strict) fp_pow_chain_kernel<24, false>(a, out, n, e, consts_from_host<24>(h));
}
"""


def _host_build(tmp_path_factory, name, headers, shim):
    """``shim`` built with g++ beside the host ptx.cuh, the CUDA stub and
    ``headers`` ({file name: text}), loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the kernels' headers needs it")
    d = tmp_path_factory.mktemp(name)
    (d / "ptx.cuh").write_text(HOST_PTX)
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    for fname, text in headers.items():
        (d / fname).write_text(text)
    (d / "shim.cpp").write_text(shim)
    so = d / f"lib{name}.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas", "-I", str(d),
         "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True, text=True, timeout=240,
    )
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "host_ec",
                      {name: (CSRC / name).read_text() for name in ("field.cuh", "ec.cuh")}, SHIM)
    P, I, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.host_mont.argtypes = [I, I, P, P, P, P, P, P, LONG]
    lib.host_rcb.argtypes = [I, I, P, P, P, I, P, LONG]
    lib.host_rcb_form.argtypes = [I, I, P, P, P, I, P, LONG]
    return lib


def _words(values, nw):
    return np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(nw)] for v in values],
                    dtype=np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in words]


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _exact_redc(T, p, nw):
    """(T + M p) / R for the one M < R that makes it divisible by R: the
    lazy value a word-by-word Montgomery reduction gives."""
    R = 1 << (32 * nw)
    M = (-T * pow(p, -1, R)) % R
    return (T + M * p) // R


@pytest.mark.parametrize("curve", CURVES)
def test_interleaved_products_match_python_word_for_word(host_lib, curve):
    spec = make_context(curve).fq_spec
    L = spec.n_limbs
    nw = L // 2
    p = spec.modulus
    R = 1 << (32 * nw)
    rng = random.Random(L + p % 97)
    edges = [0, 1, p - 1, p, 2 * p - 1]
    ops = [(x, y, z, w) for x in edges for y in edges + [2 * p] for z, w in ((x, y), (y, x))]
    ops += [(edges[i % 5], 2 * p, edges[(i + 2) % 5], 2 * p) for i in range(5)]
    ops += [tuple(rng.randrange(2 * p) for _ in range(4)) for _ in range(300)]
    a, b, c, d = (_words([o[k] for o in ops], nw) for k in range(4))
    consts = _cuda.ec_field_consts(spec)
    # mont_cios, mont_staged, mont_staged with a sum, mont_staged_pair's two
    # products, mont_staged unrolled with a sum
    for mode in (0, 1, 2, 3, 4, 5):
        sum_ = mode in (2, 5)
        out = np.zeros_like(a)
        host_lib.host_mont(L, mode, consts, _ptr(a), _ptr(b), _ptr(c), _ptr(d), _ptr(out), len(ops))
        got = _ints(out)
        for (x, y, z, w), r in zip(ops, got):
            T = z * w if mode == 4 else x * y + (z * w if sum_ else 0)
            assert r == _exact_redc(T, p, nw), (curve, mode, x, y, z, w)
            assert r * R < T + p * R and (sum_ or r < 2 * p)


def _pairs(curve, rng):
    """(P, Q) pairs of canonical projective coordinates (int triples)."""
    ctx = make_context(curve)
    p = ctx.fq_spec.modulus
    r = ctx.curve.fr.modulus
    g = ctx.g1
    pts = [ch.scalar_mul(g, rng.randrange(1, r)) for _ in range(12)]

    def proj(pt):
        if pt is None:
            return (0, 1, 0)
        z = rng.randrange(1, p)
        return (int(pt[0]) * z % p, int(pt[1]) * z % p, z)

    def affine(pt):
        return (0, 1, 0) if pt is None else (int(pt[0]), int(pt[1]), 1)

    ident = (0, 1, 0)
    pairs = [(ident, ident), (ident, affine(pts[0])), (affine(pts[1]), ident), (proj(None), proj(pts[2]))]
    for pt in pts[:6]:
        pairs += [(affine(pt), affine(pt)), (proj(pt), proj(pt)), (proj(pt), proj(ch.neg(pt))),
                  (affine(pt), affine(ch.neg(pt)))]
    pairs += [(proj(pts[i]), proj(pts[(i + 5) % 12])) for i in range(12)]
    pairs += [(affine(pts[i]), proj(pts[(i + 3) % 12])) for i in range(12)]
    # the formula on coordinates at the edges of the canonical range, on
    # and off the curve: the kernels and add_plain compute the same function
    edges = [0, 1, p - 1, rng.randrange(p)]
    for _ in range(80):
        pairs.append((tuple(rng.choice(edges) for _ in range(3)), tuple(rng.choice(edges) for _ in range(3))))
    pairs += [(tuple(rng.randrange(p) for _ in range(3)), tuple(rng.randrange(p) for _ in range(3)))
              for _ in range(60)]
    return pairs


@pytest.mark.parametrize("staged", [False, True], ids=["registers", "staged"])
@pytest.mark.parametrize("curve", CURVES)
def test_rcb_add_matches_add_plain_bit_for_bit(host_lib, curve, staged):
    ctx = make_context(curve)
    spec = ctx.fq_spec
    L = spec.n_limbs
    nw = L // 2
    p = spec.modulus
    R = 1 << (32 * nw)
    b = int(ctx.curve.b)
    b3 = ec.b3_const(spec, b, device="cpu")
    assert b3.value == 3 * b
    pairs = _pairs(curve, random.Random(b3.value * L))
    n = len(pairs)

    def mont_words(side):
        vals = [c * R % p for pair in pairs for c in pair[side]]
        return _words(vals, nw).reshape(n, 3 * nw)

    P, Q = mont_words(0), mont_words(1)
    out = np.zeros_like(P)
    host_lib.host_rcb(L, int(staged), _cuda.ec_field_consts(spec), _ptr(P), _ptr(Q), b3.value,
                      _ptr(out), n)
    rinv = pow(R, -1, p)
    got = [v * rinv % p for v in _ints(out.reshape(3 * n, nw))]

    def limbs(side):
        vals = [c for pair in pairs for c in pair[side]]
        return torch.from_numpy(ints_to_array(vals, L).astype(np.int32)).reshape(n, 3, L)

    want = array_to_ints(ec_cuda.add_plain(spec, b3.limbs, limbs(0), limbs(1)).reshape(3 * n, L).numpy())
    assert got == want


def _host_form(host_lib, spec, P, Q, b3, form):
    """(P, Q) int triples -> the shim's outputs as canonical int triples
    (inputs in Montgomery form, outputs converted back)."""
    L = spec.n_limbs
    nw = L // 2
    p = spec.modulus
    R = 1 << (32 * nw)
    n = len(P)
    mont = lambda pts: _words([c * R % p for pt in pts for c in pt], nw).reshape(n, 3 * nw)
    Pw, Qw = mont(P), mont(Q)
    out = np.zeros_like(Pw)
    host_lib.host_rcb_form(L, form, _cuda.ec_field_consts(spec), _ptr(Pw), _ptr(Qw), b3,
                           _ptr(out), n)
    rinv = pow(R, -1, p)
    got = [v * rinv % p for v in _ints(out.reshape(3 * n, nw))]
    return [tuple(got[3 * i:3 * i + 3]) for i in range(n)]


def _plain(spec, b3, P, Q):
    L = spec.n_limbs
    n = len(P)
    limbs = lambda pts: torch.from_numpy(
        ints_to_array([c for pt in pts for c in pt], L).astype(np.int32)).reshape(n, 3, L)
    out = array_to_ints(ec_cuda.add_plain(spec, b3.limbs, limbs(P), limbs(Q)).reshape(3 * n, L).numpy())
    return [tuple(out[3 * i:3 * i + 3]) for i in range(n)]


@pytest.mark.parametrize("form", ["mixed", "mixed_staged", "first_hit", "padding"])
@pytest.mark.parametrize("curve", CURVES)
def test_affine_step_forms_match_add_plain_bit_for_bit(host_lib, curve, form):
    """K4a's step forms (points with Z = 1) give add_plain's canonical words:
    the mixed add on Q with Z = 1 (in registers and staged), the first hit
    (the bucket at the identity) and the padding step (the identity, of
    either sign, added)."""
    ctx = make_context(curve)
    spec = ctx.fq_spec
    p = spec.modulus
    b3 = ec.b3_const(spec, int(ctx.curve.b), device="cpu")
    rng = random.Random(b3.value * spec.n_limbs + 1)
    pairs = _pairs(curve, rng)

    def z1(pt):  # (X/Z : Y/Z : 1), or None for Z = 0
        x, y, z = pt
        if z == 0:
            return None
        zi = pow(z, -1, p)
        return (x * zi % p, y * zi % p, 1)

    edges = [0, 1, p - 1, rng.randrange(p)]
    qs = [(x, y, 1) for x in edges for y in edges]
    P = [a for a, b in pairs if z1(b) is not None] + [pairs[i % len(pairs)][0] for i in range(len(qs))]
    Q = [z1(b) for a, b in pairs if z1(b) is not None] + qs
    ident = (0, 1, 0)
    if form in ("mixed", "mixed_staged"):
        P[:len(qs)] = [ident] * len(qs)  # the bucket at the identity
        want = _plain(spec, b3, P, Q)
    elif form == "first_hit":
        P = [ident] * len(Q)
        want = _plain(spec, b3, P, Q)
    else:
        Q = [ident] * len(P)
        want = _plain(spec, b3, P, Q)
        assert _plain(spec, b3, P, [(0, p - 1, 0)] * len(P)) == want
    code = {"mixed": 0, "first_hit": 1, "padding": 2, "mixed_staged": 3}[form]
    assert _host_form(host_lib, spec, P, Q, b3.value, code) == want


@pytest.fixture(scope="module")
def pow_lib(tmp_path_factory):
    """K2's device code: ``csrc/fp_pow_chain.cu`` up to its C launcher."""
    device_part = (CSRC / "fp_pow_chain.cu").read_text().split('extern "C"')[0]
    lib = _host_build(tmp_path_factory, "host_pow",
                      {"field.cuh": (CSRC / "field.cuh").read_text(), "pow_chain.cuh": device_part},
                      POW_SHIM)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_pow_chain.argtypes = [I, I, P, P, P, LL, I, I, I, I, P, P]
    return lib


@pytest.mark.parametrize("params", [BN254_FR, BLS12_381_FR, BLS12_381_FQ, BLS12_377_FQ],
                         ids=lambda f: f.name)
def test_pow_chain_matches_python_pow(pow_lib, params):
    """Each of K2's instances: the chain of the wrapper's window schedule
    gives x^e mod p, 0 -> 0, in the mode the wrapper picks for the field."""
    spec = make_spec(params)
    L = spec.n_limbs
    p = spec.modulus
    strict, consts = _cuda.reduction_consts(spec)
    assert strict == (params is BLS12_381_FR)
    rng = random.Random(p % 1009)
    vals = [0, 1, 2, p - 2, p - 1] + [rng.randrange(p) for _ in range(40)]
    a = ints_to_array(vals, L).astype(np.int32)
    for e in (p - 2, 5):
        sched = fc.window_schedule(e)
        sq = np.array([s for s, _ in sched.steps] or [0], dtype=np.uint16)
        dig = np.array([d for _, d in sched.steps] or [0], dtype=np.uint8)
        out = np.zeros_like(a)
        pow_lib.host_pow_chain(L, int(strict), consts, _ptr(a), _ptr(out), len(vals), sched.ntab,
                               sched.first, len(sched.steps), sched.tail, _ptr(sq), _ptr(dig))
        assert array_to_ints(out) == [pow(v, e, p) for v in vals], (params.name, e)


# kernel K5 on the host: each thread's indices are thread_local, and the
# shim walks the kernel's grid one thread after another (its threads share
# nothing)
DIGITS_STUB = r"""
#pragma once
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct int4 { int x, y, z, w; };
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; };
static thread_local uint3 threadIdx, blockIdx;
static thread_local dim3 blockDim, gridDim;
template <class T> inline T __ldg(const T* p) { return *p; }
"""

DIGITS_SHIM = r"""
#include "msm_digits.cuh"

extern "C" void host_msm_digits(const int32_t* s, int16_t* out, int B, long long n, int Lr,
                                long long n_pad, int c, int W, int vec) {
  const unsigned T = zk::DIGIT_THREADS;
  blockDim = dim3{T, 1, 1};
  gridDim = dim3{(unsigned)(((n_pad + 1) / 2 + T - 1) / T), (unsigned)B, 1};
  for (unsigned y = 0; y < gridDim.y; ++y)
    for (unsigned x = 0; x < gridDim.x; ++x)
      for (unsigned t = 0; t < T; ++t) {
        blockIdx = uint3{x, y, 0};
        threadIdx = uint3{t, 0, 0};
        if (vec) {
          zk::msm_digits_kernel<true>(s, out, n, n_pad, Lr, c, W);
        } else {
          zk::msm_digits_kernel<false>(s, out, n, n_pad, Lr, c, W);
        }
      }
}
"""


@pytest.fixture(scope="module")
def digits_lib(tmp_path_factory):
    """K5's device code: ``csrc/msm_digits.cu`` up to its C launcher."""
    device_part = (CSRC / "msm_digits.cu").read_text().split('extern "C"')[0]
    lib = _host_build(tmp_path_factory, "host_digits",
                      {"cuda_runtime.h": DIGITS_STUB, "msm_digits.cuh": device_part}, DIGITS_SHIM)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_msm_digits.argtypes = [P, P, I, LL, I, LL, I, I, I]
    return lib


def _window_runs(c, bits, digits):
    """The integer whose c-bit windows below ``bits`` are ``digits`` in turn."""
    out = 0
    for w in range(bits // c):
        out |= digits[w % len(digits)] << (c * w)
    return out


# (c, B, n, G, Lr, vectors): n_pad = ceil(n / G) * G is odd where G = 1
DIGIT_CASES = [
    (8, 3, 37, 8, 16, True), (4, 1, 37, 1, 16, True), (8, 2, 37, 1, 16, False),
    (11, 2, 20, 8, 16, True), (5, 2, 9, 4, 14, False),
]


@pytest.mark.parametrize("c, B, n, G, Lr, vec", DIGIT_CASES)
def test_msm_digits_match_digit_rows_plain(digits_lib, c, B, n, G, Lr, vec):
    r = BN254_FR.modulus
    fr_bits = r.bit_length()
    bits = min(16 * Lr, fr_bits - 2)
    half, full = 1 << (c - 1), 1 << c
    rng = random.Random(c * 1000 + n)
    vals = [0, 1, _window_runs(c, bits, [half]), _window_runs(c, bits, [half + 1, half]),
            _window_runs(c, bits, [full - 1]), _window_runs(c, bits, [half, full - 1, half + 1])]
    if 16 * Lr >= fr_bits:
        vals.append(r - 1)
    vals += [rng.randrange(min(r, 1 << (16 * Lr))) for _ in range(B * n - len(vals))]
    S = ints_to_array(vals, Lr).astype(np.int32).reshape(B, n, Lr)
    want = msm.digit_rows(torch.from_numpy(S), c, fr_bits, G).numpy()
    got = np.full_like(want, 0x5A5A)  # every code must be written, padding included
    digits_lib.host_msm_digits(_ptr(S), _ptr(got), B, n, Lr, want.shape[1], c,
                               want.shape[0] // B, int(vec))
    np.testing.assert_array_equal(got, want)


# kernel K6 on the host: the shared-memory stage of the 12-word instance a
# static array (each thread uses its own slice), and the grid walked one
# thread after another (its threads share nothing)
MERGE_STUB = DIGITS_STUB + r"""
#define __shared__ static
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return uint4{x, y, z, w}; }
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
inline int __clz(int v) { return v == 0 ? 32 : __builtin_clz((unsigned)v); }
"""

MERGE_SHIM = r"""
#include "merge.cuh"

extern "C" void host_merge(int L, const int32_t* in, int32_t* out, int G, int C, int BW, int K,
                           int b3, const uint32_t* h) {
  const unsigned T = zk::MERGE_THREADS;
  const long long threads = (long long)C * BW * (K - 1);
  blockDim = dim3{T, 1, 1};
  gridDim = dim3{(unsigned)((threads + T - 1) / T), 1, 1};
  for (unsigned x = 0; x < gridDim.x; ++x)
    for (unsigned t = 0; t < T; ++t) {
      blockIdx = uint3{x, 0, 0};
      threadIdx = uint3{t, 0, 0};
      if (L == 16) zk::ec_bucket_merge_kernel<16>(in, out, G, C, BW, K, b3, zk::consts_from_host<16>(h));
      if (L == 24) zk::ec_bucket_merge_kernel<24>(in, out, G, C, BW, K, b3, zk::consts_from_host<24>(h));
    }
}
"""


@pytest.fixture(scope="module")
def merge_lib(tmp_path_factory):
    """K6's device code: ``csrc/ec_bucket_merge.cu`` up to its C launcher."""
    device_part = (CSRC / "ec_bucket_merge.cu").read_text().split('extern "C"')[0]
    headers = {name: (CSRC / name).read_text() for name in ("field.cuh", "ec.cuh")}
    lib = _host_build(tmp_path_factory, "host_merge",
                      {**headers, "cuda_runtime.h": MERGE_STUB, "merge.cuh": device_part}, MERGE_SHIM)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_merge.argtypes = [I, P, P, I, I, I, I, I, P]
    return lib


@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("curve", CURVES)
def test_bucket_merge_kernel_matches_plain_limb_for_limb(merge_lib, curve, chunks):
    """Both launches of K6 (``chunks`` partial sums a column, then one chain
    over them) give ``msm.bucket_merge_plain``'s limbs: the sum's
    Montgomery words, never converted, and the identity in row 0.  G = 7
    groups of BW = 2 rows of K = 9 buckets: the identity, runs of one point
    (doublings), P beside -P, coordinates at 0, 1 and p - 1, and random
    projective points."""
    ctx = make_context(curve)
    spec = ctx.fq_spec
    L = spec.n_limbs
    p = spec.modulus
    b3 = ec.b3_const(spec, int(ctx.curve.b), device="cpu")
    rng = random.Random(chunks * 31 + L)
    G, BW, K = 7, 2, 9
    pts = [pt for pair in _pairs(curve, rng) for pt in pair]
    P = ch.scalar_mul(ctx.g1, 5)
    runs = [(int(P[0]), int(P[1]), 1)] * G
    negs = [(int(P[0]), int(P[1]) if g % 2 else p - int(P[1]), 1) for g in range(G)]
    cols = [[(0, 1, 0)] * G, runs, negs] + [rng.sample(pts, G) for _ in range(BW * K - 3)]
    vals = [c for g in range(G) for col in cols for c in col[g]]
    buckets = torch.from_numpy(ints_to_array(vals, L).astype(np.int32)).reshape(G, BW, K, 3, L)
    want = msm.bucket_merge_plain(spec, b3, buckets, chunks).numpy()

    consts = _cuda.ec_field_consts(spec)
    src = np.ascontiguousarray(buckets.numpy())
    part = np.full((chunks, BW, K, 3, L), 0x5A5A, dtype=np.int32)  # every limb must be written
    merge_lib.host_merge(L, _ptr(src), _ptr(part), G, chunks, BW, K, b3.value, consts)
    got = part
    if chunks > 1:
        got = np.full((1, BW, K, 3, L), 0x5A5A, dtype=np.int32)
        merge_lib.host_merge(L, _ptr(part), _ptr(got), chunks, 1, BW, K, b3.value, consts)
    np.testing.assert_array_equal(got[0], want)
