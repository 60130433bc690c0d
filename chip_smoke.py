"""Drive the PyTorch/CUDA port on one GPU and check every kernel on the card.

Run from the repository root: ``python3 chip_smoke.py``.  Needs one CUDA
card (it exits non-zero without one), ``nvcc`` and nothing else.

Phases, one line each:
  1. device   — the card's name, and nvidia-smi's name and power limit;
  2. build    — nvcc builds of the five kernels in csrc/ (in parallel),
                with ptxas's register report and each kernel's SASS
                instruction mix;
  3. parity   — each kernel against its plain PyTorch version on the same
                card tensors at the main path's shapes (and against Python
                ints on a sample), with its device time per call (CUDA
                events around calls queued back to back), the plain
                version's time and the bound; K2 at one element (the
                prover's shape) and 2^12, for e = p - 2 and e = 5; K3's
                fused passes at every pass of the (10, 2^18) iNTT and the
                (36, 2^18) forward transform, then whole transforms at the
                prover's shapes (36, 4 and 10 polynomials of 2^18), each
                D launches of K3 and nothing else; K4a (the MSM's bucket
                accumulation) at n = 2^18 + 4 with B = 3 scalar vectors,
                including 0, 1, r - 1, negative-zero digits and runs of
                one digit, and its time at the prover's batches B = 1, 2,
                3, 6;
  4. golden   — the TinyCircuit proof on the card: 802 bytes, fixed sha256;
  5. withdraw — the withdraw circuit at HEIGHT=48, NOTES=3, TABLE=1024
                (n = 2^18): SRS setup, compile, cold and warm prove, verify,
                a tampered public input that must raise, the launch
                count of every kernel over this main path, and the launches
                inside each of its NTTs (D of K3, nothing else);
  6. poseidon — device Poseidon (width 4, every add and multiply a K1
                launch) on one level of a 2^17-leaf Merkle tree (2^16 pair
                rows) plus a short row, and on the short row alone, bit for
                bit against the host hasher, with K1 launches and device
                time per batch;
  7. cli      — the port's CLI in-process at its defaults (BN254, KZG,
                Merlin, HEIGHT=48, NOTES=3, TABLE=1024, Poseidon width 4,
                SRS 2^20) in a temporary directory: compile, init-store,
                five deposits, prove-withdraw with the EPK file, then
                without it (the EPK rebuilt from the PK), the written proof
                reloaded and verified with keys loaded from the files, and
                a tampered public input that must raise;
then one JSON line of kernel records (launches summed over the main paths
of phases 5-7, each counted from zero around its own run), nvidia-smi's
line, and the result line.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks used for the bounds: HBM 3.35 TB/s (NVIDIA data sheet) and
# 32-bit integer multiplies at 132 SMs x 64 lanes x 1.98 GHz = 16.7 T/s
# (the INT32 lanes are half the FP32 lanes behind the 67 TFLOP/s float32 peak).
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9
ELEM_BYTES = 64  # one field element: 16 limbs of int32
# 32-bit multiplies of 256-bit field arithmetic: a product is 8x8 word
# products, each a mul.lo and a mul.hi; a Montgomery reduction is 8
# quotient words (a mul.lo each) and 8x8 word products of them with p.  A
# modular product is one of each; a complete EC add (RCB Algorithm 7, a = 0,
# 3b by additions) needs 12 products and 9 reductions, since layer 3 sums
# its products in pairs before one reduction (csrc/ec.cuh).  The bounds
# count what the function needs, not the work a kernel spends on its own
# bookkeeping (Montgomery conversions).
PRODUCT_OPS = 2 * 8 * 8
REDUCE_OPS = 8 + 2 * 8 * 8
MODMUL_OPS = PRODUCT_OPS + REDUCE_OPS
EC_ADD_OPS = 12 * PRODUCT_OPS + 9 * REDUCE_OPS

GOLDEN_SHA256 = "504e1dbfaa28af3d1e9da112bbb4329374e06669416c39ec1fc8015df71d3cba"
ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()


def say(phase: str, **fields) -> None:
    parts = [f"{k}={v}" for k, v in fields.items()]
    print(f"[{phase}] " + " ".join(parts), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 24
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def time_cuda(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls queued back to
    back between one pair of CUDA events, over ``reps``.  A spin kernel
    holds the stream while the host queues the calls, for twice as long as
    the host took to issue them unhindered, so the wrappers' host work
    (argument checks, allocation, the ctypes call) does not land between
    the kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_ms + 1) * _cycles_per_ms()))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, int_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_MUL_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_limbs(spec, n: int, rng: np.random.Generator) -> np.ndarray:
    """n canonical elements as (n, L) limbs: top limb below p's top limb."""
    L = spec.n_limbs
    arr = rng.integers(0, 1 << 16, size=(n, L), dtype=np.int64)
    arr[:, L - 1] = rng.integers(0, int(spec.modulus_limbs[L - 1]), size=n)
    return arr.astype(np.int32)


# ---------------------------------------------------------------------------
# phase 3: kernel parity
# ---------------------------------------------------------------------------


def adversarial_pairs(p: int, rng: random.Random):
    pairs = []
    for tgt in [0, 1, 2, 3, p - 1, p - 2, p - 3]:
        for _ in range(32):
            a = rng.randrange(1, p)
            pairs.append((a, tgt * pow(a, -1, p) % p))
    fixtures = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2]
    fixtures += [((1 << k) - 1) % p for k in range(16, 16 * 16 + 1, 16)]
    fixtures += [(1 << k) % p for k in range(15, 16 * 16, 16)]
    pairs += [(x, y) for x in fixtures for y in fixtures]
    return pairs


def parity_fp_binop(records, dev):
    from zkt_plonk_tpu_torch.fields import BN254_FQ, BN254_FR, make_spec
    from zkt_plonk_tpu_torch.fields import cuda as fc
    from zkt_plonk_tpu_torch.fields.limbs import array_to_ints, ints_to_array

    n = 1 << 20
    worst = 0
    times = {}
    for params in (BN254_FR, BN254_FQ):
        spec = make_spec(params)
        p = spec.modulus
        gen = np.random.default_rng(11)
        A = random_limbs(spec, n, gen)
        B = random_limbs(spec, n, gen)
        pairs = adversarial_pairs(p, random.Random(99))
        A[: len(pairs)] = ints_to_array([a for a, _ in pairs], 16)
        B[: len(pairs)] = ints_to_array([b for _, b in pairs], 16)
        a = torch.from_numpy(A).to(dev)
        b = torch.from_numpy(B).to(dev)
        sample = list(range(len(pairs))) + [int(i) for i in gen.integers(0, n, 300)]
        a_int = array_to_ints(A[sample])
        b_int = array_to_ints(B[sample])
        for op, ref in (
            ("mul", lambda x, y: x * y % p),
            ("add", lambda x, y: (x + y) % p),
            ("sub", lambda x, y: (x - y) % p),
        ):
            got = fc.binop(spec, op, a, b)
            plain = fc.binop_plain(spec, op, a, b)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain)
            worst = max(worst, err)
            want = [ref(x, y) for x, y in zip(a_int, b_int)]
            if err != 0 or array_to_ints(got[sample].cpu().numpy()) != want:
                raise AssertionError(f"fp_binop {op} on {params.name} disagrees (max_abs_err {err})")
            if params is BN254_FR:
                times[op] = (
                    time_cuda(lambda: fc.binop(spec, op, a, b)),
                    time_cuda(lambda: fc.binop_plain(spec, op, a, b), reps=3, warmup=1),
                )
        del a, b
    for op in ("mul", "add", "sub"):
        ops = n * MODMUL_OPS if op == "mul" else 0
        b_ms, b_by = bound_ms(3 * ELEM_BYTES * n, ops)
        say("parity", kernel=f"fp_binop.{op}", shape=f"2^20xFr", ms=times[op][0],
            plain_ms=times[op][1], bound_ms=b_ms, bound_by=b_by, max_abs_err=worst)
    k_ms, p_ms = times["mul"]
    b_ms, b_by = bound_ms(3 * ELEM_BYTES * n, n * MODMUL_OPS)
    records["fp_binop"] = dict(
        name="fp_binop", route="cuda", source="zkt_plonk_tpu_torch/csrc/fp_binop.cu",
        replaces="zkt_plonk_tpu/fields/pallas.py:310", max_abs_err=worst, ms=k_ms,
        plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


SQUARE_OPS = 2 * 36 + REDUCE_OPS  # a squaring: 36 distinct word products


def parity_fp_pow_chain(records, dev):
    from zkt_plonk_tpu_torch.fields import BN254_FR, make_spec
    from zkt_plonk_tpu_torch.fields import cuda as fc
    from zkt_plonk_tpu_torch.fields.limbs import array_to_ints

    spec = make_spec(BN254_FR)
    p = spec.modulus
    A = random_limbs(spec, 1 << 12, np.random.default_rng(5))
    A[:7] = 0
    A[7, :] = 0
    A[7, 0] = 1
    A[8] = np.asarray(spec.modulus_limbs, dtype=np.int32)
    A[8, 0] -= 1  # p - 1
    worst = 0
    timed = {}
    for e in (p - 2, 5):
        sched = fc.window_schedule(e)
        squarings = sum(s for s, _ in sched.steps) + sched.tail + (sched.ntab > 1)
        multiplies = sched.products() - squarings
        ops = squarings * SQUARE_OPS + multiplies * MODMUL_OPS
        for n in (1, 1 << 12):
            # the prover's one element: a random one (row 9)
            rows = A[9:10] if n == 1 else A
            a = torch.from_numpy(rows).to(dev)
            got = fc.pow_chain(spec, a, e)
            plain = fc.pow_chain_plain(spec, a, e)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain)
            worst = max(worst, err)
            sample = list(range(min(n, 300)))
            want = [pow(x, e, p) for x in array_to_ints(rows[sample])]
            if err != 0 or array_to_ints(got[sample].cpu().numpy()) != want:
                raise AssertionError(f"fp_pow_chain e={e} n={n} disagrees (max_abs_err {err})")
            k_ms = time_cuda(lambda: fc.pow_chain(spec, a, e))
            p_ms = time_cuda(lambda: fc.pow_chain_plain(spec, a, e), reps=1, warmup=0)
            b_ms, b_by = bound_ms(2 * ELEM_BYTES * n, n * ops)
            label = "p-2" if e == p - 2 else str(e)
            say("parity", kernel="fp_pow_chain", shape=f"{n}xFr,e={label}", window=sched.window,
                products=sched.products(), squarings=squarings, ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            timed[(e, n)] = (k_ms, p_ms, b_ms, b_by)
    # one element: the time per product of the chain's latency, the slope
    # between the two exponents
    big, small = fc.window_schedule(p - 2).products(), fc.window_schedule(5).products()
    say("time", kernel="fp_pow_chain", shape="1xFr", us_per_product=(
        (timed[(p - 2, 1)][0] - timed[(5, 1)][0]) * 1e3 / (big - small)))
    # the record: the prover's shape, one element, e = p - 2
    k_ms, p_ms, b_ms, b_by = timed[(p - 2, 1)]
    records["fp_pow_chain"] = dict(
        name="fp_pow_chain", route="cuda", source="zkt_plonk_tpu_torch/csrc/fp_pow_chain.cu",
        replaces="zkt_plonk_tpu/fields/pallas.py:412", max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def _horner(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def transform_bound(dom, name, nb):
    """Bound of one whole transform, whatever runs it (``tools/time_ntt.py``
    counts the work from the host plan)."""
    from zkt_plonk_tpu_torch.ops import ntt_mr
    from zkt_plonk_tpu_torch.tools.time_ntt import transform_work

    host = ntt_mr.build_plan(dom, inverse="ifft" in name, coset="coset" in name)
    nbytes, products = transform_work(host, nb)
    return bound_ms(nbytes, products * MODMUL_OPS)


def pass_bound(plan, d, nb):
    """Bound of fused pass d: its input and output in their layouts (limbs
    at the caller's boundary, packed words between passes) and its tables
    read once; its non-trivial stage twiddle products and table products."""
    F = plan.Fs[d]
    n = plan.n
    f = F.bit_length() - 1
    words = ELEM_BYTES // 2
    nbytes = nb * n * ((ELEM_BYTES if d == 0 else words) + (ELEM_BYTES if d == len(plan.Fs) - 1 else words))
    products = nb * (n // F) * sum(F // 2 - F // (2 << s) for s in range(1, f))
    for tbl in ((plan.tin if d == 0 else None), plan.tout[d]):
        if tbl is not None:
            nbytes += tbl.numel() * 4
            products += nb * n
    return bound_ms(nbytes, products * MODMUL_OPS)


def parity_ntt_col_pass(records, dev):
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields import BN254_FR
    from zkt_plonk_tpu_torch.fields.limbs import array_to_ints
    from zkt_plonk_tpu_torch.ops import ntt, ntt_mr
    from zkt_plonk_tpu_torch.utils.domain import make_domain

    p = BN254_FR.modulus
    gen = np.random.default_rng(21)
    worst = 0
    # whole transforms: 2^12 against the plain path on the CPU, 2^18 against
    # host Horner evaluations and round trips
    for logn in (12, 18):
        dom = make_domain(BN254_FR, 1 << logn)
        spec = dom.spec
        plan = dom.plan(dev)
        X = random_limbs(spec, 2 << logn, gen).reshape(2, 1 << logn, 16)
        x = torch.from_numpy(X).to(dev)
        outs = {
            "fft": ntt.fft(spec, plan, x),
            "ifft": ntt.ifft(spec, plan, x),
            "coset_fft": ntt.coset_fft(spec, plan, x),
            "coset_ifft": ntt.coset_ifft(spec, plan, x),
        }
        if logn == 12:
            cplan = dom.plan("cpu")
            xc = torch.from_numpy(X)
            for name, out in outs.items():
                ref = getattr(ntt, name)(spec, cplan, xc)
                if not torch.equal(out.cpu(), ref):
                    raise AssertionError(f"ntt {name} at 2^12 disagrees with the plain path")
        else:
            coeffs = array_to_ints(X[0])
            fft0 = outs["fft"][0].cpu().numpy()
            for k in (0, 1, 12345, (1 << logn) - 1):
                want = _horner(coeffs, pow(dom.group_gen, k, p), p)
                if array_to_ints(fft0[k : k + 1])[0] != want:
                    raise AssertionError(f"ntt fft at 2^18 wrong at index {k}")
            if not torch.equal(ntt.ifft(spec, plan, outs["fft"]), x):
                raise AssertionError("ifft(fft(x)) != x at 2^18")
            if not torch.equal(ntt.coset_ifft(spec, plan, outs["coset_fft"]), x):
                raise AssertionError("coset_ifft(coset_fft(x)) != x at 2^18")
            # one batched (10, n) iNTT, as in setup: row 3 alone must agree
            Y = torch.from_numpy(random_limbs(spec, 10 << logn, gen).reshape(10, 1 << logn, 16)).to(dev)
            batched = ntt.ifft(spec, plan, Y)
            if not torch.equal(batched[3], ntt.ifft(spec, plan, Y[3])):
                raise AssertionError("batched iNTT row differs from the single iNTT")
        say("parity", kernel="ntt_col_pass", transforms=f"2^{logn}", ok=True)
        del x, outs

    # each fused pass against its plain version on the same card tensors, at
    # every pass of the (10, 2^18) iNTT of setup and the (36, 2^18) forward
    # transform of the quotient round; pass d+1 takes the kernel's own lazy
    # output (values below 2p), the plain version its canonical form
    dom = make_domain(BN254_FR, 1 << 18)
    spec = dom.spec
    n = dom.size
    for name, nb in (("ifft", 10), ("fft", 36)):
        plan = dom.plan(dev).inv if name == "ifft" else dom.plan(dev).fwd
        x = torch.from_numpy(random_limbs(spec, nb * n, gen).reshape(nb, n, 16)).to(dev)
        y = x
        for d, F in enumerate(plan.Fs):
            last = d == len(plan.Fs) - 1
            got = ntt_mr.fused_pass(spec, plan, d, y, nb)
            plain_in = y if d == 0 else ntt_mr.words_canonical(spec, y)
            plain = ntt_mr.fused_pass_plain(spec, plan, d, plain_in, nb)
            torch.cuda.synchronize()
            err = max_abs_err(got if last else ntt_mr.words_canonical(spec, got), plain)
            worst = max(worst, err)
            if err != 0:
                raise AssertionError(f"ntt_col_pass {name} nb={nb} pass {d} disagrees (max_abs_err {err})")
            k_ms = time_cuda(lambda: ntt_mr.fused_pass(spec, plan, d, y, nb))
            fields = dict(ms=k_ms)
            if nb == 10:
                fields["plain_ms"] = time_cuda(
                    lambda: ntt_mr.fused_pass_plain(spec, plan, d, plain_in, nb), reps=1, warmup=0)
            b_ms, b_by = pass_bound(plan, d, nb)
            say("parity", kernel="ntt_col_pass", shape=f"({nb},2^18) {name} pass {d} F={F}",
                **fields, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            del plain, plain_in
            y = got
        del x, y, got
        torch.cuda.empty_cache()

    # whole transforms at the prover's shapes: D launches of K3, nothing else
    timing = None
    for name, nb in (("fft", 36), ("ifft", 4), ("ifft", 10)):
        plans = dom.plan(dev)
        plan = plans.inv if name == "ifft" else plans.fwd
        x = torch.from_numpy(random_limbs(spec, nb * n, gen).reshape(nb, n, 16)).to(dev)
        fn = getattr(ntt, name)
        _cuda.reset_launches()
        fn(spec, plans, x)
        launched = {k: v for k, v in _cuda.launches.items() if v}
        if launched != {"ntt_col_pass": len(plan.Fs)}:
            raise AssertionError(f"({nb}, 2^18) {name} launched {launched}")
        k_ms = time_cuda(lambda: fn(spec, plans, x))
        b_ms, b_by = transform_bound(dom, name, nb)
        fields = {}
        if nb == 10:
            def plain_chain():
                y = x
                for d in range(len(plan.Fs)):
                    y = ntt_mr.fused_pass_plain(spec, plan, d, y, nb)
                return y

            fields["plain_ms"] = time_cuda(plain_chain, reps=1, warmup=0)
            timing = (k_ms, fields["plain_ms"], b_ms, b_by)
        say("time", kernel="ntt_col_pass", shape=f"({nb},2^18) {name} transform", ms=k_ms, **fields,
            bound_ms=b_ms, bound_by=b_by, share=round(b_ms / k_ms, 3), launches=launched)
        del x
    torch.cuda.empty_cache()

    k_ms, p_ms, b_ms, b_by = timing
    records["ntt_col_pass"] = dict(
        name="ntt_col_pass", route="cuda", source="zkt_plonk_tpu_torch/csrc/ntt_col_pass.cu",
        replaces="zkt_plonk_tpu/ops/ntt_mr.py:428", max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


_SRS = {}


def srs_1024(dev):
    """1024 SRS points on the card (affine-normalized, Z = 1) and their ck."""
    if dev not in _SRS:
        from zkt_plonk_tpu_torch.commitment import kzg
        from zkt_plonk_tpu_torch.curves import make_context

        _SRS[dev] = kzg.setup(make_context("bn254"), max_degree=1023, tau=31337, device=dev)[0]
    return _SRS[dev]


def parity_ec_add(records, dev):
    from zkt_plonk_tpu_torch.curves import curve_host as ch
    from zkt_plonk_tpu_torch.ops import ec, ec_cuda

    ck = srs_1024(dev)
    ctx = ck.ctx
    spec = ctx.fq_spec
    pts = ck.powers  # (1024, 3, L), affine-normalized (Z = 1)
    b3 = ck.b3
    n = 1 << 16
    idx = torch.arange(n, device=dev)
    P = pts[idx % 1024].clone()
    Q = pts[(7 * idx + 3) % 1024].clone()
    Q[0] = ec.identity(spec, (), device=dev)  # identity + P
    Q[1] = P[1]  # P + P
    Q[2] = ec.neg(spec, P[2])  # P + (-P)
    P[3] = ec.identity(spec, (), device=dev)  # identity + identity
    Q[3] = ec.identity(spec, (), device=dev)
    worst = 0
    a, b = P, Q
    for label in ("affine inputs", "projective inputs"):
        got = ec.add(spec, b3, a, b)
        plain = ec_cuda.add_plain(spec, b3.limbs, a, b)
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        worst = max(worst, err)
        if err != 0:
            raise AssertionError(f"ec_add_complete disagrees on {label} (max_abs_err {err})")
        sample = list(range(8)) + list(range(1000, 1200))
        ah = ec.to_affine_host(spec, a[sample])
        bh = ec.to_affine_host(spec, b[sample])
        gh = ec.to_affine_host(spec, got[sample])
        Fq = ctx.Fq
        for x, y, g in zip(ah, bh, gh):
            want = ch.add(None if x is None else (Fq(x[0]), Fq(x[1])),
                          None if y is None else (Fq(y[0]), Fq(y[1])))
            want = None if want is None else (int(want[0]), int(want[1]))
            if want != g:
                raise AssertionError(f"ec_add_complete wrong against host affine add ({label})")
        # second round: the first round's projective outputs (Z != 1)
        a, b = got, P.flip(0).contiguous()
    k_ms = time_cuda(lambda: ec.add(spec, b3, P, Q))
    p_ms = time_cuda(lambda: ec_cuda.add_plain(spec, b3.limbs, P, Q), reps=3, warmup=1)
    b_ms, b_by = bound_ms(3 * 3 * ELEM_BYTES * n, n * EC_ADD_OPS)
    say("parity", kernel="ec_add_complete", shape="2^16 pairs", ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, max_abs_err=worst)
    records["ec_add_complete"] = dict(
        name="ec_add_complete", route="cuda",
        source="zkt_plonk_tpu_torch/csrc/ec_add_complete.cu",
        replaces="zkt_plonk_tpu/ops/ec_pallas.py:99", max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def _acc_bound(n, BW, G, K):
    """K4a's bound: every one of the BW * n_pad steps is one complete add;
    bytes: the points and digits read once and the bucket tensor written
    once."""
    n_pad = -(-n // G) * G
    nbytes = 3 * ELEM_BYTES * n + 2 * BW * n_pad + 3 * ELEM_BYTES * G * BW * K
    return bound_ms(nbytes, BW * n_pad * EC_ADD_OPS)


def _host_row(ck, pts_host, digits, g, bw, G, K):
    """Buckets of row (g, bw) by host affine arithmetic."""
    from zkt_plonk_tpu_torch.curves import curve_host as ch

    Fq = ck.ctx.Fq
    rows = [None] * K
    codes = digits[bw, g::G].tolist()
    for j, code in enumerate(codes):
        pt = pts_host[j * G + g] if j * G + g < len(pts_host) else None
        if pt is not None:
            pt = (Fq(pt[0]), Fq(-pt[1] if code < 0 else pt[1]))
        k = ~code if code < 0 else code
        rows[k] = ch.add(rows[k], pt)
    return [None if r is None else (int(r[0]), int(r[1])) for r in rows]


def parity_ec_bucket_accumulate(records, dev, log_n=18):
    from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
    from zkt_plonk_tpu_torch.ops import ec, msm

    ck = srs_1024(dev)
    ctx = ck.ctx
    spec = ctx.fq_spec
    r = ctx.curve.fr.modulus
    fr_bits = r.bit_length()
    top = int(ctx.fr_spec.modulus_limbs[-1])
    gen = np.random.default_rng(31)
    c = 8
    K = (1 << (c - 1)) + 1
    n = (1 << log_n) + 4

    def scalars(B):
        limbs = gen.integers(0, 1 << 16, size=(B, n, 16), dtype=np.int64)
        limbs[..., 15] = gen.integers(0, top, size=(B, n))
        return limbs.astype(np.int32)

    # parity at B = 3 (the prover's middle batch), n not a multiple of G
    B = 3
    G = msm.group_count(n, c, B, msm.num_windows(fr_bits + 1, c))
    S_np = scalars(B)
    edge = ints_to_array([0, 1, r - 1, 0xFFFF, (1 << 253) - 1, (r - 1) // 2], 16)
    S_np[0, : len(edge)] = edge
    # runs of one digit: scalar vector 1 repeats one scalar on the points of
    # groups 0..7 (every step of those rows hits one bucket), scalar vector
    # 2 repeats scalars in runs of 2 and 5 steps on groups 8..15
    for g in range(min(8, G)):
        S_np[1, g::G] = S_np[1, g]
    for g in range(8, min(16, G)):
        steps = np.arange(g, n, G)
        run = 2 if g < 12 else 5
        S_np[2, steps] = S_np[2, steps - G * ((steps // G) % run)]
    pts = ck.powers[torch.arange(n, device=dev) % 1024].contiguous()
    S = torch.from_numpy(S_np).to(dev)
    digits = msm.digit_rows(S, c, fr_bits, G)
    got = msm.bucket_accumulate(spec, ck.b3, pts, digits, G, c)
    plain = msm.bucket_accumulate_plain(spec, ck.b3, pts, digits, G, c)
    torch.cuda.synchronize()
    err = max_abs_err(got, plain)
    if err != 0:
        raise AssertionError(f"ec_bucket_accumulate disagrees (max_abs_err {err})")
    W = digits.shape[0] // B
    pts_host = ec.to_affine_host(spec, ck.powers)
    pts_host = [pts_host[i % 1024] for i in range(n)]
    digits_h = digits.cpu()
    for g, bw in ((0, 0), (3 % G, W + 5), (9 % G, 2 * W + 1), (G - 1, 3 * W - 1)):
        if ec.to_affine_host(spec, got[g, bw]) != _host_row(ck, pts_host, digits_h, g, bw, G, K):
            raise AssertionError(f"ec_bucket_accumulate row ({g}, {bw}) wrong against host adds")
    k_ms = time_cuda(lambda: msm.bucket_accumulate(spec, ck.b3, pts, digits, G, c), reps=3, warmup=1)
    p_ms = time_cuda(lambda: msm.bucket_accumulate_plain(spec, ck.b3, pts, digits, G, c),
                     reps=1, warmup=0)
    b_ms, b_by = _acc_bound(n, B * W, G, K)
    say("parity", kernel="ec_bucket_accumulate", shape=f"n=2^{log_n}+4,B={B},c={c},G={G}", ms=k_ms,
        plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    records["ec_bucket_accumulate"] = dict(
        name="ec_bucket_accumulate", route="cuda",
        source="zkt_plonk_tpu_torch/csrc/ec_bucket_accumulate.cu",
        replaces="zkt_plonk_tpu/ops/ec_pallas.py:99", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    del got, plain, digits
    # the prover's other commit batches
    for B in (1, 2, 6):
        G = msm.group_count(n, c, B, msm.num_windows(fr_bits + 1, c))
        digits = msm.digit_rows(torch.from_numpy(scalars(B)).to(dev), c, fr_bits, G)
        ms = time_cuda(lambda: msm.bucket_accumulate(spec, ck.b3, pts, digits, G, c),
                       reps=3, warmup=1)
        b_ms, b_by = _acc_bound(n, digits.shape[0], G, K)
        say("time", kernel="ec_bucket_accumulate", shape=f"n=2^{log_n}+4,B={B},c={c},G={G}", ms=ms,
            bound_ms=b_ms, bound_by=b_by)
        del digits
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------


class TinyCircuit:
    def synthesize(self, cs):
        from zkt_plonk_tpu_torch.cs import lt

        a = cs.assign_variable(2)
        b = cs.assign_variable(3)
        c = cs.mul_gate(lt(a), lt(b))
        d = cs.add_gate(lt(c), lt(a))
        cs.set_variable_public(lt(d))
        cs.lookup_constrain(lt(a))


def golden(dev):
    from zkt_plonk_tpu_torch.commitment import kzg
    from zkt_plonk_tpu_torch.cs import LookupTable
    from zkt_plonk_tpu_torch.plonk import ZKTPlonk
    from zkt_plonk_tpu_torch.utils import arkserde

    t0 = time.perf_counter()
    inst = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63), device=dev)
    ck, cvk = kzg.setup(inst.ctx, max_degree=4 * 64, tau=123456789, device=dev)
    compiled = inst.compile(TinyCircuit(), ck, cvk)
    proof = inst.prove(compiled, TinyCircuit(), rng=random.Random(9))
    inst.verify(compiled, proof, [8])
    blob = arkserde.proof_to_bytes(proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)
    digest = hashlib.sha256(blob).hexdigest()
    if len(blob) != 802 or digest != GOLDEN_SHA256:
        raise AssertionError(f"golden proof drifted: {len(blob)} bytes, sha256 {digest}")
    say("golden", bytes=len(blob), sha256=digest, seconds=round(time.perf_counter() - t0, 3))


def withdraw(dev, height=48, notes=3, table_size=1024):
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.circuits.withdraw_instance import build
    from zkt_plonk_tpu_torch.commitment import kzg
    from zkt_plonk_tpu_torch.cs import ConstraintSystem
    from zkt_plonk_tpu_torch.plonk import ZKTPlonk
    from zkt_plonk_tpu_torch.proof_system.proof import VerificationError

    def clock(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    circuit, table, pub_inputs = build(height, notes, table_size)
    inst = ZKTPlonk(curve="bn254", table=table, device=dev)
    cs = ConstraintSystem(inst.p, setup=True, lookup_table=table)
    circuit.synthesize(cs)
    bound = cs.circuit_bound()
    say("withdraw", height=height, notes=notes, table=table_size, gates=cs.n, n=bound,
        build_seconds=clock(t0))

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # every transform of the main path: its launches, by kernel
    from collections import Counter

    from zkt_plonk_tpu_torch.ops import ntt_mr

    per_transform = Counter()
    bad = []
    inner = ntt_mr.transform

    def counted(spec, plan, x):
        before = dict(_cuda.launches)
        out = inner(spec, plan, x)
        delta = {k: v - before[k] for k, v in _cuda.launches.items() if v != before[k]}
        per_transform[f"D={len(plan.Fs)}:" + ",".join(f"{k}={v}" for k, v in delta.items())] += 1
        if delta != {"ntt_col_pass": len(plan.Fs)}:
            bad.append(delta)
        return out

    ntt_mr.transform = counted
    _cuda.reset_launches()
    t0 = time.perf_counter()
    ck, cvk = kzg.setup(inst.ctx, max_degree=4 * bound, tau=987654321, device=dev)
    srs_s = clock(t0)
    t0 = time.perf_counter()
    compiled = inst.compile(circuit, ck, cvk)
    compile_s = clock(t0)
    rng = random.Random(42)
    t0 = time.perf_counter()
    inst.prove(compiled, circuit, rng=rng)
    cold_s = clock(t0)
    t0 = time.perf_counter()
    proof = inst.prove(compiled, circuit, rng=rng)
    warm_s = clock(t0)
    t0 = time.perf_counter()
    inst.verify(compiled, proof, pub_inputs)
    verify_s = clock(t0)
    launches = dict(_cuda.launches)
    ntt_mr.transform = inner
    try:
        inst.verify(compiled, proof, [(pub_inputs[0] + 1) % inst.p] + pub_inputs[1:])
    except (VerificationError, AssertionError):
        tamper = "raised"
    else:
        raise AssertionError("verification passed with a tampered public input")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    say("withdraw", srs_setup_s=srs_s, srs_points=4 * bound + 1, compile_s=compile_s,
        prove_cold_s=cold_s, prove_warm_s=warm_s, verify_s=verify_s, tamper=tamper,
        peak_device_gb=round(peak_gb, 2))
    say("launches", **launches)
    say("ntt", transforms=sum(per_transform.values()), launches_per_transform=dict(per_transform))
    if bad:
        raise AssertionError(f"transforms that launched more than their D passes of K3: {bad}")
    return launches, (cold_s, warm_s)


def poseidon(dev):
    """Device Poseidon at the size of one Merkle level of a 2^17-leaf tree."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields import BN254_FR, make_spec
    from zkt_plonk_tpu_torch.hashing import Poseidon, bn254_constants
    from zkt_plonk_tpu_torch.hashing.poseidon import device as pd

    const = bn254_constants(4)
    p = BN254_FR.modulus
    rng = random.Random(17)
    leaves = [rng.randrange(p) for _ in range(1 << 17)]
    short = [rng.randrange(p)]
    rows = [leaves[2 * i : 2 * i + 2] for i in range(1 << 16)] + [short]
    launches = {}
    for label, batch in (("2^16+1", rows), ("1", [short])):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        got = pd.hash_batch_device(const, batch, device=dev)
        wall_s = time.perf_counter() - t0
        counted = {k: v for k, v in _cuda.launches.items() if v}
        for k, v in counted.items():
            launches[k] = launches.get(k, 0) + v
        checked = list(range(min(4096, len(batch) - 1))) + [len(batch) - 1]
        want = Poseidon.hash_many_native(const, [batch[i] for i in checked])
        if [got[i] for i in checked] != want:
            raise AssertionError(f"device Poseidon disagrees with the host hasher (B = {label})")
        if set(counted) != {"fp_binop"}:
            raise AssertionError(f"device Poseidon launched {counted}")
        # the permutation alone, on the staged state: ms per batch, batches
        # queued behind a spin kernel (a small batch is bound by the host's
        # rate of issuing its launches, not by the card)
        spec = make_spec(BN254_FR)
        tabs = pd.device_tables(spec, const, dev)
        state = pd.initial_state(spec, const, batch, dev)
        ms = time_cuda(lambda: pd.permute_batch(
            spec, tabs["rc"], tabs["mds"], state, const.full_rounds // 2, const.partial_rounds),
            reps=5, warmup=1)
        say("poseidon", width=4, batch=label, rows_checked=len(checked), k1_launches=counted["fp_binop"],
            ms=ms, wall_s=round(wall_s, 3), nvidia_smi=f"'{nvidia_smi_line()}'")
        del state, tabs
    torch.cuda.empty_cache()
    return launches


def cli_phase(dev, eth_prove_s):
    """The port's CLI at its defaults, in-process, in a temporary directory."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch import cli
    from zkt_plonk_tpu_torch.config import transcript_factory
    from zkt_plonk_tpu_torch.plonk import CompiledCircuit, ZKTPlonk
    from zkt_plonk_tpu_torch.proof_system.proof import VerificationError
    from zkt_plonk_tpu_torch.proof_system.setup import extend_prover_key_from_pk
    from zkt_plonk_tpu_torch.utils import serialize as ser

    launches = {k: 0 for k in _cuda.KERNELS}
    proof_launches = {k: 0 for k in _cuda.KERNELS}
    prove_s = []
    inner_prove = ZKTPlonk.prove

    def timed_prove(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_prove(self, *a, **kw)
        torch.cuda.synchronize()
        prove_s.append(round(time.perf_counter() - t0, 3))
        return out

    def run(step, argv, proof=False):
        """One CLI call; its launches counted from zero around it."""
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        torch.cuda.synchronize()
        secs = round(time.perf_counter() - t0, 3)
        for k, v in _cuda.launches.items():
            launches[k] += v
            if proof:
                proof_launches[k] += v
        say("cli", step=step, seconds=secs, printed=json.dumps(out.getvalue().strip().splitlines()))

    addrs = ["0x" + f"{i + 1:02x}" * 20 for i in range(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ZKTPlonk.prove = timed_prove
    try:
        with tempfile.TemporaryDirectory(prefix="zkt-cli-") as d:
            f = {k: os.path.join(d, k) for k in ("ck", "cvk", "pk", "vk", "epk", "tree", "notes")}
            f["proof"] = os.path.join(d, "proof.json")
            keys = ["--ck", f["ck"], "--cvk", f["cvk"], "--pk", f["pk"], "--vk", f["vk"],
                    "--epk", f["epk"]]
            stores = ["-t", f["tree"], "-n", f["notes"]]
            run("compile", ["compile", "-d", str(1 << 20)] + keys)
            sizes = {k: os.path.getsize(f[k] + ".npz" if k in ("ck", "pk", "epk") else f[k])
                     for k in ("ck", "cvk", "pk", "vk", "epk")}
            say("cli", file_bytes=json.dumps(sizes), total_gb=round(sum(sizes.values()) / 1e9, 3))
            run("init-store", ["init-store"] + stores)
            for i, a in enumerate(addrs):
                run(f"deposit-{i}", ["deposit"] + stores + ["-i", a, "-a", str(1000 + 17 * i)])
            withdraw = ["prove-withdraw"] + keys + stores + ["-x", "0", "-x", "1", "-x", "2"]
            for a in addrs:
                withdraw += ["-s", a]
            withdraw += ["-i", addrs[0], "-a", "120"]
            first = withdraw + ["--seed", "42", "--proof-out", f["proof"]]
            args = cli.build_parser().parse_args(first)
            pub = cli.withdraw_statement(args, cli.config_from_args(args), random.Random(42)).public_inputs
            run("prove-withdraw (EPK file)", first, proof=True)

            # the loaders alone, and the file EPK against the one K3 rebuilds from the PK
            loads = {}

            def load(name, loader):
                t0 = time.perf_counter()
                out = loader(f[name], device=dev)
                torch.cuda.synchronize()
                loads[name] = round(time.perf_counter() - t0, 3)
                return out

            ck = load("ck", ser.load_committer_key)
            pk = load("pk", ser.load_prover_key)
            epk = load("epk", ser.load_extended_prover_key)
            rebuilt = extend_prover_key_from_pk(ck, pk)
            for name, t in epk.coset.items():
                if not torch.equal(t, rebuilt.coset[name]):
                    raise AssertionError(f"EPK coset table {name} rebuilt from the PK differs from the file")
            for name in ("x_coset", "zh_coset_inv", "l1_coset", "sigma_evals", "roots"):
                if not torch.equal(getattr(epk, name), getattr(rebuilt, name)):
                    raise AssertionError(f"EPK table {name} rebuilt from the PK differs from the file")
            if epk.q_lookup_evals_host != rebuilt.q_lookup_evals_host:
                raise AssertionError("EPK q_lookup evaluations rebuilt from the PK differ from the file")
            say("cli", load_seconds=json.dumps(loads), epk_rebuilt_equals_file=True)
            del ck, pk, epk, rebuilt
            torch.cuda.empty_cache()

            os.remove(f["epk"] + ".npz")
            run("prove-withdraw (EPK rebuilt from PK)", withdraw, proof=True)

            # the written proof, reloaded, against keys loaded from the files
            proof = ser.proof_from_dict(ser.load_json(f["proof"]))
            compiled = CompiledCircuit(ck=None, cvk=ser.load_kzg_vk(f["cvk"]), pk=None, epk=None,
                                       vk=ser.load_verifier_key(f["vk"]))
            inst = ZKTPlonk(transcript_factory=transcript_factory("merlin"), device=dev)
            inst.verify(compiled, proof, pub)
            try:
                inst.verify(compiled, proof, [(pub[0] + 1) % inst.p] + pub[1:])
            except (VerificationError, AssertionError):
                tamper = "raised"
            else:
                raise AssertionError("the reloaded proof verified with a tampered public input")
            leaves = ser.load_json(f["tree"])["next_index"]
    finally:
        ZKTPlonk.prove = inner_prove
    if leaves != 7:
        raise AssertionError(f"tree holds {leaves} leaves after 5 deposits and 2 withdraws")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say("cli", transcript="merlin", prove_s=prove_s, ethereum_prove_cold_warm_s=list(eth_prove_s),
        reloaded_proof="verified", tamper=tamper, tree_leaves=leaves,
        peak_device_gb=round(peak_gb, 2), nvidia_smi=f"'{nvidia_smi_line()}'")
    say("cli", proof_launches=json.dumps(proof_launches))
    return launches


def sass_mix() -> None:
    """Each kernel function's SASS instruction count, split into the integer
    multiply pipe (IMAD*) and the integer ALU pipe (IADD3, LOP3, SEL, ...),
    from cuobjdump where the toolkit has it."""
    import re
    from collections import Counter

    from zkt_plonk_tpu_torch import _cuda

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        say("sass", info="cuobjdump not found")
        return
    alu = ("IADD3", "LOP3", "SEL", "ISETP", "SHF", "LEA", "PRMT", "IABS", "VIADD")
    for name in _cuda.KERNELS:
        out = subprocess.run([tool, "-sass", _cuda._lib_path(name)], capture_output=True,
                             text=True, timeout=120).stdout
        for body in re.split(r"\n\s+Function : ", out)[1:]:
            ops = Counter(m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
            fn = re.sub(r"^_ZN2zk\d+", "", body.split()[0])[:32]
            say("sass", kernel=name, fn=fn, instructions=sum(ops.values()),
                imad=sum(v for k, v in ops.items() if k.startswith("IMAD")),
                alu=sum(v for k, v in ops.items() if k.startswith(alu)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from zkt_plonk_tpu_torch import _cuda

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=f"'{smi}'", torch=torch.__version__, cuda=torch.version.cuda)

    build_s = _cuda.build_all()
    regs = []
    for name in _cuda.KERNELS:
        with open(os.path.join(_cuda.BUILD_DIR, f"{name}.log")) as f:
            lines = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        regs.append(f"{name}:{'|'.join(lines)[-400:]}")
    say("build", seconds=round(build_s, 3), kernels=len(_cuda.KERNELS))
    for r in regs:
        say("ptxas", info=r)
    sass_mix()

    records = {}
    parity_fp_binop(records, dev)
    parity_fp_pow_chain(records, dev)
    parity_ntt_col_pass(records, dev)
    parity_ec_add(records, dev)
    parity_ec_bucket_accumulate(records, dev)

    golden(dev)
    launches, eth_prove_s = withdraw(dev)
    for name, path_launches in (("withdraw", dict(launches)), ("poseidon", poseidon(dev)),
                                ("cli", cli_phase(dev, eth_prove_s))):
        say("launches", path=name, **path_launches)
        if name != "withdraw":
            for k, v in path_launches.items():
                launches[k] += v
    missing = [k for k in _cuda.KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    say("total", wall_s=round(time.perf_counter() - T_START, 1))

    kernels = []
    for name in _cuda.KERNELS:
        rec = records[name]
        rec["launches"] = launches[name]
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
