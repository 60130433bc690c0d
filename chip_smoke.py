"""Drive the PyTorch/CUDA port on one GPU and check every kernel on the card.

Run from the repository root: ``python3 chip_smoke.py``.  Needs one CUDA
card (it exits non-zero without one), ``nvcc`` and nothing else.
``--phases parity,withdraw`` runs a subset (and prints no result line).

Phases, one line each:
  1. device   — the card's name, and nvidia-smi's name and power limit;
  2. build    — nvcc builds of the seven kernel sources in csrc/ (in
                parallel), with ptxas's registers and spills for every
                kernel instance (a K4a or K6 instance that spills fails) and
                each kernel's SASS instruction mix;
                each EC instance's resident blocks per SM and registers
                from the card's occupancy call, and K4a's and K6's against
                the tables of ops/msm.py that its G rule and its chunk rule
                read (a mismatch fails);
  3. parity   — each kernel instance against its plain PyTorch version on
                the same card tensors at the main paths' shapes (and
                against Python ints on a sample), with its device time per
                call (CUDA events around calls queued back to back), the
                plain version's time and the bound: K1 on BN254's Fr and
                Fq, BLS12-381's Fr and (L = 24) BLS12-381's Fq; K2 lazy on
                BN254's Fr (one element and 2^12, e = p - 2 and 5), strict
                on BLS12-381's Fr (e = r - 2) and lazy at L = 24 on
                BLS12-381's and BLS12-377's Fq (e = q - 2, the inversion of
                a key's Z = 1 copy); K3 lazy on BN254's Fr
                and strict on BLS12-381's Fr: every fused pass of the
                (10, 2^18) iNTT and the (36, 2^18) forward transform
                (strict: the words between passes bit for bit), whole
                transforms at 2^12 and 2^18, and at the prover's shapes
                (36, 4 and 10 polynomials of 2^18) each D launches of its
                instance and nothing else; K4 on 2^16 pairs of BN254,
                BLS12-381 and BLS12-377 points (L = 16 and 24; 3b = 9, 12,
                3) with identity, doubling and inverse pairs; K4a (the
                MSM's bucket accumulation, L = 16 on BN254, L = 24 on
                BLS12-381 and BLS12-377) at n = 2^18 + 4 with B = 3 scalar
                vectors, including 0, 1, r - 1, negative-zero digits and
                runs of one digit, on the Z = 1 copy (ec.normalize) of
                points scaled to Z != 1, and its time at the prover's
                batches B = 1, 2, 3, 6 against the bound of the work its
                digits need; before it K5 (the MSM's digit recoding) at
                n = 2^18 + 4, c = 8, B = 1, 2, 3, 6 on BN254's Fr, B = 3 on
                BLS12-381's Fr, and c = 4 at n = 4,000, against the plain
                version bit for bit, with its time against its byte bound;
                after it K6 (the MSM's group merge, L = 16 on BN254, L = 24
                on BLS12-381 and BLS12-377) on K4a's buckets at the same
                n and batches, with the G rule's G, against its plain
                version bit for bit and against K4's pairwise merge as
                affine points, its time against its operation bound and
                beside the K4 merge's time;
  4. golden   — the TinyCircuit proof on the card: 802 bytes, fixed sha256;
  5. withdraw — the withdraw circuit at HEIGHT=48, NOTES=3, TABLE=1024
                (n = 2^18) on BN254: SRS setup, compile, cold and warm
                prove, verify, the warm proof again through ShardedProver
                on a world-size-1 NCCL mesh (cold, then warm; the same
                bytes; it verifies), the root and the last nullifier each
                tampered, which must raise, the warm proof's counters
                ``circuit_gates`` and ``domain_rows`` equal to the setup
                composer's gates and bound, the launch count of every kernel instance over this
                main path, and the launches inside each of its NTTs (D of
                K3, nothing else); then BatchProver with 3 rows sharing the
                card (a size-1 NCCL group and a CUDA stream each, rows in
                threads) on one witness with 3 proof seeds, each proof
                byte-equal to the single-device proof of its seed, its
                proofs/s against the same 3 proofs one after another
                (sequential, batch, batch, sequential); the staging
                (``[staging]``): 16-bit limbs copied from pinned memory and
                widened on the card equal the int32 limbs the pageable path
                copied, for columns of 2^18 rows queued back to back, with
                each path's host-to-device copy time; one more proof under
                the profiler with every staged byte pinned, its host-to-
                device ms and GB/s, and on BN254 its fixed sha256;
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
  8. bls12_withdraw — phase 5 on BLS12-381 + KZG with the Merlin
                transcript (48-byte coordinates): the same instance with
                Poseidon constants generated for BLS12-381's Fr, SRS of
                2^20 + 1 points at L = 24, K2 and K3 in their strict mode
                (the launches inside each NTT: D of ntt_col_pass/strict),
                K2 at L = 24 (the key's Z = 1 copy) and K4a at L = 24,
                and one ShardedProver proof at D = 1, byte-equal;
  9. matrix   — IPA commits on the card against the plain versions on the
                CPU (m = 2^12 on BN254, 2^10 on BLS12-381) and against the
                host MSM at m = 2^8 (``ipa.commit(device=True)``, over the
                key's ``msm_points``); then the five configurations of
                tests/test_e2e.py:101-161 (IPA on BN254, BLS12-381 and
                BLS12-377; KZG on both BLS12 curves): each proves on the
                card and on the CPU with equal fields, verifies, and fails
                its tamper probes; the KZG proofs' bytes have fixed sha256,
                and their keys' Z = 1 copies launch K2 at L = 24;
 10. sharded_d2 — two processes on the one card over gloo, every exchange
                staged through host memory (NCCL refuses two ranks on one
                GPU): a chain circuit at n = 2^11 proved by ShardedProver
                at D = 2 (the all-to-alls, global butterfly stages, rolls,
                flips, scans and the cross-rank MSM tree on CUDA tensors),
                byte-equal to the single-device proof, with each rank's
                launches;
 11. h64_n4   — the reference CLI's largest withdraw and its sizes: K3's
                coset forward and inverse transforms at 2^19 (2
                polynomials) and 2^21 (1), each against the chain of plain
                passes on the same card tensors; K5, K4a and K6 at
                n = 2^19 + 4, c = 8, B = 1, 2, 3, 6 with the G rule's G,
                each against its plain version bit for bit; then the
                withdraw at HEIGHT=64, NOTES=4, TABLE=1024 on BN254 + KZG
                + Merlin over an SRS of 2^21 + 1 points (n = 2^19, the
                configuration ``bn254_kzg_withdraw_h64_n4``): phase 5's
                proofs and checks without the sharded, batch and staged
                proofs (349,702 gates on 2^19 rows), its sha256 and the
                peak device memory;
then one JSON line of kernel records, one per instance (launches summed
over the main paths of phases 5-11, each counted from zero around its own
run), nvidia-smi's line, and the result line.
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

# the bounds' peak rates and operation counts (H100 SXM), and K4a's bounds
from zkt_plonk_tpu_torch.tools.bounds import (
    EC_ADD_OPS, EC_ADD_OPS_24, MODMUL_OPS, MODMUL_OPS_24, accumulate_bound, bound_ms, merge_bound,
    step_counts,
)
from zkt_plonk_tpu_torch.utils import profiling

ELEM_BYTES = 64  # one field element: 16 limbs of int32

GOLDEN_SHA256 = "504e1dbfaa28af3d1e9da112bbb4329374e06669416c39ec1fc8015df71d3cba"
# the SmallCircuitDef proofs of tests/test_e2e.py over KZG (Merlin, 48-byte
# coordinates): the JAX package's and the port's CPU path's bytes
MATRIX_KZG_SHA256 = {
    "bls12_381": "b2b043dfe1ab8c68d92d5b8e87142800d2af78ed6696914e381937a51481bf73",
    "bls12_377": "87afcb2106fb26cd96b1864c780e6a6294ba1dcf6073506f0fb6465a4b8fa384",
}
# the second BN254 withdraw proof from random.Random(42) at HEIGHT=48, NOTES=3,
# TABLE=1024 (Ethereum transcript), as tools/profile_withdraw.py proves it
WITHDRAW_BN254_SHA256 = "fb2ab44927b6180f6836c570f7c5271f430a83477acd23855d935592553501bb"
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


def adversarial_pairs(p: int, rng: random.Random, bits: int = 256):
    pairs = []
    for tgt in [0, 1, 2, 3, p - 1, p - 2, p - 3]:
        for _ in range(32):
            a = rng.randrange(1, p)
            pairs.append((a, tgt * pow(a, -1, p) % p))
    fixtures = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2]
    fixtures += [((1 << k) - 1) % p for k in range(16, bits + 1, 16)]
    fixtures += [(1 << k) % p for k in range(15, bits, 16)]
    pairs += [(x, y) for x in fixtures for y in fixtures]
    return pairs


def parity_fp_binop(records, dev):
    """K1 on BN254's Fr and Fq and BLS12-381's Fr (the L = 16 instance) and
    on BLS12-381's Fq (the L = 24 instance), 2^20 elements each."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR, make_spec
    from zkt_plonk_tpu_torch.fields import cuda as fc
    from zkt_plonk_tpu_torch.fields.limbs import array_to_ints, ints_to_array

    n = 1 << 20
    worst = {}
    times = {}
    timed = {BN254_FR.name: "fp_binop", BLS12_381_FQ.name: "fp_binop/L24"}
    for params in (BN254_FR, BN254_FQ, BLS12_381_FR, BLS12_381_FQ):
        spec = make_spec(params)
        L = spec.n_limbs
        key = _cuda.instance("fp_binop", L)
        p = spec.modulus
        gen = np.random.default_rng(11)
        A = random_limbs(spec, n, gen)
        B = random_limbs(spec, n, gen)
        pairs = adversarial_pairs(p, random.Random(99), 16 * L)
        A[: len(pairs)] = ints_to_array([a for a, _ in pairs], L)
        B[: len(pairs)] = ints_to_array([b for _, b in pairs], L)
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
            before = _cuda.launches[key]
            got = fc.binop(spec, op, a, b)
            if _cuda.launches[key] != before + 1:
                raise AssertionError(f"fp_binop on {params.name} did not launch {key}")
            plain = fc.binop_plain(spec, op, a, b)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain)
            worst[key] = max(worst.get(key, 0), err)
            want = [ref(x, y) for x, y in zip(a_int, b_int)]
            if err != 0 or array_to_ints(got[sample].cpu().numpy()) != want:
                raise AssertionError(f"fp_binop {op} on {params.name} disagrees (max_abs_err {err})")
            if params.name in timed:
                times[(key, op)] = (
                    time_cuda(lambda: fc.binop(spec, op, a, b)),
                    time_cuda(lambda: fc.binop_plain(spec, op, a, b), reps=3, warmup=1),
                )
        say("parity", kernel=key, field=params.name, shape="2^20", max_abs_err=worst[key])
        del a, b
    for key in timed.values():
        L = 24 if key.endswith("L24") else 16
        mul_ops = MODMUL_OPS_24 if L == 24 else MODMUL_OPS
        for op in ("mul", "add", "sub"):
            b_ms, b_by = bound_ms(3 * 4 * L * n, n * mul_ops if op == "mul" else 0)
            say("parity", kernel=f"{key}.{op}", shape=f"2^20 L={L}", ms=times[(key, op)][0],
                plain_ms=times[(key, op)][1], bound_ms=b_ms, bound_by=b_by, max_abs_err=worst[key])
        k_ms, p_ms = times[(key, "mul")]
        b_ms, b_by = bound_ms(3 * 4 * L * n, n * mul_ops)
        records[key] = dict(
            name=key, route="cuda", source="zkt_plonk_tpu_torch/csrc/fp_binop.cu",
            replaces="zkt_plonk_tpu/fields/pallas.py:310", max_abs_err=worst[key], ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )


def square_ops(nw: int) -> int:
    """32-bit multiplies of a Montgomery squaring at nw words: the
    nw (nw + 1) / 2 distinct word products and a reduction."""
    return 2 * (nw * (nw + 1) // 2) + nw + 2 * nw * nw


def parity_fp_pow_chain(records, dev):
    """K2 lazy on BN254's Fr (e = p - 2 and 5), strict on BLS12-381's Fr
    (e = r - 2, the prover's inversion) and lazy at L = 24 on BLS12-381's
    and BLS12-377's Fq (e = q - 2, the inversion of a key's Z column), at
    one element and 2^12."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields import BLS12_381_FQ, BLS12_381_FR, BN254_FR, make_spec
    from zkt_plonk_tpu_torch.fields.params import BLS12_377_FQ
    from zkt_plonk_tpu_torch.fields import cuda as fc
    from zkt_plonk_tpu_torch.fields.limbs import array_to_ints

    for params, key in ((BN254_FR, "fp_pow_chain"), (BLS12_381_FR, "fp_pow_chain/strict"),
                        (BLS12_381_FQ, "fp_pow_chain/L24"), (BLS12_377_FQ, "fp_pow_chain/L24")):
        spec = make_spec(params)
        p = spec.modulus
        L = spec.n_limbs
        modmul_ops = MODMUL_OPS_24 if L == 24 else MODMUL_OPS
        A = random_limbs(spec, 1 << 12, np.random.default_rng(5))
        A[:7] = 0
        A[7, :] = 0
        A[7, 0] = 1
        A[8] = np.asarray(spec.modulus_limbs, dtype=np.int32)
        A[8, 0] -= 1  # p - 1
        worst = 0
        timed = {}
        exponents = (p - 2, 5) if key == "fp_pow_chain" else (p - 2,)
        for e in exponents:
            sched = fc.window_schedule(e)
            squarings = sum(s for s, _ in sched.steps) + sched.tail + (sched.ntab > 1)
            multiplies = sched.products() - squarings
            ops = squarings * square_ops(L // 2) + multiplies * modmul_ops
            for n in (1, 1 << 12):
                # the prover's one element: a random one (row 9)
                rows = A[9:10] if n == 1 else A
                a = torch.from_numpy(rows).to(dev)
                _cuda.reset_launches()
                got = fc.pow_chain(spec, a, e)
                launched = {k: v for k, v in _cuda.launches.items() if v}
                if launched != {key: 1}:
                    raise AssertionError(f"fp_pow_chain on {params.name} launched {launched}")
                plain = fc.pow_chain_plain(spec, a, e)
                torch.cuda.synchronize()
                err = max_abs_err(got, plain)
                worst = max(worst, err)
                sample = list(range(min(n, 300)))
                want = [pow(x, e, p) for x in array_to_ints(rows[sample])]
                if err != 0 or array_to_ints(got[sample].cpu().numpy()) != want:
                    raise AssertionError(f"{key} e={e} n={n} disagrees (max_abs_err {err})")
                k_ms = time_cuda(lambda: fc.pow_chain(spec, a, e))
                p_ms = time_cuda(lambda: fc.pow_chain_plain(spec, a, e), reps=1, warmup=0)
                b_ms, b_by = bound_ms(2 * 4 * L * n, n * ops)
                label = "p-2" if e == p - 2 else str(e)
                say("parity", kernel=key, shape=f"{n}x{params.name},e={label}", window=sched.window,
                    products=sched.products(), squarings=squarings, ms=k_ms, plain_ms=p_ms,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
                timed[(e, n)] = (k_ms, p_ms, b_ms, b_by)
        if key == "fp_pow_chain":
            # one element: the time per product of the chain's latency, the
            # slope between the two exponents
            big, small = fc.window_schedule(p - 2).products(), fc.window_schedule(5).products()
            say("time", kernel=key, shape="1xFr", us_per_product=(
                (timed[(p - 2, 1)][0] - timed[(5, 1)][0]) * 1e3 / (big - small)))
        if params is BLS12_377_FQ:
            continue  # the record: BLS12-381's
        # the record: the prover's shape, one element, e = p - 2
        k_ms, p_ms, b_ms, b_by = timed[(p - 2, 1)]
        records[key] = dict(
            name=key, route="cuda", source="zkt_plonk_tpu_torch/csrc/fp_pow_chain.cu",
            replaces="zkt_plonk_tpu/fields/pallas.py:412", max_abs_err=worst, ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
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


def parity_ntt_col_pass(records, dev, params, key):
    """K3 on one scalar field: ``ntt_col_pass`` (lazy, BN254's Fr) or
    ``ntt_col_pass/strict`` (BLS12-381's Fr, whose words between passes are
    canonical and must equal the plain version's bit for bit)."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields.limbs import array_to_ints
    from zkt_plonk_tpu_torch.ops import ntt, ntt_mr
    from zkt_plonk_tpu_torch.utils.domain import make_domain

    strict = key.endswith("/strict")
    p = params.modulus
    gen = np.random.default_rng(21)
    worst = 0
    # whole transforms: 2^12 against the plain path on the CPU, 2^18 against
    # host Horner evaluations and round trips
    for logn in (12, 18):
        dom = make_domain(params, 1 << logn)
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
        say("parity", kernel=key, transforms=f"2^{logn}", ok=True)
        del x, outs

    # each fused pass against its plain version on the same card tensors, at
    # every pass of the (10, 2^18) iNTT of setup and the (36, 2^18) forward
    # transform of the quotient round; pass d+1 takes the kernel's own
    # output (lazy: values below 2p), the plain version its canonical form
    dom = make_domain(params, 1 << 18)
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
                raise AssertionError(f"{key} {name} nb={nb} pass {d} disagrees (max_abs_err {err})")
            if strict and not torch.equal(got, plain if last else ntt_mr.limbs_to_words(plain)):
                raise AssertionError(f"{key} {name} nb={nb} pass {d}: words differ from the plain version's")
            k_ms = time_cuda(lambda: ntt_mr.fused_pass(spec, plan, d, y, nb))
            fields = dict(ms=k_ms)
            if nb == 10:
                fields["plain_ms"] = time_cuda(
                    lambda: ntt_mr.fused_pass_plain(spec, plan, d, plain_in, nb), reps=1, warmup=0)
            b_ms, b_by = pass_bound(plan, d, nb)
            say("parity", kernel=key, shape=f"({nb},2^18) {name} pass {d} F={F}",
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
        if launched != {key: len(plan.Fs)}:
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
        say("time", kernel=key, shape=f"({nb},2^18) {name} transform", ms=k_ms, **fields,
            bound_ms=b_ms, bound_by=b_by, share=round(b_ms / k_ms, 3), launches=launched)
        del x
    torch.cuda.empty_cache()

    k_ms, p_ms, b_ms, b_by = timing
    records[key] = dict(
        name=key, route="cuda", source="zkt_plonk_tpu_torch/csrc/ntt_col_pass.cu",
        replaces="zkt_plonk_tpu/ops/ntt_mr.py:428", max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


_SRS = {}


def srs_1024(dev, curve="bn254"):
    """1024 SRS points on the card (affine-normalized, Z = 1) and their ck."""
    if (dev, curve) not in _SRS:
        from zkt_plonk_tpu_torch.commitment import kzg
        from zkt_plonk_tpu_torch.curves import make_context

        _SRS[dev, curve] = kzg.setup(make_context(curve), max_degree=1023, tau=31337, device=dev)[0]
    return _SRS[dev, curve]


def parity_ec_add(records, dev, curve="bn254", record=True):
    """K4 on 2^16 pairs of one curve's points: ``ec_add_complete`` on BN254
    (L = 16), ``ec_add_complete/L24`` on the BLS12 curves (3b = 12 and 3)."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.curves import curve_host as ch
    from zkt_plonk_tpu_torch.ops import ec, ec_cuda

    ck = srs_1024(dev, curve)
    ctx = ck.ctx
    spec = ctx.fq_spec
    L = spec.n_limbs
    key = _cuda.instance("ec_add_complete", L)
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
            raise AssertionError(f"{key} on {curve} disagrees on {label} (max_abs_err {err})")
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
                raise AssertionError(f"{key} on {curve} wrong against host affine add ({label})")
        # second round: the first round's projective outputs (Z != 1)
        a, b = got, P.flip(0).contiguous()
    before = _cuda.launches[key]
    k_ms = time_cuda(lambda: ec.add(spec, b3, P, Q))
    if _cuda.launches[key] == before:
        raise AssertionError(f"ec.add on {curve} did not launch {key}")
    p_ms = time_cuda(lambda: ec_cuda.add_plain(spec, b3.limbs, P, Q), reps=3, warmup=1)
    b_ms, b_by = bound_ms(3 * 3 * 4 * L * n, n * (EC_ADD_OPS if L == 16 else EC_ADD_OPS_24))
    say("parity", kernel=key, curve=curve, b3=b3.value, shape="2^16 pairs", ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, max_abs_err=worst)
    if not record:
        return
    records[key] = dict(
        name=key, route="cuda",
        source="zkt_plonk_tpu_torch/csrc/ec_add_complete.cu",
        replaces="zkt_plonk_tpu/ops/ec_pallas.py:99", max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def parity_msm_digits(records, dev):
    """K5 (the MSM's digit recoding) at the main paths' shapes: n = 2^18 + 4,
    c = 8, B = 3, 1, 2, 6 with the G rule's G on BN254's Fr, B = 3 on
    BLS12-381's Fr, and c = 4 at n = 4,000, B = 3; the codes equal those of
    the plain version on the same card tensors, bit for bit, for random
    scalars with 0, 1, r - 1, windows of 2^(c-1), carry chains through
    every window and negative zeros, in the first and the last columns;
    each call's time against its byte bound and the plain version's."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields import BLS12_381_FR, BN254_FR, make_spec
    from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
    from zkt_plonk_tpu_torch.ops import msm
    from zkt_plonk_tpu_torch.tools.bounds import digits_bound

    key = "msm_digits"
    gen = np.random.default_rng(47)
    n18 = (1 << 18) + 4
    cases = [(BN254_FR, n18, 8, B) for B in (3, 1, 2, 6)]
    cases += [(BLS12_381_FR, n18, 8, 3), (BN254_FR, 4000, 4, 3)]
    rec, worst = None, 0
    for params, n, c, B in cases:
        r = params.modulus
        fr_bits = r.bit_length()
        W = msm.num_windows(fr_bits + 1, c)
        G = msm.group_count(n, c, B, W, 16)
        half, full = 1 << (c - 1), 1 << c

        def runs(ds):
            return sum(ds[w % len(ds)] << (c * w) for w in range((fr_bits - 2) // c))

        edge = ints_to_array([0, 1, r - 1, runs([half]), runs([half + 1] + [half] * 80),
                              runs([full - 1]), runs([half + 1, half, full - 1])], 16)
        S_np = random_limbs(make_spec(params), B * n, gen).reshape(B, n, 16)
        S_np[0, : len(edge)] = edge
        S_np[B - 1, n - len(edge):] = edge
        S = torch.from_numpy(S_np).to(dev)
        before = _cuda.launches[key]
        got = msm.digit_rows(S, c, fr_bits, G)
        if _cuda.launches[key] != before + 1:
            raise AssertionError(f"digit_rows on the card did not launch {key}")
        plain = msm.digit_rows_plain(S, c, fr_bits, G)
        err = max_abs_err(got, plain)
        if err != 0 or got.shape != plain.shape or got.dtype != plain.dtype:
            raise AssertionError(f"{key} at n={n}, B={B}, c={c} disagrees (max_abs_err {err})")
        worst = max(worst, err)
        k_ms = time_cuda(lambda: msm.digit_rows(S, c, fr_bits, G))
        p_ms = time_cuda(lambda: msm.digit_rows_plain(S, c, fr_bits, G), reps=5, warmup=1)
        b_ms, b_by = digits_bound(B, n, 16, W, got.shape[1])
        say("parity", kernel=key, field=params.name, shape=f"n={n},B={B},c={c},G={G}", ms=k_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, bound_share=round(b_ms / k_ms, 4),
            max_abs_err=err)
        if rec is None:  # the prover's middle batch
            rec = dict(name=key, route="cuda", source="zkt_plonk_tpu_torch/csrc/msm_digits.cu",
                       replaces="none (jnp: zkt_plonk_tpu/ops/msm.py:171)", ms=k_ms,
                       plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del S, got, plain
    rec["max_abs_err"] = worst
    records[key] = rec


def parity_ec_bucket_merge(records, dev, curve="bn254", record=True):
    """K6 at the prover's batches: n = 2^18 + 4, c = 8, B = 3, 1, 2, 6 with
    the G rule's G (1024, 512, 512, 256 at B = 1, 2, 3, 6), on K4a's buckets
    of random scalars over the curve's SRS points: ``ec_bucket_merge`` on
    BN254 (L = 16), ``ec_bucket_merge/L24`` on the BLS12 curves.  Its words
    equal ``bucket_merge_plain``'s at the chunk rule's count (one launch, or
    two where that count is above one), and its sums K4's pairwise merge's
    (``tree_reduce`` of ``ec.add``) as affine points in two rows; its time
    behind the spin kernel against its operation bound, beside the K4
    merge's time on the same buckets."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.ops import ec, msm
    from zkt_plonk_tpu_torch.utils.scan import tree_reduce

    ck = srs_1024(dev, curve)
    ctx = ck.ctx
    spec = ctx.fq_spec
    L = spec.n_limbs
    key = _cuda.instance("ec_bucket_merge", L)
    fr_bits = ctx.curve.fr.modulus.bit_length()
    top = int(ctx.fr_spec.modulus_limbs[-1])
    gen = np.random.default_rng(53)
    c = 8
    K = (1 << (c - 1)) + 1
    n = (1 << 18) + 4
    W = msm.num_windows(fr_bits + 1, c)
    pts = ck.powers[torch.arange(n, device=dev) % 1024].contiguous()
    add = lambda a, b: ec.add(spec, ck.b3, a, b)
    rec, worst = None, 0
    for B in (3, 1, 2, 6):
        G = msm.group_count(n, c, B, W, L)
        limbs = gen.integers(0, 1 << 16, size=(B, n, 16), dtype=np.int64)
        limbs[..., 15] = gen.integers(0, top, size=(B, n))
        digits = msm.digit_rows(torch.from_numpy(limbs.astype(np.int32)).to(dev), c, fr_bits, G)
        buckets = msm.bucket_accumulate(spec, ck.b3, pts, digits, G, c)
        del digits
        C = msm.merge_chunks(G, B * W * (K - 1), L)
        before = _cuda.launches[key]
        got = msm.bucket_merge(spec, ck.b3, buckets)
        if _cuda.launches[key] != before + (2 if C > 1 else 1):
            raise AssertionError(f"bucket_merge on {curve} launched {key} "
                                 f"{_cuda.launches[key] - before} times at {C} chunks")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = msm.bucket_merge_plain(spec, ck.b3, buckets, C)
        end.record()
        end.synchronize()
        p_ms = start.elapsed_time(end)
        err = max_abs_err(got, plain)
        if err != 0:
            raise AssertionError(f"{key} on {curve} at B={B} disagrees (max_abs_err {err})")
        worst = max(worst, err)
        del plain
        tree = tree_reduce(add, buckets, 0)
        for bw in (0, B * W - 1):
            if ec.to_affine_host(spec, got[bw, 1:]) != ec.to_affine_host(spec, tree[bw, 1:]):
                raise AssertionError(f"{key} on {curve} at B={B}: row {bw} differs from K4's merge")
        del got, tree
        k_ms = time_cuda(lambda: msm.bucket_merge(spec, ck.b3, buckets))
        t_ms = time_cuda(lambda: tree_reduce(add, buckets, 0), reps=5, warmup=1)
        b_ms, b_by = merge_bound(G, B * W, K, L)
        shape = f"n=2^18+4,B={B},c={c},G={G}"
        say("parity", kernel=key, curve=curve, shape=shape, chunks=C, ms=k_ms, k4_merge_ms=t_ms,
            plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, bound_share=round(b_ms / k_ms, 4),
            max_abs_err=err)
        if rec is None:  # the prover's middle batch
            rec = dict(name=key, route="cuda", source="zkt_plonk_tpu_torch/csrc/ec_bucket_merge.cu",
                       replaces="zkt_plonk_tpu/ops/msm.py:72-88 (ec_pallas.py:99)", ms=k_ms,
                       plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del buckets
    rec["max_abs_err"] = worst
    if record:
        records[key] = rec
    torch.cuda.empty_cache()


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


def parity_ec_bucket_accumulate(records, dev, curve="bn254", log_n=18, record=True):
    """K4a at n = 2^18 + 4 on one curve's points: ``ec_bucket_accumulate``
    on BN254 (L = 16), ``ec_bucket_accumulate/L24`` on the BLS12 curves.
    The points are the Z = 1 copy (``ec.normalize``, as a key's
    ``msm_points`` builds it) of the SRS points scaled by random factors to
    Z != 1: the copy equal to the points, the buckets at B = 3 equal to the
    plain version's, four rows against host adds; then the times at the
    prover's other batches.  ``record`` keeps the instance's record."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields import device as fd
    from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
    from zkt_plonk_tpu_torch.ops import ec, msm

    ck = srs_1024(dev, curve)
    ctx = ck.ctx
    spec = ctx.fq_spec
    L = spec.n_limbs
    key = _cuda.instance("ec_bucket_accumulate", L)
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
    G = msm.group_count(n, c, B, msm.num_windows(fr_bits + 1, c), L)
    shape = f"n=2^{log_n}+4,B={B},c={c},G={G}"
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
    lam = torch.from_numpy(random_limbs(spec, n, np.random.default_rng(61))).to(dev)
    lam[:, 0] |= 1  # never zero
    copy = ec.normalize(spec, fd.mul(spec, pts, lam[:, None]))
    if not torch.equal(copy, pts):
        raise AssertionError("ec.normalize of the scaled points is not the points")
    del pts, lam
    digits = msm.digit_rows(torch.from_numpy(S_np).to(dev), c, fr_bits, G)
    before = _cuda.launches[key]
    got = msm.bucket_accumulate(spec, ck.b3, copy, digits, G, c)
    if _cuda.launches[key] != before + 1:
        raise AssertionError(f"bucket_accumulate on {curve} did not launch {key}")
    # the plain version once (seconds at this size), timed by CUDA events
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = msm.bucket_accumulate_plain(spec, ck.b3, copy, digits, G, c)
    end.record()
    end.synchronize()
    p_ms = start.elapsed_time(end)
    err = max_abs_err(got, plain)
    if err != 0:
        raise AssertionError(f"{key} on {curve} disagrees (max_abs_err {err})")
    del plain
    W = digits.shape[0] // B
    pts_host = ec.to_affine_host(spec, ck.powers)
    pts_host = [pts_host[i % 1024] for i in range(n)]
    digits_h = digits.cpu()
    for g, bw in ((0, 0), (3 % G, W + 5), (9 % G, 2 * W + 1), (G - 1, 3 * W - 1)):
        if ec.to_affine_host(spec, got[g, bw]) != _host_row(ck, pts_host, digits_h, g, bw, G, K):
            raise AssertionError(f"{key} row ({g}, {bw}) wrong against host adds")
    del got
    k_ms = time_cuda(lambda: msm.bucket_accumulate(spec, ck.b3, copy, digits, G, c),
                     reps=3, warmup=1)
    b_ms, b_by = accumulate_bound(digits, n, G, K, L)
    first, repeat, padding = step_counts(digits, n, G, K)
    say("parity", kernel=key, curve=curve, shape=shape, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, bound_share=round(b_ms / k_ms, 4), first_hits=first, repeat_hits=repeat,
        padding_hits=padding, max_abs_err=err)
    if record:
        records[key] = dict(
            name=key, route="cuda",
            source="zkt_plonk_tpu_torch/csrc/ec_bucket_accumulate.cu",
            replaces="zkt_plonk_tpu/ops/ec_pallas.py:99", max_abs_err=err, ms=k_ms, plain_ms=p_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
    del digits
    # the prover's other commit batches
    for B in (1, 2, 6):
        G = msm.group_count(n, c, B, msm.num_windows(fr_bits + 1, c), L)
        digits = msm.digit_rows(torch.from_numpy(scalars(B)).to(dev), c, fr_bits, G)
        ms = time_cuda(lambda: msm.bucket_accumulate(spec, ck.b3, copy, digits, G, c),
                       reps=3, warmup=1)
        b_ms, b_by = accumulate_bound(digits, n, G, K, L)
        say("time", kernel=key, curve=curve, shape=f"n=2^{log_n}+4,B={B},c={c},G={G}", ms=ms,
            bound_ms=b_ms, bound_by=b_by, bound_share=round(b_ms / ms, 4))
        del digits
    torch.cuda.empty_cache()


def parity_ntt_at(dev, log_n, nb):
    """K3 (lazy, BN254's Fr) at a size the n = 2^18 phases do not reach: the
    coset forward and inverse transforms of nb polynomials of 2^log_n, each
    D launches of K3 and nothing else, against the chain of plain passes
    (``fused_pass_plain``) on the same card tensors; the round trip; the
    forward transform at three points against host Horner evaluations."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields import BN254_FR
    from zkt_plonk_tpu_torch.fields.limbs import array_to_ints
    from zkt_plonk_tpu_torch.ops import ntt_mr
    from zkt_plonk_tpu_torch.utils.domain import make_domain

    key = "ntt_col_pass"
    dom = make_domain(BN254_FR, 1 << log_n)
    spec, n, p = dom.spec, dom.size, dom.modulus
    plans = dom.plan(dev)
    X = random_limbs(spec, nb * n, np.random.default_rng(log_n)).reshape(nb, n, 16)
    x = torch.from_numpy(X).to(dev)
    outs = {}
    for name, plan in (("coset_fft", plans.coset_fwd), ("coset_ifft", plans.coset_inv)):
        before = dict(_cuda.launches)
        got = ntt_mr.transform(spec, plan, x)
        launched = launch_delta(before)
        if launched != {key: len(plan.Fs)}:
            raise AssertionError(f"({nb}, 2^{log_n}) {name} launched {launched}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain = x
        for d in range(len(plan.Fs)):
            plain = ntt_mr.fused_pass_plain(spec, plan, d, plain, nb)
        end.record()
        end.synchronize()
        err = max_abs_err(got, plain)
        if err != 0:
            raise AssertionError(f"{key} ({nb}, 2^{log_n}) {name} disagrees (max_abs_err {err})")
        del plain
        k_ms = time_cuda(lambda: ntt_mr.transform(spec, plan, x), reps=5, warmup=1)
        b_ms, b_by = transform_bound(dom, name, nb)
        say("parity", kernel=key, shape=f"({nb},2^{log_n}) {name}",
            factors="x".join(str(F) for F in plan.Fs), ms=k_ms,
            plain_ms=start.elapsed_time(end), bound_ms=b_ms, bound_by=b_by,
            share=round(b_ms / k_ms, 3), max_abs_err=err)
        outs[name] = got
    if not torch.equal(ntt_mr.transform(spec, plans.coset_inv, outs["coset_fft"]), x):
        raise AssertionError(f"coset_ifft(coset_fft(x)) != x at 2^{log_n}")
    coeffs = array_to_ints(X[0])
    fwd = outs["coset_fft"][0].cpu().numpy()
    for k in (0, n // 3, n - 1):
        want = _horner(coeffs, dom.coset_gen * pow(dom.group_gen, k, p) % p, p)
        if array_to_ints(fwd[k : k + 1])[0] != want:
            raise AssertionError(f"coset_fft at 2^{log_n} wrong at index {k}")
    del x, outs
    torch.cuda.empty_cache()


def parity_msm_at(dev, log_n):
    """The MSM's kernels at n = 2^log_n + 4, c = 8, at the prover's batches
    B = 1, 2, 3, 6 with the G rule's G: K5's digit codes, K4a's buckets and
    K6's merged columns, each against its plain version on the same card
    tensors (``digit_rows_plain``, ``bucket_accumulate_plain``,
    ``bucket_merge_plain`` at the chunk rule's count), bit for bit, with
    each kernel's time.  Random BN254 scalars, with 0, 1 and r - 1 in the
    first columns, over the SRS points cycled."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
    from zkt_plonk_tpu_torch.ops import msm

    ck = srs_1024(dev)
    ctx = ck.ctx
    spec = ctx.fq_spec
    L = spec.n_limbs
    r = ctx.curve.fr.modulus
    fr_bits = r.bit_length()
    top = int(ctx.fr_spec.modulus_limbs[-1])
    gen = np.random.default_rng(log_n)
    c = 8
    K = (1 << (c - 1)) + 1
    n = (1 << log_n) + 4
    W = msm.num_windows(fr_bits + 1, c)
    pts = ck.powers[torch.arange(n, device=dev) % 1024].contiguous()
    keys = ("msm_digits", _cuda.instance("ec_bucket_accumulate", L),
            _cuda.instance("ec_bucket_merge", L))
    for B in (1, 2, 3, 6):
        G = msm.group_count(n, c, B, W, L)
        C = msm.merge_chunks(G, B * W * (K - 1), L)
        limbs = gen.integers(0, 1 << 16, size=(B, n, 16), dtype=np.int64)
        limbs[..., 15] = gen.integers(0, top, size=(B, n))
        limbs[0, :3] = ints_to_array([0, 1, r - 1], 16)
        S = torch.from_numpy(limbs.astype(np.int32)).to(dev)
        before = dict(_cuda.launches)
        digits = msm.digit_rows(S, c, fr_bits, G)
        buckets = msm.bucket_accumulate(spec, ck.b3, pts, digits, G, c)
        merged = msm.bucket_merge(spec, ck.b3, buckets)
        launched = {k: _cuda.launches[k] - before[k] for k in keys}
        if launched != dict(zip(keys, (1, 1, 2 if C > 1 else 1))):
            raise AssertionError(f"the MSM at n=2^{log_n}+4, B={B} launched {launched}")
        errs = {
            "msm_digits": max_abs_err(digits, msm.digit_rows_plain(S, c, fr_bits, G)),
            keys[1]: max_abs_err(buckets, msm.bucket_accumulate_plain(spec, ck.b3, pts, digits, G, c)),
            keys[2]: max_abs_err(merged, msm.bucket_merge_plain(spec, ck.b3, buckets, C)),
        }
        if any(errs.values()):
            raise AssertionError(f"the MSM at n=2^{log_n}+4, B={B} disagrees: {errs}")
        ms = {
            "k5_ms": time_cuda(lambda: msm.digit_rows(S, c, fr_bits, G), reps=5, warmup=1),
            "k4a_ms": time_cuda(lambda: msm.bucket_accumulate(spec, ck.b3, pts, digits, G, c),
                                reps=3, warmup=1),
            "k6_ms": time_cuda(lambda: msm.bucket_merge(spec, ck.b3, buckets), reps=5, warmup=1),
        }
        b_ms, _ = accumulate_bound(digits, n, G, K, L)
        say("parity", kernels="K5,K4a,K6", shape=f"n=2^{log_n}+4,B={B},c={c},G={G}", chunks=C,
            **ms, k4a_bound_share=round(b_ms / ms["k4a_ms"], 4),
            max_abs_err=max(errs.values()))
        del S, digits, buckets, merged
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


@contextlib.contextmanager
def transform_launches(key):
    """Every transform of a main path run inside: its launches by kernel,
    counted by ``ntt_mr.transform``'s shape (per_transform), and those that
    launched anything but D passes of K3 instance ``key`` (bad)."""
    from collections import Counter

    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.ops import ntt_mr

    per_transform, bad = Counter(), []
    inner = ntt_mr.transform

    def counted(spec, plan, x):
        before = dict(_cuda.launches)
        out = inner(spec, plan, x)
        delta = launch_delta(before)
        per_transform[f"D={len(plan.Fs)}:" + ",".join(f"{k}={v}" for k, v in delta.items())] += 1
        if delta != {key: len(plan.Fs)}:
            bad.append(delta)
        return out

    ntt_mr.transform = counted
    try:
        yield per_transform, bad
    finally:
        ntt_mr.transform = inner


def merlin(coord_bytes):
    """The factory of the Merlin transcript with ``coord_bytes``-byte
    coordinates, as ``ZKTPlonk`` takes it."""
    from zkt_plonk_tpu_torch.transcript.merlin import MerlinTranscript

    return lambda label: MerlinTranscript(label, coord_bytes=coord_bytes)


def withdraw(dev, height=48, notes=3, table_size=1024, curve="bn254", phase="withdraw",
             transcript=None):
    """The withdraw circuit on one curve over an SRS of 4 x its bound, the
    degree ``compile`` trims to: BN254 + KZG with the Ethereum transcript
    (phase ``withdraw``, the default), BLS12-381 + KZG with Merlin and
    48-byte coordinates (phase ``bls12_withdraw``: K3 and K2 in their
    strict mode, K4 and K4a at L = 24), or the reference CLI's largest,
    HEIGHT=64, NOTES=4 on BN254 + Merlin (phase ``withdraw_h64_n4``:
    n = 2^19 on 2^21 + 1 points).  Compile, cold and warm prove, verify,
    the root and the last nullifier each tampered; every transform D
    launches of K3; the warm proof's MSM launches and its counters
    ``circuit_gates`` and ``domain_rows`` (the setup composer's gates and
    bound).  The two n = 2^18 phases go on to the sharded and staged proofs
    (``withdraw`` holds its sha256 to the golden digest there) and
    ``withdraw`` to the batch phase."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.circuits.withdraw_instance import build
    from zkt_plonk_tpu_torch.commitment import kzg
    from zkt_plonk_tpu_torch.cs import ConstraintSystem
    from zkt_plonk_tpu_torch.plonk import ZKTPlonk
    from zkt_plonk_tpu_torch.proof_system.proof import VerificationError
    from zkt_plonk_tpu_torch.transcript import EthereumTranscript

    def clock(t0):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    circuit, table, pub_inputs = build(height, notes, table_size, curve=curve)
    inst = ZKTPlonk(curve=curve, transcript_factory=transcript or EthereumTranscript,
                    table=table, device=dev)
    ntt_key = "ntt_col_pass" if curve == "bn254" else "ntt_col_pass/strict"
    cs = ConstraintSystem(inst.p, setup=True, lookup_table=table)
    circuit.synthesize(cs)
    bound = cs.circuit_bound()
    say(phase, curve=curve, height=height, notes=notes, table=table_size, gates=cs.n, n=bound,
        build_seconds=clock(t0))

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with transform_launches(ntt_key) as (per_transform, bad):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        ck, cvk = kzg.setup(inst.ctx, max_degree=4 * bound, tau=987654321, device=dev)
        srs_s = clock(t0)
        t0 = time.perf_counter()
        compiled = inst.compile(circuit, ck, cvk)
        compile_s = clock(t0)
        t0 = time.perf_counter()
        rng42 = random.Random(42)
        inst.prove(compiled, circuit, rng=rng42)
        cold_s = clock(t0)
        before, counts0 = dict(_cuda.launches), profiling.snapshot()
        t0 = time.perf_counter()
        proof = inst.prove(compiled, circuit, rng=random.Random(WARM_SEED))
        warm_s = clock(t0)
        single_launches = launch_delta(before)
        counts = {k: v - counts0[k] for k, v in profiling.snapshot().items()}
        t0 = time.perf_counter()
        inst.verify(compiled, proof, pub_inputs)
        verify_s = clock(t0)
        if phase != "withdraw_h64_n4":
            # the same proof through ShardedProver on a world-size-1 NCCL
            # mesh: the same bytes, each transform still D launches of K3
            sharded_proofs(phase, dev, inst, compiled, circuit, pub_inputs,
                           proof_bytes(inst, proof), warm_s, single_launches)
        launches = dict(_cuda.launches)
    if phase != "withdraw_h64_n4":
        staged_proof(phase, dev, inst, compiled, circuit, rng42)
    for k in (0, notes):  # the root, then the last nullifier
        tampered = list(pub_inputs)
        tampered[k] = (tampered[k] + 1) % inst.p
        try:
            inst.verify(compiled, proof, tampered)
        except (VerificationError, AssertionError):
            pass
        else:
            raise AssertionError(f"{phase}: verification passed with public input {k} tampered")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    say(phase, srs_setup_s=srs_s, srs_points=4 * bound + 1, compile_s=compile_s,
        prove_cold_s=cold_s, prove_warm_s=warm_s, verify_s=verify_s, tamper="raised",
        peak_device_gb=round(peak_gb, 2), circuit_gates=counts["circuit_gates"],
        domain_rows=counts["domain_rows"],
        proof_sha256=hashlib.sha256(proof_bytes(inst, proof)).hexdigest(),
        nvidia_smi=f"'{nvidia_smi_line()}'")
    say("launches", path=phase, **launches)
    say("ntt", path=phase, transforms=sum(per_transform.values()),
        launches_per_transform=dict(per_transform))
    if bad:
        raise AssertionError(f"{phase}: transforms that launched more than their D passes of K3: {bad}")
    if (counts["circuit_gates"], counts["domain_rows"]) != (cs.n, bound):
        raise AssertionError(f"{phase}: a proof counted {counts['circuit_gates']} gates and "
                             f"{counts['domain_rows']} rows: want {cs.n} and {bound}")
    msm_launches(phase, "single_device", single_launches, inst.ctx.fq_spec.n_limbs)
    if curve != "bn254" and launches["fp_pow_chain/L24"] == 0:
        raise AssertionError(f"{phase}: the key's Z = 1 copy launched no fp_pow_chain/L24")
    paths = {phase: launches}
    if phase == "withdraw":
        paths["withdraw_batch"] = batch_phase(dev, inst, compiled, circuit, pub_inputs)
    return paths, (cold_s, warm_s)


WARM_SEED = 43
BATCH_ROWS = 3


def htod_seconds(ops, copies: int, source: str = ""):
    """Device seconds of the host-to-device copies among a profiler run's
    ``profiling.device_intervals``, those from ``source`` memory
    ("Pageable", "Pinned") or all; None where the trace holds fewer than
    the ``copies`` made (a later profiler run of one process can come back
    without some of them)."""
    got = [b - a for cat, name, a, b in ops
           if cat == "gpu_memcpy" and "HtoD" in name and source in name]
    return sum(got) if len(got) >= copies else None


def ms_and_rate(nbytes: int, seconds):
    """(ms, GB/s) of a copy time, or (None, None) where it is unknown."""
    if seconds is None:
        return None, None
    return round(1e3 * seconds, 3), round(nbytes / seconds / 1e9, 2)


def staging(phase, dev, spec, rows=1 << 18, batches=4, k=3):
    """``batches`` uploads of k columns of ``rows`` ints queued back to back
    with no sync between them, each equal on the card to the int32 limbs
    the pageable path copied; each path's host-to-device copy time and rate."""
    from zkt_plonk_tpu_torch.fields import device as fd
    from zkt_plonk_tpu_torch.fields.limbs import ints_to_array

    rng = random.Random(7)
    p, L = spec.modulus, spec.n_limbs
    trap = sum(0xFFFF << (16 * i) for i in range(L - 1))  # every limb but the top 0xffff
    edge = [0, 1, p - 1, trap % p]
    blocks = [[edge + [rng.getrandbits(p.bit_length() - 1) for _ in range(rows - len(edge))]
               for _ in range(k)] for _ in range(batches)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        old = [torch.from_numpy(np.stack([ints_to_array(c, L) for c in cols]).astype(np.int32))
               .to(dev) for cols in blocks]
        torch.cuda.synchronize()
        new = [fd.upload(L, cols, dev) for cols in blocks]
        torch.cuda.synchronize()
    ops = profiling.device_intervals(prof)
    equal = all(torch.equal(a, b) for a, b in zip(old, new))
    nbytes = batches * k * rows * L
    pageable = ms_and_rate(4 * nbytes, htod_seconds(ops, batches, "Pageable"))
    pinned = ms_and_rate(2 * nbytes, htod_seconds(ops, batches, "Pinned"))
    say("staging", path=phase, shape=f"{batches}x({k},{rows},{L})", equal=equal,
        pageable_int32_ms=pageable[0], pageable_gb_per_s=pageable[1],
        pinned_uint16_ms=pinned[0], pinned_gb_per_s=pinned[1])
    if not equal:
        raise AssertionError(f"{phase}: the staged limbs differ from the pageable path's")


def staged_proof(phase, dev, inst, compiled, circuit, rng):
    """One more warm proof, under the profiler: every staged byte copied
    from pinned memory, its host-to-device ms and rate, and on BN254 the
    fixed sha256 of the second proof of ``random.Random(42)``."""
    staging(phase, dev, inst.ctx.fr_spec)
    before = profiling.snapshot()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        proof = inst.prove(compiled, circuit, rng=rng)
        torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in profiling.snapshot().items()}
    htod = ms_and_rate(counts["h2d_bytes"],
                       htod_seconds(profiling.device_intervals(prof), counts["h2d_copies"]))
    digest = hashlib.sha256(proof_bytes(inst, proof)).hexdigest()
    say("staging", path=phase, proof_sha256=digest, h2d_bytes=counts["h2d_bytes"],
        h2d_pinned_bytes=counts["h2d_pinned_bytes"], h2d_copies=counts["h2d_copies"],
        htod_ms=htod[0], htod_gb_per_s=htod[1],
        pinned_host=json.dumps({k: v for k, v in torch.cuda.host_memory_stats().items()
                                if "bytes" in k}))
    if counts["h2d_pinned_bytes"] != counts["h2d_bytes"]:
        raise AssertionError(f"{phase}: {counts['h2d_pinned_bytes']} of {counts['h2d_bytes']} "
                             "staged bytes copied from pinned memory")
    if phase == "withdraw" and digest != WITHDRAW_BN254_SHA256:
        raise AssertionError(f"withdraw: the second proof of random.Random(42) has sha256 {digest}")


def proof_bytes(inst, proof) -> bytes:
    from zkt_plonk_tpu_torch.utils import arkserde

    return arkserde.proof_to_bytes(proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def world_of_one():
    """The default process group of this process alone, over NCCL (the
    card's transport), torn down on exit."""
    import torch.distributed as dist

    from zkt_plonk_tpu_torch import parallel

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: loopback only
    parallel.init_distributed("nccl", init_method=f"tcp://localhost:{free_port()}",
                              world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def launch_delta(before):
    """The launches since ``before`` (a copy of ``_cuda.launches``), by instance."""
    from zkt_plonk_tpu_torch import _cuda

    return {k: v - before[k] for k, v in _cuda.launches.items() if v != before[k]}


def sharded_proofs(phase, dev, inst, compiled, circuit, pub_inputs, want, single_warm_s,
                   single_launches):
    """Two proofs (cold, then warm) through ``ShardedProver`` at D = 1 over
    NCCL, then the single-device warm proof again, each with a fresh
    ``random.Random(WARM_SEED)``: every one the bytes of the single-device
    proof of that seed; the sharded proof verifies.  Prints the seconds and
    the launches of each warm proof."""
    from zkt_plonk_tpu_torch import _cuda, parallel

    secs = []
    with world_of_one():
        t0 = time.perf_counter()
        mesh = parallel.make_mesh(device=dev)
        sp = parallel.ShardedProver(inst.prover(compiled), mesh)
        for _ in range(2):
            before = dict(_cuda.launches)
            proof = inst.prove(compiled, circuit, rng=random.Random(WARM_SEED), prover=sp)
            torch.cuda.synchronize()
            secs.append(round(time.perf_counter() - t0, 3))
            if proof_bytes(inst, proof) != want:
                raise AssertionError(f"{phase}: the D = 1 sharded proof differs from the single-device proof")
            t0 = time.perf_counter()
        sharded_launches = launch_delta(before)
        inst.verify(compiled, proof, pub_inputs)
        transport = mesh.transport
    t0 = time.perf_counter()
    again = inst.prove(compiled, circuit, rng=random.Random(WARM_SEED))
    torch.cuda.synchronize()
    single_again_s = round(time.perf_counter() - t0, 3)
    if proof_bytes(inst, again) != want:
        raise AssertionError(f"{phase}: the single-device proof changed between two runs")
    say(phase, sharded=f"D={mesh.D}", transport=transport, sharded_prove_cold_warm_s=secs,
        single_device_warm_s=[single_warm_s, single_again_s], bytes_equal=True, verified=True,
        nvidia_smi=f"'{nvidia_smi_line()}'")
    say(phase, launches_per_warm_proof=json.dumps({"single_device": single_launches,
                                                   "sharded_d1": sharded_launches}))
    msm_launches(phase, "sharded_d1", sharded_launches, inst.ctx.fq_spec.n_limbs)


def msm_launches(phase, path, got, n_limbs):
    """A warm proof's commits run K4a at the key's width ``n_limbs``, each
    batch's digits from K5 and its merge on K6 (one or two launches)."""
    from zkt_plonk_tpu_torch import _cuda

    key = _cuda.instance("ec_bucket_accumulate", n_limbs)
    if got.get(key, 0) == 0:
        raise AssertionError(f"{phase} {path}: K4a launches {got}: want {key}")
    if got.get("msm_digits", 0) != got[key]:
        raise AssertionError(f"{phase} {path}: {got[key]} K4a launches, "
                             f"{got.get('msm_digits', 0)} of msm_digits")
    merges = got.get(_cuda.instance("ec_bucket_merge", n_limbs), 0)
    if not got[key] <= merges <= 2 * got[key]:
        raise AssertionError(f"{phase} {path}: {got[key]} K4a launches, {merges} of K6: "
                             f"want one or two a batch")


def device_busy_share(fn):
    """The share of ``fn``'s wall time, run once under ``torch.profiler``,
    in which the card ran a kernel or a copy: the union of the device
    intervals of the trace over the wall time (the profiler slows the host,
    so the share is a lower bound's neighbour, not the unprofiled one).
    None when the trace holds no device interval."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = profiling.union([(a, b) for _, _, a, b in profiling.device_intervals(prof)])
    if not busy:
        return None
    return round(sum(b - a for a, b in busy) / wall, 4)


def batch_phase(dev, inst, compiled, circuit, pub_inputs, k=BATCH_ROWS):
    """``BatchProver`` with k rows sharing the card (world size 1, a size-1
    NCCL group and a CUDA stream per row) on one witness with k proof seeds,
    against the same k proofs proved one after another: sequential, batch,
    batch, sequential, then each once more under the profiler for the
    card's busy share.  Each batch proof is byte-equal to the single-device
    proof of its seed.  Returns the launches of the six runs."""
    from zkt_plonk_tpu_torch import _cuda, parallel

    seeds = [100 + i for i in range(k)]
    with world_of_one():
        mesh2d = parallel.make_mesh((k, 1), ("data", "poly"), device=dev)
        bp = parallel.BatchProver(inst.prover(compiled), mesh2d)

        def sequential():
            return [inst.prove(compiled, circuit, rng=random.Random(s)) for s in seeds]

        def batch():
            statements = [inst.statement(compiled, circuit) for _ in seeds]
            return bp.prove_batch([c for c, _ in statements], [t for _, t in statements],
                                  [random.Random(s) for s in seeds])

        torch.cuda.synchronize()
        _cuda.reset_launches()
        want = None
        secs = {"sequential": [], "batch": []}
        for run, fn in (("sequential", sequential), ("batch", batch), ("batch", batch),
                        ("sequential", sequential)):
            t0 = time.perf_counter()
            proofs = fn()
            torch.cuda.synchronize()
            secs[run].append(round(time.perf_counter() - t0, 3))
            got = [proof_bytes(inst, pr) for pr in proofs]
            want = want or got
            if got != want:
                raise AssertionError(f"{run} proofs differ from the single-device proofs of their seeds")
            if run == "batch" and len(secs["batch"]) == 1:
                inst.verify(compiled, proofs[-1], pub_inputs)
        busy = {run: device_busy_share(fn) for run, fn in (("sequential", sequential), ("batch", batch))}
        launches = dict(_cuda.launches)
        transports = sorted({m.transport for m in mesh2d.rows})
    seq_rate = k / (sum(secs["sequential"]) / 2)
    batch_rate = k / (sum(secs["batch"]) / 2)
    say("withdraw_batch", rows=k, seeds=seeds, transport=transports, sequential_s=secs["sequential"],
        batch_s=secs["batch"], sequential_proofs_per_s=round(seq_rate, 3),
        batch_proofs_per_s=round(batch_rate, 3), ratio=round(batch_rate / seq_rate, 3),
        bytes_equal=True, verified=True,
        device_busy_share=json.dumps({r: "not measured" if v is None else v for r, v in busy.items()}),
        nvidia_smi=f"'{nvidia_smi_line()}'")
    return launches


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

    launches = {k: 0 for k in _cuda.INSTANCES}
    proof_launches = {k: 0 for k in _cuda.INSTANCES}
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
    say("cli", transcript="merlin", prove_s=prove_s, ethereum_prove_cold_warm_s=list(eth_prove_s or ()),
        reloaded_proof="verified", tamper=tamper, tree_leaves=leaves,
        peak_device_gb=round(peak_gb, 2), nvidia_smi=f"'{nvidia_smi_line()}'")
    say("cli", proof_launches=json.dumps(proof_launches))
    return launches


class SmallCircuit:
    """``tests/test_e2e.py:SmallCircuitDef``: c = a * b public, a in the table."""

    def synthesize(self, cs):
        from zkt_plonk_tpu_torch.cs import lt

        a = cs.assign_variable(2)
        b = cs.assign_variable(3)
        c = cs.mul_gate(lt(a), lt(b))
        cs.set_variable_public(lt(c))
        cs.lookup_constrain(lt(a))


# tests/test_e2e.py:101-161, (scheme, curve, tau, seed): IPA on the three
# curves (max_degree 32), KZG on the two BLS12 curves (max_degree 64);
# BN254 + KZG is the golden proof of phase 4
MATRIX = (
    ("ipa", "bn254", None, 11),
    ("ipa", "bls12_381", None, 14),
    ("ipa", "bls12_377", None, 15),
    ("kzg", "bls12_381", 24680, 12),
    ("kzg", "bls12_377", 13579, 13),
)


def proof_fields(proof):
    """Every field of a proof as plain ints, tuples and lists."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(proof):
        v = getattr(proof, f.name)
        if f.name == "evaluations":
            out[f.name] = dataclasses.astuple(v)
        elif hasattr(v, "a_final"):  # an IPA opening
            out[f.name] = (list(v.l_points), list(v.r_points), v.a_final)
        else:
            out[f.name] = None if v is None else (int(v[0]), int(v[1]))
    return out


def matrix(dev):
    """The reference's curve x scheme matrix beside BN254 + KZG: each
    configuration proves on the card and on the CPU (the plain versions),
    the two proofs equal field for field, the card's verifies and fails its
    tamper probes.  Returns the launches of the card's compiles and proofs."""
    import copy

    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.commitment import ipa, kzg
    from zkt_plonk_tpu_torch.cs import LookupTable
    from zkt_plonk_tpu_torch.curves import make_context
    from zkt_plonk_tpu_torch.plonk import ZKTPlonk
    from zkt_plonk_tpu_torch.proof_system.proof import VerificationError
    from zkt_plonk_tpu_torch.transcript import EthereumTranscript
    from zkt_plonk_tpu_torch.utils import arkserde

    launches = {k: 0 for k in _cuda.INSTANCES}
    for scheme, curve, tau, seed in MATRIX:
        ctx = make_context(curve)
        transcript = EthereumTranscript if curve == "bn254" else merlin(48)
        if scheme == "ipa":
            ck, _ = ipa.setup(ctx, max_degree=32, device=dev)
            ck_cpu = ipa.make_key(ctx, ck.gens, ck.u, device="cpu")
            keys = {"card": (ck, ck), "cpu": (ck_cpu, ck_cpu)}
        else:
            keys = {"card": kzg.setup(ctx, max_degree=64, tau=tau, device=dev),
                    "cpu": kzg.setup(ctx, max_degree=64, tau=tau, device="cpu")}
        proofs, secs = {}, {}
        for where, (ck, cvk) in keys.items():
            inst = ZKTPlonk(curve=curve, transcript_factory=transcript,
                            table=LookupTable([1, 2, 5], size=4),
                            device=dev if where == "card" else "cpu")
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            compiled = inst.compile(SmallCircuit(), ck, cvk)
            proofs[where] = inst.prove(compiled, SmallCircuit(), random.Random(seed))
            torch.cuda.synchronize()
            secs[where] = round(time.perf_counter() - t0, 3)
            if where == "card":
                if scheme == "kzg" and not _cuda.launches["fp_pow_chain/L24"]:
                    raise AssertionError(f"kzg {curve}: the key's Z = 1 copy launched no "
                                         "fp_pow_chain/L24")
                for k, v in _cuda.launches.items():
                    launches[k] += v
                card = (inst, compiled)
        inst, compiled = card
        proof = proofs["card"]
        if proof_fields(proof) != proof_fields(proofs["cpu"]):
            raise AssertionError(f"{scheme} {curve}: the card's proof differs from the CPU's")
        inst.verify(compiled, proof, [6])
        tampered = copy.deepcopy(proof)
        tampered.evaluations.a = (tampered.evaluations.a + 1) % inst.p
        for label, pf, pub in (("public input", proof, [7]), ("evaluation", tampered, [6])):
            try:
                inst.verify(compiled, pf, pub)
            except (VerificationError, AssertionError):
                pass
            else:
                raise AssertionError(f"{scheme} {curve}: verified with a tampered {label}")
        fields = {}
        if scheme == "kzg":
            blob = arkserde.proof_to_bytes(proof, ctx.curve.fq.modulus, ctx.curve.fr.modulus)
            digest = hashlib.sha256(blob).hexdigest()
            if digest != MATRIX_KZG_SHA256[curve]:
                raise AssertionError(f"kzg {curve}: proof sha256 {digest}")
            fields = dict(bytes=len(blob), sha256=digest[:16])
        say("matrix", scheme=scheme, curve=curve, seed=seed, card_s=secs["card"], cpu_s=secs["cpu"],
            equal_fields=True, verified=True, tamper="raised", **fields)
    return launches


def ipa_commits(dev):
    """IPA commits on the card (``ipa.commit(..., device=True)``, the MSM's
    kernels) against the same commit through the plain versions on the CPU
    (m = 2^12 on BN254, 2^10 on BLS12-381) and against the host MSM at
    m = 2^8."""
    from zkt_plonk_tpu_torch.commitment import ipa

    for curve, m in (("bn254", 1 << 12), ("bls12_381", 1 << 10)):
        t0 = time.perf_counter()
        ck, _ = ipa.setup(curve, max_degree=m - 1, device=dev)
        gens_s = round(time.perf_counter() - t0, 3)
        ck_cpu = ipa.make_key(ck.ctx, ck.gens, ck.u, device="cpu")
        r = ck.ctx.curve.fr.modulus
        rng = random.Random(m)
        coeffs = [rng.randrange(r) for _ in range(m)]
        coeffs[:3] = [0, 1, r - 1]
        secs = {}
        got = {}
        for label, key, cs, dev_commit in (("card", ck, coeffs, True), ("cpu", ck_cpu, coeffs, True),
                                           ("card_256", ck, coeffs[:256], True),
                                           ("host_256", ck, coeffs[:256], False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pt = ipa.commit(key, cs, device=dev_commit)
            secs[label] = round(time.perf_counter() - t0, 3)
            got[label] = None if pt is None else (int(pt[0]), int(pt[1]))
        if got["card"] != got["cpu"] or got["card_256"] != got["host_256"]:
            raise AssertionError(f"IPA commit on {curve}: card {got['card']} / CPU {got['cpu']}, "
                                 f"m = 256: card {got['card_256']} / host {got['host_256']}")
        say("ipa_commit", curve=curve, m=m, generators_s=gens_s, card_s=secs["card"],
            plain_cpu_s=secs["cpu"], card_256_s=secs["card_256"], host_msm_256_s=secs["host_256"],
            equal=True)


class ChainCircuit:
    """k rounds of x <- x*x + a from x = a = 2, the result public, a in the
    lookup table: 2k + 1 gates, n = 2^11 at k = SHARDED_D2_ROUNDS."""

    def __init__(self, k: int):
        self.k = k

    def synthesize(self, cs):
        from zkt_plonk_tpu_torch.cs import lt

        a = cs.assign_variable(2)
        x = a
        for _ in range(self.k):
            x = cs.add_gate(lt(cs.mul_gate(lt(x), lt(x))), lt(a))
        cs.set_variable_public(lt(x))
        cs.lookup_constrain(lt(a))

    def public_inputs(self, p: int):
        x = 2
        for _ in range(self.k):
            x = (x * x + 2) % p
        return [x]


SHARDED_D2_ROUNDS = 900
SHARDED_D2_SEED = 5


def chain_instance(dev, k):
    """The chain circuit's instance and keys on ``dev`` (the same on every
    process: the SRS comes from a fixed tau)."""
    from zkt_plonk_tpu_torch.commitment import kzg
    from zkt_plonk_tpu_torch.cs import ConstraintSystem, LookupTable
    from zkt_plonk_tpu_torch.plonk import ZKTPlonk

    circuit = ChainCircuit(k)
    inst = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63), device=dev)
    cs = ConstraintSystem(inst.p, setup=True, lookup_table=inst.table)
    circuit.synthesize(cs)
    ck, cvk = kzg.setup(inst.ctx, max_degree=4 * cs.circuit_bound(), tau=2718281828, device=dev)
    return circuit, inst, inst.compile(circuit, ck, cvk)


def sharded_d2_rank(rank, port, k, device, results):
    """One of the two ranks of phase ``sharded_d2``: gloo between two
    processes on one card, every exchange staged through host memory."""
    import traceback

    try:
        import torch.distributed as dist

        from zkt_plonk_tpu_torch import _cuda, parallel

        dev = torch.device(device)
        torch.set_num_threads(1)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: loopback only
        parallel.init_distributed("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
        try:
            circuit, inst, compiled = chain_instance(dev, k)
            prover = inst.prover(compiled)
            mesh = parallel.make_mesh(device=dev)
            sp = parallel.ShardedProver(prover, mesh)
            composer, transcript = inst.statement(compiled, circuit)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            proof = sp.prove(composer, transcript, random.Random(SHARDED_D2_SEED))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs = round(time.perf_counter() - t0, 3)
            launches = {name: v for name, v in _cuda.launches.items() if v}
            out = dict(bytes=proof_bytes(inst, proof), launches=launches, D=mesh.D, d=mesh.d,
                       transport=mesh.transport, n=prover.n, prove_s=secs)
        finally:
            dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))


def sharded_d2(dev, k=SHARDED_D2_ROUNDS):
    """Two processes on the one card over gloo, host-staged: the chain
    circuit's proof at D = 2 (all-to-alls, global butterfly stages, rolls,
    flips, scans and the cross-rank MSM tree on CUDA tensors), byte-equal to
    the single-device proof of the same seed.  Returns the two ranks'
    launches."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=sharded_d2_rank, args=(r, port, k, str(dev), results))
             for r in range(2)]
    for proc in procs:
        proc.start()
    try:
        circuit, inst, compiled = chain_instance(dev, k)
        t0 = time.perf_counter()
        proof = inst.prove(compiled, circuit, rng=random.Random(SHARDED_D2_SEED))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        single_s = round(time.perf_counter() - t0, 3)
        inst.verify(compiled, proof, circuit.public_inputs(inst.p))
        want = proof_bytes(inst, proof)
        got = {}
        while len(got) < 2:
            try:
                rank, out = results.get(timeout=300)
            except queue.Empty:
                raise AssertionError("sharded_d2: a rank did not report within 300 s") from None
            if isinstance(out, str):
                raise AssertionError(f"sharded_d2 rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)
    launches = {}
    for rank in (0, 1):
        out = got[rank]
        if out["bytes"] != want:
            raise AssertionError(f"sharded_d2: rank {rank}'s proof differs from the single-device proof")
        say("sharded_d2", rank=rank, D=out["D"], d=out["d"], transport=out["transport"], n=out["n"],
            prove_s=out["prove_s"], single_device_cold_s=single_s, bytes_equal=True,
            launches=json.dumps(out["launches"]))
        for name, v in out["launches"].items():
            launches[name] = launches.get(name, 0) + v
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


def ptxas_report(name: str):
    """(function, registers, spill stores, spill loads) of each kernel in
    ``name``'s build log (nvcc -Xptxas -v)."""
    import re

    from zkt_plonk_tpu_torch import _cuda

    out, fn, spills = [], None, (0, 0)
    with open(os.path.join(_cuda.BUILD_DIR, f"{name}.log")) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = re.sub(r"^_ZN2zk\d+", "", m.group(1))[:48]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                out.append((fn, int(m.group(1)), *spills))
                fn, spills = None, (0, 0)
    return out


def occupancy_report() -> None:
    """Resident blocks per SM and registers of K4, K4a and K6 at L = 16 and
    24, from the card; each K4a instance's blocks must equal ``ops/msm.py``'s
    ``ACC_RESIDENT_BLOCKS``, from which ``msm.group_count`` sizes its bucket
    rows, and each K6 instance's ``MERGE_RESIDENT_BLOCKS``, from which
    ``msm.merge_chunks`` sizes its chunks."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.ops import msm

    table = {_cuda.instance("ec_bucket_accumulate", L): msm.ACC_RESIDENT_BLOCKS[L]
             for L in (16, 24)}
    table.update({_cuda.instance("ec_bucket_merge", L): msm.MERGE_RESIDENT_BLOCKS[L]
                  for L in (16, 24)})
    for key in _cuda.OCCUPANCY_INSTANCES:
        blocks, regs = _cuda.occupancy(key)
        say("occupancy", kernel=key, threads=msm.ACC_THREADS, blocks_per_sm=blocks,
            registers=regs, resident_threads=blocks * msm.ACC_THREADS * msm.ACC_SMS)
        if key in table and blocks != table[key]:
            raise AssertionError(
                f"{key}: {blocks} resident blocks per SM on the card, ops/msm.py says {table[key]}")


PHASES = ("parity", "golden", "withdraw", "poseidon", "cli", "bls12_withdraw", "matrix",
          "sharded_d2", "h64_n4")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s; a subset prints no result line")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
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
    say("build", seconds=round(build_s, 3), kernels=len(_cuda.KERNELS))
    for name in _cuda.KERNELS:
        for fn, regs, st, ld in ptxas_report(name):
            say("ptxas", kernel=name, fn=fn, registers=regs, spill_stores=st, spill_loads=ld)
            if fn.startswith(("bucket_accumulate", "ec_bucket_merge")) and st + ld:
                raise AssertionError(f"{fn} spills ({st} B stored, {ld} B loaded)")
    sass_mix()
    occupancy_report()

    records = {}
    if "parity" in phases:
        from zkt_plonk_tpu_torch.fields import BLS12_381_FR, BN254_FR

        parity_fp_binop(records, dev)
        parity_fp_pow_chain(records, dev)
        parity_ntt_col_pass(records, dev, BN254_FR, "ntt_col_pass")
        parity_ntt_col_pass(records, dev, BLS12_381_FR, "ntt_col_pass/strict")
        parity_ec_add(records, dev)
        parity_ec_add(records, dev, "bls12_381")
        parity_ec_add(records, dev, "bls12_377", record=False)
        parity_msm_digits(records, dev)
        parity_ec_bucket_accumulate(records, dev)
        parity_ec_bucket_accumulate(records, dev, "bls12_381")
        parity_ec_bucket_accumulate(records, dev, "bls12_377", record=False)
        parity_ec_bucket_merge(records, dev)
        parity_ec_bucket_merge(records, dev, "bls12_381")
        parity_ec_bucket_merge(records, dev, "bls12_377", record=False)
        say("total", after="parity", wall_s=round(time.perf_counter() - T_START, 1))

    # the main paths, each counted from zero around its own run
    paths = {}
    eth_prove_s = None
    if "golden" in phases:
        golden(dev)
    if "withdraw" in phases:
        found, eth_prove_s = withdraw(dev)
        paths.update(found)
        say("total", after="withdraw", wall_s=round(time.perf_counter() - T_START, 1))
    if "poseidon" in phases:
        paths["poseidon"] = poseidon(dev)
    if "cli" in phases:
        paths["cli"] = cli_phase(dev, eth_prove_s)
    if "bls12_withdraw" in phases:
        paths.update(withdraw(dev, curve="bls12_381", phase="bls12_withdraw",
                              transcript=merlin(48))[0])
        say("total", after="bls12_withdraw", wall_s=round(time.perf_counter() - T_START, 1))
    if "matrix" in phases:
        _cuda.reset_launches()
        ipa_commits(dev)
        paths["matrix"] = matrix(dev)
    if "sharded_d2" in phases:
        paths["sharded_d2"] = sharded_d2(dev)
        say("total", after="sharded_d2", wall_s=round(time.perf_counter() - T_START, 1))
    if "h64_n4" in phases:
        parity_ntt_at(dev, 19, 2)
        parity_ntt_at(dev, 21, 1)
        parity_msm_at(dev, 19)
        paths.update(withdraw(dev, 64, 4, 1024, phase="withdraw_h64_n4",
                              transcript=merlin(32))[0])
        say("total", after="h64_n4", wall_s=round(time.perf_counter() - T_START, 1))
    launches = {k: 0 for k in _cuda.INSTANCES}
    for name, path_launches in paths.items():
        say("launches", path=name, **{k: v for k, v in path_launches.items() if v})
        for k, v in path_launches.items():
            launches[k] += v
    say("total", wall_s=round(time.perf_counter() - T_START, 1))
    if phases != set(PHASES):
        print("chip_smoke: partial run of phases " + ",".join(sorted(phases)), flush=True)
        return 0

    # every instance lies on a main path
    missing = [k for k in _cuda.INSTANCES if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernel instances not launched on the main paths: {missing}")

    kernels = []
    for name in _cuda.INSTANCES:
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
