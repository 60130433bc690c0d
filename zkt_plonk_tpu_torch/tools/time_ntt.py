"""Device time of whole NTTs at the prover's shapes, and the kernels they run.

Usage (on a machine with a card; the tree whose package is timed comes first
on the path):

    PYTHONPATH=<tree> python <this file> [--out time_ntt.json]

It times, at n = 2^18 on BN254 Fr, the (36, n) forward transform of the
quotient round (``coset4_fft``: 9 polynomials x 4 subdomains), the (4, n)
inverse of ``coset4_ifft`` and the (10, n) inverse of ``setup``'s batches:
``--reps`` calls queued back to back between one pair of CUDA events,
after a warm-up.  Each transform is also run once under ``torch.profiler``,
and every device kernel it ran is listed with its count.  The work each
transform needs is counted from the host plan (``transform_work``), so the
same count serves any implementation; only the package's public NTT API and
``ops/ntt_mr.build_plan`` are used, so the file times any tree of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import Counter

import numpy as np
import torch

SHAPES = (("fft", 36), ("ifft", 4), ("ifft", 10))


def transform_work(host_plan, nb: int):
    """(bytes, modular products) one transform of nb polynomials needs:
    the (nb, n, L) int32 input read once and the output written once; one
    product for every stage twiddle other than 1 of every pass, and one per
    element for each table the plan applies (prologue, inter-pass tables,
    epilogue)."""
    n, L = host_plan.n, host_plan.L
    products = 0
    for f in host_plan.factors:
        F = 1 << f
        products += (n // F) * sum(F // 2 - F // (2 << s) for s in range(1, f))
    tables = sum(1 for ts in host_plan.post if ts) + bool(host_plan.pro) + bool(host_plan.epi)
    products += tables * n
    return 2 * nb * n * L * 4, nb * products


def time_call(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = Counter()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            out[evt.key[:80]] += evt.count
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=18)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="time_ntt.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_ntt needs a CUDA card")

    from zkt_plonk_tpu_torch.fields import BN254_FR
    from zkt_plonk_tpu_torch.ops import ntt, ntt_mr
    from zkt_plonk_tpu_torch.utils.domain import make_domain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda")
    n = 1 << args.log_n
    dom = make_domain(BN254_FR, n)
    spec = dom.spec
    plan = dom.plan(dev)
    gen = np.random.default_rng(7)
    rows = []
    for name, nb in SHAPES:
        limbs = gen.integers(0, 1 << 16, size=(nb, n, spec.n_limbs), dtype=np.int64)
        limbs[..., -1] = gen.integers(0, int(spec.modulus_limbs[-1]), size=(nb, n))
        x = torch.from_numpy(limbs.astype(np.int32)).to(dev)
        fn = lambda: getattr(ntt, name)(spec, plan, x)
        ms = time_call(fn, args.reps)
        nbytes, products = transform_work(ntt_mr.build_plan(dom, inverse=name == "ifft", coset=False), nb)
        rows.append(dict(shape=f"({nb}, 2^{args.log_n}) {name}", ms=ms, bytes=nbytes,
                         products=products, kernels=device_kernels(fn)))
        print(f"{rows[-1]['shape']}: {ms:.4f} ms  kernels {rows[-1]['kernels']}", flush=True)
        del x
    record = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, time=time.time(), rows=rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
