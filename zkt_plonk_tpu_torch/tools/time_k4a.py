"""Kernel K4a's device time at the prover's commit batches, on one CUDA card.

Usage (from the repository root, on a machine with a card):

    python -m zkt_plonk_tpu_torch.tools.time_k4a [--curve bn254] [--batches 1,2,3,6]
        [--log-n 18] [--reps 5] [--out time_k4a.json]

At n = 2^log_n + 4 points (the 1024 points of a small SRS of ``--curve``,
Z = 1, repeated; K4a's L = 16 instance on BN254, its L = 24 one on the
BLS12 curves) and c = 8, for each batch of B random scalar vectors it times
``msm.bucket_accumulate`` with the G of ``msm.group_count``, ``--reps``
times, every call between two CUDA events; medians.  Beside each time the
bound of the work the digits need (``bounds.accumulate_bound``: mixed
adds, first hits and padding steps counted from the digits).  Registers
and spills come from ptxas (the build's log), resident blocks per SM from
the library's occupancy export (``_cuda.occupancy``).  The card's name and
power limit are printed beside the numbers and the whole record is
written as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess

import numpy as np
import torch

from zkt_plonk_tpu_torch.tools.bounds import accumulate_bound, step_counts


def ptxas_lines(log_path: str):
    """(function, registers, spill stores, spill loads) of each kernel of a
    build log (nvcc -Xptxas -v)."""
    out, fn, spills = [], None, (0, 0)
    with open(log_path) as f:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--curve", default="bn254", choices=("bn254", "bls12_381", "bls12_377"))
    ap.add_argument("--batches", default="1,2,3,6")
    ap.add_argument("--log-n", type=int, default=18)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--out", default="time_k4a.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k4a needs a CUDA card")

    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.commitment import kzg
    from zkt_plonk_tpu_torch.curves import make_context
    from zkt_plonk_tpu_torch.ops import msm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda")
    ctx = make_context(args.curve)
    spec = ctx.fq_spec
    L = spec.n_limbs
    ck, _ = kzg.setup(ctx, max_degree=1023, tau=31337, device=dev)  # Z = 1 points
    n, c = (1 << args.log_n) + 4, 8
    K = (1 << (c - 1)) + 1
    pts = ck.powers[torch.arange(n, device=dev) % 1024].contiguous()
    fr_bits = ctx.curve.fr.modulus.bit_length()
    W = msm.num_windows(fr_bits + 1, c)
    top = int(ctx.fr_spec.modulus_limbs[-1])
    gen = np.random.default_rng(args.seed)

    # the occupancy call builds the library, and its log, if need be
    inst = _cuda.instance("ec_bucket_accumulate", L)
    build = {"occupancy": {inst: _cuda.occupancy(inst)},
             "ptxas": ptxas_lines(os.path.join(_cuda.BUILD_DIR, "ec_bucket_accumulate.log"))}
    print(f"build: {build}", flush=True)

    rows = []
    for B in [int(b) for b in args.batches.split(",")]:
        G = msm.group_count(n, c, B, W, L)
        limbs = gen.integers(0, 1 << 16, size=(B, n, 16), dtype=np.int64)
        limbs[..., 15] = gen.integers(0, top, size=(B, n))
        digits = msm.digit_rows(torch.from_numpy(limbs.astype(np.int32)).to(dev), c, fr_bits, G)
        first, repeat, padding = step_counts(digits, n, G, K)
        b_ms, b_by = accumulate_bound(digits, n, G, K, L)
        times = []
        for rep in range(args.reps + 1):  # the first round warms up
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            msm.bucket_accumulate(spec, ck.b3, pts, digits, G, c)
            end.record()
            end.synchronize()
            if rep:
                times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        rows.append({"batch": B, "groups": G, "steps": n // G + (n % G > 0), "ms": ms,
                     "all_ms": times, "first_hits": first, "repeat_hits": repeat,
                     "padding_hits": padding, "bound_ms": b_ms, "bound_by": b_by})
        print(f"B={B} G={G} {ms:8.3f} ms  bound {b_ms:.3f} ({b_by}, {b_ms / ms:.0%});  first hits "
              f"{first / (first + repeat):.1%} of {first + repeat} steps", flush=True)
        del digits
        torch.cuda.empty_cache()
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "curve": args.curve,
              "n": n, "c": c,
              "reps": args.reps, "build": build, "rows": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
