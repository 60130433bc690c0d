"""Warm MSM commit time on one CUDA card against the bucket group count G.

Usage (from the repository root, on a machine with a card):

    python -m zkt_plonk_tpu_torch.tools.sweep_msm_groups [--curve bn254]
        [--log-n 18] [--batches 1,2,3,6,10] [--groups 128,192,...,2816]
        [--reps 3] [--max-rows 262144] [--out sweep_msm_groups.json]

For each batch size B (the prover's commit batches at n = 2^18 are
B = 1, 2, 3, 6 and 10 polynomials of n + 4 coefficients) and each G, it
commits B random polynomials to the SRS exactly as
``kzg.Committer.commit_many`` does (``msm.msm_totals`` with ``groups=G``,
the copy of the window totals to the host, the host window fold), once to
warm up and ``--reps`` times on the host clock after a
``torch.cuda.synchronize()``, and records the median.  Beside it, the
device time of the bucket accumulation alone (kernel K4a, CUDA events
around one launch, median of ``--reps``), whose share of the commit the
group merge and the suffix scan leave, and the commit's peak device
memory above what was allocated before it.  ``--curve`` picks the SRS's
curve: BN254 runs kernel K4a at L = 16, the BLS12 curves its L = 24
instance.  For each B it also prints the G that ``msm.group_count``
picks and how far its commit and accumulation times are from the best
G's.  The card's name and power limit are printed beside the numbers and
the whole record is written as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--curve", default="bn254", choices=["bn254", "bls12_381", "bls12_377"])
    ap.add_argument("--log-n", type=int, default=18)
    ap.add_argument("--batches", default="1,2,3,6,10")
    ap.add_argument("--groups", default="128,192,256,352,512,704,1024,1408,2048,2816")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-rows", type=int, default=1 << 18,
                    help="skip a G whose bucket rows G*B*W exceed this")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="sweep_msm_groups.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_msm_groups needs a CUDA card")

    from ..commitment import kzg
    from ..curves import make_context
    from ..ops import msm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda")
    ctx = make_context(args.curve)
    m = (1 << args.log_n) + 4
    ck, _ = kzg.setup(ctx, max_degree=m - 1, tau=987654321, device=dev)
    fr_bits = ctx.curve.fr.modulus.bit_length()
    c = msm.msm_window_size(m)
    top = int(ctx.fr_spec.modulus_limbs[-1])
    gen = np.random.default_rng(args.seed)
    batches = [int(b) for b in args.batches.split(",")]
    groups = [int(g) for g in args.groups.split(",")]

    def accumulate_ms(scalars, G):
        digits = msm.digit_rows(scalars, c, fr_bits, G)
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            msm.bucket_accumulate(ctx.fq_spec, ck.b3, ck.powers, digits, G, c)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def commit(scalars, G):
        totals = msm.msm_totals(
            ctx.fq_spec, ck.b3, ck.powers, scalars, fr_bits, c=c, groups=G
        ).cpu().numpy()
        return [msm.fold_windows_host(ctx.fq_spec, ctx.Fq, t, c) for t in totals]

    print(f"card: {smi}  curve={args.curve} L={ctx.fq_spec.n_limbs} m={m} c={c}", flush=True)
    rows = []
    for B in batches:
        limbs = gen.integers(0, 1 << 16, size=(B, m, 16), dtype=np.int64)
        limbs[..., 15] = gen.integers(0, top, size=(B, m))
        scalars = torch.from_numpy(limbs.astype(np.int32)).to(dev)
        want = None
        for G in groups:
            if G * B * msm.num_windows(fr_bits + 1, c) > args.max_rows:
                continue
            got = commit(scalars, G)  # warm-up
            if want is None:
                want = got
            elif got != want:
                raise AssertionError(f"B={B}: G={G} changed the commitments")
            times = []
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(args.reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                commit(scalars, G)
                times.append(time.perf_counter() - t0)
            peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
            acc = accumulate_ms(scalars, G)
            rows.append({"batch": B, "groups": G, "seconds": statistics.median(times),
                         "all_seconds": times, "steps": -(-m // G), "accumulate_ms": acc,
                         "peak_gb": peak_gb})
            print(f"B={B:3d} G={G:5d} steps={-(-m // G):6d} "
                  f"median {statistics.median(times) * 1e3:9.2f} ms  accumulate {acc:8.2f} ms  "
                  f"peak {peak_gb:6.3f} GB  "
                  f"{times}", flush=True)
        del scalars
        torch.cuda.empty_cache()
    best = {}
    for r in rows:
        if r["batch"] not in best or r["seconds"] < best[r["batch"]]["seconds"]:
            best[r["batch"]] = r
    rule = {}
    for B, r in best.items():
        G = msm.group_count(m, c, B, msm.num_windows(fr_bits + 1, c))
        picked = next((x for x in rows if x["batch"] == B and x["groups"] == G), None)
        best_acc = min(x["accumulate_ms"] for x in rows if x["batch"] == B)
        rule[str(B)] = {"groups": G}
        if picked is not None:
            rule[str(B)].update(
                commit_over_best=picked["seconds"] / r["seconds"],
                accumulate_over_best=picked["accumulate_ms"] / best_acc)
        print(f"best for B={B}: G={r['groups']} ({r['seconds'] * 1e3:.2f} ms); "
              f"rule: G={G} {rule[str(B)]}", flush=True)
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "curve": args.curve,
              "m": m, "c": c, "reps": args.reps, "rows": rows,
              "best": {str(B): r["groups"] for B, r in best.items()}, "rule": rule}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
