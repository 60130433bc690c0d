"""Warm MSM commit time on one CUDA card against the bucket group count G.

Usage (from the repository root, on a machine with a card):

    python -m zkt_plonk_tpu_torch.tools.sweep_msm_groups [--curve bn254]
        [--log-n 18] [--batches 1,2,3,6,10] [--groups 128,192,...,2816]
        [--reps 5] [--max-rows 262144] [--out sweep_msm_groups.json]

For each batch size B (the prover's commit batches at n = 2^18 are
B = 1, 2, 3, 6 and 10 polynomials of n + 4 coefficients) and each G, it
commits B random polynomials to the SRS exactly as
``kzg.Committer.commit_many`` does (over the key's ``msm_points``, its
Z = 1 copy; ``msm.msm_totals`` with ``groups=G``,
the copy of the window totals to the host, the host window fold), once to
warm up and then ``--reps`` times with the G's in turns, each after a
``torch.cuda.synchronize()``, and records the medians of the commit's
wall time on the host clock and of its device part (CUDA events around
``msm_totals``: digit codes, K4a, the group merge and the suffix scan,
all of what G changes, without the host fold's noise).  Beside them, the
device time of the bucket accumulation alone (kernel K4a, CUDA events
around one launch, median of ``--reps``), and the commit's peak device
memory above what was allocated before it.  ``--curve`` picks the SRS's
curve: BN254 runs kernel K4a's instance at L = 16, the BLS12 curves its
L = 24 instance.  For each B it also prints the G that ``msm.group_count``
picks (from the resident rows of its K4a instance, ``msm.resident_rows``)
and how far its commit and accumulation times are from the best G's.
The card's name and power limit are printed beside the numbers and the
whole record is written as JSON to ``--out``.  ``--pool A.json B.json``
repeats that comparison on the pooled samples of earlier sweeps of one
configuration (a single sweep's commit medians move by up to 15% between
runs with the host), with no card.
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


def rule_report(rows, picks):
    """For each batch size B: the best G by the commit's wall-time median
    and by its device median, and how far the rule's pick ``picks[B]`` is
    from each (and from the best K4a time)."""
    report = {}
    for B in sorted({r["batch"] for r in rows}):
        mine = [r for r in rows if r["batch"] == B]
        best = min(mine, key=lambda r: r["seconds"])
        best_dev = min(mine, key=lambda r: r["device_ms"])
        entry = {"groups": picks[B], "best_groups": best["groups"],
                 "device_best_groups": best_dev["groups"]}
        picked = next((r for r in mine if r["groups"] == picks[B]), None)
        if picked is not None:
            entry.update(
                commit_over_best=picked["seconds"] / best["seconds"],
                device_over_best=picked["device_ms"] / best_dev["device_ms"],
                accumulate_over_best=picked["accumulate_ms"] / min(r["accumulate_ms"] for r in mine))
        print(f"best for B={B}: G={best['groups']} ({best['seconds'] * 1e3:.2f} ms), "
              f"device G={best_dev['groups']} ({best_dev['device_ms']:.2f} ms); "
              f"rule: {entry}", flush=True)
        report[str(B)] = entry
    return report


def pooled(paths):
    """The rows of several sweeps of one configuration (their ``--out``
    files) with the samples of each (B, G) pooled, and the rule's picks of
    the first."""
    recs = []
    for path in paths:
        with open(path) as f:
            recs.append(json.load(f))
    rows = []
    for r0 in recs[0]["rows"]:
        same = [next(x for x in rec["rows"] if (x["batch"], x["groups"]) == (r0["batch"], r0["groups"]))
                for rec in recs]
        walls = [t for x in same for t in x["all_seconds"]]
        devs = [t for x in same for t in x["all_device_ms"]]
        rows.append({**r0, "seconds": statistics.median(walls), "all_seconds": walls,
                     "device_ms": statistics.median(devs), "all_device_ms": devs,
                     "accumulate_ms": statistics.median(x["accumulate_ms"] for x in same)})
    picks = {int(B): v["groups"] for B, v in recs[0]["rule"].items()}
    return recs[0], rows, picks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--curve", default="bn254", choices=["bn254", "bls12_381", "bls12_377"])
    ap.add_argument("--log-n", type=int, default=18)
    ap.add_argument("--batches", default="1,2,3,6,10")
    ap.add_argument("--groups", default="128,192,256,352,512,704,1024,1408,2048,2816")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--max-rows", type=int, default=1 << 18,
                    help="skip a G whose bucket rows G*B*W exceed this")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="sweep_msm_groups.json")
    ap.add_argument("--pool", nargs="+", metavar="JSON",
                    help="print the rule against the pooled samples of earlier --out files "
                         "of one configuration, and measure nothing")
    args = ap.parse_args()
    if args.pool:
        rec, rows, picks = pooled(args.pool)
        print(f"card: {rec['nvidia_smi']}  curve={rec['curve']} m={rec['m']} c={rec['c']} "
              f"pooled {len(args.pool)} sweeps", flush=True)
        rule_report(rows, picks)
        return 0
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
    points = ck.msm_points
    fr_bits = ctx.curve.fr.modulus.bit_length()
    c = msm.msm_window_size(m)
    top = int(ctx.fr_spec.modulus_limbs[-1])
    gen = np.random.default_rng(args.seed)
    batches = [int(b) for b in args.batches.split(",")]
    W = msm.num_windows(fr_bits + 1, c)
    groups = [int(g) for g in args.groups.split(",")]

    def accumulate_ms(scalars, G):
        digits = msm.digit_rows(scalars, c, fr_bits, G)
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            msm.bucket_accumulate(ctx.fq_spec, ck.b3, points.points, digits, G, c)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def commit(scalars, G):
        """The affine commitments, the device milliseconds of the device
        part (digit codes, K4a, the group merge, the suffix scan; CUDA events
        around ``msm_totals``) and the wall seconds of the whole commit."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        totals = msm.msm_totals(ctx.fq_spec, ck.b3, points, scalars, fr_bits, c=c, groups=G)
        end.record()
        totals = totals.cpu().numpy()
        out = [msm.fold_windows_host(ctx.fq_spec, ctx.Fq, t, c) for t in totals]
        return out, start.elapsed_time(end), time.perf_counter() - t0

    L = ctx.fq_spec.n_limbs
    print(f"card: {smi}  curve={args.curve} L={L} m={m} c={c} "
          f"K4a resident rows={msm.resident_rows(L)}", flush=True)
    rows = []
    for B in batches:
        limbs = gen.integers(0, 1 << 16, size=(B, m, 16), dtype=np.int64)
        limbs[..., 15] = gen.integers(0, top, size=(B, m))
        scalars = torch.from_numpy(limbs.astype(np.int32)).to(dev)
        Gs = [G for G in groups if G * B * W <= args.max_rows]
        want = None
        peak_gb = {}
        for G in Gs:  # warm-up: the commitments must not depend on G
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got, _, _ = commit(scalars, G)
            peak_gb[G] = (torch.cuda.max_memory_allocated() - base) / 1e9
            if want is None:
                want = got
            elif got != want:
                raise AssertionError(f"B={B}: G={G} changed the commitments")
        # the G's in turns, so that a drift of the host's speed spreads over
        # all of them
        walls = {G: [] for G in Gs}
        devs = {G: [] for G in Gs}
        for _ in range(args.reps):
            for G in Gs:
                _, dev_ms, wall_s = commit(scalars, G)
                walls[G].append(wall_s)
                devs[G].append(dev_ms)
        for G in Gs:
            acc = accumulate_ms(scalars, G)
            wall = statistics.median(walls[G])
            dev_ms = statistics.median(devs[G])
            rows.append({"batch": B, "groups": G, "bucket_rows": G * B * W, "seconds": wall,
                         "all_seconds": walls[G], "device_ms": dev_ms, "all_device_ms": devs[G],
                         "steps": -(-m // G), "accumulate_ms": acc, "peak_gb": peak_gb[G]})
            print(f"B={B:3d} G={G:5d} steps={-(-m // G):6d} "
                  f"median {wall * 1e3:9.2f} ms  device {dev_ms:8.2f} ms  "
                  f"accumulate {acc:8.2f} ms  peak {peak_gb[G]:6.3f} GB  "
                  f"{[round(t * 1e3, 2) for t in walls[G]]}", flush=True)
        del scalars
        torch.cuda.empty_cache()
    rule = rule_report(rows, {B: msm.group_count(m, c, B, W, L) for B in batches})
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "curve": args.curve,
              "m": m, "c": c, "reps": args.reps,
              "resident_rows": msm.resident_rows(L), "rows": rows,
              "best": {B: r["best_groups"] for B, r in rule.items()}, "rule": rule}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
