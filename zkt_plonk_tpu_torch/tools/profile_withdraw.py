"""Where the time of a withdraw proof goes, on one CUDA card.

Usage (from the repository root, on a machine with a card):

    python -m zkt_plonk_tpu_torch.tools.profile_withdraw [--curve bn254]
        [--height 48] [--notes 3] [--table 1024] [--sharded]
        [--out profile_withdraw.json]

The file imports the package by its absolute name, so it also profiles
another tree of the port: ``PYTHONPATH=<tree> python <this file>``.

It builds the withdraw circuit (default: the reference's HEIGHT=48,
NOTES=3, TABLE=1024, n = 2^18; on BN254 with the Ethereum transcript, or
with ``--curve bls12_381`` on BLS12-381 with Merlin and 48-byte
coordinates), sets up the SRS of 4 x the circuit bound (the degree
``compile`` trims every SRS to), compiles and proves once to warm up.  It
then times one ``section`` of the span recorder (``utils/profiling``) off
and on, and proves 2 x ``PROOFS`` (12) times under ``torch.profiler`` (CUDA
activity), the recorder off and on in turns (off, on, on, off, ...), each
proof ``ZKTPlonk.prove`` then ``torch.cuda.synchronize()`` on the host
clock.  From the recorded proofs it reports, per proof:

* every span by its path (``prove/round1+2/commit/fold``): its count, its
  host milliseconds, its self milliseconds (the part of its interval that
  none of its child spans covers) and the milliseconds of its self time in
  which the card ran nothing; the self shares of ``prove`` and
  ``statement``;
* the counters (``profiling.counters``, ``_cuda.work``) and the launches,
  the circuit's gates and domain rows a proof among them
  (``circuit_gates``, ``domain_rows``),
  the share of the staged bytes copied from pinned memory
  (``h2d_pinned_bytes / h2d_bytes``), and the host-to-device copies' device
  ms and effective GB/s (``h2d_bytes`` over their time in the trace);
* the pinned host memory that torch's caching host allocator holds after
  set-up and after the proofs (``torch.cuda.host_memory_stats``);
* the card's busy time (the union of its kernel, memcpy and memset
  intervals), its idle time inside the ``prove`` spans, and the longest
  idle gaps of the recorded proofs, each named by the path of the
  innermost span open at its middle;
* device time by kernel, and the MSM's EC kernels K4a and K4 and the NTT
  kernel K3 apart;
and the mean wall time of a proof with the recorder off and on, the first
proof's sha256 (the seed is fixed, so two trees that prove the same bytes
report the same digest) and the card's name and power limit.  With
``--sharded`` the proofs go through ``parallel.ShardedProver`` on a
world-size-1 NCCL mesh (the same rounds on (body, tail) shards, the same
bytes).  It then proves ``ATTRIBUTE_PROOFS`` (3) more times under
``torch.profiler`` with CPU and CUDA activity, the recorder on and a span
``digit_rows`` around each ``ops/msm.digit_rows`` call, and joins every
device op to the innermost span open at its launching host call (by the
trace's correlation ids): the device ms a proof of each op kind
(``at::native::elementwise_kernel``, ``Memcpy DtoD``, ...) launched inside
``digit_rows``, elsewhere in a ``commit``, and elsewhere, and the span
paths that launch the most.  The whole record is written as JSON to
``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import re
import subprocess
import tempfile
import time
from collections import defaultdict
from typing import Dict, Sequence

import torch

from zkt_plonk_tpu_torch.utils.profiling import (
    DEVICE_CATEGORIES, Interval, covered, idle_gaps, innermost, own_intervals, paths, self_seconds,
    union)

# device kernel names of the MSM's EC kernels (csrc/ec_bucket_accumulate.cu,
# csrc/ec_bucket_merge.cu, csrc/ec_add_complete.cu), every instance, and of
# the NTT (csrc/ntt_col_pass.cu)
KERNELS = {
    "K4a": ("bucket_accumulate_affine_kernel",),
    "K6": ("ec_bucket_merge_kernel",),
    "K4": ("ec_add_complete_kernel", "ec_add_staged_kernel"),
    "K3": ("ntt_fused_pass_kernel",),
}
PROOFS = 6  # proofs with the recorder on, and as many with it off
ATTRIBUTE_PROOFS = 3  # proofs of the attribution pass


def phase_table(spans, proofs: int, busy: Sequence[Interval] = ()) -> Dict[str, dict]:
    """Per span path: spans, host ms, self ms and, of the self time, the ms
    in which the card ran nothing (``busy``: the union of its intervals),
    each per proof."""
    names, owns = paths(spans), own_intervals(spans)
    table = defaultdict(lambda: {"count": 0.0, "ms": 0.0, "self_ms": 0.0, "idle_ms": 0.0})
    for s in spans:
        row = table[names[s.index]]
        own = owns[s.index]
        row["count"] += 1 / proofs
        row["ms"] += 1e3 * (s.end - s.start) / proofs
        row["self_ms"] += 1e3 * sum(b - a for a, b in own) / proofs
        row["idle_ms"] += 1e3 * sum((b - a) - covered(busy, a, b) for a, b in own) / proofs
    return dict(sorted(table.items(), key=lambda kv: min(
        s.start for s in spans if names[s.index] == kv[0])))


def section_cost_us(profiling, repeats: int) -> Dict[str, float]:
    """Host microseconds of one ``with section(...)`` off and on."""
    out = {}
    for on in (False, True):
        profiling.enable(on)
        t0 = time.perf_counter()
        for _ in range(repeats):
            with profiling.section("probe"):
                pass
        out["on" if on else "off"] = 1e6 * (time.perf_counter() - t0) / repeats
        profiling.enable(False)
        profiling.drain()
    return out


def short_name(name: str) -> str:
    """A device op's name without its template and argument lists:
    ``at::native::elementwise_kernel``, ``Memcpy DtoD``."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", s, maxsplit=1)[0].strip()


def site_class(path: str) -> str:
    """The launching site of a span path: the MSM's digit recoding
    (``digit_rows``), the rest of a commit (``commit/msm``), or elsewhere."""
    parts = path.split("/")
    if "digit_rows" in parts:
        return "digit_rows"
    if "commit" in parts or "msm" in parts:
        return "commit/msm"
    return "elsewhere"


# the host calls that launch device ops, by their Chrome trace category
HOST_CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")


def launched_ops(data: dict):
    """(category, name, start, end, launch) of every kernel, memcpy and
    memset of a Chrome trace (the dict of its JSON), in wall-clock seconds;
    ``launch`` is the start of the host call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) with the same correlation id, which the trace
    holds where the profiler recorded CPU activity, else None."""
    base_us = data.get("baseTimeNanoseconds", 0) / 1e3
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    calls = {e["args"]["correlation"]: (float(e["ts"]) + base_us) / 1e6 for e in events
             if e.get("cat") in HOST_CALL_CATEGORIES and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            start = (float(e["ts"]) + base_us) / 1e6
            launch = calls.get(e.get("args", {}).get("correlation"))
            out.append((e["cat"], e.get("name", "?"), start, start + float(e["dur"]) / 1e6, launch))
    return out


def launch_sites(ops, spans, proofs: int, top: int = 25) -> dict:
    """Device ms a proof of each op kind by the site that launched it: the
    path of the innermost span open at the op's launching host call
    (``launched_ops``), classed by ``site_class``; ops whose call the trace
    lacks are counted apart."""
    names = paths(spans)
    by_class = defaultdict(lambda: defaultdict(float))
    by_site = defaultdict(float)
    unmatched = 0.0
    for _, name, a, b, launch in ops:
        ms = 1e3 * (b - a) / proofs
        if launch is None:
            unmatched += ms
            continue
        site, op = innermost(spans, names, launch), short_name(name)
        by_class[site_class(site)][op] += ms
        by_site[(site, op)] += ms
    return {
        "proofs": proofs,
        "by_class": {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in by_class.items()},
        "by_site": [[site, op, ms] for (site, op), ms in
                    sorted(by_site.items(), key=lambda kv: -kv[1])[:top]],
        "unmatched_ms": unmatched,
    }


def attribute(prove, proofs: int) -> dict:
    """``launch_sites`` of ``proofs`` calls of ``prove`` under
    ``torch.profiler`` with CPU and CUDA activity, the recorder on and a
    span ``digit_rows`` around each ``ops/msm.digit_rows`` call."""
    from zkt_plonk_tpu_torch.ops import msm
    from zkt_plonk_tpu_torch.utils import profiling

    real = msm.digit_rows

    def spanned(*args, **kwargs):
        with profiling.section("digit_rows"):
            return real(*args, **kwargs)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    profiling.drain()
    msm.digit_rows = spanned
    profiling.enable(True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            offset = time.time() - time.perf_counter()
            for _ in range(proofs):
                prove()
                torch.cuda.synchronize()
    finally:
        profiling.enable(False)
        msm.digit_rows = real
    spans = [s._replace(start=s.start + offset, end=s.end + offset) for s in profiling.drain()]
    fd, path = tempfile.mkstemp(prefix="zkt-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return launch_sites(launched_ops(data), spans, proofs)


def host_memory() -> Dict[str, int]:
    """The byte counts of torch's caching host (pinned) allocator."""
    return {k: v for k, v in torch.cuda.host_memory_stats().items() if "bytes" in k}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--curve", default="bn254", choices=["bn254", "bls12_381"])
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--notes", type=int, default=3)
    ap.add_argument("--table", type=int, default=1024)
    ap.add_argument("--sharded", action="store_true",
                    help="prove through parallel.ShardedProver at D = 1 (NCCL, world size 1)")
    ap.add_argument("--out", default="profile_withdraw.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_withdraw needs a CUDA card")

    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.circuits.withdraw_instance import build
    from zkt_plonk_tpu_torch.commitment import kzg
    from zkt_plonk_tpu_torch.cs import ConstraintSystem
    from zkt_plonk_tpu_torch.plonk import ZKTPlonk
    from zkt_plonk_tpu_torch.utils import arkserde, profiling

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda")
    circuit, table, pub = build(args.height, args.notes, args.table, curve=args.curve)
    if args.curve == "bn254":
        inst = ZKTPlonk(curve="bn254", table=table, device=dev)
    else:
        from zkt_plonk_tpu_torch.transcript.merlin import MerlinTranscript

        inst = ZKTPlonk(curve=args.curve, table=table, device=dev,
                        transcript_factory=lambda label: MerlinTranscript(label, coord_bytes=48))
    cs = ConstraintSystem(inst.p, setup=True, lookup_table=table)
    circuit.synthesize(cs)
    bound = cs.circuit_bound()
    srs_degree = 4 * bound
    ck, cvk = kzg.setup(inst.ctx, max_degree=srs_degree, tau=987654321, device=dev)
    t0 = time.perf_counter()
    compiled = inst.compile(circuit, ck, cvk)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    pinned = {"after_setup": host_memory()}
    rng = random.Random(42)
    inst.prove(compiled, circuit, rng=rng)  # warm-up: builds the prover's tables
    prover = None
    if args.sharded:
        import socket

        from zkt_plonk_tpu_torch import parallel

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: loopback only
        parallel.init_distributed("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
        prover = parallel.ShardedProver(inst.prover(compiled), parallel.make_mesh(device=dev))
        inst.prove(compiled, circuit, rng=rng, prover=prover)  # warm-up of the sharded path

    cost_us = section_cost_us(profiling, 100_000)

    # off, on, on, off, ...: the recorder's cost is not confounded with drift
    order = [(i % 4) in (1, 2) for i in range(2 * PROOFS)]
    runs = []  # (traced, t0, t1, counters, launches)
    first_proof = None
    torch.cuda.synchronize()
    profiling.drain()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        offset = time.time() - time.perf_counter()
        for traced in order:
            c0, w0, l0 = profiling.snapshot(), dict(_cuda.work), dict(_cuda.launches)
            profiling.enable(traced)
            t0 = time.perf_counter()
            proof = inst.prove(compiled, circuit, rng=rng, prover=prover)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            profiling.enable(False)
            counts = {k: v - c0[k] for k, v in profiling.snapshot().items()}
            counts.update({k: v - w0[k] for k, v in _cuda.work.items()})
            launches = {k: v - l0[k] for k, v in _cuda.launches.items() if v > l0[k]}
            runs.append((traced, t0, t1, counts, launches))
            if first_proof is None:
                first_proof = proof
    spans = profiling.drain()
    ops = profiling.device_intervals(prof)
    pinned["after_proofs"] = host_memory()
    inst.verify(compiled, first_proof, pub)
    proof_sha256 = hashlib.sha256(arkserde.proof_to_bytes(
        first_proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)).hexdigest()

    traced_runs = [r for r in runs if r[0]]
    n_traced = len(traced_runs)
    windows = [(t0 + offset, t1 + offset) for _, t0, t1, _, _ in traced_runs]
    spans = [s._replace(start=s.start + offset, end=s.end + offset) for s in spans]
    busy = union([(a, b) for _, _, a, b in ops])
    lo, hi = min(a for a, _ in windows), max(b for _, b in windows)
    aligned = 2 * sum(1 for _, _, a, b in ops if b > lo and a < hi) >= len(ops)
    phases = phase_table(spans, n_traced, busy if aligned else ())
    roots = {name: sum(s.end - s.start for s in spans if s.name == name and s.parent == -1)
             for name in ("statement", "prove")}
    selfs = self_seconds(spans)
    self_share = {name: sum(selfs[s.index] for s in spans if s.name == name and s.parent == -1)
                  / roots[name] for name in roots if roots[name]}
    prove_spans = union([(s.start, s.end) for s in spans if s.name == "prove" and s.parent == -1])
    idle_in_prove_ms = 1e3 * sum((b - a) - covered(busy, a, b) for a, b in prove_spans) / n_traced
    counters = {k: sum(r[3][k] for r in traced_runs) / n_traced for k in traced_runs[0][3]}
    per_kernel = defaultdict(float)  # launches a proof, by instance
    for r in traced_runs:
        for k, v in r[4].items():
            per_kernel[k] += v / n_traced
    by_kernel = defaultdict(lambda: [0.0, 0])
    for _, name, a, b in ops:
        by_kernel[name][0] += b - a
        by_kernel[name][1] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    kernels_ms = {label: 1e3 * sum(v[0] for k, v in by_kernel.items()
                                   if any(re.search(rf"\b{n}\b", k) for n in names)) / len(runs)
                  for label, names in KERNELS.items()}
    wall = {key: [t1 - t0 for traced, t0, t1, _, _ in runs if traced == on]
            for key, on in (("off", False), ("on", True))}
    h2d_s = sum(b - a for cat, name, a, b in ops if cat == "gpu_memcpy" and "HtoD" in name)
    h2d = {"ms_per_proof": 1e3 * h2d_s / len(runs),
           "gb_per_s": counters["h2d_bytes"] * len(runs) / h2d_s / 1e9,
           "pinned_share": counters["h2d_pinned_bytes"] / counters["h2d_bytes"]}

    record = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "config": {"curve": args.curve, "height": args.height, "notes": args.notes,
                   "table": args.table, "n": bound, "srs_degree": srs_degree,
                   "sharded": args.sharded,
                   "proofs_off": len(wall["off"]), "proofs_on": len(wall["on"])},
        "compile_s": compile_s,
        "proof_sha256": proof_sha256,
        "section_us": cost_us,
        "proof_wall_s": wall,
        "spans_per_proof": len(spans) / n_traced,
        "phases_ms_per_proof": phases,
        "root_self_share": self_share,
        "counters_per_proof": counters,
        "h2d": h2d,
        "pinned_host_bytes": pinned,
        "launches_per_proof": dict(per_kernel),
        "aligned": aligned,
        "device_busy_ms_per_proof": 1e3 * sum(b - a for a, b in busy) / len(runs),
        "device_idle_in_prove_ms_per_proof": idle_in_prove_ms if aligned else None,
        "idle_gaps_s": idle_gaps(busy, spans, windows) if aligned else [],
        "kernels_ms_per_proof": kernels_ms,
        "top_device_ops": [{"name": k, "seconds": v[0], "calls": v[1]} for k, v in top],
    }
    record["attribution"] = attribute(
        lambda: inst.prove(compiled, circuit, rng=rng, prover=prover), ATTRIBUTE_PROOFS)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    print(f"card: {smi}")
    print(f"{args.curve} n={bound} srs_degree={srs_degree} sharded={args.sharded} "
          f"compile_s={compile_s:.3f} proof_sha256={proof_sha256}")
    print(f"size a proof: circuit_gates {counters['circuit_gates']:.0f}, "
          f"domain_rows {counters['domain_rows']:.0f}")
    print(f"section: off {cost_us['off']:.3f} us, on {cost_us['on']:.3f} us; "
          f"{len(spans) / n_traced:.1f} spans a proof")
    print(f"proof wall: recorder off {mean(wall['off']):.4f} s {wall['off']}, "
          f"on {mean(wall['on']):.4f} s {wall['on']}")
    print(f"self share: {self_share}")
    print(f"counters a proof: {counters}")
    print(f"h2d: {h2d['ms_per_proof']:.3f} ms a proof on the card, {h2d['gb_per_s']:.2f} GB/s, "
          f"pinned share {h2d['pinned_share']}; pinned host memory {pinned}")
    print(f"launches a proof: {sum(per_kernel.values()):.1f} {dict(per_kernel)}")
    busy_ms = record["device_busy_ms_per_proof"]
    print(f"device busy {busy_ms:.3f} ms a proof, idle inside prove {idle_in_prove_ms:.3f} ms "
          f"a proof (aligned: {aligned}); kernels {kernels_ms}")
    print(f"{'path':44s} {'count':>6s} {'ms':>10s} {'self ms':>10s} {'idle ms':>10s}")
    for name, row in phases.items():
        print(f"{name:44s} {row['count']:6.1f} {row['ms']:10.3f} {row['self_ms']:10.3f} "
              f"{row['idle_ms']:10.3f}")
    for name, seconds in record["idle_gaps_s"]:
        print(f"  idle gap {1e3 * seconds:9.3f} ms  {name}")
    for k, v in top:
        print(f"  {v[0] * 1e3:10.2f} ms {v[1]:7d} ops  {k[:90]}")
    att = record["attribution"]
    print(f"attribution: device ms a proof by launching site ({att['proofs']} proofs; "
          f"ops without their launching call {att['unmatched_ms']:.3f} ms)")
    for klass, ops in att["by_class"].items():
        print(f"  {klass}: {sum(ops.values()):.3f} ms: "
              + ", ".join(f"{op} {ms:.3f}" for op, ms in list(ops.items())[:8]))
    for site, op, ms in att["by_site"]:
        print(f"  {ms:9.3f} ms  {op[:44]:44s} {site}")
    if args.sharded:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
