"""Where the time of one withdraw proof goes, on one CUDA card.

Usage (from the repository root, on a machine with a card):

    python -m zkt_plonk_tpu_torch.tools.profile_withdraw [--curve bn254]
        [--height 48] [--notes 3] [--table 1024] [--sharded]
        [--out profile_withdraw.json]

The file imports the package by its absolute name, so it also profiles
another tree of the port: ``PYTHONPATH=<tree> python <this file>``.

It builds the withdraw circuit (default: the reference's HEIGHT=48,
NOTES=3, TABLE=1024, n = 2^18; on BN254 with the Ethereum transcript, or
with ``--curve bls12_381`` on BLS12-381 with Merlin and 48-byte
coordinates), sets up the SRS, compiles, proves once to warm up, then
  1. proves again (the proof's sha256 is reported: the seed is fixed, so
     two trees that prove the same bytes report the same digest) with
     every prover phase timed on the host clock around a
     ``torch.cuda.synchronize()`` (synthesis, the iNTT/blinding batches, the
     MSM commit batches, the z and quotient rounds, evaluations,
     linearization, openings; the remainder is host work in ``prove``),
     counting the launches of each kernel in that proof, and those inside
     its NTTs (``ops/ntt_mr.transform``);
  2. proves a third time under ``torch.profiler`` and sums the device time
     of every kernel by name; each NTT runs inside a ``record_function``
     range, whose span on the device (first kernel to last, gaps included)
     is reported apart, and so are the MSM's EC kernels K4a and K4; busy
     time over the wall time of that proof gives the device's busy share
     (profiling slows the host, so that proof's wall time is longer than the
     unprofiled one).
With ``--sharded`` the proofs go through ``parallel.ShardedProver`` on a
world-size-1 NCCL mesh instead (the same rounds on (body, tail) shards,
the same bytes), with the same phases timed.  The card's name and power
limit are printed beside the numbers, and the whole record is written as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import subprocess
import time
from collections import defaultdict

import torch


# device kernel names of the MSM's EC kernels (csrc/ec_bucket_accumulate.cu,
# csrc/ec_add_complete.cu), every instance
EC_KERNELS = {
    "K4a": ("bucket_accumulate_kernel", "bucket_accumulate_affine_kernel"),
    "K4": ("ec_add_complete_kernel", "ec_add_staged_kernel"),
}


def _sync():
    torch.cuda.synchronize()


def _timed(table, stack, name, fn):
    """Wrap ``fn`` to add its EXCLUSIVE time (minus timed callees) to table."""

    def wrapper(*args, **kwargs):
        _sync()
        t0 = time.perf_counter()
        stack.append(0.0)
        try:
            out = fn(*args, **kwargs)
            _sync()
        finally:
            elapsed = time.perf_counter() - t0
            table[name] += elapsed - stack.pop()
            if stack:
                stack[-1] += elapsed
        return out

    return wrapper


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
    from zkt_plonk_tpu_torch.ops import ntt_mr
    from zkt_plonk_tpu_torch.plonk import ZKTPlonk
    from zkt_plonk_tpu_torch.utils import arkserde

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
    ck, cvk = kzg.setup(inst.ctx, max_degree=4 * bound, tau=987654321, device=dev)
    t0 = time.perf_counter()
    compiled = inst.compile(circuit, ck, cvk)
    _sync()
    compile_s = time.perf_counter() - t0
    rng = random.Random(42)
    inst.prove(compiled, circuit, rng=rng)  # warm-up: builds the prover's tables
    prover = inst.prover(compiled)
    committer = prover.committer

    def prove():
        return inst.prove(compiled, circuit, rng=rng)

    if args.sharded:
        import socket

        from zkt_plonk_tpu_torch import parallel

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: loopback only
        parallel.init_distributed("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
        prover = committer = parallel.ShardedProver(prover, parallel.make_mesh(device=dev))

        def prove():
            return inst.prove(compiled, circuit, rng=rng, prover=prover)

        prove()  # warm-up of the sharded path

    # every NTT: its launches by kernel, inside a profiler range
    transform = ntt_mr.transform
    ntt_launches = defaultdict(int)
    ntt_calls = [0]

    def counted_transform(*a, **kw):
        before = dict(_cuda.launches)
        with torch.profiler.record_function("ntt_transform"):
            out = transform(*a, **kw)
        for k, v in _cuda.launches.items():
            ntt_launches[k] += v - before[k]
        ntt_calls[0] += 1
        return out

    ntt_mr.transform = counted_transform

    # 1. phase timing
    phases = defaultdict(float)
    stack = []
    originals = {}
    for name in ("commit_batch", "z_round", "quotient_round", "evaluate", "linearize", "open_batch"):
        originals[name] = getattr(prover, name)
        setattr(prover, name, _timed(phases, stack, name, originals[name]))
    commit_many = committer.commit_many
    committer.commit_many = _timed(phases, stack, "msm_commits", commit_many)
    synth = circuit.synthesize
    circuit.synthesize = _timed(phases, stack, "synthesize", synth)
    _sync()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    proof = prove()
    _sync()
    prove_s = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    ntt_per_proof = {"transforms": ntt_calls[0],
                     "launches": {k: v for k, v in ntt_launches.items() if v}}
    for name, fn in originals.items():
        setattr(prover, name, fn)
    committer.commit_many = commit_many
    circuit.synthesize = synth
    phases = dict(phases)
    phases["host_rest"] = prove_s - sum(phases.values())
    inst.verify(compiled, proof, pub)
    proof_sha256 = hashlib.sha256(arkserde.proof_to_bytes(
        proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)).hexdigest()

    # 2. device time by kernel under the profiler
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    _sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prove()
        _sync()
        prof_wall = time.perf_counter() - t0
    ntt_mr.transform = transform
    kernels = defaultdict(lambda: [0.0, 0])
    ntt_span_s = 0.0
    for evt in prof.key_averages():
        # device-side events only (kernels, copies); the aten op that
        # launched a kernel reports the same device time again
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.key.startswith("Activity Buffer"):  # the profiler's own
            continue
        if evt.key == "ntt_transform":
            # the range on the device, from each transform's first kernel to
            # its last: a span, not a kernel
            ntt_span_s = evt.self_device_time_total / 1e6
            continue
        if evt.self_device_time_total > 0:
            kernels[evt.key][0] += evt.self_device_time_total / 1e6
            kernels[evt.key][1] += evt.count
    busy = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    # the MSM's EC kernels: K4a (bucket accumulation) and K4 (merges, scans)
    ec_kernels = {}
    for label, names in EC_KERNELS.items():
        hits = [v for k, v in kernels.items() if any(n in k for n in names)]
        ec_kernels[label] = {"seconds": sum(v[0] for v in hits), "calls": sum(v[1] for v in hits)}

    record = {
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "config": {"curve": args.curve, "height": args.height, "notes": args.notes,
                   "table": args.table, "n": bound, "sharded": args.sharded},
        "compile_s": compile_s,
        "prove_s": prove_s,
        "proof_sha256": proof_sha256,
        "phases_s": phases,
        "launches_per_proof": launches,
        "ntt_per_proof": ntt_per_proof,
        "ntt_device_span_s": ntt_span_s,
        "profiled_prove_wall_s": prof_wall,
        "device_busy_s": busy,
        "device_busy_share": busy / prof_wall if prof_wall else None,
        "ec_kernels": ec_kernels,
        "top_device_ops": [
            {"name": k, "seconds": v[0], "calls": v[1], "share_of_busy": v[0] / busy}
            for k, v in top
        ],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"card: {smi}")
    print(f"n={bound} sharded={args.sharded} compile_s={compile_s:.3f} prove_s={prove_s:.3f} "
          f"proof_sha256={proof_sha256}")
    print(f"kernel launches in one proof: {launches}")
    print(f"NTTs in one proof: {ntt_per_proof}")
    for k, v in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"  phase {k:16s} {v:.4f} s")
    print(f"profiled prove wall {prof_wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / prof_wall:.1f}%), NTT device span {ntt_span_s * 1e3:.3f} ms")
    for label, v in ec_kernels.items():
        print(f"  {label}: {v['seconds'] * 1e3:.2f} ms device in {v['calls']} calls")
    for k, v in top:
        print(f"  {v[0] * 1e3:10.2f} ms {v[1]:7d} calls  {k[:90]}")
    if args.sharded:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
