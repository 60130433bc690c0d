"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card.  The run builds the cell's
deployment from ``--seed`` (``core/inputs.py``), sets the port up on it
(SRS, compile) and warms it up, serves the cell's traffic for
``--seconds`` on the traffic's path (``paths/<path>.py``), judges every proof of the window with
the plain reference (``core/check.py``), and prints one JSON line last on
standard output.  Every window runs under ``torch.profiler`` (CUDA
activity).  ``--trace 0`` reports the cell's end-to-end metrics, the
device's busy time per proof among them; ``--trace 1`` its per-layer
metrics from the same trace, the benchmark's host spans and the program's
launch counter.  See ``README.md``.

It exits with a code other than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), when the port cannot be
imported, and when the process holds JAX or the JAX package once the
window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux: /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.core import check, inputs, spec, trace as tr  # noqa: E402

# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "zkt_plonk_tpu")

# build and kernel caches of the program, at fixed paths in the checkout
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton_cache"),
}


def say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Setup:
    """A cell's deployment with the port set up on it, and the path
    (``benchmark/paths/<path>.py``) that serves its traffic."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, device: str,
                 program_config=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.path = spec.path(traffic["path"])
        self.path.check(traffic)
        self.seed = seed
        t0 = time.perf_counter()
        self.deployment = inputs.make(self.config, self.traffic, seed)
        say(f"inputs {time.perf_counter() - t0:.3f} s: {len(self.deployment.requests)} requests")
        from benchmark.core.port import Port

        # the program may be run under another configuration (a control);
        # the reference always holds it to the cell's own
        self.port = Port(program_config or self.config, self.deployment, device, say)
        self.circuits = [self.port.circuit(r) for r in self.deployment.requests]
        self.warm_answers = []

    def circuit(self, j: int):
        """The port's circuit of the pool's request j (cycling)."""
        return self.circuits[j % len(self.circuits)]

    def warm_up(self, traced: bool) -> None:
        t0 = time.perf_counter()
        self.warm_answers = self.path.warm_up(self, [] if traced else None)
        say(f"warm-up {len(self.warm_answers)} proofs {time.perf_counter() - t0:.3f} s")


def measure(setup: Setup, seconds: float, traced: bool):
    """(window, trace).  On a card every window runs under the device's
    profiler, which ``device_ms_per_proof`` reads; the traced run adds the
    benchmark's host spans.  Elsewhere the trace is None."""
    spans = [] if traced else None
    if setup.port.device.type != "cuda":
        return setup.path.window(setup, seconds, spans), None
    import torch

    with tr.DeviceProfiler(torch) as prof:
        launches0 = setup.port.launches()
        offset = tr.wall_offset()
        window = setup.path.window(setup, seconds, spans)
        launches = setup.port.launches() - launches0
    ops = prof.device_ops()
    opened, closed = window.opened + offset, window.closed + offset
    aligned = tr.aligned(ops, opened, closed)
    if traced and not aligned:
        say("fewer than half of the device operations fall in the window: the trace's "
            "clock is not the wall clock, so the idle gaps are left out")
    trace = tr.Trace(proofs=len(window.completed()), opened=opened, closed=closed,
                     spans=[(n, a + offset, b + offset) for n, a, b in spans or []],
                     device_ops=ops, launches=launches, aligned=aligned,
                     latencies=[r.done - r.issued for r in window.records])
    return window, trace


def cell_setup(cell_name: str, seed: int, device: str = "cuda", program_config=None) -> Setup:
    """``Setup`` of a cell of ``BENCHMARK.json``, its files found by name."""
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    return Setup(cell, config, spec.traffic(cell["traffic"]), seed, device, program_config)


def run(setup: Setup, seconds: float, traced: bool, t_start: float = None, report=print):
    """One run of a set-up cell: warm-up, window, judgement; returns the
    result line's object (``report`` prints it)."""
    t_start = T_START if t_start is None else t_start
    cell_name = setup.cell["name"]
    setup.warm_up(traced)
    cpu0 = time.process_time()
    window, trace = measure(setup, seconds, traced)
    say(f"host: process cpu {time.process_time() - cpu0:.3f} s of {window.seconds:.3f} s")
    setup_s = window.opened - t_start
    say(f"set-up {setup_s:.3f} s; window {window.seconds:.3f} s, "
        f"{len(window.completed())} of {len(window.records)} proofs; "
        f"{window.proofs_per_s():.6f} proofs/s, latency p50 {window.latency_p50_s():.6f} s")
    if trace is not None:
        say(f"device busy {trace.busy_s():.6f} s, {trace.device_ms_per_proof()} ms a proof")
    say("latencies_s " + json.dumps([r.done - r.issued for r in window.records]))
    for rec in window.records:
        if rec.error:
            say(f"request {rec.k} failed: {rec.error}")

    torch = setup.port.torch
    dev = setup.port.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": setup.cell["chips"],
        "memory_peak_bytes": setup.port.peak_bytes() if dev.type == "cuda" else 0,
    }
    breakdown = None
    if traced:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.seconds
        kind, read = "per_layer", lambda name: spec.reader(name)(trace)
        breakdown = trace.breakdown()
    else:
        values = {"device_ms_per_proof": trace.device_ms_per_proof() if trace else None,
                  "setup_s": setup_s}
        kind, read = "end_to_end", values.get
    metrics = {}
    for m in spec.metrics(kind, cell_name):
        value = read(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the reference runs once the program's state is freed
    setup.port.close()
    t0 = time.perf_counter()
    checks, reasons = check.judge(setup.config, setup.deployment, window, setup.warm_answers)
    say(f"reference {time.perf_counter() - t0:.3f} s over {len(window.completed())} proofs")
    for why in reasons:
        say(f"refused: {why}")
    result = {
        "correct": check.correct(checks, len(window.completed())),
        "attempted": len(window.records),
        "failed": checks["failed"]["value"],
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        say(f"the process holds {', '.join(bad)}: no result")
        raise SystemExit(3)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    report(json.dumps(result))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(CACHE_DIRS)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        say(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    run(cell_setup(args.workload, args.seed), args.seconds, bool(args.trace))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
