"""The harness on the CPU: window and trace arithmetic, the files that
``BENCHMARK.json`` names, the import rules, and the refusals of ``run.py``
without a card."""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import pytest

from benchmark.core import spec, trace as tr, window as win

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# -- window arithmetic -------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("durations,seconds,want_n", [
    ([2.0] * 10, 5.0, 3),  # ends at 2, 4, 6: the third ends after 5 and closes it
    ([2.0] * 10, 6.0, 3),  # ends exactly at the deadline: closes
    ([1.0, 3.0, 0.5, 0.5], 3.5, 2),  # ends at 1, then 4: closes
    ([7.0], 5.0, 1),  # one request longer than the window
])
def test_closed_loop_window(durations, seconds, want_n):
    clock = FakeClock()

    def serve(k):
        clock.t += durations[k]
        return bytes([k])

    w = win.closed_loop(serve, seconds, clock=clock)
    assert len(w.records) == want_n
    assert w.seconds == pytest.approx(sum(durations[:want_n]))
    assert w.proofs_per_s() == pytest.approx(want_n / sum(durations[:want_n]))
    assert w.latency_p50_s() == pytest.approx(statistics.median(durations[:want_n]))


def test_failed_requests_count_and_the_loop_goes_on():
    clock = FakeClock()

    def serve(k):
        clock.t += 1.0
        if k == 1:
            raise RuntimeError("boom")
        return b"x%d" % k

    w = win.closed_loop(serve, 2.5, clock=clock)
    assert [r.answer is None for r in w.records] == [False, True, False]
    assert "boom" in w.records[1].error
    assert w.proofs_per_s() == pytest.approx(2 / 3.0)


@pytest.mark.parametrize("values", [[3.0], [1.0, 5.0], [4, 1, 3, 2, 5], [2.5, 2.5, 9.0, 0.1]])
def test_median(values):
    assert win.median(values) == pytest.approx(statistics.median(values))


def test_interval_union_gaps_and_cover():
    ivs = [(5, 6), (0, 1), (0.5, 2), (2, 3), (8, 9), (8.5, 8.7)]
    assert win.union(ivs) == [(0, 3), (5, 6), (8, 9)]
    assert win.clip(ivs, 1.5, 8.6) == [(5, 6), (1.5, 2), (2, 3), (8, 8.6), (8.5, 8.6)]
    assert win.gaps(ivs, -1, 10) == [(-1, 0), (3, 5), (6, 8), (9, 10)]
    assert win.gaps(ivs, 0.2, 2.5) == []


# -- the traced run's record and the per-layer readers -----------------------

def chrome(base_ns, events):
    return {"baseTimeNanoseconds": base_ns, "traceEvents": events}


def test_device_ops_of_a_chrome_trace():
    data = chrome(1_000_000_000_000, [
        {"ph": "X", "cat": "kernel", "name": "void ntt_fused_pass_kernel<3, 16, false>(A)",
         "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 20.0, "dur": 1.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0.0, "dur": 100.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 30.0},
    ])
    ops = tr.device_ops_of(data)
    assert [(c, tr.short_name(n)) for c, n, _, _ in ops] == [
        ("kernel", "ntt_fused_pass_kernel"), ("gpu_memcpy", "Memcpy HtoD")]
    assert tr.short_name("void at::native::(anonymous namespace)::fill_kernel<float>(float*)") \
        == "at::native::fill_kernel"
    assert tr.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert tr.short_name("void zk::ntt_fused_pass_kernel<3, 16, false>(zk::A)") \
        == "zk::ntt_fused_pass_kernel"
    assert ops[0][2] == pytest.approx(1000.0 + 10e-6)
    assert ops[0][3] - ops[0][2] == pytest.approx(5e-6)


def synthetic_trace():
    """Two proofs over [0, 10] s: statement [0, 3] and [5, 8], prove [3, 5]
    and [8, 10]; the device busy in [3.5, 4] and [8.5, 9] (overlapping
    kernels), plus one copy."""
    ops = [
        ("kernel", "void bucket_accumulate_affine_kernel<16>(x)", 3.5, 3.8),
        ("kernel", "void ec_add_complete_kernel<16>(x)", 3.7, 3.9),
        ("kernel", "ntt_fused_pass_kernel<2, 16, true>(y)", 3.9, 4.0),
        ("kernel", "void bucket_accumulate_affine_kernel<16>(x)", 8.5, 8.8),
        ("kernel", "void to_montgomery_xy_kernel<16>(x)", 8.8, 8.9),
        ("gpu_memcpy", "Memcpy DtoH", 8.9, 9.0),
    ]
    spans = [("statement", 0.0, 3.0), ("prove", 3.0, 5.0),
             ("statement", 5.0, 8.0), ("prove", 8.0, 10.0)]
    return tr.Trace(proofs=2, opened=0.0, closed=10.0, spans=spans, device_ops=ops,
                    launches=1186, latencies=[5.0, 4.0, 7.0])


def test_readers_on_a_synthetic_trace():
    t = synthetic_trace()
    read = {m: spec.reader(m)(t) for m in (
        "entry.proofs_per_s", "entry.latency_p50_s", "synthesis.ms_per_proof",
        "prover.ms_per_proof", "kernels.ec_ms_per_proof",
        "kernels.ntt_ms_per_proof", "device.idle_share", "device.launches_per_proof")}
    assert read["entry.proofs_per_s"] == pytest.approx(0.2)
    assert read["entry.latency_p50_s"] == pytest.approx(5.0)
    assert read["synthesis.ms_per_proof"] == pytest.approx(3000.0)
    assert read["prover.ms_per_proof"] == pytest.approx(2000.0)
    # K4a 0.3 + 0.3 s, K4 0.2 s; the conversion kernel is not in the list
    assert read["kernels.ec_ms_per_proof"] == pytest.approx(400.0)
    assert read["kernels.ntt_ms_per_proof"] == pytest.approx(50.0)
    # busy: [3.5, 4.0] and [8.5, 9.0] = 1.0 s of 10 s
    assert t.busy_s() == pytest.approx(1.0)
    assert read["device.idle_share"] == pytest.approx(90.0)
    assert read["device.launches_per_proof"] == pytest.approx(593.0)
    b = t.breakdown()
    assert b["device_ops"][0] == ["bucket_accumulate_affine_kernel", pytest.approx(0.6)]
    assert b["idle_gaps"][0] == ["statement", pytest.approx(4.5)]
    assert [name for name, _ in b["idle_gaps"]] == ["statement", "statement", "prove"]


def test_idle_share_needs_no_clock_and_gaps_need_one():
    # the same trace with its device operations shifted off the window's
    # clock: the busy time and the idle share stay, the idle gaps go
    t = synthetic_trace()
    shifted = [(c, n, a + 1e6, b + 1e6) for c, n, a, b in t.device_ops]
    assert tr.aligned(t.device_ops, t.opened, t.closed)
    assert not tr.aligned(shifted, t.opened, t.closed)
    off = tr.Trace(proofs=2, opened=0.0, closed=10.0, spans=t.spans, device_ops=shifted,
                   launches=t.launches, aligned=False)
    assert off.busy_s() == pytest.approx(1.0)
    assert spec.reader("device.idle_share")(off) == pytest.approx(90.0)
    assert off.breakdown()["idle_gaps"] == []
    assert [[n, pytest.approx(v)] for n, v in off.breakdown()["device_ops"]] == \
        t.breakdown()["device_ops"]


def test_device_ms_per_proof_is_the_busy_union_over_the_proofs():
    # [3.5, 4.0] and [8.5, 9.0]: 1.0 s busy, overlapping kernels counted once
    assert synthetic_trace().device_ms_per_proof() == pytest.approx(500.0)
    none = tr.Trace(proofs=0, opened=0.0, closed=1.0, spans=[], launches=0,
                    device_ops=synthetic_trace().device_ops)
    idle = tr.Trace(proofs=2, opened=0.0, closed=1.0, spans=[], device_ops=[], launches=0)
    assert none.device_ms_per_proof() is None and idle.device_ms_per_proof() is None


def test_readers_find_nothing_in_an_empty_trace():
    t = tr.Trace(proofs=0, opened=0.0, closed=1.0, spans=[], device_ops=[], launches=0)
    for m in spec.benchmark()["per_layer"]:
        assert spec.reader(m["name"])(t) is None, m["name"]


def test_kernel_names_match_whole_identifiers():
    t = tr.Trace(proofs=1, opened=0.0, closed=1.0, spans=[], launches=1, device_ops=[
        ("kernel", "void bucket_accumulate_affine_kernel<16>(x)", 0.0, 0.5)])
    assert t.kernel_seconds(["bucket_accumulate_kernel"]) is None
    assert t.kernel_seconds(["bucket_accumulate_affine_kernel"]) == pytest.approx(0.5)


# -- BENCHMARK.json and the files it names ------------------------------------

def test_benchmark_json_keys_and_names():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])
    assert len(json.dumps(b).encode()) <= 64 * 1024


def test_every_named_file_is_found_by_name():
    b = spec.benchmark()
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert c["file"].startswith("benchmark/configs/")
        assert cfg["curve"] in ("bn254", "bls12_381", "bls12_377") and cfg["scheme"] == "kzg"
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert spec.cell(w["name"]) == w
        spec.config(w["config"])
        mix = spec.traffic(w["traffic"])
        path = spec.path(mix["path"])
        path.check(mix)
        assert callable(path.warm_up) and callable(path.window)
        assert mix["pool"] >= 1 and mix["warmup"] >= 1
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))
    metric_files = {f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR, "metrics"))
                    if f.endswith(".py")}
    assert metric_files == {m["name"] for m in b["per_layer"]}


class FakePort:
    def __init__(self):
        self.proved = []

    def prove(self, circuit, rng, spans=None):
        self.proved.append(circuit)
        return bytes([circuit, rng.randrange(256)])


class FakeSetup:
    def __init__(self, mix):
        self.traffic, self.seed, self.port = mix, 2**33 + 7, FakePort()

    def circuit(self, j):
        return j % self.traffic["pool"]


@pytest.mark.parametrize("mix", sorted({w["traffic"] for w in spec.benchmark()["workloads"]}))
def test_every_run_proves_a_request_twice(mix):
    # fresh blinders are checked by ``repeated``, which sees them only on a
    # request proved twice: the warm-up proves the pool's first requests
    # and the window proves them again, whatever its length
    traffic = spec.traffic(mix)
    setup = FakeSetup(traffic)
    path = spec.path(traffic["path"])
    path.warm_up(setup)
    window = path.window(setup, 0.0)
    assert setup.port.proved[:traffic["warmup"]] == list(range(traffic["warmup"]))
    assert window.records[0].k == 0 and setup.port.proved[traffic["warmup"]] == 0


# -- import rules ------------------------------------------------------------

FORBIDDEN_CHECK = """
import sys
sys.path.insert(0, {root!r})
{imports}
tops = {{m.split(".", 1)[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "zkt_plonk_tpu", "zkt_plonk_tpu_torch"}}))
"""


def _tops(imports: str):
    code = FORBIDDEN_CHECK.format(root=ROOT, imports=imports)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_a_cell_imports_neither_jax_nor_the_jax_package():
    # everything a run imports: the harness, the port's modules the cell
    # drives (through Port's own imports), the reference
    imports = """
import benchmark.run, benchmark.core.port, benchmark.core.check, benchmark.core.inputs
from zkt_plonk_tpu_torch.circuits.withdraw import WithdrawCircuit
from zkt_plonk_tpu_torch.commitment import kzg
from zkt_plonk_tpu_torch.cs import LookupTable
from zkt_plonk_tpu_torch.hashing import PoseidonConstants, bn254_constants
from zkt_plonk_tpu_torch.hashing.merkle import PoECircuit
from zkt_plonk_tpu_torch.plonk import ZKTPlonk
from zkt_plonk_tpu_torch.transcript import EthereumTranscript, MerlinTranscript
from zkt_plonk_tpu_torch.utils import arkserde
from zkt_plonk_tpu_torch.proof_system import prover
from benchmark.core import spec
for m in spec.benchmark()["per_layer"]:
    spec.reader(m["name"])
for w in spec.benchmark()["workloads"]:
    spec.path(spec.traffic(w["traffic"])["path"])
"""
    assert _tops(imports) == ["zkt_plonk_tpu_torch"]


def test_the_reference_imports_nothing_of_the_port():
    imports = """
import benchmark.reference, benchmark.reference.plonk_kzg
import benchmark.core.inputs, benchmark.core.check, benchmark.core.window, benchmark.core.trace
"""
    assert _tops(imports) == []


# -- run.py refuses without a card ------------------------------------------

def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bn254_kzg_withdraw.serial1",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_no_result_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
