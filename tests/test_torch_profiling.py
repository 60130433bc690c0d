"""The port's span recorder (``utils/profiling``) and the arithmetic it
reads spans and device traces with, on the CPU: request ids per thread,
counters under threads, self times, device intervals from a Chrome trace,
and idle gaps named by the innermost span open at their middle."""

import ast
import json
import sys
import threading

import pytest

from zkt_plonk_tpu_torch.tools import profile_withdraw as pw
from zkt_plonk_tpu_torch.utils import profiling
from zkt_plonk_tpu_torch.utils.profiling import Span


@pytest.fixture
def recorder():
    profiling.drain()
    profiling.enable()
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.drain()


def test_the_recorder_cannot_reach_the_device():
    """The recorder imports only the standard library, so neither a span
    nor a counter can synchronize, copy or allocate on the card."""
    tree = ast.parse(open(profiling.__file__).read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not any(isinstance(n, ast.ImportFrom) and n.level for n in ast.walk(tree))
    assert imported <= set(sys.stdlib_module_names) | {"__future__"}, imported


def test_off_a_section_is_one_shared_no_op():
    assert not profiling.enabled()
    assert profiling.section("a") is profiling.section("b")
    with profiling.section("a"):
        pass
    assert profiling.drain() == []


def test_a_request_spans_a_statement_and_the_prove_after_it_on_its_thread(recorder):
    """``begin_request`` gives the thread's next root spans one id; a thread
    that began none (a batch row) gives each root span a fresh id."""
    ids = {}

    def row(k):
        for j in range(2):
            with profiling.section("prove"):
                with profiling.section("stage"):
                    pass
        ids[k] = threading.get_ident()

    profiling.begin_request()
    with profiling.section("statement"):
        with profiling.section("synthesize"):
            pass
    threads = [threading.Thread(target=row, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    with profiling.section("prove"):
        pass
    spans = profiling.drain()
    main = [s for s in spans if s.thread == threading.get_ident()]
    assert [s.name for s in main] == ["synthesize", "statement", "prove"]
    assert len({s.request for s in main}) == 1
    rows = [s for s in spans if s.thread != threading.get_ident()]
    assert len(rows) == 12 and {s.thread for s in rows} == set(ids.values())
    roots = [s for s in rows if s.parent == -1]
    assert len({s.request for s in roots}) == 6 and main[0].request not in {s.request for s in roots}
    by_index = {s.index: s for s in spans}
    for s in rows:
        if s.parent != -1:
            assert by_index[s.parent].thread == s.thread and by_index[s.parent].request == s.request


def test_counters_stay_exact_under_threads():
    before = profiling.snapshot()

    def work():
        for _ in range(2000):
            profiling.count(h2d_copies=1, h2d_bytes=64)
            with profiling.waiting():
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    after = profiling.snapshot()
    assert after["h2d_copies"] - before["h2d_copies"] == 16000
    assert after["h2d_bytes"] - before["h2d_bytes"] == 16000 * 64
    assert after["host_waits"] - before["host_waits"] == 16000
    assert profiling.drain() == []  # the recorder was off: waits counted, no span kept


class Chain:
    """A circuit of ``gates`` additions, a public output and one lookup."""

    def __init__(self, gates):
        self.gates = gates

    def synthesize(self, cs):
        from zkt_plonk_tpu_torch.cs import lt

        a = cs.assign_variable(1)
        x = a
        for _ in range(self.gates):
            x = cs.add_gate(lt(x), lt(a))
        cs.set_variable_public(lt(x))
        cs.lookup_constrain(lt(a))


class Compiled:
    """What ``ZKTPlonk.statement`` reads of a compiled circuit: the verifier
    key that seeds the transcript (here it appends nothing), so the test
    needs no SRS and no keys."""

    class vk:
        @staticmethod
        def seed_transcript(transcript):
            pass


@pytest.mark.parametrize("gates,rows", [(5, 64), (200, 256)])  # the table's 63 rows bind at 5
def test_each_statement_counts_the_circuit_gates_and_domain_rows(gates, rows):
    """``ZKTPlonk.statement`` adds its proving composer's gates to
    ``circuit_gates`` and its ``circuit_bound()`` to ``domain_rows``, once a
    statement, whatever the circuit: two statements, twice."""
    from zkt_plonk_tpu_torch.cs import LookupTable
    from zkt_plonk_tpu_torch.plonk import ZKTPlonk

    inst = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63), device="cpu")
    compiled = Compiled()
    before = profiling.snapshot()
    composer, _ = inst.statement(compiled, Chain(gates))
    composer_again, _ = inst.statement(compiled, Chain(gates))
    after = profiling.snapshot()
    assert composer.n == composer_again.n == gates + 2
    assert after["circuit_gates"] - before["circuit_gates"] == 2 * composer.n
    assert after["domain_rows"] - before["domain_rows"] == 2 * rows
    assert profiling.drain() == []  # the recorder was off: counted, no span kept


def _span(name, start, end, index, parent=-1):
    return Span(name, start, end, index, parent, 1, 0)


# one proof on one clock: statement [0, 4) with synthesize [0.5, 3.5) and a
# note [1, 2) in it; prove [5, 10) with a stage [5, 6), and round1+2 [6, 9)
# holding a commit [6, 8.5) of msm [6, 6.5), wait [6.5, 8) and fold [8, 8.5)
SPANS = [
    _span("note", 1.0, 2.0, 2, 1),
    _span("synthesize", 0.5, 3.5, 1, 0),
    _span("statement", 0.0, 4.0, 0),
    _span("stage", 5.0, 6.0, 4, 3),
    _span("msm", 6.0, 6.5, 7, 6),
    _span("wait", 6.5, 8.0, 8, 6),
    _span("fold", 8.0, 8.5, 9, 6),
    _span("commit", 6.0, 8.5, 6, 5),
    _span("round1+2", 6.0, 9.0, 5, 3),
    _span("prove", 5.0, 10.0, 3),
]
# the card busy during the copies, the MSM and the wait
BUSY = [(5.5, 6.0), (6.2, 7.9)]


def test_span_paths_and_self_times():
    names = profiling.paths(SPANS)
    assert names[9] == "prove/round1+2/commit/fold"
    assert names[2] == "statement/synthesize/note"
    selfs = profiling.self_seconds(SPANS)
    assert selfs[0] == pytest.approx(1.0)  # statement outside synthesize
    assert selfs[1] == pytest.approx(2.0)
    assert selfs[3] == pytest.approx(1.0)  # prove outside stage and round1+2
    assert selfs[6] == pytest.approx(0.0)
    table = pw.phase_table(SPANS, proofs=1, busy=profiling.union(BUSY))
    assert list(table)[:3] == ["statement", "statement/synthesize", "statement/synthesize/note"]
    assert table["prove/round1+2"]["ms"] == pytest.approx(3000.0)
    assert table["prove/round1+2"]["self_ms"] == pytest.approx(500.0)
    # the card's idle time, put down to the span whose own time it falls in
    idle = {name: row["idle_ms"] for name, row in table.items()}
    assert idle == pytest.approx({
        "statement": 1000.0, "statement/synthesize": 2000.0, "statement/synthesize/note": 1000.0,
        "prove": 1000.0, "prove/stage": 500.0, "prove/round1+2": 500.0,
        "prove/round1+2/commit": 0.0, "prove/round1+2/commit/msm": 200.0,
        "prove/round1+2/commit/wait": 100.0, "prove/round1+2/commit/fold": 500.0})
    assert sum(idle.values()) == pytest.approx(1e3 * sum(
        b - a for a, b in profiling.gaps(profiling.union(BUSY), 0.0, 10.0)) - 1e3 * (5.0 - 4.0))


def test_interval_union_cover_and_gaps():
    merged = profiling.union([(3.0, 4.0), (0.0, 1.0), (0.5, 2.0), (4.0, 4.5)])
    assert merged == [(0.0, 2.0), (3.0, 4.5)]
    assert profiling.covered(merged, 1.0, 3.5) == pytest.approx(1.5)
    assert profiling.gaps(merged, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.5, 5.0)]
    assert profiling.gaps(merged, 0.5, 1.5) == []


def test_idle_gaps_are_named_by_the_innermost_span_open_at_their_middle():
    """Idle stretches [0, 5.5), [6.0, 6.2), [7.9, 10) and, past the last
    span, [10, 12): longest first, at most ``top``."""
    gaps = profiling.idle_gaps(profiling.union(BUSY), SPANS, [(0.0, 10.0), (10.0, 12.0)], top=4)
    assert [name for name, _ in gaps] == [
        "statement/synthesize", "prove/round1+2", "between", "prove/round1+2/commit/msm"]
    assert [s for _, s in gaps] == pytest.approx([5.5, 2.1, 2.0, 0.2])
    assert len(profiling.idle_gaps(profiling.union(BUSY), SPANS, [(0.0, 10.0)], top=2)) == 2


def test_device_intervals_read_a_chrome_trace_on_the_wall_clock():
    """Kernels, copies and memsets, shifted by the trace's base time; host
    events and instants left out."""

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"baseTimeNanoseconds": 2_000_000_000, "traceEvents": [
                    {"ph": "X", "cat": "kernel", "name": "k", "ts": 1_000_000, "dur": 250},
                    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1_000_500,
                     "dur": 100},
                    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 9},
                    {"ph": "i", "cat": "kernel", "name": "mark", "ts": 5},
                ]}, f)

    got = profiling.device_intervals(Prof())
    assert [(c, n) for c, n, _, _ in got] == [("kernel", "k"), ("gpu_memcpy", "Memcpy HtoD")]
    assert [t for _, _, a, b in got for t in (a, b)] == pytest.approx(
        [3.0, 3.00025, 3.0005, 3.0006])


def test_device_ops_are_joined_to_their_launching_call_and_span():
    """Each device op takes the start of the host call with its correlation
    id (None without one); ``launch_sites`` puts its device ms under the
    innermost span open at that call, classed as the digit recoding, the
    rest of a commit, or elsewhere."""
    data = {"baseTimeNanoseconds": 0, "traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1_500_000,
         "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 2_500_000,
         "dur": 5, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 3_500_000,
         "dur": 5, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128, 2>(int)",
         "ts": 1_600_000, "dur": 4000, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
         "ts": 2_600_000, "dur": 2000, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "void zk::msm_digits_kernel<true>(int const*)",
         "ts": 3_600_000, "dur": 1000, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "void at::native::(anonymous namespace)::"
         "CatArrayBatchedCopy<int>(int)", "ts": 4_000_000, "dur": 500, "args": {}},
    ]}
    ops = pw.launched_ops(data)
    assert [op[4] for op in ops] == pytest.approx([1.5, 2.5, 3.5, None])
    spans = [Span("prove", 0.0, 5.0, 0, -1, 1, 1), Span("commit", 1.0, 2.0, 1, 0, 1, 1),
             Span("msm", 1.2, 1.9, 2, 1, 1, 1), Span("digit_rows", 1.4, 1.6, 3, 2, 1, 1),
             Span("round3", 2.0, 4.0, 4, 0, 1, 1), Span("digit_rows", 3.4, 3.6, 5, 4, 1, 1)]
    got = pw.launch_sites(ops, spans, proofs=2)
    want = {"digit_rows": {"at::native::elementwise_kernel": 2.0, "zk::msm_digits_kernel": 0.5},
            "elsewhere": {"Memcpy DtoD": 1.0}}
    assert set(got["by_class"]) == set(want)
    for site, ms in want.items():
        assert got["by_class"][site] == pytest.approx(ms)
    assert got["unmatched_ms"] == pytest.approx(0.25)
    assert got["by_site"][0] == ["prove/commit/msm/digit_rows", "at::native::elementwise_kernel",
                                 pytest.approx(2.0)]
    assert pw.site_class("prove/round1+2/commit/fold") == "commit/msm"
    assert pw.short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
