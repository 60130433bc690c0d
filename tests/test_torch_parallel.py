"""The port's parallel layer (``zkt_plonk_tpu_torch.parallel``) on the CPU,
over gloo, against the JAX package.

One spawn of four ranks runs every multi-rank check of this module, and one
spawn of a single rank the in-process ones; the parent computes the JAX
references meanwhile and the tests read both.  Each rank is a process with
its own ``device="cpu"`` tensors and its rendezvous file under pytest's
``tmp_path``, so that parallel test workers never share a port.

* ops, at D = 4, N = 128 (m = 32), inputs from ``random.Random`` seeds as
  in ``tests/test_multichip.py``: every port function of
  ``parallel/ops.py``, gathered over the ranks, equals the JAX
  ``parallel.ops`` function run under ``jax.shard_map`` on 4 devices, limb
  for limb; the MSM reductions (``pmsm_totals``, ``pcommit_totals``) equal
  as host-folded affine points the JAX package's host sum of the same
  scalar multiples (the JAX sharded MSM's program takes about 30 s to
  compile on the CPU; ``tests/test_multichip.py`` ties it to the
  single-device MSM);
* the TinyCircuit of ``tests/test_multichip.py`` (n = 64, SRS degree 256,
  tau 123456789, seed 9): ``ShardedProver``'s proof at D = 1, 2 and 4,
  through ``ZKTPlonk.prove``, is byte-equal to the JAX package's
  single-device proof (sha256 ``GOLDEN``, which ``tests/test_e2e.py``
  derives from the JAX package on every run) and verifies;
* the rounds ``commit_batch``, ``z_round`` and ``quotient_round`` of the
  port's ``Prover`` against the sharded rounds at D = 2, gathered;
* ``BatchProver`` with the witnesses of ``tests/test_multichip.py``'s batch
  test, in two layouts, (data = 2, poly = 2) over 4 ranks and
  (data = 2, poly = 1) in one process: each proof is byte-equal to the JAX
  package's single-device proof of its witness and seed, which the parent
  proves with ``zkt_plonk_tpu.plonk.ZKTPlonk.prove`` on the same keys;
* launch counts stay exact when threads launch at once, and every wrapper
  counts its launches through the one locked counter.

JAX is imported only by the parent's reference fixture, which runs while the
ranks work: the ranks import this module to find their entry point and must
not load JAX.
"""

import ast
import hashlib
import multiprocessing as mp
import os
import random
import sys
import threading
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from zkt_plonk_tpu_torch import _cuda, parallel
from zkt_plonk_tpu_torch.commitment import kzg
from zkt_plonk_tpu_torch.cs import LookupTable, lt
from zkt_plonk_tpu_torch.fields import BN254_FR, make_spec
from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
from zkt_plonk_tpu_torch.parallel import ops as pops
from zkt_plonk_tpu_torch.parallel.mesh import gather_rows, shard_rows
from zkt_plonk_tpu_torch.parallel.prover import BodyTail
from zkt_plonk_tpu_torch.plonk import ZKTPlonk
from zkt_plonk_tpu_torch.utils import arkserde
from zkt_plonk_tpu_torch.utils.domain import make_domain

D = 4
N = 128
SPEC = make_spec(BN254_FR)
P_MOD = SPEC.modulus
MSM_N = 64
GOLDEN = "504e1dbfaa28af3d1e9da112bbb4329374e06669416c39ec1fc8015df71d3cba"
BATCH_TAU = 42424242
BATCH = (((2, 5), 100, [12]), ((1, 5), 101, [6]))  # (witness, seed, public inputs)
RANK_TIMEOUT_S = 300

# the ops checks: (name, axis the output is sharded on, or None when replicated)
BATCHED = ("pcoset_fft", "pcoset_ifft", "pprefix_products")  # (2, N, L) inputs
OPS = [
    ("pbitrev", -2), ("pfft", -2), ("pifft", -2), ("pcoset_fft", -2), ("pcoset_ifft", -2),
    ("proll+1", -2), ("proll-1", -2), ("proll-2", -2), ("proll-4", -2),
    ("pprefix_products", -2), ("pflip", -2), ("pbatch_inverse", -2),
    ("peval_many", None), ("pdivide_by_linear.body", -2), ("pdivide_by_linear.tail", None),
]


class Circuit:
    """TinyCircuit (a, b) = (2, 3) and the batch witnesses of
    ``tests/test_multichip.py``: d = a*b + a public, a in the table.  ``lt``
    is the port's, or the JAX package's for its own constraint system."""

    def __init__(self, a=2, b=3, lt=lt):
        self.a, self.b, self.lt = a, b, lt

    def synthesize(self, cs):
        lt = self.lt
        a = cs.assign_variable(self.a)
        b = cs.assign_variable(self.b)
        c = cs.mul_gate(lt(a), lt(b))
        d = cs.add_gate(lt(c), lt(a))
        cs.set_variable_public(lt(d))
        cs.lookup_constrain(lt(a))


def _rand_limbs(rng, count):
    return ints_to_array([rng.randrange(P_MOD) for _ in range(count)], 16).astype(np.int32)


def _op_inputs():
    """Inputs of the ops checks, as in ``tests/test_multichip.py``."""
    rng = random.Random(1)
    x = _rand_limbs(rng, N).reshape(N, 16)
    xb = _rand_limbs(rng, 2 * N).reshape(2, N, 16)
    inv = _rand_limbs(rng, N).reshape(N, 16)
    inv[3] = 0
    inv[77] = 0
    bodies = _rand_limbs(rng, 3 * N).reshape(3, N, 16)
    tails = _rand_limbs(rng, 12).reshape(3, 4, 16)
    pt = rng.randrange(1, P_MOD)
    scalar = lambda v: ints_to_array([v], 16).astype(np.int32)[0]
    return dict(x=x, xb=xb, inv=inv, bodies=bodies, tails=tails, pt=scalar(pt),
                pt_inv=scalar(pow(pt, -1, P_MOD)))


def _msm_inputs():
    """Points k_i * G (host ints k_i), scalars, and the SRS-style commit
    case: N body points and 4 tail points, N + 4 coefficients."""
    from zkt_plonk_tpu_torch.curves import make_context
    from zkt_plonk_tpu_torch.ops import ec

    ctx = make_context("bn254")
    r = ctx.curve.fr.modulus
    rng = random.Random(7)
    ks = [rng.randrange(1, r) for _ in range(N + 4)]
    pts = ec.from_affine_host(ctx.fq_spec, [_mul_g(ctx, k) for k in ks]).astype(np.int32)
    scalars = [rng.randrange(r) for _ in range(N + 4)]
    return dict(ks=ks, points=pts, scalars=scalars,
                scalar_limbs=ints_to_array(scalars, 16).astype(np.int32))


def _mul_g(ctx, k):
    from zkt_plonk_tpu_torch.curves import curve_host as ch

    pt = ch.scalar_mul(ctx.g1, k)
    return None if pt is None else (int(pt[0]), int(pt[1]))


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------


def _keys(tau, circuit):
    inst = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63), device="cpu")
    ck, cvk = kzg.setup(inst.ctx, max_degree=4 * 64, tau=tau, device="cpu")
    compiled = inst.compile(circuit, ck, cvk)
    return inst, compiled, inst.prover(compiled)


def _bytes(inst, proof):
    return arkserde.proof_to_bytes(proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)


def _sharded_proof(inst, compiled, prover, mesh, verify):
    proof = inst.prove(compiled, Circuit(), random.Random(9),
                       prover=parallel.ShardedProver(prover, mesh))
    if verify:
        inst.verify(compiled, proof, [8])
    return _bytes(inst, proof)


def _batch(mesh2d):
    inst, compiled, prover = _keys(BATCH_TAU, Circuit(2, 5))
    statements = [inst.statement(compiled, Circuit(*w)) for w, _, _ in BATCH]
    proofs = parallel.BatchProver(prover, mesh2d).prove_batch(
        [s[0] for s in statements], [s[1] for s in statements],
        [random.Random(seed) for _, seed, _ in BATCH])
    if dist.get_rank() == 0:
        for proof, (_, _, pub) in zip(proofs, BATCH):
            inst.verify(compiled, proof, pub)
    return [_bytes(inst, p) for p in proofs]


def _ops_job(mesh, inp, msm):
    from zkt_plonk_tpu_torch.curves import make_context
    from zkt_plonk_tpu_torch.ops import ec
    from zkt_plonk_tpu_torch.ops import msm as msm_mod

    st = pops.build_shard_ntt_tables(make_domain(BN254_FR, N), mesh)
    T = torch.from_numpy
    sh = lambda a: shard_rows(mesh, T(a)).contiguous()
    x, xb = sh(inp["x"]), sh(inp["xb"])
    pt, pt_inv = T(inp["pt"]), T(inp["pt_inv"])
    q_body, q_tail = pops.pdivide_by_linear(SPEC, x, T(inp["tails"][0]), pt, pt_inv, mesh)
    out = {
        "pbitrev": pops.pbitrev(x, st.rev_d, st.rev_m, mesh),
        "pfft": pops.pfft(SPEC, st, x, mesh),
        "pifft": pops.pifft(SPEC, st, x, mesh),
        "pcoset_fft": pops.pcoset_fft(SPEC, st, xb, mesh),
        "pcoset_ifft": pops.pcoset_ifft(SPEC, st, xb, mesh),
        "pprefix_products": pops.pprefix_products(SPEC, xb, 1, mesh),
        "pflip": pops.pflip(x, 0, mesh),
        "pbatch_inverse": pops.pbatch_inverse(SPEC, sh(inp["inv"]), 0, mesh),
        "peval_many": pops.peval_many(SPEC, sh(inp["bodies"]), T(inp["tails"]), pt, mesh),
        "pdivide_by_linear.body": q_body,
        "pdivide_by_linear.tail": q_tail,
    }
    for shift in (1, -1, -2, -4):
        out[f"proll{shift:+d}"] = pops.proll(x, shift, mesh, axis=0)

    ctx = make_context("bn254")
    fr_bits = ctx.curve.fr.modulus.bit_length()
    b3 = ec.b3_const(ctx.fq_spec, ctx.curve.b, device="cpu")
    z1 = lambda pts: msm_mod.commit_points(ctx.fq_spec, pts)
    pts = z1(shard_rows(mesh, T(msm["points"][:MSM_N]), axis=0))
    sc = shard_rows(mesh, T(msm["scalar_limbs"][:MSM_N]), axis=0)
    out["pmsm_totals"] = pops.pmsm_totals(ctx.fq_spec, b3, pts, sc, fr_bits, mesh, c=4, groups=2)
    out["pcommit_totals"] = pops.pcommit_totals(
        ctx.fq_spec, b3, z1(shard_rows(mesh, T(msm["points"][:N]), axis=0)), z1(T(msm["points"][N:])),
        shard_rows(mesh, T(msm["scalar_limbs"][:N]), axis=0), T(msm["scalar_limbs"][N:]),
        fr_bits, c=4, mesh=mesh, groups=2)
    return {k: v.numpy() for k, v in out.items()}


def _rounds_job(prover, mesh):
    """The port's rounds on one device and sharded over ``mesh``, on the
    same random inputs: (single, gathered sharded) per round."""
    sp = parallel.ShardedProver(prover, mesh)
    n = prover.n
    rng = random.Random(21)
    R = lambda *shape: torch.from_numpy(_rand_limbs(rng, int(np.prod(shape))).reshape(*shape, 16))
    joined = lambda bt: torch.cat([gather_rows(mesh, bt.body), bt.tail], dim=-2).numpy()
    sh = lambda t: shard_rows(mesh, t).contiguous()
    out = {}
    evals, blinders = R(6, n), R(6, 4)
    out["commit_batch"] = (prover.commit_batch(evals, blinders).numpy(),
                           joined(sp.commit_batch(sh(evals), blinders)))
    wires, f, t, h1, h2, zs, zb = R(3, n), R(n), R(n), R(n), R(n), R(8), R(2, 4)
    out["z_round"] = (prover.z_round(wires, f, t, h1, h2, zs, zb).numpy(),
                      joined(sp.z_round(sh(wires), sh(f), sh(t), sh(h1), sh(h2), zs, zb)))
    polys8, pi, sc, w, qb = R(8, n + 4), R(n), R(7), R(7), R(2)
    out["quotient_round"] = (
        prover.quotient_round(polys8, pi, sc, w, qb).numpy(),
        joined(sp.quotient_round(BodyTail(sh(polys8[:, :n]), polys8[:, n:]), sh(pi), sc, w, qb)))
    return out


def _rank_main(rank, world, init_file, payload, results):
    """One rank: every check of this world size, in one process."""
    torch.set_num_threads(1)
    try:
        parallel.init_distributed("gloo", init_method=f"file://{init_file}",
                                  world_size=world, rank=rank)
        out = {}
        try:
            if world == 1:
                inst, compiled, prover = _keys(123456789, Circuit())
                out["prove_d1"] = _sharded_proof(inst, compiled, prover,
                                                 parallel.make_mesh(device="cpu"), True)
                mesh2d = parallel.make_mesh((2, 1), ("data", "poly"), device="cpu")
                out["batch_2x1"] = _batch(mesh2d)
                out["batch_2x1_transports"] = [m.transport for m in mesh2d.rows]
            else:
                mesh = parallel.make_mesh(device="cpu")
                out["ops"] = _ops_job(mesh, payload["ops"], payload["msm"])
                inst, compiled, prover = _keys(123456789, Circuit())
                out["prove_d4"] = _sharded_proof(inst, compiled, prover, mesh, rank == 0)
                mesh2d = parallel.make_mesh((2, 2), ("data", "poly"), device="cpu")
                row = next(m for m in mesh2d.rows if m is not None)
                out["row_ranks"] = row.ranks
                out["prove_d2"] = _sharded_proof(inst, compiled, prover, row, row.d == 0)
                out["rounds_d2"] = _rounds_job(prover, row)
                out["batch_2x2"] = _batch(mesh2d)
        finally:
            dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------


class _Spawn:
    """``world`` ranks of ``_rank_main``, started at once; ``results()``
    waits for them all and raises with the tracebacks of any that failed."""

    def __init__(self, world, tmp, payload):
        ctx = mp.get_context("spawn")
        self.world = world
        self.queue = ctx.Queue()
        init_file = os.path.join(tmp, f"rendezvous-{world}")
        self.procs = [ctx.Process(target=_rank_main, args=(r, world, init_file, payload, self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._out = None

    def results(self):
        if self._out is None:
            out = {}
            try:
                while len(out) < self.world:
                    rank, res = self.queue.get(timeout=RANK_TIMEOUT_S)
                    out[rank] = res
            finally:
                self.stop()
            failed = {r: v for r, v in out.items() if isinstance(v, str)}
            assert not failed, "\n".join(f"rank {r}:\n{v}" for r, v in failed.items())
            self._out = out
        return self._out

    def stop(self):
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)


@pytest.fixture(scope="module")
def inputs():
    return dict(ops=_op_inputs(), msm=_msm_inputs())


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    tmp = str(tmp_path_factory.mktemp("gloo"))
    four = _Spawn(D, tmp, inputs)
    one = _Spawn(1, tmp, inputs)
    yield {D: four, 1: one}
    four.stop()
    one.stop()


@pytest.fixture(scope="module")
def jax_ref(spawned, inputs):
    """The JAX package's results, computed while the ranks run: ``ops``, its
    ``parallel.ops`` under ``jax.shard_map`` on 4 devices on the same
    inputs, in one program; ``batch``, the bytes of its single-device
    proofs of the batch witnesses."""
    return dict(ops=_jax_ops(inputs), batch=_jax_batch_proofs())


def _jax_batch_proofs():
    from zkt_plonk_tpu.commitment import kzg as jkzg
    from zkt_plonk_tpu.cs import LookupTable as JLookupTable
    from zkt_plonk_tpu.cs import lt as jlt
    from zkt_plonk_tpu.plonk import ZKTPlonk as JZKTPlonk
    from zkt_plonk_tpu.utils import arkserde as jarkserde

    inst = JZKTPlonk(curve="bn254", table=JLookupTable([1, 2, 5], size=63))
    ck, cvk = jkzg.setup(inst.ctx, max_degree=4 * 64, tau=BATCH_TAU)
    compiled = inst.compile(Circuit(2, 5, lt=jlt), ck, cvk)
    fq, fr = inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus
    proofs = [inst.prove(compiled, Circuit(*w, lt=jlt), rng=random.Random(seed)) for w, seed, _ in BATCH]
    return [jarkserde.proof_to_bytes(proof, fq, fr) for proof in proofs]


def _jax_ops(inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from zkt_plonk_tpu.fields import BN254_FR as JFR
    from zkt_plonk_tpu.fields import make_spec as jmake_spec
    from zkt_plonk_tpu.parallel import ops as jpops
    from zkt_plonk_tpu.utils.domain import make_domain as jmake_domain

    spec = jmake_spec(JFR)
    A = "poly"
    mesh = Mesh(np.asarray(jax.devices()[:D]), (A,))
    st = jax.tree_util.tree_map(jnp.asarray, jpops.build_shard_ntt_tables(jmake_domain(JFR, N), D))
    inp = {k: jnp.asarray(v.astype(np.uint32)) for k, v in inputs["ops"].items()}

    def body(st, x, xb, inv, bodies, tails, pt, pt_inv):
        q_body, q_tail = jpops.pdivide_by_linear(spec, x, tails[0], pt, pt_inv, A)
        out = {
            "pbitrev": jpops.pbitrev(x, st.rev_d, st.rev_m, A),
            "pfft": jpops.pfft(spec, st, x, A),
            "pifft": jpops.pifft(spec, st, x, A),
            "pcoset_fft": jpops.pcoset_fft(spec, st, xb, A),
            "pcoset_ifft": jpops.pcoset_ifft(spec, st, xb, A),
            "pprefix_products": jpops.pprefix_products(spec, xb, 1, A),
            "pflip": jpops.pflip(x, 0, A),
            "pbatch_inverse": jpops.pbatch_inverse(spec, inv, 0, A),
            "peval_many": jpops.peval_many(spec, bodies, tails, pt, A),
            "pdivide_by_linear.body": q_body,
            "pdivide_by_linear.tail": q_tail,
        }
        for shift in (1, -1, -2, -4):
            out[f"proll{shift:+d}"] = jpops.proll(x, shift, A, axis=0)
        return out

    row, batch = P(A, None), P(None, A, None)
    out_specs = {name: P() if axis is None else batch if name in BATCHED else row
                 for name, axis in OPS}
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, check_vma=False, out_specs=out_specs,
        in_specs=(jpops.shard_ntt_specs(A), row, batch, row, batch, P(), P(), P())))
    got = fn(st, inp["x"], inp["xb"], inp["inv"], inp["bodies"], inp["tails"], inp["pt"], inp["pt_inv"])
    return {k: np.asarray(v).astype(np.int64) for k, v in got.items()}


def _gathered(results, name, axis):
    shards = [results[r]["ops"][name] for r in range(D)]
    if axis is None:
        for s in shards[1:]:
            np.testing.assert_array_equal(s, shards[0])
        return shards[0].astype(np.int64)
    return np.concatenate(shards, axis=axis).astype(np.int64)


@pytest.mark.parametrize("name,axis", OPS, ids=[name for name, _ in OPS])
def test_op_matches_jax_shard_map(spawned, jax_ref, name, axis):
    got = _gathered(spawned[D].results(), name, axis)
    np.testing.assert_array_equal(got, jax_ref["ops"][name])


def test_pbitrev_is_the_global_bit_reversal(spawned, inputs):
    want = inputs["ops"]["x"][[pops._rev(i, N.bit_length() - 1) for i in range(N)]]
    np.testing.assert_array_equal(_gathered(spawned[D].results(), "pbitrev", -2), want)


@pytest.mark.parametrize("name,count", [("pmsm_totals", MSM_N), ("pcommit_totals", N + 4)])
def test_msm_totals_fold_to_the_jax_host_msm(spawned, inputs, name, count):
    """Window totals, replicated on every rank, folded on the host: the
    affine point of sum s_i (k_i G), by the JAX package's host curve."""
    from zkt_plonk_tpu.curves import curve_host as jch
    from zkt_plonk_tpu.curves import make_context as jmake_context
    from zkt_plonk_tpu_torch.curves import make_context
    from zkt_plonk_tpu_torch.ops import msm

    results = spawned[D].results()
    totals = _gathered(results, name, None).astype(np.int32)
    ctx = make_context("bn254")
    got = msm.fold_windows_host(ctx.fq_spec, ctx.Fq, totals, 4)
    jctx = jmake_context("bn254")
    m = inputs["msm"]
    r = jctx.curve.fr.modulus
    k = sum(s * k_ for s, k_ in zip(m["scalars"][:count], m["ks"][:count])) % r
    want = jch.scalar_mul(jctx.g1, k)
    assert got == (None if want is None else (int(want[0]), int(want[1])))


@pytest.mark.parametrize("key", ["prove_d1", "prove_d2", "prove_d4"])
def test_sharded_proof_is_the_jax_single_device_proof(spawned, key):
    """Every rank returns the same proof, byte-equal to the JAX package's
    single-device TinyCircuit proof (verified on a rank)."""
    results = spawned[1 if key == "prove_d1" else D].results()
    for r, out in results.items():
        assert len(out[key]) == 802
        assert hashlib.sha256(out[key]).hexdigest() == GOLDEN, f"rank {r}"


def test_batch_rows_are_subgroups(spawned):
    results = spawned[D].results()
    assert [results[r]["row_ranks"] for r in range(D)] == [(0, 1), (0, 1), (2, 3), (2, 3)]
    assert spawned[1].results()[0]["batch_2x1_transports"] == ["gloo", "gloo"]


@pytest.mark.parametrize("layout", ["batch_2x2", "batch_2x1"])
def test_batch_proofs_are_the_jax_single_device_proofs(spawned, jax_ref, layout):
    """Proofs in input order on every rank, each byte-equal to the JAX
    package's single-device proof of its witness and seed."""
    results = spawned[D if layout == "batch_2x2" else 1].results()
    want = jax_ref["batch"]
    assert [len(b) for b in want] == [802] * len(BATCH)
    for r, out in results.items():
        assert out[layout] == want, f"rank {r}"


@pytest.mark.parametrize("name", ["commit_batch", "z_round", "quotient_round"])
def test_sharded_round_matches_the_single_device_round(spawned, name):
    for r, out in spawned[D].results().items():
        single, sharded = out["rounds_d2"][name]
        np.testing.assert_array_equal(sharded, single, err_msg=f"rank {r}")


def test_launch_counts_are_exact_under_threads():
    """Threads adding launches at once through ``_cuda.count`` lose none."""
    saved = dict(_cuda.launches)
    threads, per = 16, 2000
    names = [_cuda.instance("fp_binop"), _cuda.instance("ntt_col_pass", strict=True)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _cuda.reset_launches()
        start = threading.Barrier(threads)

        def work(i):
            start.wait(timeout=60)
            for _ in range(per):
                _cuda.count(names[i % 2])

        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
        assert _cuda.launches[names[0]] == _cuda.launches[names[1]] == threads * per // 2
    finally:
        sys.setswitchinterval(interval)
        _cuda.launches.update(saved)


def _calls(fn, attr):
    """The calls ``_cuda.<attr>(...)`` inside function ``fn``."""
    return [node for node in ast.walk(fn) if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute) and node.func.attr == attr
            and isinstance(node.func.value, ast.Name) and node.func.value.id == "_cuda"]


def test_every_launch_is_counted_through_the_locked_counter():
    """Each wrapper that binds a kernel's library (``_cuda.lib``) counts its
    launch by one ``_cuda.count`` call, and the package writes
    ``launches[...]`` only inside ``_cuda.count`` and
    ``_cuda.reset_launches``, under their lock: so the exactness under
    threads above holds for the real wrappers."""
    pkg = Path(_cuda.__file__).parent
    wrappers, writes = {}, []
    for path in sorted(pkg.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef) and _calls(fn, "lib"):
                wrappers[f"{path.relative_to(pkg)}:{fn.name}"] = len(_calls(fn, "count"))
        locked = {id(n) for w in ast.walk(tree) if isinstance(w, ast.With)
                  and any(isinstance(i.context_expr, ast.Name) and i.context_expr.id == "_count_lock"
                          for i in w.items)
                  for stmt in w.body for n in ast.walk(stmt)}
        scopes = [f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)]
        for stmt in ast.walk(tree):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target] if isinstance(stmt, ast.AugAssign) else [])
            for t in targets:
                if isinstance(t, ast.Subscript) and (
                        (isinstance(t.value, ast.Name) and t.value.id == "launches")
                        or (isinstance(t.value, ast.Attribute) and t.value.attr == "launches")):
                    fn = next((f.name for f in scopes if stmt in ast.walk(f)), "<module>")
                    writes.append((path.name, fn, id(stmt) in locked))
    assert wrappers == {
        "fields/cuda.py:binop": 1, "fields/cuda.py:pow_chain": 1,
        "ops/ec_cuda.py:add": 1, "ops/msm.py:bucket_accumulate": 1,
        "ops/msm.py:digit_rows": 1, "ops/msm.py:bucket_merge": 1,
        "ops/ntt_mr.py:fused_pass": 1,
    }
    assert sorted(writes) == [("_cuda.py", "count", True), ("_cuda.py", "reset_launches", True)]


def test_init_distributed_without_environment_does_nothing(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert parallel.init_distributed() is False
    assert not dist.is_initialized()


def test_cuda_mesh_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the error without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.init_distributed("nccl", init_method=f"file://{tmp_path}/r", world_size=1, rank=0)
    parallel.init_distributed("gloo", init_method=f"file://{tmp_path}/g", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.make_mesh(device="cuda")
        mesh = parallel.make_mesh(device="cpu")
        assert (mesh.D, mesh.d, mesh.transport) == (1, 0, "gloo")
        x = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
        assert torch.equal(gather_rows(mesh, shard_rows(mesh, x, axis=1), axis=1), x)
        with pytest.raises(ValueError, match="tile"):
            parallel.make_mesh((3, 2), ("data", "poly"), device="cpu")
    finally:
        dist.destroy_process_group()
