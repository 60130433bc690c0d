"""Gate-check harness — the workhorse circuit test fixture.

Rebuild of ``plonk-core/src/constraint_system/helper.rs:13-113``: run the
same synthesis closure through a Setup composer and a Proving composer,
check expected witness values, then re-evaluate every gate equation and
lookup membership on the host.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

from .lookup import LookupTable
from .system import ConstraintSystem
from .variable import LTVariable


def check_gate(
    setup,
    proving,
    pub_inputs: List[int],
    table: LookupTable,
    p: int,
):
    assert setup.n == proving.n, "circuit size in setup not equals to proving"
    assert len(setup.pp) == len(pub_inputs), "arity of public inputs in setup is not correct"
    assert len(proving.pi) == len(pub_inputs), "arity of public inputs in proving is not correct"
    for i, (x, y) in enumerate(zip(proving.pi_values(), pub_inputs)):
        assert x == y % p, f"public input value at {i} is not correct"

    pi_evals = proving.pi_as_evals(proving.n)
    pp = set(setup.pp)
    vm = proving.var_map
    for i in range(setup.n):
        a = vm.value_of(proving.w_l[i])
        b = vm.value_of(proving.w_r[i])
        c = vm.value_of(proving.w_o[i])
        pi = pi_evals[i]
        if i not in pp and pi != 0:
            raise AssertionError(_gate_err(setup, i, "public input"))
        arith = (
            setup.q_m[i] * a * b
            + setup.q_l[i] * a
            + setup.q_r[i] * b
            + setup.q_o[i] * c
            + pi
            + setup.q_c[i]
        ) % p
        if arith != 0:
            raise AssertionError(_gate_err(setup, i, "arithmetic gate"))
        query = setup.q_lookup[i] * c % p
        if query != 0 and not table.contains(query):
            raise AssertionError(_gate_err(setup, i, "lookup gate"))


def _gate_err(setup, i: int, kind: str) -> str:
    msg = f"{kind} at {i} is not satisfied"
    if getattr(setup, "trace", None) is not None:
        msg += "\n" + setup.trace.explain(i)
    return msg


def test_gate_constraints(
    p: int,
    process: Callable[[ConstraintSystem], Iterable[Tuple[LTVariable, int]]],
    pub_inputs: List[int],
    table: LookupTable,
):
    """Dual-mode run + witness expectation + full gate re-evaluation."""
    cs_setup = ConstraintSystem(p, setup=True, lookup_table=table)
    cs_prove = ConstraintSystem(p, setup=False, lookup_table=table)

    process(cs_setup)
    expected = process(cs_prove)
    for lt_var, expect in expected:
        actual = cs_prove.proving.var_map.value_of_lt(lt_var)
        assert actual == expect % p, f"value of variable {lt_var} is incorrect"

    check_gate(cs_setup.setup, cs_prove.proving, pub_inputs, table, p)
