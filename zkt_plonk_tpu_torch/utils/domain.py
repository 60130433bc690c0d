"""Radix-2 evaluation domains (host metadata + device twiddle tables).

Same domains as ``zkt_plonk_tpu/utils/domain.py`` (arkworks convention:
group generator from ``fields/params.py``, coset offset = the field's
multiplicative generator).  ``plan(device)`` and ``quarter_plan(device)``
build the NTT tables once per (field, size, device) and keep them as
torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List

import numpy as np
import torch

from ..fields.limbs import FieldSpec, ints_to_array, make_spec
from ..fields.params import FieldParams


@dataclass(frozen=True, eq=False)
class Domain:
    spec: FieldSpec
    size: int
    log_size: int
    group_gen: int  # omega, order == size
    group_gen_inv: int
    size_inv: int  # 1/n mod p
    coset_gen: int  # multiplicative generator g for coset FFTs
    coset_gen_inv: int

    @property
    def modulus(self) -> int:
        return self.spec.modulus

    def elements(self) -> List[int]:
        p = self.modulus
        out = [1]
        for _ in range(self.size - 1):
            out.append(out[-1] * self.group_gen % p)
        return out

    # -- device tables -----------------------------------------------------

    def plan(self, device="cuda"):
        """The four mixed-radix NTT plans (``ops/ntt.NttPlan``) on ``device``."""
        dev = torch.device(device)
        key = (self.spec.params.name, self.log_size, str(dev))
        cached = _plan_cache.get(key)
        if cached is None:
            from ..ops import ntt

            cached = ntt.make_plan(self, dev)
            _plan_cache[key] = cached
        return cached

    def quarter_plan(self, device="cuda"):
        """Tables for the INTERLEAVED 4n-coset transform (ops/ntt.coset4_*).

        The 4n coset g*H_4n splits into 4 interleaved n-subdomains
        {g * w4n^j * H_n} (j = 0..3, global index i = 4k + j), so a 4n
        coset FFT = 4 batched n-size NTTs with per-subdomain coset
        scalings (``quotient_poly.rs:52-96`` in the reference).
        """
        dev = torch.device(device)
        key = (self.spec.params.name, self.log_size, "q4", str(dev))
        cached = _plan_cache.get(key)
        if cached is not None:
            return cached
        from ..ops.ntt import Coset4Plan

        p, n = self.modulus, self.size
        w4n = self.spec.params.root_of_unity(self.log_size + 2)
        g = self.coset_gen
        i4 = pow(w4n, n, p)  # primitive 4th root of unity
        gj = [g * pow(w4n, j, p) % p for j in range(4)]
        L = self.spec.n_limbs
        pow4 = np.stack([self.powers_array(x, n) for x in gj])
        ipow4 = np.stack([self.powers_array(pow(x, -1, p), n) for x in gj])
        gn4 = ints_to_array([pow(x, n, p) for x in gj], L)
        inv4 = pow(4, -1, p)
        i4_inv = pow(i4, -1, p)
        g_inv_n = pow(g, -n, p)
        mix_vals = [
            pow(i4_inv, j * t, p) * pow(g_inv_n, t, p) % p * inv4 % p
            for t in range(4)
            for j in range(4)
        ]
        mix = ints_to_array(mix_vals, L).reshape(4, 4, L)
        to_dev = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
        plan = Coset4Plan(pow4=to_dev(pow4), ipow4=to_dev(ipow4), gn4=to_dev(gn4), mix=to_dev(mix))
        _plan_cache[key] = plan
        return plan

    def powers_array(self, base: int, count: int) -> np.ndarray:
        """Limb array of [1, base, base^2, ...] (uint32, host)."""
        p = self.modulus
        vals = [1] * count
        for i in range(1, count):
            vals[i] = vals[i - 1] * base % p
        return ints_to_array(vals, self.spec.n_limbs)


_plan_cache = {}


@lru_cache(maxsize=None)
def make_domain(params: FieldParams, size: int) -> Domain:
    assert size >= 1 and (size & (size - 1)) == 0, "domain size must be a power of two"
    log_size = size.bit_length() - 1
    assert log_size <= params.two_adicity, "field lacks required two-adicity"
    p = params.modulus
    omega = params.root_of_unity(log_size)
    g = params.generator
    return Domain(
        spec=make_spec(params),
        size=size,
        log_size=log_size,
        group_gen=omega,
        group_gen_inv=pow(omega, -1, p) if size > 1 else 1,
        size_inv=pow(size, -1, p),
        coset_gen=g,
        coset_gen_inv=pow(g, -1, p),
    )
