"""NTT / iNTT / coset NTTs over limb tensors — one mixed-radix path.

Same transforms as ``zkt_plonk_tpu/ops/ntt.py`` (ark-poly's radix-2 FFT in
the reference, ``plonk-core/src/util.rs:63-140``), all through
``ops/ntt_mr.transform`` at every size.  Polynomials are ``(..., n, L)``
int32 limb tensors; the polynomial axis is -2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import device as fd
from ..fields.limbs import FieldSpec
from . import ntt_mr


class NttPlan(NamedTuple):
    """Device plans of the four directions for one domain size."""

    fwd: ntt_mr.DevicePlan
    inv: ntt_mr.DevicePlan
    coset_fwd: ntt_mr.DevicePlan
    coset_inv: ntt_mr.DevicePlan


def make_plan(dom, device) -> NttPlan:
    host = ntt_mr.build_plan_set(dom)
    spec = dom.spec
    return NttPlan(
        ntt_mr.DevicePlan(spec, host.fwd, device),
        ntt_mr.DevicePlan(spec, host.inv, device),
        ntt_mr.DevicePlan(spec, host.coset_fwd, device),
        ntt_mr.DevicePlan(spec, host.coset_inv, device),
    )


def fft(spec: FieldSpec, plan: NttPlan, coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations at [1, w, w^2, ...] (natural order)."""
    return ntt_mr.transform(spec, plan.fwd, coeffs)


def ifft(spec: FieldSpec, plan: NttPlan, evals: torch.Tensor) -> torch.Tensor:
    """Evaluations -> coefficients."""
    return ntt_mr.transform(spec, plan.inv, evals)


def coset_fft(spec: FieldSpec, plan: NttPlan, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluations over the coset g*H (arkworks ``coset_fft`` semantics)."""
    return ntt_mr.transform(spec, plan.coset_fwd, coeffs)


def coset_ifft(spec: FieldSpec, plan: NttPlan, evals: torch.Tensor) -> torch.Tensor:
    return ntt_mr.transform(spec, plan.coset_inv, evals)


class Coset4Plan(NamedTuple):
    """Tables for the interleaved 4n-coset transform (``Domain.quarter_plan``)."""

    pow4: torch.Tensor  # (4, n, L) — (g*w4n^j)^i
    ipow4: torch.Tensor  # (4, n, L) — (g*w4n^j)^-i
    gn4: torch.Tensor  # (4, L) — (g*w4n^j)^n (tail-fold scalars)
    mix: torch.Tensor  # (4, 4, L) — M[t][j] = i4^(-jt) * g^(-tn) / 4


def coset4_fft(spec: FieldSpec, plan: NttPlan, q4: Coset4Plan, coeffs: torch.Tensor):
    """Evals of P (up to n+4 coefficients) on the 4n coset, INTERLEAVED.

    Returns (..., 4, n, L) with out[..., j, k, :] = P(g * w4n^j * w_n^k)
    — global 4n-coset index i = 4k + j — as 4 batched n-size NTTs:
    P(g_j w_n^k) = NTT_n(h_j)[k] with h_j[i] = g_j^i * (c_i + g_j^n * c_{i+n}).
    """
    n = q4.pow4.shape[1]
    head = coeffs[..., :n, :]
    ntail = coeffs.shape[-2] - n
    assert 0 <= ntail <= 4, "coset4_fft supports at most n+4 coefficients"
    head4 = head.unsqueeze(-3).expand(*head.shape[:-2], 4, n, head.shape[-1])
    if ntail:
        tail = coeffs[..., n:, :]  # (..., ntail, L)
        t4 = fd.mul(spec, q4.gn4[:, None, :], tail.unsqueeze(-3))
        folded = fd.add(spec, head4[..., :ntail, :], t4)
        head4 = torch.cat([folded, head4[..., ntail:, :]], dim=-2)
    h = fd.mul(spec, head4, q4.pow4)
    return fft(spec, plan, h)


def coset4_ifft(spec: FieldSpec, plan: NttPlan, q4: Coset4Plan, evals: torch.Tensor):
    """Interleaved 4n-coset evals (..., 4, n, L) -> coefficient ROWS
    (..., 4, n, L): row t holds q[t*n : (t+1)*n] of the 4n-coefficient
    polynomial (per-subdomain iNTT + unscale, then a 4-point inverse DFT
    across subdomains)."""
    u = ifft(spec, plan, evals)
    v = fd.mul(spec, u, q4.ipow4)  # (..., 4j, n, L)
    terms = fd.mul(spec, v.unsqueeze(-4), q4.mix[:, :, None, :])  # (..., 4t, 4j, n, L)
    t0, t1, t2, t3 = (terms[..., j, :, :] for j in range(4))
    return fd.add(spec, fd.add(spec, t0, t1), fd.add(spec, t2, t3))
