"""Vectorized device Poseidon: B hashes in parallel on limb tensors.

The batched hasher for bulk work (Merkle tree levels, note commitments,
nullifier batches), as ``zkt_plonk_tpu/hashing/poseidon/device.py``: the
same round schedule as ``spec.py`` (``plonk-hashing/src/hasher/poseidon/
spec.rs:267-310``) over ``(..., L)`` int32 limb tensors with the
``fields.device`` ops, so on the card every add and multiply of a round
is one launch of kernel K1 (``fields/cuda.py``); on the CPU the same calls
run K1's plain version.

Bit-identical to the host schedule (the plain one: full round =
x -> (x + rc)^5, partial round adds all rcs then sboxes row 0, MDS product
every round; output = state row 1).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ... import _cuda
from ...fields import device as fd
from ...fields.limbs import FieldSpec, ints_to_array, make_spec
from .constants import PoseidonConstants


def device_tables(spec: FieldSpec, constants: PoseidonConstants, device="cuda") -> Dict:
    """Constant tables as tensors on ``device``.

    rc: (R, W, L) per-round constants; mds: (W*W, L) row-major matrix;
    tag: (L,) domain tag.
    """
    dev = _cuda.require_cuda(device)
    w = constants.width
    rcs = list(constants.round_constants)
    R = len(rcs) // w
    rc = ints_to_array(rcs, spec.n_limbs).reshape(R, w, spec.n_limbs)
    mds_flat = [constants.mds[i][j] for i in range(w) for j in range(w)]

    def t(arr):
        return torch.from_numpy(arr.astype(np.int32)).to(dev)

    return {
        "rc": t(rc),
        "mds": t(ints_to_array(mds_flat, spec.n_limbs)),
        "tag": t(ints_to_array([constants.domain_tag], spec.n_limbs)[0]),
    }


def _sbox5(spec, x):
    sq = fd.mul(spec, x, x)
    quad = fd.mul(spec, sq, sq)
    return fd.mul(spec, quad, x)


def _mds_apply(spec, state, mds):
    """state (W, B, L) x mds (W*W, L) -> (W, B, L): out_j = sum_i s_i m_ij.

    One stacked multiply of all W*W products, then a log-depth add tree
    over i (``spec.rs:73-88``)."""
    W = state.shape[0]
    lhs = torch.repeat_interleave(state, W, dim=0)  # rows (i, j) = s_i
    prods = fd.mul(spec, lhs, mds[:, None, :])  # (W*W, B, L)
    acc = prods.reshape(W, W, *state.shape[1:])  # [i, j]
    k = W
    while k > 1:
        half = (k + 1) // 2
        lo = acc[:half]
        hi = acc[half:k]
        if hi.shape[0] < half:
            hi = torch.cat([hi, torch.zeros_like(acc[: half - hi.shape[0]])], dim=0)
        acc = fd.add(spec, lo, hi)
        k = half
    return acc[0]  # (W, B, L) indexed by j


def permute_batch(
    spec: FieldSpec, rc: torch.Tensor, mds: torch.Tensor, state: torch.Tensor,
    half_full: int, partial: int,
) -> torch.Tensor:
    """Run the full Poseidon permutation on a batch: state (W, B, L)."""

    def full_round(r, st):
        st = fd.add(spec, st, rc[r][:, None, :])
        st = _sbox5(spec, st)
        return _mds_apply(spec, st, mds)

    def partial_round(r, st):
        st = fd.add(spec, st, rc[r][:, None, :])
        row0 = _sbox5(spec, st[0])
        st = torch.cat([row0[None], st[1:]], dim=0)
        return _mds_apply(spec, st, mds)

    st = state
    for r in range(half_full):
        st = full_round(r, st)
    for r in range(half_full, half_full + partial):
        st = partial_round(r, st)
    for r in range(half_full + partial, 2 * half_full + partial):
        st = full_round(r, st)
    return st


def hash_batch_device(
    constants: PoseidonConstants, rows: Sequence[Sequence[int]], params=None, device="cuda"
) -> List[int]:
    """Hash B input rows (each up to arity ints, zero-padded) on ``device``.

    Batched equivalent of ``Poseidon.hash_many_native``; output is the
    permuted state's row 1 (``spec.rs:309``).
    """
    from ...fields import BN254_FR

    dev = _cuda.require_cuda(device)
    spec = make_spec(params if params is not None else BN254_FR)
    t = device_tables(spec, constants, dev)
    out = permute_batch(
        spec, t["rc"], t["mds"], initial_state(spec, constants, rows, dev),
        constants.full_rounds // 2, constants.partial_rounds,
    )
    return spec.decode(out[1].cpu().numpy())


def initial_state(
    spec: FieldSpec, constants: PoseidonConstants, rows: Sequence[Sequence[int]], device
) -> torch.Tensor:
    """The sponge's (W, B, L) start state on ``device``: row 0 the domain
    tag, rows 1.. the inputs, each input row zero-padded to the arity."""
    arity = constants.width - 1
    padded = [list(r) + [0] * (arity - len(r)) for r in rows]
    state = np.stack(
        [np.tile(ints_to_array([constants.domain_tag], spec.n_limbs), (len(rows), 1))]
        + [ints_to_array([r[i] for r in padded], spec.n_limbs) for i in range(arity)]
    )
    return torch.from_numpy(state.astype(np.int32)).to(device)
