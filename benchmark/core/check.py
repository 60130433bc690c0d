"""What decides ``correct``: every proof of the window judged by the plain
reference (``reference/plonk_kzg``), after the window has closed.

Each number compared has its limit; all are exact (limit 0):

* ``refused``: window proofs that the reference does not accept for the
  public inputs of the request they answer (the reference derives the
  verifier key itself from the configuration and tau);
* ``repeated``: window proofs whose bytes equal an earlier answer's of the
  run (every proof draws fresh blinders, so equal bytes are a stale or
  cached answer, or blinders that are not fresh: the warm-up proves the
  pool's first requests and the window proves them again);
* ``failed``: window requests that raised and returned no proof.

A window with no proof is not correct.
"""

from __future__ import annotations

from typing import Dict, Iterable

from ..reference import plonk_kzg

LIMITS = {"refused": 0, "repeated": 0, "failed": 0}


def judge(config: dict, deployment, window, earlier: Iterable[bytes] = ()):
    """(checks, the reference's reasons for what it refused); ``earlier``
    are the run's answers before the window."""
    vk = plonk_kzg.verifier_key(config, deployment.tau)
    pool = len(deployment.requests)
    seen = set(earlier)
    refused = repeated = 0
    reasons = []
    for rec in window.completed():
        req = deployment.requests[rec.k % pool]
        try:
            plonk_kzg.verify(vk, rec.answer, req.public_inputs)
        except plonk_kzg.Rejected as exc:
            refused += 1
            reasons.append(str(exc))
        if rec.answer in seen:
            repeated += 1
        seen.add(rec.answer)
    values = {"refused": refused, "repeated": repeated,
              "failed": len(window.records) - len(window.completed())}
    checks = {name: {"value": v, "limit": LIMITS[name]} for name, v in values.items()}
    return checks, sorted(set(reasons))


def correct(checks: Dict[str, dict], proofs: int) -> bool:
    return proofs > 0 and all(c["value"] <= c["limit"] for c in checks.values())
