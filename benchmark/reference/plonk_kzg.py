"""The plain reference: a PLONK + Plookup verifier over KZG on plain ints.

It judges the port's proofs and reads nothing the port made but the proof
bytes.  For a configuration and the SRS trapdoor tau (which the benchmark
draws from the seed and hands to both sides) it

* derives the verifier key itself: the withdraw circuit synthesized in
  setup mode by the frozen composer (``frozen/``), its ten selector,
  permutation and table columns evaluated at tau through the Lagrange
  basis of the domain, each commitment p(tau) * G1;
* decodes a proof from its arkworks bytes (compressed points, x with the
  sign and infinity flags; fields little-endian);
* replays the transcript, computes r0 and the linearization commitment,
  and makes the two batched opening checks without a pairing: with tau
  known, e(F + z W, H) == e(W, tau H) is F == (tau - z) W in G1.

Imports: the standard library and ``frozen/`` only.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from .frozen.circuits.withdraw import WithdrawCircuit
from .frozen.cs import K1, K2, ConstraintSystem
from .frozen.hashing.poseidon.constants import PoseidonConstants, bn254_constants

TRANSCRIPT_LABEL = "ZKT Plonk"
MIN_CIRCUIT_SIZE = 8
POLY_ORDER = ["q_m", "q_l", "q_r", "q_o", "q_c", "sigma1", "sigma2", "sigma3", "q_lookup",
              "q_table"]
COMMIT_ORDER = ["a_commit", "b_commit", "c_commit", "t_commit", "h1_commit", "h2_commit",
                "z1_commit", "z2_commit", "q_lo_commit", "q_mid_commit", "q_hi_commit"]
EVAL_ORDER = ["a", "b", "c", "sigma1", "sigma2", "z1_next", "q_lookup", "t", "t_next",
              "z2_next", "h1_next", "h2"]

Point = Optional[Tuple[int, int]]


@dataclass(frozen=True)
class Curve:
    """y^2 = x^3 + b over F_q with a subgroup of order r generated by g1;
    F_r's multiplicative generator and two-adicity give the FFT domains
    (the arkworks convention)."""

    name: str
    q: int
    r: int
    b: int
    g1: Tuple[int, int]
    r_generator: int
    r_two_adicity: int

    def root_of_unity(self, log_n: int) -> int:
        base = pow(self.r_generator, (self.r - 1) >> self.r_two_adicity, self.r)
        return pow(base, 1 << (self.r_two_adicity - log_n), self.r)


CURVES = {
    "bn254": Curve(
        "bn254",
        q=21888242871839275222246405745257275088696311157297823662689037894645226208583,
        r=21888242871839275222246405745257275088548364400416034343698204186575808495617,
        b=3, g1=(1, 2), r_generator=5, r_two_adicity=28,
    ),
    "bls12_381": Curve(
        "bls12_381",
        q=int("4002409555221667393417789825735904156556882819939007885332058136124031650490837"
              "864442687629129015664037894272559787"),
        r=52435875175126190479447740508185965837690552500527637822603658699938581184513,
        b=4,
        g1=(int("36854167537133870167810883151830777579616207957825464098945783786886075923783"
                "76318836054947676345821548104185464507"),
            int("13395065449444764730204713799419212215849338759383496204265437364165114239563"
                "33506472724655353366534992391756441569")),
        r_generator=7, r_two_adicity=32,
    ),
    "bls12_377": Curve(
        "bls12_377",
        q=int("2586644260129690940106527336948935335363935127549146605398842626667204683483408"
              "22774968888139573360124440321458177"),
        r=8444461749428370424248824938781546531375899335154063827935233455917409239041,
        b=1,
        g1=(int("81937999373150964239938255573465948239988671502647976594219695644855304257327"
                "692006745978603320413799295628339695"),
            int("24126674985971547373978887824058568173392719116860189638375912210211290735777"
                "9751001206799952863815012735208165030")),
        r_generator=22, r_two_adicity=47,
    ),
}


class Rejected(Exception):
    """The reference refuses a proof; the message says at which check."""


# -- G1 on plain ints: Jacobian (X, Y, Z), a = 0 ------------------------------

def _jdouble(P, q):
    X, Y, Z = P
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    A = X * X % q
    B = Y * Y % q
    C = B * B % q
    D = 2 * ((X + B) * (X + B) - A - C) % q
    E = 3 * A % q
    X3 = (E * E - 2 * D) % q
    Y3 = (E * (D - X3) - 8 * C) % q
    Z3 = 2 * Y * Z % q
    return (X3, Y3, Z3)


def _jadd_affine(P, x2, y2, q):
    """P (Jacobian) + (x2, y2) (affine, not the identity)."""
    X1, Y1, Z1 = P
    if Z1 == 0:
        return (x2, y2, 1)
    Z1Z1 = Z1 * Z1 % q
    U2 = x2 * Z1Z1 % q
    S2 = y2 * Z1 % q * Z1Z1 % q
    H = (U2 - X1) % q
    R = (S2 - Y1) % q
    if H == 0:
        return _jdouble(P, q) if R == 0 else (1, 1, 0)
    HH = H * H % q
    HHH = H * HH % q
    V = X1 * HH % q
    X3 = (R * R - HHH - 2 * V) % q
    Y3 = (R * (V - X3) - Y1 * HHH) % q
    Z3 = Z1 * H % q
    return (X3, Y3, Z3)


def _to_affine(P, q) -> Point:
    X, Y, Z = P
    if Z == 0:
        return None
    zi = pow(Z, -1, q)
    zi2 = zi * zi % q
    return (X * zi2 % q, Y * zi2 % q * zi % q)


def msm(curve: Curve, points: Sequence[Point], scalars: Sequence[int]) -> Point:
    """sum s_i P_i with one shared doubling chain (Straus, one bit a step)."""
    q, r = curve.q, curve.r
    terms = [(pt, s % r) for pt, s in zip(points, scalars) if pt is not None and s % r]
    if not terms:
        return None
    acc = (1, 1, 0)
    for bit in range(max(s for _, s in terms).bit_length() - 1, -1, -1):
        acc = _jdouble(acc, q)
        for (x, y), s in terms:
            if (s >> bit) & 1:
                acc = _jadd_affine(acc, x, y, q)
    return _to_affine(acc, q)


def on_curve(curve: Curve, pt: Point) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - curve.b) % curve.q == 0


# -- proof bytes ---------------------------------------------------------------

def _nbytes(modulus: int) -> int:
    return (modulus.bit_length() + 7) // 8


def _sqrt(a: int, p: int) -> Optional[int]:
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, x = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, x = i, b * b % p, t * b * b % p, x * b % p
    return x


def _point(curve: Curve, raw: bytes) -> Point:
    """arkworks 0.3 compressed G1: x little-endian, bit 7 of the last byte
    set when y > -y, bit 6 for the identity."""
    data = bytearray(raw)
    flags = data[-1] & 0xC0
    data[-1] &= 0x3F
    x = int.from_bytes(bytes(data), "little")
    if flags & 0x40:
        if x != 0:
            raise Rejected("identity with a non-zero x")
        return None
    if x >= curve.q:
        raise Rejected("non-canonical x")
    y = _sqrt(x * x * x + curve.b, curve.q)
    if y is None:
        raise Rejected("x off the curve")
    if (y > curve.q - y) != bool(flags & 0x80):
        y = (curve.q - y) % curve.q
    return (x, y)


def decode_proof(curve: Curve, data: bytes):
    """(commitments by name, the two openings, evaluations by name)."""
    nq, nr = _nbytes(curve.q), _nbytes(curve.r)
    want = 13 * nq + 2 + 12 * nr
    if len(data) != want:
        raise Rejected(f"proof of {len(data)} bytes, want {want}")
    off = 0
    commits = {}
    for name in COMMIT_ORDER:
        commits[name] = _point(curve, data[off:off + nq])
        off += nq
    openings = []
    for _ in range(2):
        openings.append(_point(curve, data[off:off + nq]))
        off += nq
        if data[off] != 0:
            raise Rejected("hiding opening")
        off += 1
    evals = {}
    for name in EVAL_ORDER:
        v = int.from_bytes(data[off:off + nr], "little")
        if v >= curve.r:
            raise Rejected(f"non-canonical evaluation {name}")
        evals[name] = v
        off += nr
    return commits, openings, evals


# -- the verifier key, from the circuit and tau -----------------------------------

@dataclass
class VerifierKey:
    curve: Curve
    n: int
    pi_pos: List[int]
    omega: int
    scalars: Dict[str, int]  # p(tau) of each preprocessed polynomial
    commitments: Dict[str, Point]  # p(tau) * G1
    transcript: str  # the module ``frozen/transcript/<transcript>.py``
    coord_bytes: int
    tau: int


@lru_cache(maxsize=None)
def poseidon_constants(curve: str, width: int) -> PoseidonConstants:
    """The Poseidon instance of ``curve``'s scalar field as the reference
    ``bin`` builds it: BN254's audited constants (baked, as in its
    ``gadgets/src/poseidon/bn254_x*.rs``), for any other field the
    constants generated for it (Grain LFSR round constants, Cauchy MDS),
    which is what its ``bls12-381`` feature uses."""
    if curve == "bn254":
        return bn254_constants(width)
    r = CURVES[curve].r
    return PoseidonConstants.generate(r, width, r.bit_length())


def setup_columns(config):
    """(n, PI positions, the ten preprocessed columns as evaluations on the
    domain), by the frozen composer, in the port's order (``POLY_ORDER``)."""
    curve = CURVES[config["curve"]]
    r = curve.r
    circuit = WithdrawCircuit.default(
        poseidon_constants(config["curve"], config["poseidon_width"]), config["note_inputs"],
        config["height"])
    cs = ConstraintSystem(r, table_size=config["table_size"])
    circuit.synthesize(cs)
    n = max(cs.circuit_bound(), MIN_CIRCUIT_SIZE)
    comp = cs.setup
    comp.pad_to(n)
    omega = curve.root_of_unity(n.bit_length() - 1)
    roots = [1] * n
    for i in range(1, n):
        roots[i] = roots[i - 1] * omega % r
    sigmas = comp.perm.compute_all_sigma_evals(n, roots, r)
    if n <= config["table_size"]:
        raise Rejected("the table does not fit the domain")
    q_table = [0] * config["table_size"] + [1] * (n - config["table_size"])
    cols = [comp.q_m, comp.q_l, comp.q_r, comp.q_o, comp.q_c, *sigmas, comp.q_lookup, q_table]
    return n, list(comp.pp), omega, roots, cols


def lagrange_at(r: int, n: int, roots: List[int], tau: int) -> List[int]:
    """L_i(tau) = (tau^n - 1) / n * w^i / (tau - w^i) for every i."""
    diffs = [(tau - w) % r for w in roots]
    if 0 in diffs:
        raise Rejected("tau lies in the domain")
    prefix = [1] * (n + 1)
    for i, d in enumerate(diffs):
        prefix[i + 1] = prefix[i] * d % r
    inv = pow(prefix[n], -1, r)
    scale = (pow(tau, n, r) - 1) * pow(n, -1, r) % r
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = inv * prefix[i] % r * roots[i] % r * scale % r
        inv = inv * diffs[i] % r
    return out


def transcript_module(name: str):
    """``frozen/transcript/<name>.py``, whose ``make(label, coord_bytes)``
    opens the transcript of that name."""
    return importlib.import_module(f"{__package__}.frozen.transcript.{name}")


def verifier_key(config, tau: int) -> VerifierKey:
    if config["scheme"] != "kzg":
        raise ValueError("the reference verifies KZG proofs only")
    transcript_module(config["transcript"])
    curve = CURVES[config["curve"]]
    r = curve.r
    n, pi_pos, omega, roots, cols = setup_columns(config)
    weights = lagrange_at(r, n, roots, tau)
    scalars = {}
    for name, col in zip(POLY_ORDER, cols):
        acc = 0
        for v, w in zip(col, weights):
            if v:
                acc += (v % r) * w if v != 1 else w
        scalars[name] = acc % r
    commitments = {name: msm(curve, [curve.g1], [s]) for name, s in scalars.items()}
    return VerifierKey(curve=curve, n=n, pi_pos=pi_pos, omega=omega, scalars=scalars,
                       commitments=commitments, transcript=config["transcript"],
                       coord_bytes=config["coord_bytes"], tau=tau)


# -- verification ------------------------------------------------------------

def transcript(vk: VerifierKey):
    t = transcript_module(vk.transcript).make(TRANSCRIPT_LABEL, vk.coord_bytes)
    t.append_u64("circuit_size", vk.n)
    for name in POLY_ORDER:
        t.append_commitment(f"{name}_commit", vk.commitments[name])
    return t


def verify(vk: VerifierKey, data: bytes, public_inputs: Sequence[int]) -> None:
    """Raises ``Rejected`` unless ``data`` proves the statement whose public
    inputs are ``public_inputs``."""
    curve = vk.curve
    r = curve.r
    C, (aw, saw), ev = decode_proof(curve, data)
    for name, pt in [*C.items(), ("aw", aw), ("saw", saw)]:
        if not on_curve(curve, pt):
            raise Rejected(f"{name} off the curve")
    if len(public_inputs) != len(vk.pi_pos):
        raise Rejected("wrong number of public inputs")
    pis = [v % r for v in public_inputs]

    t = transcript(vk)
    t.append_scalars("pi", pis)
    for name in COMMIT_ORDER[:6]:
        t.append_commitment(name, C[name])
    beta = t.challenge_scalar("beta")
    gamma = t.challenge_scalar("gamma")
    delta = t.challenge_scalar("delta")
    epsilon = t.challenge_scalar("epsilon")
    if len({beta, gamma, delta, epsilon}) != 4:
        raise Rejected("challenges not distinct")
    t.append_commitment("z1_commit", C["z1_commit"])
    t.append_commitment("z2_commit", C["z2_commit"])
    alpha = t.challenge_scalar("alpha")
    for name in ("q_lo_commit", "q_mid_commit", "q_hi_commit"):
        t.append_commitment(name, C[name])
    xi = t.challenge_scalar("xi")

    n = vk.n
    zh = (pow(xi, n, r) - 1) % r
    l1 = zh * pow(n * (xi - 1) % r, -1, r) % r
    a2 = alpha * alpha % r
    a3 = a2 * alpha % r
    a4 = a3 * alpha % r
    eps_1pd = epsilon * (1 + delta) % r

    # r0: the PI term and the constant parts of the permutation and lookup
    pi_term = 0
    for v, pos in zip(pis, vk.pi_pos):
        w = pow(vk.omega, pos, r)
        pi_term += zh * w % r * pow(n * (xi - w) % r, -1, r) % r * v
    r0 = (-pi_term
          + alpha * ev["z1_next"] % r * ((ev["a"] + beta * ev["sigma1"] + gamma) % r)
          * ((ev["b"] + beta * ev["sigma2"] + gamma) % r) * ((ev["c"] + gamma) % r)
          + l1 * a2
          + a3 * ev["z2_next"] % r * ((eps_1pd + delta * ev["h2"]) % r)
          * ((eps_1pd + ev["h2"] + delta * ev["h1_next"]) % r)
          + l1 * a2 % r * a2) % r

    # the linearization commitment: preprocessed parts as scalars on G1
    beta_xi = beta * xi % r
    xi_n2 = (zh + 1) * xi % r * xi % r
    g_coeff = (ev["a"] * ev["b"] % r * vk.scalars["q_m"] + ev["a"] * vk.scalars["q_l"]
               + ev["b"] * vk.scalars["q_r"] + ev["c"] * vk.scalars["q_o"] + vk.scalars["q_c"]
               - alpha * beta % r * ev["z1_next"] % r
               * ((beta * ev["sigma1"] + ev["a"] + gamma) % r)
               * ((beta * ev["sigma2"] + ev["b"] + gamma) % r) % r * vk.scalars["sigma3"]
               + a4 * alpha % r * ev["t"] % r * vk.scalars["q_table"]) % r
    lin = [
        (C["z1_commit"], alpha * ((beta_xi + ev["a"] + gamma) % r)
         * ((beta_xi * K1 + ev["b"] + gamma) % r) * ((beta_xi * K2 + ev["c"] + gamma) % r)
         + l1 * a2),
        (C["z2_commit"], a3 * (1 + delta) % r * ((epsilon + ev["q_lookup"] * ev["c"]) % r)
         * ((eps_1pd + ev["t"] + delta * ev["t_next"]) % r) + a4 * l1),
        (C["h1_commit"], -a3 * ev["z2_next"] * ((eps_1pd + ev["h2"] + delta * ev["h1_next"]) % r)),
        (C["q_lo_commit"], -zh),
        (C["q_mid_commit"], -zh * xi_n2),
        (C["q_hi_commit"], -zh * xi_n2 % r * xi_n2),
    ]

    for name in EVAL_ORDER:
        t.append_scalar(f"{name}_eval", ev[name])
    eta = t.challenge_scalar("eta")

    # check 1 at xi: [r_commit, a, b, c, sigma1, sigma2, q_lookup, t, h2]
    # against [r0, the evaluations]; r_commit = lin + g_coeff * G1
    def powers(k):
        out = [1]
        for _ in range(k - 1):
            out.append(out[-1] * eta % r)
        return out

    e1 = powers(9)
    vals1 = [r0, ev["a"], ev["b"], ev["c"], ev["sigma1"], ev["sigma2"], ev["q_lookup"], ev["t"],
             ev["h2"]]
    v1 = sum(e * v for e, v in zip(e1, vals1)) % r
    g1_scalar = (g_coeff + e1[4] * vk.scalars["sigma1"] + e1[5] * vk.scalars["sigma2"]
                 + e1[6] * vk.scalars["q_lookup"] - v1) % r
    pts = [pt for pt, _ in lin] + [C["a_commit"], C["b_commit"], C["c_commit"], C["t_commit"],
                                   C["h2_commit"], curve.g1, aw]
    scs = [s for _, s in lin] + [e1[1], e1[2], e1[3], e1[7], e1[8], g1_scalar,
                                 -(vk.tau - xi)]
    if msm(curve, pts, scs) is not None:
        raise Rejected("opening check at xi")

    # check 2 at omega * xi: [z1, z2, t, h1] against the shifted evaluations
    wxi = xi * vk.omega % r
    e2 = powers(4)
    vals2 = [ev["z1_next"], ev["z2_next"], ev["t_next"], ev["h1_next"]]
    v2 = sum(e * v for e, v in zip(e2, vals2)) % r
    pts = [C["z1_commit"], C["z2_commit"], C["t_commit"], C["h1_commit"], curve.g1, saw]
    scs = e2 + [-v2, -(vk.tau - wxi)]
    if msm(curve, pts, scs) is not None:
        raise Rejected("opening check at omega * xi")
