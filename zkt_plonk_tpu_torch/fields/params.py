"""Prime-field and curve parameters.

Parameters mirror the curves supported by the reference stack
(``plonk-core`` supports Bn254, Bls12-377, Bls12-381 via
arkworks; see ``plonk-core/src/plonk.rs:220-254`` test matrix).  All values
here are standard public constants.

The FFT data (two-adicity, multiplicative generator) follows the arkworks
convention: ``root_of_unity = generator ** ((r - 1) >> two_adicity) mod r`` so
that polynomial coefficient representations match the reference bit-exactly.
"""

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional, Tuple


@dataclass(frozen=True)
class FieldParams:
    name: str
    modulus: int
    # Multiplicative generator of the full group (arkworks GENERATOR).
    generator: int
    # nu with modulus - 1 = 2^two_adicity * odd.
    two_adicity: int

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def bytes_len(self) -> int:
        return (self.bits + 7) // 8

    def root_of_unity(self, log_n: int) -> int:
        """2^log_n-th root of unity, arkworks-compatible."""
        assert log_n <= self.two_adicity
        base = pow(self.generator, (self.modulus - 1) >> self.two_adicity, self.modulus)
        return pow(base, 1 << (self.two_adicity - log_n), self.modulus)


@dataclass(frozen=True)
class CurveParams:
    """Short Weierstrass curve y^2 = x^3 + b over fq, group order fr."""

    name: str
    fq: FieldParams
    fr: FieldParams
    b: int
    g1: Tuple[int, int]
    # G2 over Fq2 = Fq[u]/(u^2 + nonresidue): coordinates as (c0, c1) pairs.
    fq2_nonresidue: int  # u^2 = -nonresidue ... i.e. u^2 + nonresidue = 0
    b2: Tuple[int, int]
    g2: Tuple[Tuple[int, int], Tuple[int, int]]
    # Sextic twist / pairing data (filled for curves with pairing support).
    ate_loop_count: Optional[int] = None
    ate_is_negative: bool = False
    curve_family: str = "bn"  # "bn" | "bls"
    # "D": E' y^2 = x^3 + b/xi (bn254); "M": E' y^2 = x^3 + b*xi (bls12-381).
    # Determines the untwist map and therefore the sparse line embedding.
    twist_type: str = "D"
    # G1 cofactor #E(Fq)/r — 1 for BN curves; hash-to-curve points must be
    # multiplied by it to land in the prime-order subgroup.
    g1_cofactor: int = 1


# --------------------------------------------------------------------------
# BN254 (a.k.a. alt_bn128) — the default curve of the reference CLI
# (`bin/src/instance.rs:7-15`, feature `bn254`).
# --------------------------------------------------------------------------

BN254_FQ = FieldParams(
    name="bn254_fq",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,
    two_adicity=1,
)

BN254_FR = FieldParams(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
    two_adicity=28,
)

BN254 = CurveParams(
    name="bn254",
    fq=BN254_FQ,
    fr=BN254_FR,
    b=3,
    g1=(1, 2),
    fq2_nonresidue=1,  # u^2 = -1
    # b2 = 3 / (9 + u)
    b2=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    g2=(
        (
            10857046999023057135944570762232829481370756359578518086990519993285655852781,
            11559732032986387107991004021392285783925812861821192530917403151452391805634,
        ),
        (
            8495653923123431417604973247489272438418190587263600148770280649306958101930,
            4082367875863433681332203403145435568316851327593401208105741076214120093531,
        ),
    ),
    # 6t + 2 with t = 4965661367192848881
    ate_loop_count=29793968203157093288,
    ate_is_negative=False,
    curve_family="bn",
)

# --------------------------------------------------------------------------
# BLS12-381
# --------------------------------------------------------------------------

BLS12_381_FQ = FieldParams(
    name="bls12_381_fq",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    generator=2,
    two_adicity=1,
)

BLS12_381_FR = FieldParams(
    name="bls12_381_fr",
    modulus=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,
    two_adicity=32,
)

BLS12_381 = CurveParams(
    name="bls12_381",
    g1_cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
    fq=BLS12_381_FQ,
    fr=BLS12_381_FR,
    b=4,
    g1=(
        3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    ),
    fq2_nonresidue=1,  # u^2 = -1
    b2=(4, 4),  # 4 * (1 + u)
    g2=(
        (
            352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
            3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
        ),
        (
            1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
            927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
        ),
    ),
    # |x| with x = -0xd201000000010000
    ate_loop_count=0xD201000000010000,
    ate_is_negative=True,
    curve_family="bls",
    twist_type="M",  # b2 = 4*(1+u) = b*xi
)

# --------------------------------------------------------------------------
# BLS12-377 — third curve of the reference test matrix
# (``plonk-core/src/plonk.rs:220-254`` stamps tests over Bn254 /
# Bls12-377 / Bls12-381).  Tower: Fq2 = Fq[u]/(u^2 + 5),
# Fq6 = Fq2[v]/(v^3 - u) — note xi = u, unlike the other two curves.
# --------------------------------------------------------------------------

BLS12_377_FQ = FieldParams(
    name="bls12_377_fq",
    modulus=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    generator=15,
    two_adicity=46,
)

BLS12_377_FR = FieldParams(
    name="bls12_377_fr",
    modulus=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    generator=22,
    two_adicity=47,
)

BLS12_377 = CurveParams(
    name="bls12_377",
    g1_cofactor=0x170B5D44300000000000000000000000,
    fq=BLS12_377_FQ,
    fr=BLS12_377_FR,
    b=1,
    g1=(
        81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
        241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
    ),
    fq2_nonresidue=5,  # u^2 = -5
    # D-type twist: b2 = b/xi = 1/u = (0, -(1/5) mod q)
    b2=(
        0,
        155198655607781456406391640216936120121836107652948796323930557600032281009004493664981332883744016074664192874906,
    ),
    g2=(
        (
            233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
            140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118,
        ),
        (
            63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
            149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491,
        ),
    ),
    # BLS parameter x = 0x8508c00000000001 (positive)
    ate_loop_count=0x8508C00000000001,
    ate_is_negative=False,
    curve_family="bls",
    twist_type="D",
)

CURVES = {"bn254": BN254, "bls12_381": BLS12_381, "bls12_377": BLS12_377}
FIELDS = {
    p.name: p
    for p in (
        BN254_FQ,
        BN254_FR,
        BLS12_381_FQ,
        BLS12_381_FR,
        BLS12_377_FQ,
        BLS12_377_FR,
    )
}


@lru_cache(maxsize=None)
def get_curve(name: str) -> CurveParams:
    return CURVES[name]


@lru_cache(maxsize=None)
def get_field(name: str) -> FieldParams:
    return FIELDS[name]
