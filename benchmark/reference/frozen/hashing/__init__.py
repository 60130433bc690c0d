from .poseidon.constants import PoseidonConstants, bn254_constants
from .poseidon.spec import Poseidon
