from .constants import PoseidonConstants, bn254_constants
from .spec import Poseidon
