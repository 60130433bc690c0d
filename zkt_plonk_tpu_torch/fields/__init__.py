from .params import BN254, BLS12_381, BN254_FQ, BN254_FR, BLS12_381_FQ, BLS12_381_FR, BLS12_377_FR
from .host import make_field, FpElement, batch_inverse_ints, powers_of
from .limbs import FieldSpec, make_spec, int_to_limbs, limbs_to_int, ints_to_array, array_to_ints
