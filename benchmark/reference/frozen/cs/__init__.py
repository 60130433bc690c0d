from .variable import LTVariable, ZERO, lt
from .composer import Selectors, SetupComposer, Permutation, K1, K2
from .system import ConstraintSystem, Boolean
