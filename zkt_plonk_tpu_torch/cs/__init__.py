from .variable import LTVariable, VariableMap, ZERO, lt
from .composer import Selectors, SetupComposer, ProvingComposer, Permutation, K1, K2
from .lookup import LookupTable, combine_split, ElementNotInTable
from .system import ConstraintSystem, Boolean
from .helper import check_gate, test_gate_constraints
