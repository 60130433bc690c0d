"""Plookup lookup table and multiset operations.

Rebuild of ``plonk-core/src/lookup/{table.rs, multiset.rs}``: an
insertion-ordered deduplicated table and the Plonkup ``combine_split``
(bucket-counting "sorted concatenation" split into even/odd halves,
``multiset.rs:103-146``).  Host-side: these are data-dependent and tiny
compared to the polynomial work.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


class ElementNotInTable(Exception):
    pass


class LookupTable:
    """Insertion-ordered set of field elements (ints), bounded by ``size``."""

    def __init__(self, elements: Iterable[int] = (), size: int = 0):
        self.size = size
        self._elems: Dict[int, None] = {}
        for e in elements:
            self._elems.setdefault(int(e), None)

    def __len__(self):
        return len(self._elems)

    def elements(self) -> List[int]:
        return list(self._elems.keys())

    def contains(self, v: int) -> bool:
        return v in self._elems

    def masks(self, n: int) -> List[int]:
        """q_table evals: 0^SIZE then 1^(n-SIZE) (``table.rs:42-48``)."""
        assert n > self.size, "max table size is equal or larger than n"
        return [0] * self.size + [1] * (n - self.size)

    def into_multiset(self, n: int) -> List[int]:
        """Pad the table with zeros to length n (``table.rs:52-61``)."""
        assert n > self.size, "max table size is equal or larger than n"
        t = self.elements()
        assert len(t) <= self.size, "table size exceeds max size"
        return t + [0] * (n - len(t))


def combine_split(t: List[int], f: List[int]) -> Tuple[List[int], List[int]]:
    """Plonkup combine+split without sorting (``multiset.rs:103-146``).

    Buckets are keyed in first-occurrence order of t; every element of f
    must appear in t.  The concatenated buckets are split into even/odd
    halves h1/h2.
    """
    counters: Dict[int, int] = {}
    for e in t:
        counters[e] = counters.get(e, 0) + 1
    for e in f:
        if e not in counters:
            raise ElementNotInTable(f"lookup query {e} not in table")
        counters[e] += 1

    evens: List[int] = []
    odds: List[int] = []
    parity = False
    for elem, count in counters.items():
        half = count // 2
        evens.extend([elem] * half)
        odds.extend([elem] * half)
        if count % 2 == 1:
            if parity:
                odds.append(elem)
                parity = False
            else:
                evens.append(elem)
                parity = True
    return evens, odds
