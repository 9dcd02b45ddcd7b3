"""Bit-exact emulation of OpenACM's accuracy-configurable multipliers.

Three families (paper Sec. III-B/C), arbitrary bit width:

  * ``exact``     — AND-array partial products reduced by exact 4-2
                    compressors / FAs / HAs, then a carry-propagate add.
                    Structurally value-conserving, so ``exact(a,b) == a*b``
                    by construction (and verified exhaustively in tests).
  * ``appro42``   — same tree, but approximate 4-2 compressors on the
                    low-order product columns (default: columns 0..n-1
                    for an n-bit multiplier, the paper's "#0..#7" for
                    8-bit).  Compressor cell + column count are tunable.
  * ``mitchell``  — classic logarithmic multiplier [24]: the error part
                    (A-2^k1)(B-2^k2) is dropped.
  * ``log_our``   — the paper's compensated LM: the larger EP operand is
                    dynamically rounded to the nearest power of two and
                    the compensation is merged with the 2^(k1+k2) term by
                    bitwise OR (adder-free, Eq. 3).

All functions are vectorized over numpy integer arrays (the LUT
compiler, offline) and over torch integer tensors on any device, where
the reference takes jax.numpy arrays: `error_model.characterize_batch`
evaluates a whole spec grid as int32 tensors on the card.  The GEMM
kernels' own arithmetic lives beside them in kernels/.

Wiring note: silicon reduction trees chain cin/cout inside a stage; our
scheduler feeds compressors cin=0 and treats cout as an extra carry bit.
Exact cells conserve value either way, and the paper leaves the
"combination strategy" free (Sec. IV), so this is a legal member of the
design family; the approximate-cell truth tables are honored exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .compressors import Compressor, get_compressor


def _xp(a):
    """Array namespace for `a`: torch for a tensor (its `asarray`,
    `where`, `maximum`, ... take numpy's arguments), numpy otherwise."""
    if isinstance(a, torch.Tensor):
        return torch
    return np


# ---------------------------------------------------------------------------
# Compressor-tree multipliers (exact / appro42)
# ---------------------------------------------------------------------------


def _pp_columns(a, b, bits: int) -> Dict[int, list]:
    """AND-gate partial-product matrix, bucketed by column weight."""
    cols: Dict[int, list] = {c: [] for c in range(2 * bits)}
    for i in range(bits):
        ai = (a >> i) & 1
        for j in range(bits):
            bj = (b >> j) & 1
            cols[i + j].append(ai & bj)
    return cols


def _reduce_tree(cols: Dict[int, list], approx_cols: Sequence[int],
                 comp: Compressor, exact_comp: Compressor):
    """Compress every column to <= 2 bits using 4-2 cells / FAs / HAs."""
    approx_set = set(approx_cols)
    ncols = max(cols) + 2
    while max(len(v) for v in cols.values()) > 2:
        nxt: Dict[int, list] = {c: [] for c in range(ncols + 1)}
        for c in sorted(cols):
            bits_c = cols[c]
            i = 0
            # groups of four -> 4-2 compressor (approx on selected columns)
            while len(bits_c) - i >= 4:
                x1, x2, x3, x4 = bits_c[i:i + 4]
                cell = comp if c in approx_set else exact_comp
                s, cy, co = cell(x1, x2, x3, x4)
                nxt[c].append(s)
                nxt[c + 1].append(cy)
                if cell.exact:
                    nxt[c + 1].append(co)
                i += 4
            rem = len(bits_c) - i
            if rem == 3:  # full adder (always exact)
                t = bits_c[i] + bits_c[i + 1] + bits_c[i + 2]
                nxt[c].append(t & 1)
                nxt[c + 1].append(t >> 1)
            elif rem == 2:
                if len(bits_c) > 2:  # half adder keeps the column shrinking
                    t = bits_c[i] + bits_c[i + 1]
                    nxt[c].append(t & 1)
                    nxt[c + 1].append(t >> 1)
                else:
                    nxt[c].extend(bits_c[i:])
            elif rem == 1:
                nxt[c].append(bits_c[i])
        cols = {c: v for c, v in nxt.items() if v}
    return cols


def _final_add(cols: Dict[int, list], dtype):
    """Compose the final <=2 rows and carry-propagate add (plain +)."""
    total = None
    for c, v in cols.items():
        for bit in v:
            term = bit.astype(dtype) << c if hasattr(bit, "astype") else bit << c
            total = term if total is None else total + term
    return total


@dataclasses.dataclass(frozen=True)
class MultiplierSpec:
    """Configuration of one multiplier instance (the 'macro datapath')."""

    family: str = "exact"          # exact | appro42 | mitchell | log_our
    bits: int = 8
    signed: bool = False
    compressor: str = "yang1"      # appro42 only
    n_approx_cols: Optional[int] = None  # appro42 only; default = bits

    @property
    def approx_cols(self) -> List[int]:
        if self.family != "appro42":
            return []
        # paper Sec. III-B / Fig. 2: approximate compressors sit in the
        # lower 8 product columns (#0..#7) regardless of operand width
        n = (min(self.bits, 8) if self.n_approx_cols is None
             else self.n_approx_cols)
        return list(range(n))

    @property
    def out_bits(self) -> int:
        return 2 * self.bits

    def short_name(self) -> str:
        if self.family == "appro42":
            n = self.bits if self.n_approx_cols is None else self.n_approx_cols
            return f"appro42[{self.compressor}/{n}c]{self.bits}b"
        return f"{self.family}{self.bits}b"


def _tree_multiply(a, b, spec: MultiplierSpec):
    xp = _xp(a)
    dtype = a.dtype if hasattr(a, "dtype") else np.int64
    cols = _pp_columns(a, b, spec.bits)
    comp = get_compressor(spec.compressor)
    cols = _reduce_tree(cols, spec.approx_cols, comp, get_compressor("exact"))
    out = _final_add(cols, dtype)
    return xp.asarray(out)


# ---------------------------------------------------------------------------
# Logarithmic multipliers (mitchell / log_our)
# ---------------------------------------------------------------------------


def leading_one_pos(x, bits: int):
    """floor(log2(x)) for x >= 1 (0 for x == 0), vectorized."""
    xp = _xp(x)
    k = xp.zeros_like(x)
    for i in range(1, bits):
        k = xp.where((x >> i) > 0, i, k)
    return k


def _mitchell_parts(a, b, bits):
    xp = _xp(a)
    k1 = leading_one_pos(a, bits)
    k2 = leading_one_pos(b, bits)
    one = xp.ones_like(a)
    q1 = a - (one << k1)
    q2 = b - (one << k2)
    ap = (one << (k1 + k2)) + (q1 << k2) + (q2 << k1)
    return k1, k2, q1, q2, ap, one


def _mitchell(a, b, spec: MultiplierSpec):
    xp = _xp(a)
    *_, ap, _ = _mitchell_parts(a, b, spec.bits)
    return xp.where((a == 0) | (b == 0), xp.zeros_like(a), ap)


def _log_our(a, b, spec: MultiplierSpec):
    """Paper Eq. 3: AP + adder-free dynamic EP compensation."""
    xp = _xp(a)
    bits = spec.bits
    k1, k2, q1, q2, ap_lo, one = _mitchell_parts(a, b, bits)
    q_big = xp.maximum(q1, q2)
    q_small = xp.minimum(q1, q2)
    m = leading_one_pos(q_big, bits)
    # round(q_big) -> 2^m or 2^{m+1}, whichever is nearer (>= 1.5*2^m rounds up)
    round_up = (q_big << 1) >= (one << m) * 3
    shift = m + xp.where(round_up, xp.ones_like(m), xp.zeros_like(m))
    comp = xp.where(q_big > 0, q_small << shift, xp.zeros_like(a))
    # comp < 2^(k1+k2) (proved in paper): merge with the leading term by OR
    lead = (one << (k1 + k2)) | comp
    p = lead + (q1 << k2) + (q2 << k1)
    return xp.where((a == 0) | (b == 0), xp.zeros_like(a), p)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

_FAMILIES = ("exact", "appro42", "mitchell", "log_our")


def multiply_unsigned(a, b, spec: MultiplierSpec):
    """Apply the configured multiplier to unsigned operands in [0, 2^bits)."""
    if spec.family in ("exact", "appro42"):
        return _tree_multiply(a, b, spec)
    if spec.family == "mitchell":
        return _mitchell(a, b, spec)
    if spec.family == "log_our":
        return _log_our(a, b, spec)
    raise ValueError(f"unknown family {spec.family!r}; one of {_FAMILIES}")


def multiply(a, b, spec: MultiplierSpec):
    """Signed (sign-magnitude, the standard approx-multiplier wrapper) or
    unsigned multiply according to `spec`."""
    xp = _xp(a)
    if not spec.signed:
        return multiply_unsigned(a, b, spec)
    sa = a < 0
    sb = b < 0
    mag = multiply_unsigned(xp.abs(a), xp.abs(b), spec)
    return xp.where(sa ^ sb, -mag, mag)


def exact_reference(a, b, spec: MultiplierSpec):
    """Ground-truth product with a dtype wide enough for 2*bits."""
    xp = _xp(a)
    return xp.asarray(a) * xp.asarray(b)
