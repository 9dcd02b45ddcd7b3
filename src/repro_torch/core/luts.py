"""LUT compilation: the TPU-native 'macro generation' step.

An n-bit multiplier's full semantics are a 2^n x 2^n product table.  For
n <= `MAX_LUT_BITS` we materialize it once (offline, numpy) and the
bit-exact GEMM paths (the plain torch gather and the CUDA kernel) just
gather from it — the moral equivalent of OpenACM emitting a macro
netlist.  Numpy copy of the JAX package's module; byte-equal tables are
a tested contract.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from .multipliers import MultiplierSpec, multiply_unsigned

MAX_LUT_BITS = 10  # 2^20 entries of int32 = 4 MiB; plenty for CiM widths


def _spec_key(spec: MultiplierSpec) -> Tuple:
    return (spec.family, spec.bits, spec.compressor, spec.n_approx_cols)


@functools.lru_cache(maxsize=64)
def _build_lut_cached(key: Tuple) -> np.ndarray:
    family, bits, compressor, n_approx = key
    spec = MultiplierSpec(family=family, bits=bits, signed=False,
                          compressor=compressor, n_approx_cols=n_approx)
    n = 1 << bits
    a, b = np.meshgrid(np.arange(n, dtype=np.int64),
                       np.arange(n, dtype=np.int64), indexing="ij")
    p = multiply_unsigned(a.ravel(), b.ravel(), spec).reshape(n, n)
    assert p.min() >= 0 and p.max() < np.iinfo(np.int32).max
    return p.astype(np.int32)


def build_lut(spec: MultiplierSpec) -> np.ndarray:
    """(2^bits, 2^bits) int32 unsigned-product table for `spec`."""
    if spec.bits > MAX_LUT_BITS:
        raise ValueError(
            f"LUT materialization capped at {MAX_LUT_BITS} bits "
            f"(got {spec.bits}); use the arithmetic or surrogate path")
    return _build_lut_cached(_spec_key(spec))


def signed_product_lut(spec: MultiplierSpec) -> np.ndarray:
    """Signed product table indexed by two's-complement-offset operands.

    Index (a + 2^{bits-1}, b + 2^{bits-1}) for a, b in
    [-2^{bits-1}, 2^{bits-1}).  Sign-magnitude semantics (paper's signed
    wrapper); |-2^{bits-1}| saturates to 2^{bits-1}-1.
    """
    u = build_lut(spec)  # magnitudes up to 2^{bits-1}-1 used only
    half = 1 << (spec.bits - 1)
    vals = np.arange(-half, half, dtype=np.int64)
    mags = np.minimum(np.abs(vals), half - 1)
    signs = np.sign(vals)
    p = u[np.ix_(mags, mags)].astype(np.int64)
    out = p * np.outer(signs, signs)
    # Padding-correctness invariant (kernels/approx_matmul.py): the
    # Pallas GEMMs zero-pad ragged tiles, so every padded lane gathers
    # the (0, b) / (a, 0) entries — those MUST be 0 for any family.  An
    # approximate compressor tree does not guarantee 0*0 == 0 on its
    # own; here the sign-magnitude wrapper enforces it (sign(0) == 0
    # annihilates the row/column), and this check keeps any future
    # signedness refactor honest instead of silently corrupting ragged
    # shapes.
    assert_zero_annihilation(out, half, spec.short_name())
    return out.astype(np.int32)


def assert_zero_annihilation(signed_lut: np.ndarray, zero_index: int,
                             name: str) -> None:
    """Raise unless the signed table maps (0, b) and (a, 0) to 0 — the
    precondition for the Pallas kernels' zero-padding of ragged tiles."""
    if (signed_lut[zero_index, :] != 0).any() \
            or (signed_lut[:, zero_index] != 0).any():
        raise AssertionError(
            f"LUT for {name} does not annihilate zero "
            "operands; the Pallas kernels' zero-padding would corrupt "
            "ragged shapes (mask padded lanes instead)")


# ---------------------------------------------------------------------------
# Nibble (half-width) sub-LUT decomposition
# ---------------------------------------------------------------------------
#
# A full b-bit product LUT has 2^{2b} entries (256 KiB of int32 at
# 8-bit) and its gather kernel materializes a (bm, bk, bn) int32 index
# tensor into it.  Splitting each magnitude into high/low half-words,
#     |a| = ah << h | al,   |b| = bh << h | bl,       h = bits // 2,
# an *exact* multiplier factorizes as
#     |a|*|b| = S_hh[ah,bh] + S_hl[ah,bl] + S_lh[al,bh] + S_ll[al,bl]
# with S_xy the family's own product of half-word-scaled operands
# (S_hh[u,v] = U(u<<h, v<<h), etc.), i.e. four 2^h x 2^h sub-LUTs — 4 KiB
# total at 8-bit instead of 256 KiB.  For approximate families the
# factorization holds only when every approximated column's partial
# products come from a single sub-product (e.g. appro42 with its
# approximated columns confined to one half-word); rather than encode
# that condition analytically we VERIFY it bit-for-bit over the whole
# magnitude grid at build time and return None when it fails, so the
# dispatcher (core/approx_gemm.py) can fall back to the full-LUT
# k-sliced gather.  This mirrors how multi-precision DCiM compilers
# reuse narrow subcircuits to build wide multipliers (SEGA-DCIM /
# SynDCIM, PAPERS.md).


@functools.lru_cache(maxsize=64)
def _nibble_sub_luts_cached(key: Tuple):
    family, bits, compressor, n_approx = key
    if bits < 2 or bits % 2 or bits > MAX_LUT_BITS:
        return None
    spec = MultiplierSpec(family=family, bits=bits, signed=False,
                          compressor=compressor, n_approx_cols=n_approx)
    h = bits // 2
    hb = 1 << h
    u, v = np.meshgrid(np.arange(hb, dtype=np.int64),
                       np.arange(hb, dtype=np.int64), indexing="ij")
    uf, vf = u.ravel(), v.ravel()
    subs = np.stack([
        multiply_unsigned(uf << h, vf << h, spec).reshape(hb, hb),
        multiply_unsigned(uf << h, vf, spec).reshape(hb, hb),
        multiply_unsigned(uf, vf << h, spec).reshape(hb, hb),
        multiply_unsigned(uf, vf, spec).reshape(hb, hb),
    ]).astype(np.int64)
    # bit-exactness check over the magnitude domain the signed kernels
    # index (quantization clips to qmax, so magnitudes are < 2^{bits-1})
    half = 1 << (bits - 1)
    full = build_lut(spec).astype(np.int64)[:half, :half]
    a = np.arange(half, dtype=np.int64)
    ah, al = a >> h, a & (hb - 1)
    recomposed = (subs[0][np.ix_(ah, ah)] + subs[1][np.ix_(ah, al)]
                  + subs[2][np.ix_(al, ah)] + subs[3][np.ix_(al, al)])
    if not np.array_equal(recomposed, full):
        return None
    assert subs.max() < np.iinfo(np.int32).max
    return subs.astype(np.int32)


def nibble_sub_luts(spec: MultiplierSpec):
    """(4, 2^{bits//2}, 2^{bits//2}) int32 sub-tables [S_hh, S_hl, S_lh,
    S_ll] when the family's LUT is bit-exactly half-word-decomposable,
    else None.  Order matches kernels/approx_matmul.nibble_lut_matmul."""
    return _nibble_sub_luts_cached(_spec_key(spec))


def nibble_decomposable(spec: MultiplierSpec) -> bool:
    """Routing predicate for the nibble-decomposed Pallas kernel."""
    try:
        return nibble_sub_luts(spec) is not None
    except ValueError:
        return False
