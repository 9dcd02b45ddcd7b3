"""Variation-aware stuck-at fault injection (the JAX package's DESIGN.md
§14), numpy and torch.

`yield_analysis` characterizes the macro offline: MNIS importance
sampling puts a number Pf on the probability that process variation
breaks a bit-cell's read stability (Table V).  This module samples the
defect map that Pf predicts and applies it to everything the macro
*stores*:

  * the compiled product LUTs (`core/luts.py`): the full signed table
    and the nibble sub-tables, faulted over their 2b-bit words (numpy,
    cached on (spec_key, fault));
  * the quantized weight words: faulted over their b-bit two's-
    complement cells on every call (`apply_weight_faults`, torch), from
    masks drawn once per (fault, shape, bits, tag) and kept on the
    device (`weight_masks`).

Activations are transient (they stream through the ADC), so they carry
no faults.

A `FaultConfig` is a frozen, hashable value: it rides inside
`GemmParams` and so inside every plan-cache key, and a faulted lane and
a clean one never share a plan.  Every mask derives from
``np.random.SeedSequence([seed, crc32(tag), nbits, *shape])`` through
PCG64, byte-equal to the JAX package's masks (tested).  Masks are drawn
in row chunks (PCG64's doubles come one 64-bit draw each, in order, so a
chunked draw is the one-shot draw): a (6144, 2048) weight's 100.7 M
uniforms never sit in host memory at once.

Mask sharing: one (shape, tag) pair is one physical array's defect map.
Every weight of the same shape reuses the same mask, as in the
reference: the model's layers stream through one macro geometry.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from . import yield_analysis
from .luts import build_lut, nibble_sub_luts
from .multipliers import MultiplierSpec

# Modes that have an integer storage domain to fault.  The surrogate
# modes model the *average* approximation error statistically: they store
# no words and no tables, so "as-fabricated" is undefined there.
FAULT_MODES = ("exact", "bit_exact", "hardware")

# uniforms a mask chunk draws at once (float64: 128 MiB)
_CHUNK_DRAWS = 1 << 24


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """One macro's stuck-at defect statistics (frozen: cache-key safe).

    `p_sa0` / `p_sa1` are PER-CELL probabilities of a bit stuck at 0 /
    stuck at 1; `seed` picks the concrete defect map."""

    p_sa0: float = 0.0
    p_sa1: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for name in ("p_sa0", "p_sa1"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if self.p_sa0 + self.p_sa1 > 1.0:
            raise ValueError(
                f"p_sa0 + p_sa1 = {self.p_sa0 + self.p_sa1} > 1; a cell "
                "cannot be stuck both ways")

    @property
    def rate(self) -> float:
        """Total per-cell defect probability."""
        return self.p_sa0 + self.p_sa1

    @classmethod
    def from_yield(cls, rows: int = 64, seed: int = 0,
                   sa1_frac: float = 0.5,
                   scale: float = 1.0) -> "FaultConfig":
        """The defect rate from the MNIS yield characterization: the
        Table V geometry of `rows` rows gives Pf, the total stuck-at
        rate, split `sa1_frac` to stuck-at-1; `scale` moves it above or
        below the characterized point."""
        pf = min(_pf_for_rows(rows) * scale, 1.0)
        return cls(p_sa0=pf * (1.0 - sa1_frac), p_sa1=pf * sa1_frac,
                   seed=seed)


@functools.lru_cache(maxsize=16)
def _pf_for_rows(rows: int) -> float:
    res = yield_analysis.mnis_yield(yield_analysis.model_for_geometry(rows))
    return float(res.pf)


def _mask_chunks(fault: FaultConfig, shape: Tuple[int, ...], nbits: int,
                 tag: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(sa0, sa1) int64 masks of consecutive row blocks of `shape`, in C
    order, drawn from one stream: their concatenation is the one-shot
    draw of the reference's `stuck_at_masks`."""
    if nbits < 1 or nbits > 62:
        raise ValueError(f"nbits must be in [1, 62], got {nbits}")
    shape = tuple(int(s) for s in shape)
    ss = np.random.SeedSequence(
        [fault.seed & 0xFFFFFFFF, zlib.crc32(tag.encode("utf-8")), nbits,
         *shape])
    rng = np.random.default_rng(ss)
    lead = shape[0] if shape else 1
    row = int(np.prod(shape[1:], dtype=np.int64)) * nbits
    step = max(1, _CHUNK_DRAWS // max(row, 1))
    lo_p, hi_p = fault.p_sa0, fault.p_sa0 + fault.p_sa1
    for r0 in range(0, lead, step):
        rows = min(step, lead - r0)
        r = rng.random(size=((rows,) + shape[1:] if shape else ())
                       + (nbits,))
        sa0 = r < lo_p
        sa1 = (~sa0) & (r < hi_p)
        m0 = np.zeros(r.shape[:-1], np.int64)
        m1 = np.zeros(r.shape[:-1], np.int64)
        for i in range(nbits):
            m0 |= sa0[..., i].astype(np.int64) << i
            m1 |= sa1[..., i].astype(np.int64) << i
        yield m0, m1


def stuck_at_masks(fault: FaultConfig, shape: Tuple[int, ...], nbits: int,
                   tag: str) -> Tuple[np.ndarray, np.ndarray]:
    """The (sa0, sa1) bit masks of one stored array: int64 arrays of
    `shape`, `m0` with a 1 wherever a cell is stuck at 0, `m1` wherever
    stuck at 1.  A cell is stuck one way or the other (one uniform a
    cell), and the stream is keyed on (seed, tag, nbits, shape) through
    SeedSequence/PCG64, never Python's salted `hash`."""
    parts = list(_mask_chunks(fault, shape, nbits, tag))
    if not tuple(shape):
        return parts[0]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def fault_unsigned_words(words: np.ndarray, fault: FaultConfig, nbits: int,
                         tag: str) -> np.ndarray:
    """Stuck-at masks applied to unsigned nbits-bit words (the stored-LUT
    read path); values stay in [0, 2^nbits)."""
    m0, m1 = stuck_at_masks(fault, words.shape, nbits, tag)
    span = np.int64(1) << nbits
    u = words.astype(np.int64) & (span - 1)
    return (u & ~m0) | m1


# ---------------------------------------------------------------------------
# Faulted weight words (torch, every call; masks on the device, once)
# ---------------------------------------------------------------------------


def _narrowest(nbits: int) -> torch.dtype:
    return (torch.uint8 if nbits <= 8 else torch.int16 if nbits <= 15
            else torch.int32)


@functools.lru_cache(maxsize=32)
def _device_masks(fault: FaultConfig, shape: Tuple[int, ...], bits: int,
                  tag: str, device: torch.device):
    span = (1 << bits) - 1
    dt = _narrowest(bits)
    keep = torch.empty(shape, dtype=dt, device=device)
    m1 = torch.empty(shape, dtype=dt, device=device)
    r0 = 0
    for c0, c1 in _mask_chunks(fault, shape, bits, tag):
        r1 = r0 + c0.shape[0]
        keep[r0:r1] = torch.from_numpy((~c0 & span).astype(np.int32)).to(dt)
        m1[r0:r1] = torch.from_numpy(c1.astype(np.int32)).to(dt)
        r0 = r1
    return keep, m1


def weight_masks(fault: FaultConfig, shape: Tuple[int, ...], bits: int,
                 device, tag: str = "w") -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, m1) of one weight shape on `device`, drawn once and cached:
    ``keep = ~m0 & (2^bits - 1)``, in the narrowest integer type that
    holds a word (uint8 up to 8 bits).  Every weight of the shape shares
    them (one macro geometry)."""
    if len(shape) != 2:
        raise ValueError(f"weight masks are 2-D, got shape {tuple(shape)}")
    return _device_masks(fault, tuple(int(s) for s in shape), int(bits), tag,
                         torch.device(device))


def apply_weight_faults(wq: torch.Tensor, fault: FaultConfig, bits: int,
                        tag: str = "w") -> torch.Tensor:
    """Stuck-at faults on quantized weight words: ``u & ~m0 | m1`` on the
    b-bit two's-complement word of each entry of `wq` (signed b-bit
    words in [-qmax, qmax]), re-read as signed and clipped back to
    [-qmax, qmax] (the macro's read path saturates at the quantizer
    range, so every kernel's operand contract holds).  Same dtype and
    device as `wq`; bitwise the reference's."""
    keep, m1 = weight_masks(fault, tuple(wq.shape), bits, wq.device, tag)
    span = 1 << bits
    half = span >> 1
    qmax = half - 1
    wide = torch.int16 if bits <= 14 else torch.int32
    u = wq.to(wide) & (span - 1)
    f = (u & keep.to(wide)) | m1.to(wide)
    s = torch.where(f >= half, f - span, f)
    return torch.clamp(s, -qmax, qmax).to(wq.dtype)


# ---------------------------------------------------------------------------
# Faulted stored tables (the LUT twin of core/luts.py): numpy, cached on
# (spec_key, fault); spec_key = (family, bits, compressor, n_approx_cols)
# ---------------------------------------------------------------------------


def _spec_of(spec_key: Tuple) -> MultiplierSpec:
    family, bits, compressor, n_approx = spec_key
    return MultiplierSpec(family, bits, False, compressor, n_approx)


@functools.lru_cache(maxsize=32)
def faulted_unsigned_lut(spec_key: Tuple, fault: FaultConfig) -> np.ndarray:
    """As-fabricated unsigned magnitude table (2^b, 2^b) int64: each
    product sits in a 2b-bit word of the array."""
    spec = _spec_of(spec_key)
    return fault_unsigned_words(build_lut(spec), fault, 2 * spec.bits, "lut")


@functools.lru_cache(maxsize=32)
def faulted_signed_lut_flat(spec_key: Tuple,
                            fault: FaultConfig) -> np.ndarray:
    """Flat faulted signed table (2^{2b},) int32, rebuilt from the faulted
    magnitude storage by the sign-magnitude construction of
    `luts.signed_product_lut`: sign(0) == 0 zeroes the row and column of
    operand 0 whatever the faulted cells read back."""
    bits = spec_key[1]
    uf = faulted_unsigned_lut(spec_key, fault)
    half = 1 << (bits - 1)
    vals = np.arange(-half, half, dtype=np.int64)
    mags = np.minimum(np.abs(vals), half - 1)
    signs = np.sign(vals)
    out = uf[np.ix_(mags, mags)] * np.outer(signs, signs)
    if not ((out[half, :] == 0).all() and (out[:, half] == 0).all()):
        raise AssertionError("faulted table lost zero annihilation")
    return out.astype(np.int32).ravel()


def magnitude_table(spec_key: Tuple,
                    fault: Optional[FaultConfig]) -> np.ndarray:
    """The (2^{b-1} x 2^{b-1},) table of magnitude products
    ``uf[|a|, |b|]`` for |a|, |b| <= qmax, flat, int64, from which the
    signed table is built (faulted with `fault`, clean without): the
    form the magnitude-table LUT kernel holds, which restores the signs
    itself."""
    bits = spec_key[1]
    half = 1 << (bits - 1)
    u = (faulted_unsigned_lut(spec_key, fault) if fault is not None
         else build_lut(_spec_of(spec_key)).astype(np.int64))
    return np.ascontiguousarray(u[:half, :half]).ravel()


@functools.lru_cache(maxsize=32)
def faulted_nibble_subs_flat(spec_key: Tuple, fault: FaultConfig):
    """Faulted nibble sub-tables, flat (4 * 2^h * 2^h,) int32: each
    sub-table its own physical array (tags subs0..3), its entries 2b-bit
    words like the full table's.  None when the clean spec is not
    nibble-decomposable."""
    family, bits, compressor, n_approx = spec_key
    spec = MultiplierSpec(family, bits, True, compressor, n_approx)
    subs = nibble_sub_luts(spec)
    if subs is None:
        return None
    out = np.stack([fault_unsigned_words(subs[i], fault, 2 * bits,
                                         f"subs{i}") for i in range(4)])
    if out.max() >= np.iinfo(np.int32).max:
        raise AssertionError("faulted sub-table word past int32")
    return out.astype(np.int32).ravel()


def clear_fault_caches() -> None:
    """Drop the memoized defect tables and device masks (tests)."""
    _pf_for_rows.cache_clear()
    _device_masks.cache_clear()
    faulted_unsigned_lut.cache_clear()
    faulted_signed_lut_flat.cache_clear()
    faulted_nibble_subs_flat.cache_clear()
