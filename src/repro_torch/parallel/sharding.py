"""Logical-axis sharding: the rules that map the model's logical dim
names onto the ("data", "model") process mesh, with the
divisibility-aware fallback, and the cuts of full tensors to this rank's
shard.

A copy of the JAX package's rules (its ``parallel/sharding.py``), kept
here because the port imports nothing of that package:

  batch   -> ("pod", "data")    data parallel
  vocab/heads/ff/expert -> "model"   tensor parallel
  embed   -> "data"             FSDP storage (training); DECODE_RULES
                                keeps it whole for serving
  layers, seq -> None

A dim that does not divide its mesh axes is replicated instead, and a
mesh axis carries at most one dim of a tensor.  Where JAX places a
global array with a ``NamedSharding``, every rank of the port holds its
own block: `shard` cuts a full tensor to the contiguous block of this
rank's coordinates (so head i of rank r on a "heads"-sharded weight is
global head r * H/m + i, and the GQA map i // (H/KV) holds locally).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "embed": ("data",),
    "layers": None,
    "seq": None,
    None: None,
}

# Serving: no optimizer state, so weights stay tensor-parallel only,
# replicated across the data axis.
DECODE_RULES = dict(DEFAULT_RULES, embed=None)


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (whole), a
    mesh axis name, or a tuple of axis names (the dim split over their
    product, the first the slowest)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def axes_of(entry) -> Tuple[str, ...]:
    """One spec entry as a tuple of axis names (() for None)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_entry(axes: Tuple[str, ...]):
    """The inverse of `axes_of`: None, one name, or a tuple."""
    return None if not axes else (axes[0] if len(axes) == 1 else tuple(axes))


def axes_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


def _axes_for(logical: Optional[str], mesh, rules) -> Tuple[str, ...]:
    want = rules.get(logical, None)
    if want is None:
        return ()
    if isinstance(want, str):
        want = (want,)
    return tuple(a for a in want if a in mesh.shape)


def logical_to_spec(spec, shape, mesh, rules=None) -> P:
    """Resolve a logical spec tuple to a partition spec for `mesh`
    (anything with a ``.shape`` dict of axis sizes), dropping axes whose
    size does not divide the dim and axes an earlier dim already took."""
    rules = rules or DEFAULT_RULES
    if spec is None:
        return P()
    out = []
    used = set()
    for dim, logical in zip(shape, spec):
        axes = _axes_for(logical, mesh, rules)
        axes = tuple(a for a in axes if a not in used)
        size = axes_size(mesh, axes)
        if axes and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            out.append(None)
    return P(*out)


def batch_axes(mesh, dim0: Optional[int] = None,
               rules=None) -> Tuple[str, ...]:
    """Mesh axes the batch dim shards over; () when `dim0` is given and
    does not divide their product (the replication fallback)."""
    rules = rules or DEFAULT_RULES
    axes = _axes_for("batch", mesh, rules)
    if dim0 is not None and axes:
        if dim0 % axes_size(mesh, axes):
            return ()
    return axes


def shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's contiguous block of the full tensor `t` under `spec`
    (a copy, so the full tensor can be freed)."""
    for dim, entry in enumerate(spec):
        axes = axes_of(entry)
        if not axes:
            continue
        n = axes_size(mesh, axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide over {axes} (size {n})")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axes) * size, size)
    return t.clone(memory_format=torch.contiguous_format)
