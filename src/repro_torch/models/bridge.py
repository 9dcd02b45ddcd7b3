"""Carry the JAX package's LM weights into the port's parameter layout.

`params_from_numpy` takes the tree of ``LM(cfg).init(key)`` from the JAX
package with every leaf already converted to numpy by the caller (the
port never imports JAX): nested dicts whose leaves are arrays or objects
with a ``.value`` array.  bf16 leaves arrive as ``ml_dtypes.bfloat16``
and are carried as a uint16 view, reinterpreted as ``torch.bfloat16``
(bit for bit).  The stacked ``body`` leaves' leading layer axis becomes
the per-layer list, and head-shaped attention weights are flattened to
the 2-D (K, N) form cim_linear takes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(leaf, device) -> torch.Tensor:
    # a copy: the caller's arrays may be read-only views of JAX buffers
    arr = np.array(getattr(leaf, "value", leaf), order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _layer(body: Dict[str, Any], i: int, device) -> Dict[str, Any]:
    def at(leaf):
        return _tensor(np.asarray(getattr(leaf, "value", leaf))[i], device)

    attn = body["attn"]
    out_attn = {}
    for name, leaf in attn.items():
        t = at(leaf)
        if name in ("wq", "wk", "wv"):          # (D, H, hd) -> (D, H*hd)
            t = t.reshape(t.shape[0], -1)
        elif name == "wo":                      # (H, hd, D) -> (H*hd, D)
            t = t.reshape(-1, t.shape[-1])
        out_attn[name] = t
    return {"norm1": {k: at(v) for k, v in body["norm1"].items()},
            "attn": out_attn,
            "norm2": {k: at(v) for k, v in body["norm2"].items()},
            "mlp": {k: at(v) for k, v in body["mlp"].items()}}


def params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The port's parameter dict from a numpy-leaved JAX LM tree (dense
    ATTN stacks: ``body`` holds the one-layer period "0")."""
    if tree.get("prefix"):
        raise NotImplementedError("prefix layers are a later slice")
    body = tree["body"]["0"]
    n_layers = np.asarray(getattr(body["norm1"]["scale"], "value",
                                  body["norm1"]["scale"])).shape[0]
    p = {"embed": _tensor(tree["embed"], device),
         "final_norm": {k: _tensor(v, device)
                        for k, v in tree["final_norm"].items()},
         "layers": [_layer(body, i, device) for i in range(n_layers)]}
    if "head" in tree:
        p["head"] = _tensor(tree["head"], device)
    return p
