"""Carry the JAX package's LM and CNN weights into the port's parameter
layout.

`params_from_numpy` takes the tree of ``LM(cfg).init(key)`` from the JAX
package with every leaf already converted to numpy by the caller (the
port never imports JAX): nested dicts whose leaves are arrays or objects
with a ``.value`` array.  bf16 leaves arrive as ``ml_dtypes.bfloat16``
and are carried as a uint16 view, reinterpreted as ``torch.bfloat16``
(bit for bit).  The stacked ``body`` holds one entry per position j of
the period, each stacked over the periods p: layer ``p * len(period) +
j`` of the per-layer list is ``body[str(j)]`` at index p.  Head-shaped
attention weights are flattened to the 2-D (K, N) form cim_linear takes;
the xLSTM blocks' leaves (``rnn``) are carried as they are.

`shard_params` cuts a full parameter dict (carried, or seeded by
``LM.init``) to one rank's shards on a mesh, per
models.transformer.param_layout (DECODE_RULES).
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

    if "rnn" in body:                           # mLSTM / sLSTM
        return {"norm1": {k: at(v) for k, v in body["norm1"].items()},
                "rnn": {k: at(v) for k, v in body["rnn"].items()}}
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
    """The port's parameter dict from a numpy-leaved JAX LM tree (a body
    of periods of attention or xLSTM layers, no prefix)."""
    if tree.get("prefix"):
        raise NotImplementedError("prefix layers are a later slice")
    body = tree["body"]
    period = [body[str(j)] for j in range(len(body))]
    scale = period[0]["norm1"]["scale"]
    n_periods = np.asarray(getattr(scale, "value", scale)).shape[0]
    p = {"embed": _tensor(tree["embed"], device),
         "final_norm": {k: _tensor(v, device)
                        for k, v in tree["final_norm"].items()},
         "layers": [_layer(lp, i, device) for i in range(n_periods)
                    for lp in period]}
    if "head" in tree:
        p["head"] = _tensor(tree["head"], device)
    return p


def cnn_params_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The port's CNN parameter dict (models/cnn.py) from the JAX
    package's ``init_cnn`` tree with numpy leaves: the same names, each
    ``Param.value`` carried bit for bit."""
    return {name: _tensor(leaf, device) for name, leaf in tree.items()}


def shard_params(params: Dict[str, Any], cfg, mesh) -> Dict[str, Any]:
    """This rank's parameters of a tensor-parallel LM on `mesh`: each
    layer's attention and MLP weights cut to the contiguous block of its
    coordinates (`param_layout`; whole heads, so local head i keeps the
    GQA map onto local kv head i // (H/KV)), everything else whole.  The
    full tensors are not kept."""
    from repro_torch.parallel.sharding import shard

    from .transformer import param_layout

    layout = param_layout(cfg, mesh)
    layers = []
    for lp in params["layers"]:
        out = {g: dict(v) for g, v in lp.items()}
        for (g, name), spec in layout.items():
            out[g][name] = shard(lp[g][name], spec, mesh)
        layers.append(out)
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": layers}
