"""Config registry of the port (the dense architectures of this slice)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.core.compiler import CiMConfig
from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def arch_names():
    return sorted(_REGISTRY)


def get_config(name: str, smoke: bool = False,
               cim: Optional[CiMConfig] = None,
               **overrides) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {arch_names()}")
    cfg = table[name]()
    if cim is not None or overrides:
        cfg = dataclasses.replace(cfg, **({"cim": cim} if cim else {}),
                                  **overrides)
    return cfg
