"""OpenACM on PyTorch and CUDA: the port of the `repro` JAX package.

It mirrors the JAX package's layout (core/, kernels/, models/, configs/,
serving/, launch/) and never imports it or JAX.  Entry points run on a
CUDA device unless the caller passes ``device="cpu"``, where the GPU
kernels' plain PyTorch versions run instead.

`repro_torch.autoallocate` (with `Allocation` and `exhaustive_oracle`)
is the one-command per-module accuracy allocator (core/allocate.py),
loaded on first use.
"""

_LAZY = {
    "autoallocate": ("repro_torch.core.allocate", "autoallocate"),
    "Allocation": ("repro_torch.core.allocate", "Allocation"),
    "exhaustive_oracle": ("repro_torch.core.allocate", "exhaustive_oracle"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
