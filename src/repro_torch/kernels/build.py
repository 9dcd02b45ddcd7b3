"""Build and bind the hand-written CUDA kernels (plain C interface).

Each source ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/lib<name>-<digest>.so`` at the
repository root, the digest being that of the source, every header under
``csrc/`` and the flags, and loaded with `ctypes`.  Nothing here runs at
import time, so the CPU tests import every module without a toolkit.  No
fast-math: the kernels' quantization needs IEEE division and
round-half-to-even.

`build(names)` starts one ``nvcc`` per missing source, all at once, and
returns each build's seconds and ``-Xptxas -v`` report.  `CudaKernel` is
one C entry point plus its launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
# every kernel source the port's paths launch (csrc/<name>.cu); the
# measurement source csrc/nibble_shapes.cu is built by
# launch/cluster_sweep.py alone
SOURCES = ("lut_gemm", "nibble_gemm", "log_gemm", "conv_gemm", "attn_gemm",
           "surrogate_gemm", "slstm_scan")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dynamic shared memory one Hopper block may use
SMEM_BYTES = 232_448

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc); the "
                           "GPU kernels build only where nvcc exists")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """The library of csrc/<name>.cu, named by the digest of the source,
    of every csrc/*.cuh (a header edit rebuilds every source) and of the
    flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Tuple[float, str]]:
    """Compile every missing library among `names` in parallel.

    Returns {name: (seconds, compiler report)}; a library already built
    from the same source reports (0.0, its saved report).  Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Tuple[float, str]] = {}
    jobs: List[Tuple[str, Path, Path, subprocess.Popen, float]] = []
    for name in names:
        lib = library_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = (0.0, log.read_text() if log.exists() else "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc, time.perf_counter()))
    failed = []
    for name, lib, tmp, proc, t0 in jobs:
        report, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{report}")
            continue
        lib.with_suffix(".log").write_text(report)
        os.replace(tmp, lib)
        out[name] = (secs, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (building it if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


class CudaKernel:
    """One C entry point of a built library and its launch count.

    Every entry point returns ``cudaGetLastError()`` after its launch; a
    nonzero code raises here.  `launches` counts successful launches and
    is the only place a launch is counted."""

    def __init__(self, library: str, symbol: str, argtypes: Sequence):
        self.library, self.symbol = library, symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


def query(library: str, symbol: str, *args: int) -> int:
    """Call a C query of a built library that takes `args` (ints) and an
    int out-pointer, returning the int it wrote (no launch, nothing
    counted); raises on a nonzero CUDA error code."""
    fn = getattr(load(library), symbol)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    rc = fn(*args, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc}")
    return out.value


# argument kinds for CudaKernel signatures
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLT = ctypes.c_float


def on_cuda(*tensors) -> bool:
    """True when every operand lies on one CUDA device, False when all
    lie on the CPU; raises on a mix or on any other device.  This is the
    wrappers' only switch between a kernel and its plain version."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = tensors[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev.type == "cuda"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def stream_of(t) -> int:
    """The current CUDA stream of `t`'s device, as the C entry points
    take it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
