"""The port's process mesh: a ("data", "model") grid of
``torch.distributed`` ranks, one process each, the SPMD counterpart of
the JAX package's device mesh (its ``launch/mesh.py``).

Where JAX hands a single controller global arrays and slices them inside
``shard_map``, here every rank runs the same program on its own shards,
and the collectives that JAX inserts are explicit calls on the `Mesh`:

  * `Mesh.all_reduce` (sum or max over a set of axes) and
    `Mesh.all_gather` (concatenation over a set of axes along one dim),
    staged through host memory: the transport is the gloo backend, which
    works on one card and on the CPU alike (NCCL refuses two ranks on
    one GPU).  Each call is counted and timed (`Mesh.comm`);
  * ``with mesh:`` makes a mesh the ambient one (`ambient_mesh`), a
    context variable in place of JAX's ``thread_resources``.

`make_host_mesh(model_parallel)` builds the mesh over the initialized
world.  `spawn(fn, n_ranks, device)` runs ``fn(rank, world, device,
*args)`` in `n_ranks` fresh processes (start method ``spawn``) joined in
one gloo world through a file store, rank r on ``cuda:{r % count}`` (or
the CPU), and returns each rank's result; a rank that fails or hangs
fails the call, and no process outlives it.  The tests, the launcher and
chip_smoke.py all start their ranks through it.
"""

from __future__ import annotations

import contextvars
import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("data", "model")

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def ambient_mesh() -> Optional["Mesh"]:
    """The mesh of an enclosing ``with mesh:`` block, or None."""
    return _AMBIENT.get()


class Mesh:
    """A mesh of ranks over the initialized ``torch.distributed`` world.

    `shape` maps each axis name to its size (ordered, the first the
    slowest); `coords` maps it to this rank's coordinate.  Two meshes are
    equal when their shapes and this rank's coordinates are; `key` is
    that pair, for cache keys."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self._dm = device_mesh
        if device_mesh is not None:
            coord = device_mesh.get_coordinate()
            self.coords = dict(zip(self.axis_names, coord))
        else:
            self.coords = {a: 0 for a in self.axis_names}
        self.key = (tuple(self.shape.items()), tuple(self.coords.values()))
        self.comm = {"calls": 0, "seconds": 0.0}
        self._tokens: List[contextvars.Token] = []

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.key == other.key

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords})"

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes) if axes else 1

    def index(self, axes: Sequence[str]) -> int:
        """This rank's shard index over `axes` (row-major, the first axis
        the slowest)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    # -- the ambient mesh -----------------------------------------------------
    def __enter__(self) -> "Mesh":
        self._tokens.append(_AMBIENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.reset(self._tokens.pop())

    # -- collectives ----------------------------------------------------------
    def _group(self, axes: Sequence[str]):
        """The process group of this rank's slice over `axes` (None when
        their size is 1: nothing to exchange)."""
        live = tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)
        if not live:
            return None
        if len(live) == 1:
            return self._dm.get_group(live[0])
        import torch.distributed as dist

        if dist.get_world_size() != self.size:
            raise ValueError(f"a collective over {live} needs the mesh to "
                             f"span the world ({self.size} ranks)")
        return dist.group.WORLD

    def _timed(self, op: Callable) -> torch.Tensor:
        t0 = time.perf_counter()
        out = op()
        self.comm["seconds"] += time.perf_counter() - t0
        self.comm["calls"] += 1
        return out

    def all_reduce(self, t: torch.Tensor, op: str,
                   axes: Sequence[str]) -> torch.Tensor:
        """The elementwise "sum" or "max" of `t` over the ranks of this
        rank's slice along `axes`, on every one of them (a new tensor on
        `t`'s device; `t` itself is left alone).  The copy to the host
        waits for the kernels that produce `t`; the time counted starts
        after it."""
        group = self._group(axes)
        if group is None:
            return t
        import torch.distributed as dist

        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        host = t.detach().to("cpu", copy=True).contiguous()

        def run():
            dist.all_reduce(host, op=reduce_op, group=group)
            return host.to(t.device)
        return self._timed(run)

    def all_gather(self, t: torch.Tensor, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
        """The blocks of `t` of the ranks of this rank's slice along
        `axes`, concatenated along `dim` in shard order (the inverse of
        parallel.sharding.shard over those axes)."""
        for a in reversed(tuple(axes)):     # the fastest axis first
            group = self._group((a,))
            if group is None:
                continue
            import torch.distributed as dist

            host = t.detach().to("cpu", copy=True).contiguous()

            def run(host=host, group=group, a=a):
                parts = [torch.empty_like(host)
                         for _ in range(self.shape[a])]
                dist.all_gather(parts, host, group=group)
                return torch.cat(parts, dim=dim).to(t.device)
            t = self._timed(run)
        return t


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """A ("data", "model") mesh over every rank of the initialized world:
    `model_parallel` ranks a model group (cut down to a divisor of the
    world size), the rest data parallel."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    mp = max(1, min(model_parallel, n))
    while n % mp:
        mp -= 1
    dm = init_device_mesh("cpu", (n // mp, mp), mesh_dim_names=AXES)
    return Mesh({"data": n // mp, "model": mp}, dm)


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, store: str, device: str, args,
               workdir: str, pg_timeout: float,
               threads: Optional[int]) -> None:
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            idx = rank % torch.cuda.device_count()
            torch.cuda.set_device(idx)
            dev = torch.device("cuda", idx)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=pg_timeout))
        out = fn(rank, world, dev, *args)
        dist.barrier()
        dist.destroy_process_group()
        tmp = os.path.join(workdir, f"rank{rank}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(workdir, f"rank{rank}.pkl"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn(fn: Callable, n_ranks: int, *, device="cuda", args: Tuple = (),
          timeout: float = 900.0, pg_timeout: float = 300.0,
          threads: Optional[int] = None,
          workdir: Optional[str] = None) -> List:
    """Run ``fn(rank, n_ranks, device, *args)`` in `n_ranks` fresh
    processes joined in one gloo world, and return their results in rank
    order.

    `fn` must be importable by name (a module-level function) and its
    result picklable.  Rank r runs on ``cuda:{r % device_count}`` for a
    CUDA `device`, else on the CPU, with `threads` intra-op threads if
    given.  The world meets through a file store in `workdir` (a fresh
    temporary directory by default), so concurrent callers never share
    one; its collectives give up after `pg_timeout` seconds.  Raises
    RuntimeError with the rank's traceback as soon as any rank fails,
    TimeoutError when not every rank has finished after `timeout`
    seconds; either way every rank process is stopped before it
    returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="mesh-") if own else str(workdir)
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    env_set = "GLOO_SOCKET_IFNAME" not in os.environ
    if env_set:                         # one host: talk over the loopback
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    procs = []
    try:
        for r in range(n_ranks):
            p = ctx.Process(target=_rank_main,
                            args=(fn, r, n_ranks, store, str(device), args,
                                  workdir, pg_timeout, threads))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            for r, c in enumerate(codes):
                if c not in (None, 0):
                    err = os.path.join(workdir, f"rank{r}.err")
                    text = (open(err).read() if os.path.exists(err)
                            else "(no traceback)")
                    raise RuntimeError(f"mesh rank {r} of {n_ranks} exited "
                                       f"with code {c}:\n{text}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"mesh ranks {late} of {n_ranks} still "
                                   f"running after {timeout:.0f}s")
            time.sleep(0.02)
        out = []
        for r in range(n_ranks):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        if env_set:
            os.environ.pop("GLOO_SOCKET_IFNAME", None)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
