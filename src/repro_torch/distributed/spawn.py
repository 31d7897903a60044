"""Start N ranks of one SPMD program on ``torch.distributed``.

``spawn(fn, n, backend=..., init_file=...)`` starts ``n`` processes with
the ``spawn`` start method (the parent may already hold a CUDA context,
which ``fork`` would copy), joins each to one process group over a file
rendezvous, and runs ``fn(mesh, *args)`` in each, ``mesh`` being the
rank's ``make_mesh(mesh_shape, mesh_axes)``: by default ``(n,)`` over
``("model",)``, the row-sharded mesh of ``--shards N``; ``mesh_shape=(2,
2), mesh_axes=("data", "model")`` gives the reference's two-dimensional
(data, model) mesh, rank r at ``np.unravel_index(r, mesh_shape)``. It
returns the ranks' results in rank order, tensors turned into numpy
arrays.

The backend is the caller's, and nothing else is tried when it fails:

* ``"nccl"`` when each rank has its own card: rank r runs on ``cuda:r``;
* ``"gloo"`` for CPU ranks and for ranks that share one card. Gloo moves
  CUDA tensors only for ``broadcast`` and ``all_reduce`` (through host
  memory); ``collectives.all_to_all`` exchanges a host copy over gloo.

The rendezvous is a file path that the caller passes and that must not
exist yet: a fixed TCP port would collide between concurrent runs. Every
child sets ``torch.set_num_threads(1)``. The process group gets
``timeout_s`` and the parent waits at most ``join_timeout_s`` for all
results: past it, or when a rank fails, the parent terminates every rank
and raises with the failures' tracebacks, so a hang fails the caller
instead of holding it.

``fn`` and ``args`` are pickled to the children: ``fn`` must be a
module-level function, and its module must import without side effects.
Build the CUDA kernels in the parent first (``kernels._build.build_all``):
N children that find no build would each run every ``nvcc``.

The launchers' ``--shards N --backend gloo|nccl [--rendezvous FILE]
[--timeout S]`` and ``--mesh none|pod|multipod`` options are defined,
checked and run here (``add_shard_args``, ``check_shard_args``,
``spawn_launcher``, ``launcher_mesh``).
"""
from __future__ import annotations

import argparse
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def _to_host(x: Any) -> Any:
    """A result with every tensor replaced by a numpy copy (a tensor
    pickled by torch's queue would live in shared memory that its
    producer frees when it exits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _child(rank: int, n: int, backend: str, init_file: str,
           timeout_s: float, mesh_shape: tuple, mesh_axes: tuple,
           fn: Callable, args: tuple, out) -> None:
    torch.set_num_threads(1)
    try:
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(rank)
            kw["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s),
            **kw)
        try:
            from repro_torch.launch.mesh import make_mesh
            result = fn(make_mesh(mesh_shape, mesh_axes), *args)
            out.put((rank, True, _to_host(result)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, *, backend: str, init_file: str,
          args: Sequence = (), timeout_s: float = 120.0,
          join_timeout_s: float = 120.0,
          mesh_shape: Optional[Sequence[int]] = None,
          mesh_axes: Sequence[str] = ("model",)) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``nprocs`` ranks joined over
    ``backend``, ``mesh`` the rank's ``make_mesh(mesh_shape, mesh_axes)``
    (default ``(nprocs,)`` over ``("model",)``; the shape's product must
    be ``nprocs``); returns each rank's result, in rank order."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: name one of {BACKENDS}")
    if nprocs < 1:
        raise ValueError(f"{nprocs} ranks")
    mesh_shape = (nprocs,) if mesh_shape is None else tuple(mesh_shape)
    mesh_axes = tuple(mesh_axes)
    if int(np.prod(mesh_shape)) != nprocs or len(mesh_shape) != len(
            mesh_axes):
        raise ValueError(f"mesh {mesh_shape} over {mesh_axes} for "
                         f"{nprocs} ranks")
    if os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists already; "
                         "pass a fresh path")
    if backend == "nccl" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(
            f"nccl needs one card a rank: {nprocs} ranks, "
            f"{torch.cuda.device_count()} cards (ranks that share a card "
            "run over gloo)")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child,
                         args=(r, nprocs, backend, init_file, timeout_s,
                               mesh_shape, mesh_axes, fn, tuple(args), out))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results: List[Any] = [None] * nprocs
    failures: List[str] = []
    got = 0
    deadline = time.monotonic() + join_timeout_s
    try:
        # drain the queue before joining: a child blocks in its exit
        # until what it put has been read
        while got < nprocs and not failures:
            left = deadline - time.monotonic()
            if left <= 0:
                failures.append(f"ranks did not finish within "
                                f"{join_timeout_s} s")
                break
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    failures.append(f"ranks {dead} exited with "
                                    f"{[procs[r].exitcode for r in dead]} "
                                    "and no result")
                continue
            got += 1
            if ok:
                results[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            if failures:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
    if failures:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(failures))
    return results



def add_shard_args(p: argparse.ArgumentParser, shards_help: str) -> None:
    """A launcher's ``--mesh``, ``--shards``, ``--backend``,
    ``--rendezvous`` and ``--timeout`` options."""
    p.add_argument("--mesh", default="none",
                   choices=("none", "pod", "multipod"),
                   help="the production (data, model) mesh of 256 ranks, or "
                        "the (pod, data, model) mesh of 512, over the ranks "
                        "this process was started among (not with --shards)")
    p.add_argument("--shards", type=int, default=1, help=shards_help)
    p.add_argument("--backend", default=None, choices=BACKENDS,
                   help="with --shards: nccl (a card a rank) or gloo (CPU "
                        "ranks, or ranks that share one card)")
    p.add_argument("--rendezvous", default=None,
                   help="with --shards: the file the ranks join over (must "
                        "not exist; default: a fresh temporary file)")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="with --shards: seconds the ranks may take in all")


def check_shard_args(p: argparse.ArgumentParser, args: argparse.Namespace,
                     *, shardable: bool,
                     what: str = "row-shards a DLRM arena") -> None:
    """Refuse what ``add_shard_args``' options cannot mean together;
    ``shardable`` says whether the chosen model takes ``--shards``, and
    ``what`` what it does (the refusal's text)."""
    if args.shards < 1:
        p.error("--shards must be at least 1")
    if args.shards > 1 and not shardable:
        p.error(f"--shards {what}")
    if (args.shards > 1) != (args.backend is not None):
        p.error("--shards N (N > 1) and --backend go together: name the "
                "backend (nccl: a card a rank; gloo: CPU ranks or one "
                "shared card)")
    if args.rendezvous and args.shards == 1:
        p.error("--rendezvous goes with --shards")


def launcher_mesh(args: argparse.Namespace):
    """The mesh ``--mesh`` names, as the reference's launchers' ``_mesh``:
    None for ``none``; ``--shards`` (which builds its own N-way 'model'
    mesh) is refused beside it; else ``make_production_mesh``, which
    raises ``RuntimeError`` unless this process is one of its 256 (512)
    joined ranks."""
    if args.mesh == "none":
        return None
    if args.shards > 1:
        raise SystemExit(
            "--shards builds its own N-way 'model' mesh and cannot be "
            "combined with --mesh pod/multipod (the production meshes "
            "fix their own model-axis width); pass one or the other")
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(multi_pod=(args.mesh == "multipod"))


def mesh_leader(mesh) -> bool:
    """Whether this rank prints for the run: rank 0 of every axis (every
    process without a mesh)."""
    return mesh is None or all(mesh.rank(a) == 0 for a in mesh.axis_names)


def spawn_launcher(fn: Callable, args: argparse.Namespace) -> List[Any]:
    """Run ``fn(mesh, args)`` on ``args.shards`` ranks over
    ``args.backend``, joined over ``args.rendezvous`` (a fresh temporary
    file when not given); on the card the kernels are built here first,
    once for every rank. Returns the ranks' results in rank order."""
    if args.device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    rendezvous = args.rendezvous or os.path.join(
        tempfile.mkdtemp(prefix="repro_torch_"), "rendezvous")
    return spawn(fn, args.shards, backend=args.backend, init_file=rendezvous,
                 args=(args,), timeout_s=args.timeout,
                 join_timeout_s=args.timeout)
