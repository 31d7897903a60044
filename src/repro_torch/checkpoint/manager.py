"""Checkpoints: async save, atomic publish, keep-N, in the reference's
on-disk layout.

A checkpoint is ``<dir>/step_<n>/arrays.npz`` (the leaves as ``arr_<i>``)
plus ``manifest.json`` (step, tree paths, shapes, dtypes, meta), written
to ``<dir>/tmp.<n>`` and renamed into place only when complete, so a
writer killed mid-save never corrupts the latest checkpoint. Serving
artifacts ride the same machinery: ``save_source`` persists a
``VersionedSource`` blob as ``<dir>/src_<n>/source.vsrc``, and
``restore_source`` rebuilds it (a tiered member's host store is dropped
by the serializer and comes back ``None``).

The leaves are ordered as ``jax.tree_util.tree_flatten`` orders them
(dict keys sorted, sequences in order) and named by its ``keystr``
paths, so a checkpoint written by either package restores in the other.
The port's optimizer state holds its step counts as Python ints: they
are saved as 0-d arrays and restored as ints.

The port's train steps update their tensors in place, so ``save_async``
copies every leaf to host memory before it returns: a step taken while
the background write runs cannot reach the checkpoint.

Row-sharded state (a ``launch.mesh.Mesh`` of more than one rank, one
process a rank) stays unsharded on disk, so a checkpoint is readable by
either package at any shard count. ``shardings`` is a tree of the
state's structure whose leaves are a ``Mesh`` (the leaf is this rank's
block of a row-sharded arena, ``se.shard_block``: its rows, then a zero
sentinel) or ``None`` (replicated); ``row_shardings`` marks a train
state's arena leaves. ``save(..., shardings=)`` is collective: every
rank's block is brought to the writer (the axis' rank 0) through host
memory by per-owner broadcasts, the sentinels left out, and that one
rank writes. ``restore(..., shardings=)`` slices each rank's block of
the saved arena for the mesh it is given (``reshard_checkpoint``: an
elastic rescale, 4 ranks to 2 say): padding rows that the new shard
count does not need must be zero, and missing ones are zero.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import sparse_engine as se
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import tree_map, tree_paths


def row_shardings(state, mesh: Mesh):
    """The ``shardings`` tree of a row-sharded train state: ``mesh`` at
    every tensor leaf under an ``['arena']`` path (the arena and its
    accumulator), ``None`` elsewhere."""
    flat = tree_paths(state)
    marks = [mesh if isinstance(x, torch.Tensor) and "['arena']" in p
             else None for p, x in flat]
    return _unflatten(state, marks)


class _Mark:
    """A sharding (None included) held as a leaf: ``tree_paths`` would
    drop a None."""
    def __init__(self, mesh):
        self.mesh = mesh


def _marked(state, shardings):
    """``state``'s structure with a ``_Mark`` a leaf; ``shardings`` may be
    a prefix of it (a leaf of it applies to the whole subtree)."""
    if not isinstance(shardings, (dict, list, tuple)):
        return tree_map(lambda t: None if t is None else _Mark(shardings),
                        state)
    if isinstance(state, dict):
        return {k: _marked(state[k], shardings[k]) for k in state}
    return type(state)(_marked(a, b) for a, b in zip(state, shardings))


def _sharding_leaves(state, shardings) -> List[Optional[Mesh]]:
    """One sharding a leaf of ``state``, in ``tree_paths`` order: the
    ``Mesh`` of a row-sharded leaf of more than one rank, else None."""
    marks = [x.mesh for _, x in tree_paths(_marked(state, shardings))]
    for m in marks:
        if m is not None and not isinstance(m, Mesh):
            raise TypeError(f"a sharding is a repro_torch Mesh (row-"
                            f"sharded) or None, got {type(m).__name__}")
    return [m if m is not None and m.size("model") > 1 else None
            for m in marks]


def _unflatten(template, leaves: List[Any]):
    """``template``'s structure (its containers' types) with its leaves
    replaced, in ``tree_paths``' order, from ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _to_host(leaf) -> np.ndarray:
    """A host copy that shares no memory with ``leaf``: a tensor on the
    CPU would otherwise hand numpy its own storage, which the next
    in-place step rewrites. numpy has no bfloat16, so those leaves are
    kept as float32 (exactly) and restored to the template's dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.array(leaf)


def _place(a: np.ndarray, like, device: torch.device):
    """A saved leaf in the form of the template's: a tensor of its dtype
    on ``device``, a Python number of its type, else an array."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(a)).to(device=device,
                                                dtype=like.dtype)
    if isinstance(like, (int, float)):
        return type(like)(a)
    return np.array(a, dtype=np.asarray(like).dtype)


class CheckpointManager:
    """Checkpoints of a tree of tensors under ``directory``, the newest
    ``keep_n`` kept. ``restore`` and ``restore_source`` place tensors on
    ``device``, the card unless told otherwise."""

    def __init__(self, directory, keep_n: int = 3, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.device = device
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def _write(self, step: int, host: List[np.ndarray], paths: List[str],
               meta: Optional[Dict]) -> Path:
        tmp = self.dir / f"tmp.{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{f"arr_{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": int(step),
            "paths": paths,
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
            "meta": meta or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._gc()
        return final

    def _host_leaves(self, state, shardings):
        """(host copies of the leaves, their paths, whether this rank
        writes): a row-sharded leaf whole, gathered from every rank."""
        # imported here: repro_torch.distributed imports this module
        from repro_torch.distributed import collectives
        flat = tree_paths(state)
        host, writer = [], True
        for (_, x), mesh in zip(flat, _sharding_leaves(state, shardings)):
            if mesh is None:
                host.append(_to_host(x))
                continue
            writer = mesh.rank("model") == 0
            host.append(_to_host(collectives.gather_blocks(x, mesh)))
        return host, [p for p, _ in flat], writer

    def save(self, step: int, state, meta: Optional[Dict] = None,
             shardings=None) -> Path:
        """Write ``state`` at ``step``. With ``shardings`` (a tree of
        ``Mesh``/None, see the module docstring) every rank calls this
        together; the axis' rank 0 writes, and all return once it has."""
        host, paths, writer = self._host_leaves(state, shardings)
        final = self.dir / f"step_{step}"
        if writer:
            final = self._write(step, host, paths, meta)
        meshes = [m for m in _sharding_leaves(state, shardings)
                  if m is not None]
        if meshes:
            # the other ranks return once the writer has published
            dist.barrier(group=meshes[0].group("model"))
        return final

    def save_async(self, step: int, state, meta: Optional[Dict] = None,
                   shardings=None):
        """Copy every leaf to host memory now (a blocking copy from the
        card; with ``shardings`` a collective that gathers the sharded
        leaves), write in the background (on the writer alone)."""
        self.wait()
        host, paths, writer = self._host_leaves(state, shardings)
        if not writer:
            return

        def _write():
            try:
                self._write(step, host, paths, meta)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
        self._gc_orphans()

    def _gc_orphans(self):
        """Remove ``tmp.*`` debris of writers that died mid-save: every
        completed save sweeps any earlier torn write."""
        for p in self.dir.glob("tmp.*"):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------- source artifacts
    def save_source(self, step: int, versioned,
                    meta: Optional[Dict] = None) -> Path:
        """Persist a ``VersionedSource`` serving artifact at ``step``: the
        bytes ``publish_source`` broadcasts, tmp-then-rename, keep-N
        (``src_*`` and ``step_*`` are separate namespaces)."""
        from repro_torch.core.embedding_source import VersionedSource
        if not isinstance(versioned, VersionedSource):
            raise TypeError(f"save_source needs a VersionedSource, got "
                            f"{type(versioned).__name__}")
        blob = versioned.serialize()
        tmp = self.dir / f"tmp.src.{step}"
        final = self.dir / f"src_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        (tmp / "source.vsrc").write_bytes(blob)
        manifest = {"step": int(step),
                    "version": int(versioned.version),
                    "bytes": len(blob),
                    "meta": meta or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                  # atomic publish
        self._gc_sources()
        return final

    def source_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("src_*"))

    def latest_source_step(self) -> Optional[int]:
        s = self.source_steps()
        return s[-1] if s else None

    def restore_source(self, step: Optional[int] = None):
        """The ``VersionedSource`` artifact at ``step`` (default: latest)
        and its manifest, its tensors on the manager's device."""
        from repro_torch.core.embedding_source import VersionedSource
        step = step if step is not None else self.latest_source_step()
        if step is None:
            raise FileNotFoundError(f"no source artifacts in {self.dir}")
        d = self.dir / f"src_{step}"
        blob = (d / "source.vsrc").read_bytes()
        manifest = json.loads((d / "manifest.json").read_text())
        return VersionedSource.deserialize(
            blob, device=resolve_device(self.device)), manifest

    def _gc_sources(self):
        steps = self.source_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.dir / f"src_{s}", ignore_errors=True)
        self._gc_orphans()

    # --------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: Optional[int] = None,
                shardings=None):
        """Restore into the structure of ``template``: new tensors of the
        template's dtypes on the manager's device, ints where it holds
        ints. With ``shardings`` a leaf marked with a ``Mesh`` is this
        rank's block: the template gives its shape (vlocal + 1 rows), and
        the rank's rows are sliced from the saved arena (module
        docstring). Returns (tree, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as data:
            leaves = [data[f"arr_{i}"]
                      for i in range(len(manifest["paths"]))]
        t_leaves = [x for _, x in tree_paths(template)]
        if len(t_leaves) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, template "
                f"{len(t_leaves)}: structure mismatch")
        marks = _sharding_leaves(template, shardings)
        for i, (a, t, mesh) in enumerate(zip(leaves, t_leaves, marks)):
            if mesh is not None:
                leaves[i] = a = _rank_block(a, t, mesh)
            shape = tuple(t.shape) if hasattr(t, "shape") else ()
            if tuple(a.shape) != shape:
                raise ValueError(f"shape mismatch {a.shape} vs {shape}")
        dev = resolve_device(self.device)
        return _unflatten(template, [_place(a, t, dev)
                                     for a, t in zip(leaves, t_leaves)]), \
            manifest


def _rank_block(a: np.ndarray, like, mesh: Mesh) -> np.ndarray:
    """This rank's block (its rows, then a zero sentinel) of a saved
    unsharded arena, for a template block of ``like``'s shape. Saved rows
    past the new shard count's must be zero: they are padding."""
    n, vlocal = mesh.size("model"), like.shape[0] - 1
    if tuple(a.shape[1:]) != tuple(like.shape[1:]):
        raise ValueError(f"shape mismatch {a.shape} vs a block of "
                         f"{tuple(like.shape)}")
    if np.any(a[n * vlocal:]):
        raise ValueError(f"the saved arena has {a.shape[0]} rows, and rows "
                         f"past {n * vlocal} are not zero padding")
    return se.shard_block(torch.from_numpy(np.array(a)), mesh.rank("model"),
                          n, vlocal).numpy()


def reshard_checkpoint(src_dir, template, new_shardings,
                       step: Optional[int] = None, *,
                       device: Optional[Union[str, torch.device]] = None):
    """Elastic rescale: restore a checkpoint onto a new mesh (this rank's
    blocks of it; ``restore(..., shardings=)``), on ``device``."""
    mgr = CheckpointManager(src_dir, keep_n=0, device=device)
    return mgr.restore(template, step=step, shardings=new_shardings)
