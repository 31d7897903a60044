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

Sharded state (a ``launch.mesh.Mesh`` of more than one rank, one process
a rank) stays unsharded on disk, so a checkpoint is readable by either
package at any shard count and on any mesh. ``shardings`` is a tree of
the state's structure (or a prefix of it) whose leaves are:

* a ``Mesh``: the leaf is this rank's block of a row-sharded arena
  (``se.shard_block``: its rows, then a zero sentinel) on the mesh's
  'model' axis; ``row_shardings`` marks a train state's arena leaves;
* a ``distributed.sharding.Sharding``: the leaf is this rank's block
  under the resolved spec on its mesh, of any shape of mesh (an LM's
  params and optimizer moments, ``models.api.train_state_specs``; the
  blocks may differ in size, as the heads split);
* ``None``: replicated, every rank holds it whole.

``save(..., shardings=)`` is collective: the blocks of each sharded leaf
are brought together through host memory by per-owner broadcasts (the
sentinels left out), among the ranks at index 0 of every axis the leaf
is not split over, and one rank writes, the one at index 0 of every
axis, so no data replica writes a block twice. ``restore(...,
shardings=)`` reads one leaf at a time and cuts this rank's block of it
for the mesh it is given, which need only give this rank's coordinates
and the axes' sizes (``reshard_checkpoint``: an elastic rescale, 4 ranks
to 2, or (4, 2) to (2, 4)). A saved arena's padding rows that the new
shard count does not need must be zero, and missing ones are zero.
"""
from __future__ import annotations

import json
import shutil
import struct
import threading
import warnings
import zipfile
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


def _marked(state, shardings, leaf_type):
    """``state``'s structure with a ``_Mark`` a leaf; ``shardings`` may be
    a prefix of it (a leaf of it, a ``leaf_type`` or no container,
    applies to the whole subtree)."""
    if isinstance(shardings, leaf_type) or not isinstance(
            shardings, (dict, list, tuple)):
        return tree_map(lambda t: None if t is None else _Mark(shardings),
                        state)
    if isinstance(state, dict):
        return {k: _marked(state[k], shardings[k], leaf_type) for k in state}
    return type(state)(_marked(a, b, leaf_type)
                       for a, b in zip(state, shardings))


def _ranks(mesh) -> int:
    return int(np.prod([mesh.size(a) for a in mesh.axis_names]))


def _sharding_leaves(state, shardings) -> List[Any]:
    """One sharding a leaf of ``state``, in ``tree_paths`` order: the
    ``Mesh`` of a row-sharded leaf of more than one rank, the
    ``Sharding`` of a leaf on a mesh of more than one rank, else None."""
    # imported here: repro_torch.distributed imports this module
    from repro_torch.distributed.sharding import Sharding
    marks = [x.mesh for _, x in tree_paths(_marked(state, shardings,
                                                   Sharding))]
    out = []
    for m in marks:
        if isinstance(m, Mesh):
            out.append(m if m.size("model") > 1 else None)
        elif isinstance(m, Sharding):
            out.append(m if _ranks(m.mesh) > 1 else None)
        elif m is None:
            out.append(None)
        else:
            raise TypeError(f"a sharding is a repro_torch Mesh (row-"
                            f"sharded), a sharding.Sharding or None, got "
                            f"{type(m).__name__}")
    return out


def _leader(mesh) -> bool:
    return all(mesh.rank(a) == 0 for a in mesh.axis_names)


def _full_shape(block, sh, sharding) -> tuple:
    """The whole leaf's shape of this rank's block under ``sh`` (the
    ``sharding`` module passed in: it imports this one)."""
    shape = list(block.shape)
    for dim, e in enumerate(sh.spec):
        if isinstance(e, sharding.Blocks):
            shape[dim] = sum(e.sizes)
        else:
            for a in sharding.entry_axes(e):
                if a in sh.mesh.axis_names:
                    shape[dim] *= sh.mesh.size(a)
    return tuple(shape)


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
        writes): a sharded leaf whole, gathered from every rank; on a
        rank that does not write, None in place of a gathered leaf."""
        # imported here: repro_torch.distributed imports this module
        from repro_torch.distributed import collectives, sharding
        flat = tree_paths(state)
        marks = _sharding_leaves(state, shardings)
        writer = all(_leader(m if isinstance(m, Mesh) else m.mesh)
                     for m in marks if m is not None)
        host = []
        for (_, x), mark in zip(flat, marks):
            if mark is None:
                host.append(_to_host(x))
            elif isinstance(mark, Mesh):
                host.append(_to_host(collectives.gather_blocks(x, mark)))
            else:
                mesh = mark.mesh
                # the ranks in the writer's line of every axis the leaf
                # is not split over bring its blocks together
                split = {a for e in mark.spec
                         for a in sharding.entry_axes(e)}
                whole = None
                if all(mesh.rank(a) == 0 for a in mesh.axis_names
                       if a not in split):
                    whole = sharding.gather_full(
                        x, mesh, mark.spec, _full_shape(x, mark, sharding))
                host.append(_to_host(whole) if writer else None)
        return host, [p for p, _ in flat], writer

    def save(self, step: int, state, meta: Optional[Dict] = None,
             shardings=None) -> Path:
        """Write ``state`` at ``step``. With ``shardings`` (a tree of
        ``Mesh``/``Sharding``/None, see the module docstring) every rank
        calls this together; the rank at index 0 of every axis writes,
        and all return once it has."""
        host, paths, writer = self._host_leaves(state, shardings)
        final = self.dir / f"step_{step}"
        if writer:
            final = self._write(step, host, paths, meta)
        if any(m is not None for m in _sharding_leaves(state, shardings)):
            # the other ranks return once the writer has published
            dist.barrier()
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
        ints. With ``shardings`` a leaf marked with a ``Mesh`` or a
        ``Sharding`` is this rank's block, which the template's leaf
        shapes, cut from the saved leaf (module docstring); no collective.
        Returns (tree, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        n = len(manifest["paths"])
        t_leaves = [x for _, x in tree_paths(template)]
        if len(t_leaves) != n:
            raise ValueError(
                f"checkpoint has {n} leaves, template "
                f"{len(t_leaves)}: structure mismatch")
        # imported here: repro_torch.distributed imports this module
        from repro_torch.distributed.sharding import local_block
        marks = _sharding_leaves(template, shardings)
        dev = resolve_device(self.device)
        out = []
        with np.load(d / "arrays.npz") as data:
            # one leaf at a time; of a leaf cut by a Sharding, only the
            # block is read
            for i, (t, mark) in enumerate(zip(t_leaves, marks)):
                if isinstance(mark, Mesh):
                    a = _rank_block(data[f"arr_{i}"], t, mark)
                elif mark is not None:
                    a = _mapped(d / "arrays.npz", f"arr_{i}")
                    with warnings.catch_warnings():
                        # read only: the block is copied out
                        warnings.simplefilter("ignore", UserWarning)
                        a = local_block(torch.from_numpy(a), mark.mesh,
                                        mark.spec).numpy()
                else:
                    a = data[f"arr_{i}"]
                shape = tuple(t.shape) if hasattr(t, "shape") else ()
                if tuple(a.shape) != shape:
                    raise ValueError(f"shape mismatch {a.shape} vs {shape}")
                out.append(_place(a, t, dev))
        return _unflatten(template, out), manifest


def _mapped(path: Path, name: str) -> np.ndarray:
    """Member ``name`` of an npz written by ``np.savez`` (stored, not
    compressed), mapped read-only, so that a rank reads the pages of its
    block alone."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(name + ".npy")
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        n_name, n_extra = struct.unpack("<HH", f.read(30)[26:30])
        f.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(f)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        if info.compress_type != zipfile.ZIP_STORED or read is None:
            raise ValueError(f"{path}: {name} is not an uncompressed .npy "
                             f"of version 1.0 or 2.0, as np.savez writes")
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if fortran:
        raise ValueError(f"{path}: {name} is stored in Fortran order")
    return np.memmap(path, dtype=dtype, mode="r", offset=offset,
                     shape=shape)


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
