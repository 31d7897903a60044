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

``restore(..., shardings=...)`` and ``reshard_checkpoint`` place a
checkpoint onto a mesh: sharding is ROADMAP Queue 1, item 13, and both
refuse it naming that item.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim import tree_paths

_SHARDING = ("placing a checkpoint onto a mesh is sharding, not ported yet "
             "(ROADMAP Queue 1, item 13)")


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

    def save(self, step: int, state, meta: Optional[Dict] = None) -> Path:
        flat = tree_paths(state)
        return self._write(step, [_to_host(x) for _, x in flat],
                           [p for p, _ in flat], meta)

    def save_async(self, step: int, state, meta: Optional[Dict] = None):
        """Copy every leaf to host memory now (a blocking copy from the
        card), write in the background."""
        self.wait()
        flat = tree_paths(state)
        host = [_to_host(x) for _, x in flat]
        paths = [p for p, _ in flat]

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
        ints. Returns (tree, manifest)."""
        if shardings is not None:
            raise NotImplementedError(_SHARDING)
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
        for a, t in zip(leaves, t_leaves):
            shape = tuple(t.shape) if hasattr(t, "shape") else ()
            if tuple(a.shape) != shape:
                raise ValueError(f"shape mismatch {a.shape} vs {shape}")
        dev = resolve_device(self.device)
        return _unflatten(template, [_place(a, t, dev)
                                     for a, t in zip(leaves, t_leaves)]), \
            manifest


def reshard_checkpoint(src_dir, template, new_shardings,
                       step: Optional[int] = None):
    """Elastic rescale onto a new mesh: ROADMAP Queue 1, item 13."""
    raise NotImplementedError(_SHARDING)
