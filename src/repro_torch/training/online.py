"""Online trainer: the ragged training loop.

``OnlineTrainer`` consumes ragged numpy batches and advances the model
and optimizer state with ``dlrm.make_train_step_ragged``. This slice
ports the uncached trainer: the decayed row histogram, the versioned
hot-cache rebuild and write-through, the int8 and tiered maintenance and
the broadcast artifacts wait for the cached sources (ROADMAP Queue 1,
item 9, after item 8), and so does telemetry, which needs the port's copy
of ``repro.obs``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm
from repro_torch.optim import tree_map

_BATCH_KEYS = ("dense", "indices", "offsets", "labels")


class OnlineTrainer:
    """Consume ragged batches on the card (or wherever ``device`` says).

    The train step works in place: ``params`` is moved to ``device`` once
    and from then on the trainer's tensors are updated step by step.
    """

    def __init__(self, cfg: DLRMConfig, params: Dict, *, max_l: int,
                 lr: float = 1e-3, sparse: bool = True,
                 cache_cfg: Optional[Any] = None, mesh: Any = None,
                 telemetry: Optional[Any] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if cache_cfg is not None:
            raise NotImplementedError(
                "the online hot cache (cache_cfg) is not ported yet "
                "(ROADMAP Queue 1, item 9)")
        if telemetry is not None:
            raise NotImplementedError(
                "trainer telemetry needs the port's copy of repro.obs, "
                "not ported yet (ROADMAP Queue 1, item 9)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = dlrm.arena_spec(cfg)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_l = max_l
        opt, self._step = dlrm.make_train_step_ragged(
            cfg, max_l=max_l, lr=lr, sparse=sparse, mesh=mesh)
        self.opt_state = opt.init(self.params)
        self.steps = 0
        self.losses: list = []

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
                for k in _BATCH_KEYS}

    def train_step(self, batch: Dict) -> float:
        """One optimizer step on a numpy batch; returns its loss."""
        self.params, self.opt_state, loss, _ = self._step(
            self.params, self.opt_state, self._to_device(batch))
        self.steps += 1
        loss = float(loss)
        self.losses.append(loss)
        return loss

    def train(self, batches: Iterable[Dict]) -> list:
        for batch in batches:
            self.train_step(batch)
        return self.losses
