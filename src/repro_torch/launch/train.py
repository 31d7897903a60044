"""Training launcher: DLRM, the paper's workload.

    python -m repro_torch.launch.train --arch dlrm1 --steps 200
    python -m repro_torch.launch.train --arch dlrm1 --ragged --steps 200
    python -m repro_torch.launch.train --arch dlrm1 --ragged --dense-grads
    python -m repro_torch.launch.train --smoke --device cpu

Runs on the card unless ``--device cpu``. Without ``--ragged`` it trains
the fixed-L layout (``DLRMSynthetic.batch``, every bag
``lookups_per_table`` long) with the dense-gradient step
(``dlrm.make_train_step``); ``--ragged`` trains on ragged
SparseLengthsSum batches with the row-wise sparse optimizer, or with
``--dense-grads`` the dense-gradient baseline. Not offered yet, each with
the ROADMAP item it waits for: LM training (Queue 1, item 16),
``--online-cache``/``--quantize-cold`` (item 9), ``--shards``/``--mesh``
(item 13), ``--ckpt-dir``/``--resume`` and the straggler monitor
(item 14), ``--trace`` and ``--metrics-json`` (the ``repro.obs`` copy,
item 9).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import default_device
from repro_torch.configs.dlrm import DLRM_CONFIGS, DLRM_SMOKE
from repro_torch.core import dlrm as dlrm_mod
from repro_torch.data import DLRMSynthetic
from repro_torch.training import OnlineTrainer


def _setup(args):
    cfg = DLRM_SMOKE if args.smoke else DLRM_CONFIGS[args.arch]
    device = (default_device() if args.device == "cuda"
              else torch.device(args.device))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, device, dlrm_mod.init(gen, cfg, device=device)


def train_dlrm(args) -> float:
    """Fixed-L training with the dense-gradient step; returns the last
    step's loss."""
    cfg, device, params = _setup(args)
    opt, step_fn = dlrm_mod.make_train_step(cfg)
    opt_state = opt.init(params)
    data = DLRMSynthetic(cfg, seed=args.seed)
    loss = float("nan")
    for step in range(args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(args.batch_size).items()}
        params, opt_state, loss_t = step_fn(params, opt_state, batch)
        loss = float(loss_t)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({time.time() - t0:.3f}s)")
    print(f"final loss {loss:.4f}")
    return loss


def train_dlrm_ragged(args) -> float:
    """Online ragged training with the row-wise sparse optimizer (or the
    dense-gradient baseline); returns the last step's loss."""
    cfg, device, params = _setup(args)
    max_l = 2 * cfg.lookups_per_table
    trainer = OnlineTrainer(cfg, params, max_l=max_l,
                            sparse=not args.dense_grads, device=device)
    data = DLRMSynthetic(cfg, seed=args.seed)
    pad_to = args.batch_size * cfg.n_tables * max_l
    loss = float("nan")
    for step in range(args.steps):
        t0 = time.time()
        batch = data.ragged_batch(args.batch_size, max_l=max_l,
                                  pad_to=pad_to)
        loss = trainer.train_step(batch)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({time.time() - t0:.3f}s)")
    print(f"final loss {loss:.4f}")
    return loss


def main(argv: Optional[Sequence[str]] = None) -> float:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="dlrm1", choices=sorted(DLRM_CONFIGS),
                   help="a DLRM of paper Table I")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ragged", action="store_true",
                   help="train on ragged SparseLengthsSum batches with the "
                        "row-wise sparse optimizer (default: the fixed-L "
                        "layout, dense-gradient step)")
    p.add_argument("--dense-grads", action="store_true",
                   help="with --ragged: densified-gradient baseline "
                        "instead of the row-wise sparse optimizer")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--ckpt-dir", default=None,
                   help="not ported yet (ROADMAP Queue 1, item 14)")
    p.add_argument("--resume", action="store_true",
                   help="not ported yet (ROADMAP Queue 1, item 14)")
    args = p.parse_args(argv)
    if args.ckpt_dir is not None or args.resume:
        p.error("checkpoints (--ckpt-dir/--resume) are not ported yet "
                "(ROADMAP Queue 1, item 14)")
    if args.ragged:
        return train_dlrm_ragged(args)
    if args.dense_grads:
        p.error("--dense-grads picks the baseline of --ragged; the fixed-L "
                "step is the dense-gradient step")
    return train_dlrm(args)


if __name__ == "__main__":
    main()
