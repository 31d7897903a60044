"""Training launcher: DLRM (the paper's workload) and the ported LM archs.

    python -m repro_torch.launch.train --arch dlrm1 --steps 200
    python -m repro_torch.launch.train --arch dlrm1 --ragged --steps 200
    python -m repro_torch.launch.train --arch dlrm1 --ragged --dense-grads
    python -m repro_torch.launch.train --arch dlrm1 --ragged --online-cache \
        [--cache-k 2048 --cache-refresh 50 --quantize-cold] \
        [--metrics-json metrics.json] [--trace]
    python -m repro_torch.launch.train --arch dlrm1 --ragged --steps 200 \
        --ckpt-dir ckpt [--ckpt-every 50] [--resume]
    python -m repro_torch.launch.train --smoke --device cpu
    python -m repro_torch.launch.train --arch dlrm1 --ragged --shards 2 \
        --backend gloo|nccl [--rendezvous FILE]
    python -m repro_torch.launch.train --arch smollm-360m --seq-len 2048 \
        --batch-size 4 --steps 50 [--ckpt-dir ckpt --resume]
    python -m repro_torch.launch.train --arch smollm-360m --smoke \
        --device cpu
    python -m repro_torch.launch.train --arch qwen1.5-4b --smoke \
        --device cpu --shards 2 --backend gloo [--ckpt-dir ckpt --resume]

Runs on the card unless ``--device cpu``. DLRM: without ``--ragged`` it
trains the fixed-L layout (``DLRMSynthetic.batch``, every bag
``lookups_per_table`` long) with the dense-gradient step
(``dlrm.make_train_step``); ``--ragged`` trains on ragged
SparseLengthsSum batches with the row-wise sparse optimizer, or with
``--dense-grads`` the dense-gradient baseline. With ``--ragged``:
``--online-cache`` keeps a live hot-row cache (``--cache-k`` rows,
rebuilt every ``--cache-refresh`` steps, with ``--quantize-cold`` an
int8 cold arena kept incrementally), ``--metrics-json`` writes the
trainer's telemetry snapshot (counters, gauges, histograms and events) at
exit, and ``--trace`` collects host spans and turns the profiler's stage
annotations on. LM (the registry's ids): seeded
random weights, ``LMSynthetic`` batches of ``--batch-size`` x
``--seq-len`` tokens (a ``vlm`` model's patch embeddings cast to bf16,
as the reference casts them, and an encoder-decoder's frame embeddings
too, as its encoder casts them), ``api.make_train_step`` with the default
``layerwise(adamw)`` and global-norm clipping at 1.0. Either way
``--ckpt-dir`` saves (params, optimizer state) every ``--ckpt-every``
steps with ``CheckpointManager.save_async`` and ``--resume`` restarts
after the latest checkpoint there (an LM run draws past the batches of
the steps it skips, so it trains on the batches an uninterrupted run
would); a ``StragglerMonitor`` times every step and the run prints its
count of flagged steps.

LM ``--shards N`` (a decoder, GQA or MLA, dense or MoE, or the
vision-prefix decoder; the other families are ROADMAP Queue 1, item
13e) trains tensor- and sequence-parallel (a MoE expert-parallel) on
the reference's N-way "model" mesh
(``make_mesh((N,), ("model",))``), every rank on the whole batch, its
blocks of the params checkpointed unsharded on disk and resumed on the
mesh; an LM with ``--mesh pod|multipod`` trains on the production mesh,
data-parallel over its data axes.

DLRM ``--shards N`` row-shards the arena over an N-way "model" mesh: the
launcher starts N ranks (``distributed.spawn``, one process a rank) over
the backend ``--backend`` names (``nccl`` when each rank has its own
card, ``gloo`` for CPU ranks or ranks that share one card; there is no
default), joined over the file ``--rendezvous`` (a fresh temporary file
when not given). Every rank trains on the same batches: ``--ragged``
with the sharded sparse step, else the fixed-L dense-gradient step
through the sharded source; checkpoints are collective and unsharded on
disk. Rank 0 prints; the ranks' losses must agree bit for bit.
``--mesh pod|multipod`` trains a DLRM on the reference's production
(data, model) mesh (``launch.mesh.make_production_mesh``) among the 256
(512) ranks this process was started with; with fewer it raises the
reference's ``RuntimeError``, and it cannot go with ``--shards``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import default_device, obs
from repro_torch.checkpoint import CheckpointManager, row_shardings
from repro_torch.configs import registry
from repro_torch.configs.dlrm import DLRM_CONFIGS, DLRM_SMOKE
from repro_torch.core import dlrm as dlrm_mod
from repro_torch.core import sparse_engine as se
from repro_torch.data import DLRMSynthetic, LMSynthetic, make_placer
from repro_torch.distributed import StragglerMonitor
from repro_torch.distributed.spawn import (add_shard_args, check_shard_args,
                                           launcher_mesh, mesh_leader,
                                           spawn_launcher)
from repro_torch.models import api
from repro_torch.training import OnlineCacheConfig, OnlineTrainer


def _device(args) -> torch.device:
    return (default_device() if args.device == "cuda"
            else torch.device(args.device))


def _log(mesh, *text) -> None:
    """Print on rank 0 (every rank of a sharded run trains the same)."""
    if mesh_leader(mesh):
        print(*text)


def _setup(args, mesh=None):
    """(config, device, params): on a mesh the rank's params, its block
    of the arena padded for the shard count."""
    cfg = DLRM_SMOKE if args.smoke else DLRM_CONFIGS[args.arch]
    device = _device(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = dlrm_mod.init(gen, cfg, se.mesh_shards(mesh), device=device)
    return cfg, device, dlrm_mod.shard_params(params, mesh)


def _checkpoints(args, device, state, mesh=None, shardings=None):
    """The run's CheckpointManager (None without ``--ckpt-dir``), the
    state to start from, the first step (after the latest checkpoint with
    ``--resume``, else step 0) and the state's shardings on a mesh (a
    DLRM's row-sharded arena unless ``shardings`` is given)."""
    if shardings is None and se.mesh_shards(mesh) > 1:
        shardings = row_shardings(state, mesh)
    if not args.ckpt_dir:
        return None, state, 0, shardings
    ckpt = CheckpointManager(args.ckpt_dir, device=device)
    latest = ckpt.latest_step()
    if not args.resume or latest is None:
        return ckpt, state, 0, shardings
    state, _ = ckpt.restore(state, step=latest, shardings=shardings)
    _log(mesh, f"resumed from step {latest}")
    return ckpt, state, latest + 1, shardings


def _after_step(args, ckpt, mon, step: int, seconds: float, state,
                shardings=None) -> None:
    """The straggler monitor's record, and the periodic async save."""
    mon.record(step, seconds)
    if ckpt is not None and (step + 1) % args.ckpt_every == 0:
        ckpt.save_async(step, state, shardings=shardings)


def _finish(ckpt, mon, loss: float, mesh=None) -> None:
    if ckpt is not None:
        ckpt.wait()
    _log(mesh, f"straggler events: {len(mon.events)}")
    _log(mesh, f"final loss {loss:.4f}")


def train_dlrm(args, mesh=None) -> float:
    """Fixed-L training with the dense-gradient step (through the sharded
    source on a mesh); returns the last step's loss."""
    cfg, device, params = _setup(args, mesh)
    opt, step_fn = dlrm_mod.make_train_step(cfg, mesh=mesh)
    ckpt, (params, opt_state), start, shardings = _checkpoints(
        args, device, (params, opt.init(params)), mesh)
    mon = StragglerMonitor()
    data = DLRMSynthetic(cfg, seed=args.seed)
    loss = float("nan")
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(args.batch_size).items()}
        params, opt_state, loss_t = step_fn(params, opt_state, batch)
        loss = float(loss_t)
        _after_step(args, ckpt, mon, step, time.time() - t0,
                    (params, opt_state), shardings)
        if step % args.log_every == 0:
            _log(mesh, f"step {step:5d} loss {loss:.4f} "
                 f"({time.time() - t0:.3f}s)")
    _finish(ckpt, mon, loss, mesh)
    return loss


def train_dlrm_ragged(args, mesh=None) -> float:
    """Online ragged training with the row-wise sparse optimizer (the
    sharded one on a mesh) or the dense-gradient baseline, and optionally
    a live hot-row cache that re-ranks itself from the decayed histogram;
    returns the last step's loss."""
    cfg, device, params = _setup(args, mesh)
    max_l = 2 * cfg.lookups_per_table
    cache_cfg = None
    if args.online_cache:
        cache_cfg = OnlineCacheConfig(k=args.cache_k,
                                      refresh_every=args.cache_refresh,
                                      quantize_cold=args.quantize_cold)
    telemetry = obs.Telemetry(tracing=args.trace)
    if args.trace:
        obs.enable_stage_annotations(True)
    trainer = OnlineTrainer(cfg, params, max_l=max_l,
                            sparse=not args.dense_grads, cache_cfg=cache_cfg,
                            mesh=mesh, telemetry=telemetry, device=device)
    ckpt, (trainer.params, trainer.opt_state), start, shardings = \
        _checkpoints(args, device, (trainer.params, trainer.opt_state),
                     mesh)
    mon = StragglerMonitor()
    data = DLRMSynthetic(cfg, seed=args.seed)
    pad_to = args.batch_size * cfg.n_tables * max_l
    loss = float("nan")
    for step in range(start, args.steps):
        t0 = time.time()
        batch = data.ragged_batch(args.batch_size, max_l=max_l,
                                  pad_to=pad_to)
        loss = trainer.train_step(batch)
        _after_step(args, ckpt, mon, step, time.time() - t0,
                    (trainer.params, trainer.opt_state), shardings)
        if step % args.log_every == 0:
            extra = (f" cache v{trainer.version}" if args.online_cache
                     else "")
            _log(mesh, f"step {step:5d} loss {loss:.4f} "
                 f"({time.time() - t0:.3f}s){extra}")
    _finish(ckpt, mon, loss, mesh)
    if args.metrics_json and mesh_leader(mesh):
        with open(args.metrics_json, "w") as f:
            json.dump(telemetry.snapshot(), f, indent=2, default=str)
        print(f"metrics snapshot -> {args.metrics_json}")
    return loss


def train_lm(args, mesh=None) -> Tuple[float, Any]:
    """LM training with ``api.make_train_step``; returns the last step's
    loss and the final (params, optimizer state). On ``mesh`` each rank
    holds its blocks of the params and trains on its share of each
    batch (``api.batch_specs``), and the state is this rank's."""
    cfg = (registry.get_smoke if args.smoke else registry.get_arch)(args.arch)
    device = _device(args)
    params = api.init(torch.Generator(device=device).manual_seed(args.seed),
                      cfg, device=device)
    params = api.shard_params(params, cfg, mesh)
    opt_name, opt, step_fn = api.make_train_step(cfg, mesh=mesh)
    # on a mesh, the state's shardings (api.train_state_specs)
    shardings = (api.train_state_specs(cfg, opt_name, opt, mesh)[:2]
                 if mesh is not None else None)
    ckpt, (params, opt_state), start, shardings = _checkpoints(
        args, device, (params, opt.init(params)), mesh, shardings)
    place = make_placer(device, mesh,
                        api.batch_specs(cfg, mesh) if mesh else None)
    mon = StragglerMonitor()
    data = LMSynthetic(cfg, seed=args.seed)
    for _ in range(start):
        data.batch(args.batch_size, args.seq_len)
    loss = float("nan")
    for step in range(start, args.steps):
        t0 = time.time()
        batch = place(data.batch(args.batch_size, args.seq_len))
        for k in ("patches", "frames"):
            if k in batch:
                batch[k] = batch[k].to(torch.bfloat16)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        _after_step(args, ckpt, mon, step, time.time() - t0,
                    (params, opt_state), shardings)
        if step % args.log_every == 0:
            _log(mesh, f"step {step:5d} loss {loss:.4f} "
                 f"gnorm {float(metrics['grad_norm']):.3f} "
                 f"({time.time() - t0:.3f}s)")
    _finish(ckpt, mon, loss, mesh)
    return loss, (params, opt_state)


DLRM_ONLY = ("ragged", "dense_grads", "online_cache", "quantize_cold",
             "metrics_json", "trace")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The launcher's arguments, checked (``SystemExit`` on a bad
    combination)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="dlrm1",
                   help=f"a DLRM of paper Table I ({', '.join(DLRM_CONFIGS)})"
                        f" or an LM ({', '.join(registry.ARCH_IDS)})")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced config (CPU-runnable)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=64,
                   help="LM: tokens a sequence")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ragged", action="store_true",
                   help="train on ragged SparseLengthsSum batches with the "
                        "row-wise sparse optimizer (default: the fixed-L "
                        "layout, dense-gradient step)")
    p.add_argument("--dense-grads", action="store_true",
                   help="with --ragged: densified-gradient baseline "
                        "instead of the row-wise sparse optimizer")
    p.add_argument("--online-cache", action="store_true",
                   help="with --ragged: maintain a live versioned hot-row "
                        "cache from the decayed trace histogram")
    p.add_argument("--cache-k", type=int, default=2048)
    p.add_argument("--cache-refresh", type=int, default=50)
    p.add_argument("--quantize-cold", action="store_true",
                   help="with --online-cache: maintain an int8 cold "
                        "arena incrementally (only rows touched since "
                        "the last rebuild are re-quantized)")
    p.add_argument("--metrics-json", default=None,
                   help="with --ragged: write the telemetry registry "
                        "snapshot (counters/gauges/histograms + swap "
                        "events) to this path at exit")
    p.add_argument("--trace", action="store_true",
                   help="with --ragged: collect host spans and enable the "
                        "profiler's stage annotations")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--ckpt-dir", default=None,
                   help="save (params, optimizer state) here every "
                        "--ckpt-every steps, in the background")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="with --ckpt-dir: start after its latest "
                        "checkpoint")
    add_shard_args(p, "DLRM: row-shard the embedding arena over an N-way "
                      "'model' mesh of N ranks (with --ragged the sparse "
                      "optimizer applies shard-local row updates); a "
                      "decoder or vision-prefix LM: tensor- and "
                      "sequence-parallel over it")
    args = p.parse_args(argv)
    check_shard_args(p, args, shardable=args.arch in DLRM_CONFIGS
                     or _lm_shards(args.arch), what="row-shards a DLRM arena "
                     "or shards a decoder LM (the other LM families are "
                     "ROADMAP Queue 1, item 13e)")
    if args.resume and not args.ckpt_dir:
        p.error("--resume goes with --ckpt-dir")
    if args.ckpt_every < 1:
        p.error("--ckpt-every must be at least 1")
    if args.arch not in DLRM_CONFIGS:
        try:
            registry.get_arch(args.arch)
        except KeyError as e:
            p.error(str(e))
        if any(getattr(args, f) for f in DLRM_ONLY):
            p.error("--" + ", --".join(f.replace("_", "-") for f in DLRM_ONLY)
                    + " are DLRM options")
        return args
    if (args.online_cache or args.quantize_cold or args.metrics_json
            or args.trace) and not args.ragged:
        p.error("--online-cache, --quantize-cold, --metrics-json and "
                "--trace go with --ragged")
    if args.quantize_cold and not args.online_cache:
        p.error("--quantize-cold goes with --online-cache")
    if args.dense_grads and not args.ragged:
        p.error("--dense-grads picks the baseline of --ragged; the fixed-L "
                "step is the dense-gradient step")
    return args


def _lm_shards(arch: str) -> bool:
    """Whether the LM ``arch`` runs on a mesh (its family's logical axes
    are ported; the others are ROADMAP Queue 1, item 13e)."""
    return arch in registry.ARCHS and api.mesh_ported(registry.get_arch(arch))


def _train_rank(mesh, args) -> float:
    """One rank of a ``--shards`` run."""
    if args.arch not in DLRM_CONFIGS:
        return train_lm(args, mesh)[0]
    if args.ragged:
        return train_dlrm_ragged(args, mesh)
    return train_dlrm(args, mesh)


def train_sharded(args) -> float:
    """Start ``--shards`` ranks over ``--backend`` and train on each;
    returns the last loss, which every rank must have computed alike."""
    losses = spawn_launcher(_train_rank, args)
    if len({repr(x) for x in losses}) != 1:
        raise RuntimeError(f"the ranks' losses differ: {losses}")
    return losses[0]


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Train as the arguments say; returns the last step's loss."""
    args = parse_args(argv)
    mesh = launcher_mesh(args)
    if mesh is not None:
        if args.arch not in DLRM_CONFIGS:
            return train_lm(args, mesh)[0]
        return (train_dlrm_ragged if args.ragged else train_dlrm)(args,
                                                                   mesh)
    if args.shards > 1:
        return train_sharded(args)
    if args.arch not in DLRM_CONFIGS:
        return train_lm(args)[0]
    if args.ragged:
        return train_dlrm_ragged(args)
    return train_dlrm(args)


if __name__ == "__main__":
    main()
