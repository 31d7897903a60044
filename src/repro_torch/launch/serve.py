"""Serving launcher: batched DLRM inference (the paper's deployment) or LM
decode through the slot-pooled decode engine.

    python -m repro_torch.launch.serve --arch dlrm1 --requests 64
    python -m repro_torch.launch.serve --arch dlrm1 --pipelined \\
        --microbatches 4 --batch-size 32
    python -m repro_torch.launch.serve --smoke --device cpu
    python -m repro_torch.launch.serve --arch dlrm1 --shards 2 \
        --backend gloo|nccl [--rendezvous FILE]
    python -m repro_torch.launch.serve --arch smollm-360m --smoke --device cpu

DLRM: serves fixed-L batches (``DLRMSynthetic.batch``) with random
weights from a seeded generator, through ``dlrm.make_serve_step`` or,
with ``--pipelined``, the two-stream micro-batch pipeline
(``hybrid.make_pipelined_serve_step``), and prints p50/p99 of the time
around each synchronised step, the first (which builds the kernels)
left out. LM (the registry's ids: the dense GQA decoders, the MoE
decoders kimi-k2-1t-a32b and arctic-480b, MLA minicpm3-4b, the
vision-prefix internvl2-2b, which decodes tokens only, the RG-LRU hybrid
recurrentgemma-9b, RWKV-6 rwkv6-7b and the encoder-decoder
seamless-m4t-large-v2, which decodes against zero cross K/V as the
reference's engine does): seeded random
weights, ``--requests`` random prompts of ``--prompt-len`` tokens
decoded for ``--new-tokens`` tokens by a ``DecodeEngine`` of
``--batch-size`` slots and a ``--max-len`` cache, and prints the
engine's latency stats. Runs on the card unless ``--device cpu``. DLRM
``--shards N`` serves row-sharded over an N-way "model" mesh of N ranks
started over ``--backend`` (``nccl``: a card a rank; ``gloo``: CPU ranks
or ranks sharing a card; no default), each serving the same batches;
the ranks' probabilities must agree bit for bit. An LM is served
unsharded whatever ``--mesh`` says, as the reference's ``serve_lm``
serves it (``models.api``'s ``mesh=`` steps shard LM serving).
``--mesh pod|multipod`` serves a DLRM on the reference's production
(data, model) mesh
(``launch.mesh.make_production_mesh``) among the 256 (512) ranks this
process was started with; with fewer it raises the reference's
``RuntimeError``, and it cannot go with ``--shards``.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.configs import registry
from repro_torch.configs.dlrm import DLRM_CONFIGS, DLRM_SMOKE
from repro_torch.core import dlrm as dlrm_mod
from repro_torch.core import sparse_engine as se
from repro_torch.core.hybrid import make_pipelined_serve_step
from repro_torch.data import DLRMSynthetic
from repro_torch.distributed.spawn import (add_shard_args, check_shard_args,
                                           launcher_mesh, mesh_leader,
                                           spawn_launcher)
from repro_torch.models import api
from repro_torch.serving import Batcher, DecodeEngine, Request


def _device(args) -> torch.device:
    return (default_device() if args.device == "cuda"
            else torch.device(args.device))


def serve_dlrm(args, mesh=None) -> Dict[str, float]:
    cfg = DLRM_SMOKE if args.smoke else DLRM_CONFIGS[args.arch]
    device = _device(args)
    params = dlrm_mod.shard_params(
        dlrm_mod.init(torch.Generator(device=device).manual_seed(0), cfg,
                      se.mesh_shards(mesh), device=device), mesh)
    serve = (make_pipelined_serve_step(cfg, args.microbatches, mesh)
             if args.pipelined else dlrm_mod.make_serve_step(cfg, mesh))
    data = DLRMSynthetic(cfg, seed=1)
    lat = []
    for _ in range(max(1, args.requests // args.batch_size)):
        b = data.batch(args.batch_size)
        batch = {k: torch.from_numpy(b[k]).to(device)
                 for k in ("dense", "indices")}
        t0 = time.perf_counter()
        probs = serve(params, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        lat.append(time.perf_counter() - t0)
        if not torch.isfinite(probs).all():
            raise RuntimeError("non-finite probabilities")
    arr = np.array(lat[1:] or lat)   # the first step builds the kernels
    out = {"p50_ms": float(np.percentile(arr, 50) * 1e3),
           "p99_ms": float(np.percentile(arr, 99) * 1e3),
           "steps": len(lat)}
    if mesh_leader(mesh):
        print(f"dlrm serve: {args.requests} reqs, batch {args.batch_size}"
              f"{f', pipelined x{args.microbatches}' if args.pipelined else ''}"
              f"{f', {se.mesh_shards(mesh)} shards' if mesh else ''}"
              f", p50 {out['p50_ms']:.2f} ms p99 {out['p99_ms']:.2f} ms")
    if mesh is not None:
        out["last_probs"] = probs.cpu().numpy()
    return out


def _serve_rank(mesh, args) -> Dict[str, float]:
    """One rank of a ``--shards`` run."""
    return serve_dlrm(args, mesh)


def serve_sharded(args) -> Dict[str, float]:
    """Start ``--shards`` ranks over ``--backend``, each serving the same
    batches; returns rank 0's stats (its last batch's probabilities under
    ``"last_probs"``) once every rank's agree bit for bit."""
    outs = spawn_launcher(_serve_rank, args)
    first = outs[0]["last_probs"]
    for o in outs[1:]:
        if not np.array_equal(o["last_probs"], first):
            raise RuntimeError("the ranks served different probabilities")
    return outs[0]


def serve_lm(args) -> Dict[str, float]:
    cfg = (registry.get_smoke if args.smoke else registry.get_arch)(args.arch)
    device = _device(args)
    params = api.init(torch.Generator(device=device).manual_seed(0), cfg,
                      device=device)
    engine = DecodeEngine(cfg, params, n_slots=args.batch_size,
                          max_len=args.max_len)
    batcher = Batcher(max_batch=args.batch_size)
    rng = np.random.RandomState(0)
    for rid in range(args.requests):
        batcher.submit(Request(
            rid=rid,
            prompt=rng.randint(0, cfg.vocab_size, size=(args.prompt_len,))
            .astype(np.int32),
            max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    while len(engine.latencies) < args.requests:
        if engine.idle():
            wave = batcher.take()
            if not wave:
                break
            engine.admit(wave)
        engine.step()
    wall = time.perf_counter() - t0
    stats = engine.stats()
    print(f"lm serve stats: {stats}, {wall:.2f} s")
    return {**stats, "wall_s": wall}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="dlrm1",
                   help="a DLRM of paper Table I (dlrm1..dlrm6) or an LM: "
                   f"{', '.join(registry.ARCH_IDS)}")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced config (CPU-runnable)")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pipelined", action="store_true",
                   help="overlap sparse/dense via the micro-batch pipeline")
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--new-tokens", type=int, default=8)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    add_shard_args(p, "DLRM: serve row-sharded over an N-way 'model' mesh "
                      "of N ranks")
    args = p.parse_args(argv)
    check_shard_args(p, args, shardable=args.arch in DLRM_CONFIGS)
    if args.arch in registry.ARCHS:
        # as the reference's serve_lm: the LM is served unsharded,
        # whatever --mesh says (no mesh is built)
        return serve_lm(args)
    mesh = launcher_mesh(args)
    if mesh is not None:
        return serve_dlrm(args, mesh)
    if args.arch not in DLRM_CONFIGS:
        p.error(f"unknown arch {args.arch!r}; DLRMs: {sorted(DLRM_CONFIGS)}"
                f", LMs: {sorted(registry.ARCHS)}")
    if args.shards > 1:
        return serve_sharded(args)
    return serve_dlrm(args)


if __name__ == "__main__":
    main()
