#!/usr/bin/env python3
"""Which side drifts in the card's fp32 decode of kimi-k2's cut: the card
or the CPU path, held against an fp64 pass on each.

    python3 examples/torch_decode_fp64_check.py [--positions 2048]

kimi-k2-1t-a32b at full width (d 7168, 64 query and 8 kv heads of 112,
vocab 163,840 untied) cut to 1 layer and 16 of its 384 experts (top-8
kept): ``chip_smoke.py`` 17(c)'s cut, its weights (seed 1, bf16) and its
prompt (seed 6). Each pass prefills all but the last position and
decodes the last, and gives the decode's logits; every pass's experts
are pinned to the CPU fp64 pass's choices (the router's weights at those
experts, renormalised), so the routing is the same everywhere. The
passes:

* fp64 on the CPU and on the card, the decode cache fp64;
* fp32 on the CPU and on the card (TF32 off; below 2,048 positions the
  prefill attends directly, no kernel), with the bf16 decode cache that
  ``api.prefill`` builds (the setting in which the card's fp32 decode
  lay 1.169e-2 from the CPU path's) and with an fp32 cache.

The model code keeps its fp32 islands in an fp64 pass (the norms, RoPE's
angles, the attention scores, the router and the head's logits compute
in fp32), so fp64 here means the projections, the attention's PV
product, the experts and the residual stream in fp64. It prints each
pass's largest distance from each fp64 pass, the two fp32 passes'
distance from each other, and the card's name and power limit. Runs on the card only: without one it exits non-zero.
"""
import argparse
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import api, moe, transformer  # noqa: E402
from repro_torch.optim import tree_map  # noqa: E402

ARCH, EXPERTS, LAYERS, SEED, PROMPT_SEED = "kimi-k2-1t-a32b", 16, 1, 1, 6


def cut():
    full = registry.get_arch(ARCH)
    return full.replace(n_layers=LAYERS, moe=dataclasses.replace(
        full.moe, n_experts=EXPERTS))


@contextlib.contextmanager
def routes(record=None, pin=None):
    """Every MoE call's expert choices appended to ``record``, or replaced
    by ``pin``'s in call order (the weights renormalised at them)."""
    inner = moe._route
    calls = iter(pin or ())

    def route(xf32, wr, mcfg):
        w, idx, probs = inner(xf32, wr, mcfg)
        if record is not None:
            record.append(idx.cpu())
        if pin is None:
            return w, idx, probs
        want = next(calls).to(idx.device)
        w = torch.gather(probs, -1, want)
        return (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), want,
                probs)
    moe._route = route
    try:
        yield
    finally:
        moe._route = inner


def decode_logits(params, cfg, tokens, cache_dtype) -> torch.Tensor:
    """Prefill all but the last position (cache in ``cache_dtype``), then
    decode the last: its logits (V,) in fp64 on the host."""
    s = tokens.shape[1]
    with torch.inference_mode():
        _, cache = transformer.prefill(params, cfg, {"tokens": tokens[:, :-1]},
                                       s, dtype=cache_dtype)
        logits, _ = transformer.decode_step(params, cfg, cache,
                                            tokens[:, -1], s - 1)
    return logits[0, :cfg.vocab_size].double().cpu()


def one_pass(name, params16, cfg, tokens, device, dtype, cache_dtype,
             pin=None, record=None) -> tuple:
    t0 = time.perf_counter()
    # the bf16 leaves in the pass' dtype; the model's fp32 leaves (the
    # norms, the router) stay fp32, as the model keeps them
    params = tree_map(lambda t: t.to(device=device, dtype=dtype)
                      if t.dtype == torch.bfloat16 else t.to(device),
                      params16)
    cfg_d = cfg.replace(dtype={torch.float32: "float32",
                               torch.float64: "float64"}[dtype])
    with routes(record, pin):
        out = decode_logits(params, cfg_d, tokens.to(device), cache_dtype)
    del params
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"  {name}: {secs:.1f} s")
    return out, secs


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--positions", type=int, default=2048)
    p.add_argument("--out", default=None, help="write the record as JSON")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this check runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card)
    cfg = cut()
    params16 = api.init(torch.Generator(device="cuda").manual_seed(SEED),
                        cfg, device="cuda")
    params16 = tree_map(lambda t: t.cpu(), params16)
    rng = np.random.RandomState(PROMPT_SEED)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (1, args.positions)).astype(np.int32))
    print(f"{ARCH}: {LAYERS} layer, {EXPERTS} experts (top-"
          f"{cfg.moe.top_k}), {args.positions} positions; decode of the "
          "last after a prefill of the rest")
    seen = []
    out, secs = {}, {}
    out["cpu64"], secs["cpu64"] = one_pass(
        "CPU fp64, fp64 cache", params16, cfg, tokens, "cpu", torch.float64,
        torch.float64, record=seen)
    for name, dev, dt, cdt in (
            ("card64", "cuda", torch.float64, torch.float64),
            ("cpu32_bf16cache", "cpu", torch.float32, torch.bfloat16),
            ("card32_bf16cache", "cuda", torch.float32, torch.bfloat16),
            ("cpu32_f32cache", "cpu", torch.float32, torch.float32),
            ("card32_f32cache", "cuda", torch.float32, torch.float32)):
        out[name], secs[name] = one_pass(
            f"{name} (pinned to CPU fp64's {len(seen)} routings)", params16,
            cfg, tokens, dev, dt, cdt, pin=seen)

    def dist(a, b):
        return float((out[a] - out[b]).abs().max())

    rec = {"card": card, "positions": args.positions, "seconds": secs,
           "logits_max_abs": float(out["cpu64"].abs().max()),
           "from_cpu64": {k: dist(k, "cpu64") for k in out if k != "cpu64"},
           "from_card64": {k: dist(k, "card64") for k in out
                           if k != "card64"},
           "card32_vs_cpu32": {"bf16cache": dist("card32_bf16cache",
                                                 "cpu32_bf16cache"),
                               "f32cache": dist("card32_f32cache",
                                                "cpu32_f32cache")}}
    print(f"  max |logit| {rec['logits_max_abs']:.3f}")
    for k, v in rec["from_cpu64"].items():
        print(f"  {k:18s} from CPU fp64 {v:.3e}, from card fp64 "
              f"{rec['from_card64'].get(k, 0.0):.3e}")
    print(f"  card fp32 against CPU fp32: bf16 cache "
          f"{rec['card32_vs_cpu32']['bf16cache']:.3e}, fp32 cache "
          f"{rec['card32_vs_cpu32']['f32cache']:.3e}")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rec, indent=2))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
