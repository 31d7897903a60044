#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py [--out FILE]

Phases, in order; any failure raises and the script exits non-zero:

1. Card: print the card's name and power limit (nvidia-smi), build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` and print the build
   time and ptxas's report.
2. Kernels: at the serving path's shapes (bucket 32) and at edge shapes,
   hold each kernel against its plain PyTorch version on the card under
   a stated tolerance; time kernel, plain version, the one PyTorch call
   that computes the same function (``library_ms``, a yardstick the port
   never calls) and the least time the card could take (``bound_ms``),
   at bucket 32 and at 2048 samples, with CUDA events (median).
3. Serve: DLRM(1) at full size (5 x 200,000 x 32 fp32 arena, MLPs
   13-512-256-32 and 47-512-256-1) from a seeded generator, served by
   ``RecEngine(max_l=40, max_batch=32)`` for 512 requests. Every kernel
   must have launched on that run, the probabilities must be finite in
   (0, 1) and equal, within tolerance, those of the port's CPU path on a
   CPU copy of the same params. Then a few more micro-batches say where
   the time goes: device time per kernel group and the device's idle
   share (torch.profiler on the card), host time per stage (on the host).
4. Report: one JSON line of the kernels, then the device line, which is
   always the last line of the output.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.dlrm import DLRM_CONFIGS  # noqa: E402
from repro_torch.core import dlrm  # noqa: E402
from repro_torch.core import sparse_engine as se  # noqa: E402
from repro_torch.data import DLRMSynthetic  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import feature_interaction as fi_k  # noqa: E402
from repro_torch.kernels import fused_dispatch as fd_k  # noqa: E402
from repro_torch.kernels import gemm as gm_k  # noqa: E402
from repro_torch.serving import RecEngine, requests_from_ragged_batch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12           # fp32 on the CUDA cores, no tensor cores

BUCKET = 32                        # the serving path's micro-batch
LARGE = 2048                       # samples of the large timing row
MAX_L = 40                         # 2 x lookups_per_table, as served
N_REQUESTS = 512

KERNELS = {
    "fused_segment_sum": {
        "module": fd_k,
        "source": "src/repro_torch/kernels/csrc/fused_segment_sum.cu",
        "replaces": "src/repro/kernels/fused_dispatch.py:61",
        "per_forward": 1},
    "gemm": {
        "module": gm_k,
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:39",
        "per_forward": 6},
    "interaction": {
        "module": fi_k,
        "source": "src/repro_torch/kernels/csrc/interaction.cu",
        "replaces": "src/repro/kernels/feature_interaction.py:30",
        "per_forward": 1},
}

# Tolerances, kernel against plain version, both fp32 on the card:
# fused_segment_sum: <= 40 terms of ~1e-2 summed in another order.
# gemm: up to K = 512 products of O(1) values, FMA in order of k against
# cuBLAS's blocked order; relative error grows ~ sqrt(K) * 6e-8.
# interaction: D = 32 products of O(1) values.
TOL = {"fused_segment_sum": dict(rtol=0.0, atol=1e-6),
       "gemm": dict(rtol=1e-5, atol=1e-5),
       "interaction": dict(rtol=1e-5, atol=1e-5)}
# served probabilities, card kernels against the CPU path: fp32 logits
# of magnitude <= ~10 through sigmoid (slope <= 1/4)
PROB_ATOL = 1e-5


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int = 20, trials: int = 15) -> float:
    """Median over trials of the mean time of `reps` back-to-back calls,
    with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out))


def _kernel_times_us(prof) -> dict:
    """Device time (us) per kernel name from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def device_ms(fn, reps: int = 20):
    """Mean device time per call, summed over every kernel `fn` runs, from
    torch.profiler's CUPTI trace; None when the trace holds no device
    time. Unlike `time_ms`, the host's launch cost is not in it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(_kernel_times_us(prof).values())
    return total / 1e3 / reps if total > 0 else None


def measure(kernel, plain, library) -> dict:
    """Per-call times of a kernel, its plain version and the library call:
    host-inclusive (CUDA events around back-to-back calls) and device-only
    (profiler)."""
    return {"ms": time_ms(kernel), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library), "device_ms": device_ms(kernel),
            "plain_device_ms": device_ms(plain),
            "library_device_ms": device_ms(library)}


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            what: str) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name} {what}: {tuple(got.shape)} {got.dtype} against "
             f"{tuple(want.shape)} {want.dtype}")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got, want, **TOL[name]):
        fail(f"{name} {what}: max |kernel - plain| = {err} over {TOL[name]}")
    print(f"  {name:18s} {what:34s} max_abs_err {err:.3e}")
    return err


# ---------------------------------------------------------------- phase 1

def phase_card() -> dict:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs "
                 "the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s for {len(libs)} libraries "
          f"({', '.join(sorted(libs))})")
    for name, log in _build.build_logs().items():
        print(f"--- nvcc {name}\n{log.strip()}")
    return {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
            "build_s": build_s}


# ---------------------------------------------------------------- phase 2

def serving_dense_ids(cfg, batch_size: int, seed: int) -> torch.Tensor:
    """The dense id matrix the serving path hands the kernel: a poisson
    ragged batch, flattened into the arena and relayouted to max_l."""
    rb = DLRMSynthetic(cfg, seed=seed).ragged_batch(
        batch_size, dist="poisson", max_l=MAX_L,
        pad_to=batch_size * cfg.n_tables * MAX_L)
    spec = dlrm.arena_spec(cfg)
    idx = torch.from_numpy(rb["indices"]).cuda()
    off = torch.from_numpy(rb["offsets"]).cuda()
    flat = se.flatten_ragged_indices(spec, idx, off)
    return se.ragged_dense_ids(flat, off, max_l=MAX_L, fill=spec.null_row)


def check_fused(arena, cfg, gen) -> tuple:
    name = "fused_segment_sum"
    errs = []
    ids32 = serving_dense_ids(cfg, BUCKET, seed=11)
    errs.append(compare(name, fd_k.fused_segment_sum(arena, ids32),
                        ref.fused_segment_sum(arena, ids32),
                        f"ids {tuple(ids32.shape)}"))
    empty = ids32[:, :0].contiguous()
    errs.append(compare(name, fd_k.fused_segment_sum(arena, empty),
                        torch.zeros(ids32.shape[0], arena.shape[1],
                                    device="cuda"), "max_l = 0"))
    small = torch.randn((50, 16), generator=gen, device="cuda")
    small_ids = torch.randint(0, 50, (9, 7), generator=gen, device="cuda",
                              dtype=torch.int32)
    errs.append(compare(name, fd_k.fused_segment_sum(small, small_ids),
                        ref.fused_segment_sum(small, small_ids),
                        "D = 16, B = 9, max_l = 7"))
    rows = []
    for ids in (ids32, serving_dense_ids(cfg, LARGE, seed=12)):
        b, l = ids.shape
        d = arena.shape[1]
        touched = torch.unique(ids).numel()
        bound_ms, by = bound(4 * (ids.numel() + touched * d + b * d),
                             ids.numel() * d)
        rows.append({
            "samples": b // cfg.n_tables, "shape": [b, l, d],
            **measure(lambda: fd_k.fused_segment_sum(arena, ids),
                      lambda: ref.fused_segment_sum(arena, ids),
                      lambda: F.embedding_bag(ids, arena, mode="sum")),
            "bound_ms": bound_ms, "bound_by": by})
    return max(errs), rows


def check_gemm(params, gen) -> tuple:
    name = "gemm"
    layers = [w for w, _ in params["bottom"]] + [w for w, _ in params["top"]]
    errs = []
    for m in (BUCKET, 1):
        for w in layers:
            x = torch.randn((m, w.shape[0]), generator=gen, device="cuda")
            errs.append(compare(name, gm_k.gemm(x, w), ref.gemm(x, w),
                                f"{m} x {w.shape[0]} x {w.shape[1]}"))
    x = torch.randn((33, 70), generator=gen, device="cuda")
    w = torch.randn((70, 65), generator=gen, device="cuda")
    errs.append(compare(name, gm_k.gemm(x, w), ref.gemm(x, w),
                        "33 x 70 x 65 (tile edges)"))
    rows = []
    for m in (BUCKET, LARGE):
        row = {"samples": m, "shape": [], "bound_ms": 0.0, "bytes": 0,
               "flops": 0}
        for w in layers:
            k, n = w.shape
            x = torch.randn((m, k), generator=gen, device="cuda")
            row["shape"].append([m, k, n])
            for key, v in measure(lambda: gm_k.gemm(x, w),
                                  lambda: ref.gemm(x, w),
                                  lambda: torch.matmul(x, w)).items():
                # the six layers' sum; None once any layer has no trace
                row[key] = (None if v is None or row.get(key, 0.0) is None
                            else row.get(key, 0.0) + v)
            row["bytes"] += 4 * (m * k + k * n + m * n)
            row["flops"] += 2 * m * k * n
            row["bound_ms"] += bound(4 * (m * k + k * n + m * n),
                                     2 * m * k * n)[0]
        row["bound_by"] = bound(row["bytes"], row["flops"])[1]
        rows.append(row)
    return max(errs), rows


def check_interaction(cfg, gen) -> tuple:
    name = "interaction"
    f, d = cfg.n_interact_features, cfg.emb_dim
    errs = []
    for shape in ((BUCKET, f, d), (1, f, d), (9, f, d), (3, 4, 16)):
        x = torch.randn(shape, generator=gen, device="cuda")
        errs.append(compare(name, fi_k.interaction(x), ref.interaction(x),
                            f"x {shape}"))
    rows = []
    for b in (BUCKET, LARGE):
        x = torch.randn((b, f, d), generator=gen, device="cuda")
        xt = x.transpose(1, 2)
        bound_ms, by = bound(4 * (b * f * d + b * f * f), 2 * b * f * f * d)
        rows.append({
            "samples": b, "shape": [b, f, d],
            **measure(lambda: fi_k.interaction(x),
                      lambda: ref.interaction(x),
                      lambda: torch.bmm(x, xt)),
            "bound_ms": bound_ms, "bound_by": by})
    return max(errs), rows


def phase_kernels(cfg, params, gen) -> dict:
    out = {}
    for name, (err, rows) in (
            ("fused_segment_sum", check_fused(params["arena"], cfg, gen)),
            ("gemm", check_gemm(params, gen)),
            ("interaction", check_interaction(cfg, gen))):
        out[name] = {"max_abs_err": err, "rows": rows}
        for r in rows:
            print(f"  {name:18s} {r['samples']:5d} samples, ms per call "
                  f"(device ms): kernel {r['ms']:.4f} "
                  f"({_fmt(r['device_ms'])}), plain {r['plain_ms']:.4f} "
                  f"({_fmt(r['plain_device_ms'])}), library "
                  f"{r['library_ms']:.4f} ({_fmt(r['library_device_ms'])}), "
                  f"bound {r['bound_ms']:.5f} ({r['bound_by']})")
    return out


# ---------------------------------------------------------------- phase 3

def serve(cfg, params, device: str):
    """512 requests, sent by the client 32 at a time: each group is
    stamped when it is sent and served by one engine step."""
    engine = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                       device=device)
    engine.warmup()
    rb = DLRMSynthetic(cfg, seed=7).ragged_batch(N_REQUESTS, dist="poisson",
                                                 max_l=MAX_L)
    reqs = requests_from_ragged_batch(rb, cfg.n_tables)
    if device == "cuda":
        for k in KERNELS.values():
            k["module"].launches = 0
    for i in range(0, len(reqs), BUCKET):
        sent = time.monotonic()
        for r in reqs[i:i + BUCKET]:
            r.submitted_mono = sent
            engine.submit(r)
        engine.step()
    engine.drain()
    return engine, np.array([r.prob for r in reqs], np.float64)


def _kernel_group(name: str) -> str:
    for group, symbol in (("fused_segment_sum", "fused_segment_sum_kernel"),
                          ("gemm", "gemm_f32_kernel"),
                          ("interaction", "interaction_kernel")):
        if symbol in name:
            return group
    low = name.lower()
    return "copies" if "memcpy" in low or "memset" in low else "torch ops"


STAGES = ("sparse_lookup", "emb_lookup", "interaction", "mlp")


def profile_serve(engine, cfg, n_batches: int = 4) -> dict:
    """Where a served micro-batch's time goes. Three passes of n_batches
    micro-batches of 32: plain (host clock), under torch.profiler tracing
    the card (device time per kernel group), and tracing the host (time
    inside each stage's record_function span). The device's idle share is
    1 - device time / plain host time per batch. The profiled passes run
    slower than the plain one; their times are for shares, not totals."""
    activities = (None, torch.profiler.ProfilerActivity.CUDA,
                  torch.profiler.ProfilerActivity.CPU)
    walls, traces = [], []
    for seed, activity in zip((8, 9, 10), activities):
        rb = DLRMSynthetic(cfg, seed=seed).ragged_batch(
            n_batches * BUCKET, dist="poisson", max_l=MAX_L)
        reqs = requests_from_ragged_batch(rb, cfg.n_tables)
        torch.cuda.synchronize()
        with (torch.profiler.profile(activities=[activity])
              if activity is not None else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            for i in range(0, len(reqs), BUCKET):
                for r in reqs[i:i + BUCKET]:
                    engine.submit(r)
                engine.step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / n_batches)
        traces.append(prof)
    by_name = _kernel_times_us(traces[1])
    groups = {}
    for name, us in by_name.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / n_batches
    busy = sum(groups.values())
    host = {e.key: e.cpu_time_total / 1e3 / n_batches
            for e in traces[2].key_averages() if e.key in STAGES}
    return {"batches": n_batches, "wall_ms_per_batch": walls[0],
            "device_traced_wall_ms_per_batch": walls[1],
            "host_traced_wall_ms_per_batch": walls[2],
            "device_ms_per_batch": groups, "device_busy_ms_per_batch": busy,
            "device_idle_share": (1.0 - busy / walls[0]) if busy else None,
            "host_stage_ms_per_batch": host,
            "device_us_by_kernel": by_name}


def phase_serve(cfg, params) -> dict:
    t0 = time.perf_counter()
    engine, probs = serve(cfg, params, "cuda")
    serve_s = time.perf_counter() - t0
    launches = {name: k["module"].launches for name, k in KERNELS.items()}
    stats = engine.stats()
    print(f"  served {engine.served} requests in {engine.batches} batches "
          f"({serve_s:.2f} s with warmup); launches {launches}")
    print(f"  stats {stats}")
    if engine.served != N_REQUESTS:
        fail(f"served {engine.served} of {N_REQUESTS} requests")
    for name, k in KERNELS.items():
        want = k["per_forward"] * engine.batches
        if launches[name] == 0 or launches[name] != want:
            fail(f"{name} launched {launches[name]} times on the main path; "
                 f"{k['per_forward']} per forward x {engine.batches} "
                 f"forwards = {want}")
    if not (np.isfinite(probs).all() and (probs > 0).all()
            and (probs < 1).all()):
        fail("probabilities outside (0, 1) or not finite")
    cpu_params = {"bottom": [(w.cpu(), b.cpu()) for w, b in params["bottom"]],
                  "top": [(w.cpu(), b.cpu()) for w, b in params["top"]],
                  "arena": params["arena"].cpu()}
    _, cpu_probs = serve(cfg, cpu_params, "cpu")
    err = float(np.abs(probs - cpu_probs).max())
    print(f"  card vs CPU path: max |prob diff| {err:.3e} (atol {PROB_ATOL})")
    if err > PROB_ATOL:
        fail(f"card probabilities differ from the CPU path by {err}")
    prof = profile_serve(engine, cfg)
    print(f"  per micro-batch of {BUCKET}: host {prof['wall_ms_per_batch']:.4f}"
          f" ms, device {prof['device_busy_ms_per_batch']:.4f} ms "
          f"{ {k: round(v, 5) for k, v in prof['device_ms_per_batch'].items()} }"
          f", device idle share {prof['device_idle_share']}")
    print(f"  host ms per micro-batch inside each stage (traced, "
          f"{prof['host_traced_wall_ms_per_batch']:.4f} ms per batch): "
          f"{ {k: round(v, 4) for k, v in prof['host_stage_ms_per_batch'].items()} }")
    return {"launches": launches, "stats": stats, "batches": engine.batches,
            "serve_s": serve_s, "prob_max_abs_err": err,
            "prob_range": [float(probs.min()), float(probs.max())],
            "profile": prof}


# ---------------------------------------------------------------- main

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    print("== phase 1: card")
    card = phase_card()
    cfg = DLRM_CONFIGS["dlrm1"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dlrm.init(gen, cfg, device="cuda")
    print("== phase 2: kernels against their plain versions")
    kernels = phase_kernels(cfg, params, gen)
    print("== phase 3: serve DLRM(1) at full size")
    served = phase_serve(cfg, params)

    line = {"kernels": []}
    for name, k in KERNELS.items():
        at32 = kernels[name]["rows"][0]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": served["launches"][name],
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": at32["ms"], "plain_ms": at32["plain_ms"],
            "bound_ms": at32["bound_ms"], "bound_by": at32["bound_by"],
            "library_ms": at32["library_ms"]})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card, "kernels": kernels, "serve": served}, indent=1))
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        fail(f"imported the JAX side: {leaked[:5]}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
