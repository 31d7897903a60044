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
   ``RecEngine(max_l=40, max_batch=32)`` for 512 requests. Every serving
   kernel must have launched on that run, the probabilities must be
   finite in (0, 1) and equal, within tolerance, those of the port's CPU
   path on a CPU copy of the same params. Then a few more micro-batches
   say where the time goes: device time per kernel group and the
   device's idle share (torch.profiler on the card), host time per stage
   (on the host).
4. Train: DLRM(1) at full size, batch 32, both modes of
   ``make_train_step_ragged`` (the row-wise sparse step and the
   dense-gradient baseline). (a) ``sls_grad_table`` against its plain
   version at 6,400 and 409,600 positions (two launches bitwise equal,
   and equal bit for bit to the plain version on the CPU, which adds in
   the same order), and ``gemm`` at the backward shapes. (b) A few steps
   of each mode from one set of params on the same numpy batches, each
   on the card and on the CPU path from a copy of the card's state:
   losses, touched rows, MLP params and touched arena rows. (c) Time per step (CUDA events), device busy and
   idle share (torch.profiler), launches per step. (d) The main path:
   an uncached ``OnlineTrainer`` on the card takes those steps again;
   every kernel must launch exactly as often as the step claims, and the
   run must repeat (b)'s card run bit for bit. Then the training
   launcher takes three steps of each mode on the card.
5. Report: one JSON line of the kernels, then the device line, which is
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
from repro_torch.kernels import embedding_gather as eg_k  # noqa: E402
from repro_torch.kernels import feature_interaction as fi_k  # noqa: E402
from repro_torch.kernels import fused_dispatch as fd_k  # noqa: E402
from repro_torch.kernels import gemm as gm_k  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.optim import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import RecEngine, requests_from_ragged_batch  # noqa: E402
from repro_torch.training import OnlineTrainer, unique_padded  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12           # fp32 on the CUDA cores, no tensor cores

BUCKET = 32                        # the serving path's micro-batch
LARGE = 2048                       # samples of the large timing row
MAX_L = 40                         # 2 x lookups_per_table, as served
N_REQUESTS = 512
TRAIN_STEPS = 4                    # steps of each mode, card against CPU
TIMED_STEPS = 20                   # steps per timing trial
LR = 1e-3                          # make_train_step_ragged's default

# launches per served forward and per train step (either mode): a step
# runs the forward (6 gemm), dw of all six layers and dx of five (the
# bottom MLP's input needs none), and one sls_grad_table -- the table
# gradient in the dense mode, the row gradients in the sparse mode
KERNELS = {
    "fused_segment_sum": {
        "module": fd_k,
        "source": "src/repro_torch/kernels/csrc/fused_segment_sum.cu",
        "replaces": "src/repro/kernels/fused_dispatch.py:61",
        "per_forward": 1, "per_step": 1},
    "gemm": {
        "module": gm_k,
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:39",
        "per_forward": 6, "per_step": 17},
    "interaction": {
        "module": fi_k,
        "source": "src/repro_torch/kernels/csrc/interaction.cu",
        "replaces": "src/repro/kernels/feature_interaction.py:30",
        "per_forward": 1, "per_step": 1},
    "sls_grad_table": {
        "module": eg_k,
        "source": "src/repro_torch/kernels/csrc/sls_grad_table.cu",
        "replaces": "src/repro/kernels/embedding_gather.py:188",
        "per_forward": 0, "per_step": 1},
}

# Tolerances, kernel against plain version, both fp32 on the card:
# fused_segment_sum: <= 40 terms of ~1e-2 summed in another order.
# gemm: up to K = 512 products of O(1) values, FMA in order of k against
# cuBLAS's blocked order; relative error grows ~ sqrt(K) * 6e-8.
# interaction: D = 32 products of O(1) values.
# sls_grad_table: g ~ N(0, 1); the plain version on the card adds with
# float atomics, in an order that changes from run to run. A run of k <=
# ~2,200 terms (the hottest Zipf row at 2048 samples) differs between two
# orders by a random walk of ~sqrt(k) * 6e-8 * |partial sum| ~ 1.5e-4;
# five runs on the H100 saw 1.9e-4 to 3.5e-4.
# Against the plain version on the CPU, which adds in the kernel's
# order, the tolerance is 0.
TOL = {"fused_segment_sum": dict(rtol=0.0, atol=1e-6),
       "gemm": dict(rtol=1e-5, atol=1e-5),
       "interaction": dict(rtol=1e-5, atol=1e-5),
       "sls_grad_table": dict(rtol=1e-5, atol=1e-3)}
# served probabilities, card kernels against the CPU path: fp32 logits
# of magnitude <= ~10 through sigmoid (slope <= 1/4)
PROB_ATOL = 1e-5
# train steps, card against the CPU path. Each step starts both from the
# card's state, so differences do not compound. The two sum in other
# orders, ~1e-6 of each value, and two things amplify that:
# * a ReLU pre-activation within rounding of zero is kept on one side and
#   dropped on the other, which changes that one sample's gradient through
#   the unit. The first runs of this phase on the H100 saw one: top MLP
#   layer 0, sample 15, unit 277, +9.0e-7 on the card and -6.4e-7 on the
#   CPU; it moved that sample's d_emb by 1.6e-4 (of 0.037) and no other
#   sample's by more than 3e-8;
# * AdamW's first steps move a param by ~lr * sign(g), so a gradient
#   element whose sign flips moves by 2 lr instead of ~1e-6 lr.
# So per step: the loss (a forward from equal params) to rtol 1e-5, the
# touched rows exactly, and of the updated params all within atol 1e-5
# but for at most 1e-3 of the MLP elements and the rows of two samples'
# bags (2 * T * max_l rows) of the arena, and none further apart than two
# steps of opposite sign: 2 lr (1.01 + wd |p|) for AdamW (|m_hat /
# sqrt(v_hat)| <= 1.002 over the first four steps, by Cauchy-Schwarz over
# the moment weights), 2 * 10 lr * sqrt(D) for row-wise Adagrad (|g_i| /
# rms(g) <= sqrt(D)).
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
MLP_SHARE = 1e-3
ARENA_SAMPLES = 2


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
                          ("interaction", "interaction_kernel"),
                          ("sls_grad_table", "sls_grad_table_kernel")):
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
        if launches[name] != want or (k["per_forward"] and not want):
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


# ---------------------------------------------------------------- phase 4

def _runs(dst: torch.Tensor, null_row: int, n_rows: int) -> dict:
    """Longest run of one destination in a sorted stream, the null row's
    run and padding apart."""
    rows, counts = torch.unique_consecutive(dst, return_counts=True)
    real = (rows != null_row) & (rows < n_rows)
    return {"longest_run": int(counts[real].max()) if real.any() else 0,
            "null_run": int(counts[rows == null_row].sum()),
            "touched_rows": int(real.sum())}


def _sls_part(name: str) -> str:
    low = name.lower()
    if "sls_grad_table_kernel" in name:
        return "kernel"
    if "sort" in low:
        return "sort"
    if "fill" in low or "memset" in low:
        return "zero fill"
    return "other"


def sls_device_parts(fn, reps: int = 20) -> dict:
    """Device ms per call of the wrapper's parts: the kernel, the sort,
    the zero fill and the other small ops (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for name, us in _kernel_times_us(prof).items():
        part = _sls_part(name)
        parts[part] = parts.get(part, 0.0) + us / 1e3 / reps
    return parts


def check_sls_grad_table(cfg, gen) -> tuple:
    """The kernel at the training path's shapes: the dense-gradient
    backward over the dense id form (null row skipped, 6,400 and 409,600
    positions), the sparse step's row gradients, and edge cases."""
    name = "sls_grad_table"
    spec = dlrm.arena_spec(cfg)
    d = spec.dim
    errs = []

    def check(g, ids, off, n_rows, skip, what):
        k1 = eg_k.sls_grad_table(g, ids, off, n_rows=n_rows, skip_row=skip)
        k2 = eg_k.sls_grad_table(g, ids, off, n_rows=n_rows, skip_row=skip)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            fail(f"{name} {what}: two launches differ")
        plain = ref.sls_grad_table(g, ids, off, n_rows)
        cpu = ref.sls_grad_table(g.cpu(), ids.cpu(), off.cpu(), n_rows)
        if skip is not None:
            plain[skip] = 0.0
            cpu[skip] = 0.0
        if not torch.equal(k1.cpu(), cpu):
            fail(f"{name} {what}: differs from the plain version on the "
                 f"CPU by {(k1.cpu() - cpu).abs().max().item()}")
        errs.append(compare(name, k1, plain, what))

    rows = []
    for b in (BUCKET, LARGE):
        ids = serving_dense_ids(cfg, b, seed=13).reshape(-1)
        n_bags = b * cfg.n_tables
        off = torch.arange(n_bags + 1, dtype=torch.int32,
                           device="cuda") * MAX_L
        g = torch.randn((n_bags, d), generator=gen, device="cuda")
        check(g, ids, off, spec.total_rows, spec.null_row,
              f"dense ids, {ids.numel()} positions")
        dst, bag = eg_k.sort_by_destination(ids, off, spec.total_rows)
        runs = _runs(dst, spec.null_row, spec.total_rows)
        valid = (dst != spec.null_row).float()[:, None]
        walked = int(valid.sum())

        def kernel():
            return eg_k.sls_grad_table(g, ids, off, n_rows=spec.total_rows,
                                       skip_row=spec.null_row)

        # the kernel's own bytes: sorted ids and bag ids, the g rows, the
        # touched rows written; the zero fill is a bound of its own
        bound_ms, by = bound(4 * (2 * ids.numel() + n_bags * d
                                  + runs["touched_rows"] * d), walked * d)
        rows.append({
            "samples": b, "positions": ids.numel(), **runs,
            "device_ms_by_part": sls_device_parts(kernel),
            **measure(kernel,
                      lambda: ref.sls_grad_table(g, ids, off,
                                                 spec.total_rows),
                      lambda: torch.zeros(spec.total_rows, d,
                                          device="cuda").index_add_(
                          0, dst, g[bag] * valid)),
            "bound_ms": bound_ms, "bound_by": by,
            "zero_fill_bound_ms": 4 * spec.total_rows * d
            / HBM_BYTES_PER_S * 1e3})
    # the sparse step's use: row gradients over unique-row ids, n_rows = N
    rb = DLRMSynthetic(cfg, seed=14).ragged_batch(
        BUCKET, max_l=MAX_L, pad_to=BUCKET * cfg.n_tables * MAX_L)
    idx = torch.from_numpy(rb["indices"]).cuda()
    off = torch.from_numpy(rb["offsets"]).cuda()
    flat = se.flatten_ragged_indices(spec, idx, off)
    _, inv = unique_padded(flat, spec.null_row)
    g = torch.randn((off.numel() - 1, d), generator=gen, device="cuda")
    check(g, inv.to(torch.int32), off, flat.numel(), None,
          "unique-row ids (sparse step)")
    check(g, flat, off, spec.total_rows, None, "ragged, padded tail")
    # edges: empty bags and a padded tail, D = 16, no ids at all
    small_off = torch.tensor([0, 0, 3, 3, 7, 9], dtype=torch.int32,
                             device="cuda")
    small_ids = torch.randint(0, 6, (12,), generator=gen, device="cuda",
                              dtype=torch.int32)
    check(torch.randn((5, 16), generator=gen, device="cuda"), small_ids,
          small_off, 6, 2, "empty bags, padded tail, D = 16")
    check(torch.randn((5, 16), generator=gen, device="cuda"),
          small_ids[:0].contiguous(), torch.zeros_like(small_off), 6, None,
          "N = 0")
    return max(errs), rows


def check_gemm_backward(params, gen) -> float:
    """The two backward GEMMs of every layer at batch 32: dx = g w^T and
    dw = x^T g, with the transposes made contiguous as the step does."""
    name = "gemm"
    errs = []
    for w, _ in params["bottom"] + params["top"]:
        k, n = w.shape
        gy = torch.randn((BUCKET, n), generator=gen, device="cuda")
        x = torch.randn((BUCKET, k), generator=gen, device="cuda")
        wt, xt = w.t().contiguous(), x.t().contiguous()
        errs.append(compare(name, gm_k.gemm(gy, wt), ref.gemm(gy, wt),
                            f"dx {BUCKET} x {n} x {k}"))
        errs.append(compare(name, gm_k.gemm(xt, gy), ref.gemm(xt, gy),
                            f"dw {k} x {BUCKET} x {n}"))
    return max(errs)


def train_batches(cfg, n: int, seed: int) -> list:
    data = DLRMSynthetic(cfg, seed=seed)
    return [data.ragged_batch(BUCKET, max_l=MAX_L,
                              pad_to=BUCKET * cfg.n_tables * MAX_L)
            for _ in range(n)]


TRAIN_KEYS = ("dense", "indices", "offsets", "labels")


def _copy(tree, device: str):
    return tree_map(lambda t: t.detach().to(device).clone()
                    if isinstance(t, torch.Tensor) else t, tree)


def _beyond(a: torch.Tensor, b: torch.Tensor, budget: int, limit: float,
            what: str) -> dict:
    """Rows of a (card) and b (CPU) with an element further apart than
    PARAM_ATOL: at most `budget` of them, none further than `limit`."""
    d = (a.cpu() - b).abs().reshape(a.shape[0], -1).amax(dim=1)
    out = {"max_abs_err": d.max().item() if d.numel() else 0.0,
           "beyond": int((d > PARAM_ATOL).sum()), "of": d.numel()}
    if out["beyond"] > budget or out["max_abs_err"] > limit:
        fail(f"{what}: {out['beyond']} of {d.numel()} beyond {PARAM_ATOL},"
             f" max {out['max_abs_err']} (limit {limit})")
    return out


def train_card_vs_cpu(cfg, p0, batches, sparse: bool) -> dict:
    """Each step on the card, and on the CPU path from a copy of the card's
    state before it; returns the card's trajectory and the comparisons."""
    mode = "sparse" if sparse else "dense"
    spec = dlrm.arena_spec(cfg)
    opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L, sparse=sparse)
    params = _copy(p0, "cuda")
    state = opt.init(params)
    losses, cmp = [], []
    p_max = max(w.abs().max().item() for w in tree_leaves(
        {k: p0[k] for k in ("bottom", "top")}))
    for i, b in enumerate(batches):
        cpu_params, cpu_state = _copy(params, "cpu"), _copy(state, "cpu")
        params, state, loss, r = step(params, state, {
            k: torch.from_numpy(b[k]).cuda() for k in TRAIN_KEYS})
        cpu_params, cpu_state, cpu_loss, cpu_r = step(
            cpu_params, cpu_state,
            {k: torch.from_numpy(b[k]) for k in TRAIN_KEYS})
        losses.append(float(loss))
        rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        if rel > LOSS_RTOL:
            fail(f"train {mode} step {i}: loss {float(loss)} on the card, "
                 f"{float(cpu_loss)} on the CPU")
        if not torch.equal(r.cpu(), cpu_r):
            fail(f"train {mode} step {i}: touched rows differ")
        touched = r[r != spec.null_row].long()
        mlp_card, mlp_cpu = (torch.cat([t.reshape(-1)
                                        for k in ("bottom", "top")
                                        for t in tree_leaves(p[k])])
                             for p in (params, cpu_params))
        mlp = _beyond(mlp_card, mlp_cpu, int(MLP_SHARE * mlp_cpu.numel()),
                      2 * LR * (1.01 + 0.01 * p_max),
                      f"train {mode} step {i} MLP")
        arena = _beyond(params["arena"][touched],
                        cpu_params["arena"][touched.cpu()],
                        ARENA_SAMPLES * cfg.n_tables * MAX_L,
                        2 * 10 * LR * spec.dim ** 0.5,
                        f"train {mode} step {i} arena rows")
        if params["arena"][spec.null_row].any():
            fail(f"train {mode} step {i}: the null row moved")
        cmp.append({"loss_card": float(loss), "loss_cpu": float(cpu_loss),
                    "loss_rel_err": rel, "mlp": mlp, "arena": arena})
        print(f"  train {mode:6s} step {i}: loss {float(loss):.6f} (card "
              f"vs CPU rel {rel:.1e}); touched rows equal; MLP {mlp['beyond']}"
              f" of {mlp['of']} beyond {PARAM_ATOL} (max {mlp['max_abs_err']:.1e}),"
              f" touched arena rows {arena['beyond']} of {arena['of']} (max "
              f"{arena['max_abs_err']:.1e})")
    return {"params": params, "losses": losses, "steps": cmp}


TRAIN_STAGES = ("sparse_lookup", "emb_lookup", "interaction", "mlp",
                "backward", "optimizer")


def profile_train(cfg, params, batch, sparse: bool) -> dict:
    """Where one train step's time goes (batch 32): ms per step with CUDA
    events (median over trials of TIMED_STEPS steps), device time per
    kernel group and idle share (torch.profiler tracing the card), host
    time per stage (tracing the host), and kernel launches per step."""
    opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L, sparse=sparse)
    state = [opt.init(params)]

    def one():
        _, state[0], _, _ = step(params, state[0], batch)

    before = {n: k["module"].launches for n, k in KERNELS.items()}
    ms = time_ms(one, reps=TIMED_STEPS, trials=5)
    calls = 3 + 5 * TIMED_STEPS
    per_step = {n: (k["module"].launches - before[n]) / calls
                for n, k in KERNELS.items()}
    traces = []
    for activity in (torch.profiler.ProfilerActivity.CUDA,
                     torch.profiler.ProfilerActivity.CPU):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[activity]) as prof:
            for _ in range(TIMED_STEPS):
                one()
            torch.cuda.synchronize()
        traces.append(prof)
    groups = {}
    for kname, us in _kernel_times_us(traces[0]).items():
        g = _kernel_group(kname)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / TIMED_STEPS
    busy = sum(groups.values())
    host = {e.key: e.cpu_time_total / 1e3 / TIMED_STEPS
            for e in traces[1].key_averages() if e.key in TRAIN_STAGES}
    # CUDA runtime calls per step (kernel launches, copies, syncs), from
    # the card's trace, and the host ops that take the most time
    runtime = {e.key: [e.count / TIMED_STEPS,
                       e.cpu_time_total / 1e3 / TIMED_STEPS]
               for e in traces[0].key_averages() if e.key.startswith("cuda")}
    top = sorted(((e.self_cpu_time_total / 1e3 / TIMED_STEPS,
                   e.count / TIMED_STEPS, e.key)
                  for e in traces[1].key_averages()), reverse=True)[:12]
    return {"ms_per_step": ms, "device_ms_per_step": groups,
            "device_busy_ms_per_step": busy,
            "device_idle_share": (1.0 - busy / ms) if busy else None,
            "host_stage_ms_per_step": host, "launches_per_step": per_step,
            "runtime_calls_per_step": runtime,
            "host_top_self_ms_per_step": top}


def phase_train(cfg, gen) -> dict:
    sls_err, sls_rows = check_sls_grad_table(cfg, gen)
    for r in sls_rows:
        print(f"  sls_grad_table     {r['samples']:5d} samples, "
              f"{r['positions']} positions (longest run {r['longest_run']},"
              f" null-row run {r['null_run']}, {r['touched_rows']} rows): "
              f"ms per call (device ms): kernel {r['ms']:.4f} "
              f"({_fmt(r['device_ms'])}), plain {r['plain_ms']:.4f} "
              f"({_fmt(r['plain_device_ms'])}), library "
              f"{r['library_ms']:.4f} ({_fmt(r['library_device_ms'])}), "
              f"bound {r['bound_ms']:.5f} ({r['bound_by']}), zero fill "
              f"bound {r['zero_fill_bound_ms']:.5f}; wrapper's device ms by "
              f"part { {k: round(v, 5) for k, v in r['device_ms_by_part'].items()} }")
    p0 = dlrm.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                   device="cuda")
    gemm_err = check_gemm_backward(p0, gen)
    batches = train_batches(cfg, TRAIN_STEPS, seed=21)
    out = {"sls_grad_table": {"max_abs_err": sls_err, "rows": sls_rows},
           "gemm_backward_max_abs_err": gemm_err}
    for sparse, mode in ((True, "sparse"), (False, "dense")):
        card = train_card_vs_cpu(cfg, p0, batches, sparse)
        out[mode] = {"steps": card["steps"]}
        # the main path: the uncached online trainer on the card
        trainer = OnlineTrainer(cfg, _copy(p0, "cuda"), max_l=MAX_L,
                                sparse=sparse, device="cuda")
        for k in KERNELS.values():
            k["module"].launches = 0
        trainer.train(batches)
        launches = {n: k["module"].launches for n, k in KERNELS.items()}
        for n, k in KERNELS.items():
            if launches[n] != k["per_step"] * TRAIN_STEPS:
                fail(f"train {mode}: {n} launched {launches[n]} times in "
                     f"{TRAIN_STEPS} steps; {k['per_step']} per step")
        if trainer.losses != card["losses"] or not all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(trainer.params),
                    tree_leaves(card["params"]))):
            fail(f"train {mode}: two runs on the card differ")
        print(f"  train {mode:6s} OnlineTrainer on the card: launches "
              f"{launches}; repeats the card run bit for bit")
        out[mode]["launches"] = launches
        batch = {k: torch.from_numpy(batches[0][k]).cuda()
                 for k in TRAIN_KEYS}
        prof = profile_train(cfg, _copy(p0, "cuda"), batch, sparse)
        out[mode]["profile"] = prof
        print(f"  train {mode:6s} per step of {BUCKET}: "
              f"{prof['ms_per_step']:.4f} ms (CUDA events), device "
              f"{prof['device_busy_ms_per_step']:.4f} ms "
              f"{ {k: round(v, 5) for k, v in prof['device_ms_per_step'].items()} }"
              f", idle share {prof['device_idle_share']}")
        print(f"  train {mode:6s} host ms per step inside each stage "
              f"(traced): "
              f"{ {k: round(v, 4) for k, v in prof['host_stage_ms_per_step'].items()} }"
              f"; launches per step {prof['launches_per_step']}")
        print(f"  train {mode:6s} CUDA runtime calls per step [count, host "
              f"ms]: { {k: [round(x, 3) for x in v] for k, v in prof['runtime_calls_per_step'].items()} }")
        print(f"  train {mode:6s} host ops by self ms per step (traced): "
              f"{[(round(t, 3), round(c, 1), k) for t, c, k in prof['host_top_self_ms_per_step']]}")
    # the launcher's --ragged path, on the card by default (no --device)
    for extra in ([], ["--dense-grads"]):
        loss = train_launcher.main(["--arch", "dlrm1", "--ragged", "--steps",
                                    "3", "--log-every", "1", *extra])
        if not np.isfinite(loss):
            fail(f"launcher {extra}: final loss {loss}")
        out[f"launcher_loss{''.join(extra)}"] = loss
    return out


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
    del params
    print("== phase 4: train DLRM(1) at full size")
    trained = phase_train(cfg, gen)
    kernels["sls_grad_table"] = trained["sls_grad_table"]
    kernels["gemm"]["max_abs_err"] = max(
        kernels["gemm"]["max_abs_err"], trained["gemm_backward_max_abs_err"])

    line = {"kernels": []}
    for name, k in KERNELS.items():
        at32 = kernels[name]["rows"][0]
        by_path = {"serve": served["launches"][name],
                   "train_sparse": trained["sparse"]["launches"][name],
                   "train_dense": trained["dense"]["launches"][name]}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": at32["ms"], "plain_ms": at32["plain_ms"],
            "bound_ms": at32["bound_ms"], "bound_by": at32["bound_by"],
            "library_ms": at32["library_ms"],
            # sls_grad_table: the (V, D) output's zero fill, apart from
            # the kernel's own bytes
            **{k: at32[k] for k in ("zero_fill_bound_ms",) if k in at32}})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card, "kernels": kernels, "serve": served,
             "train": trained}, indent=1))
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
