#!/usr/bin/env python3
"""A short check of the port's ``gemm`` kernel on one card.

    python3 examples/torch_gemm_check.py [--json FILE]

Builds the CUDA kernels and prints ptxas's report for ``gemm``
(registers a thread, shared memory, spills); launches each layout once
at a small shape and holds it against its plain version before anything
larger. Then, at DLRM(1)'s six layers (13-512-256-32 and 47-512-256-1)
for M = 1, 8, 32, 64, 65 and 2048, at the 33 x 70 x 65 edge case and at
the backward shapes at batch 32 and 2048 (dx = g w^T, dw = x^T g),
prints for each product the largest difference from the plain version
and whether it is within rtol = atol = 1e-5 (``chip_smoke.py``'s
``TOL["gemm"]``), the kernel's and the plain version's distance from the
fp64 product, whether two launches give the same bits and, for M <= 64,
whether rows 0..m-1 of an M = 64 product equal the m-row product bit for
bit. Then it times, with CUDA events around back-to-back calls and with
the profiler's device time, the six forward layers at M = 32 and 2048
beside ``torch.matmul``, the backward's two products per layer at batch
32 and 2048 as the tree's ``kernels/ops.py`` computes them (with the
transposed copies where the tree makes them) beside ``torch.matmul(g,
w.t())`` and ``torch.matmul(x.t(), g)``, and one sparse train step of
DLRM(1) at batch 32: its kernels on the card and the gemm's device ms.
``chip_smoke.py`` runs the full check; this is the quick one.

It imports ``repro_torch`` from the ``src`` beside it and calls only
public entries, so a copy placed in an older checkout times that
checkout's kernel (the accuracy part needs the three layouts and is
skipped there): run the two in turns to compare them on one card. The
last line is one JSON object of the times.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.dlrm import DLRM_CONFIGS  # noqa: E402
from repro_torch.core import dlrm  # noqa: E402
from repro_torch.data import DLRMSynthetic  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import gemm as gm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BATCHES = (32, 2048)
MAX_L = 40
HAS_LAYOUTS = hasattr(gm, "gemm_nt")
# the gemm kernels' symbols on this tree and on older ones
GEMM_SYMBOLS = ("gemm_f32_kernel", "gemm_splitk_cluster_kernel",
                "gemm_tf32x3_kernel")


def dx_fn(g, w):
    """dx = g w^T as the tree's backward computes it."""
    if HAS_LAYOUTS:
        return lambda: gm.gemm_nt(g, w)
    return lambda: gm.gemm(g, w.t().contiguous())


def dw_fn(x, g):
    """dw = x^T g as the tree's backward computes it."""
    if HAS_LAYOUTS:
        return lambda: gm.gemm_tn(x, g)
    return lambda: gm.gemm(x.t().contiguous(), g)


def events_ms(fn, reps: int = 20, trials: int = 9) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return float(np.median(out))


def device_ms(fn, reps: int = 20) -> tuple:
    """(device ms a call, kernels a call) from the profiler's trace; a
    trace that comes back empty (the profiler has lost one) is taken
    once more."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t > 0:
                us += t
                n += e.count
        if us > 0:
            break
    return us / 1e3 / reps, n / reps


def check(what: str, kernel, plain, exact, rows=None) -> dict:
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    row = {"what": what, "max_abs_err": err,
           "within_tol": bool(torch.allclose(got, want, **TOL)),
           # the least atol at rtol 1e-5 that holds kernel to plain
           "atol_needed": ((got - want).abs()
                           - TOL["rtol"] * want.abs()).max().item(),
           "kernel_vs_fp64": (got.double() - exact).abs().max().item(),
           "plain_vs_fp64": (want.double() - exact).abs().max().item(),
           "deterministic": bool(torch.equal(got, again))}
    if rows is not None:
        row["rows_independent_of_m"] = all(
            torch.equal(part(), got[:m]) for m, part in rows)
    print(json.dumps(row), flush=True)
    return row


def accuracy(layers, gen) -> list:
    out = []
    for m in (1, 8, 32, 64, 65, 2048):
        for w in layers:
            k, n = w.shape
            x = torch.randn((m, k), generator=gen, device="cuda")
            rows = ([(r, (lambda r=r: gm.gemm(x[:r].contiguous(), w)))
                     for r in (1, 8, 31) if r < m] if m <= 64 else None)
            out.append(check(f"x @ w {m} x {k} x {n}", lambda: gm.gemm(x, w),
                             lambda: ref.gemm(x, w),
                             x.double() @ w.double(), rows))
    x = torch.randn((33, 70), generator=gen, device="cuda")
    w = torch.randn((70, 65), generator=gen, device="cuda")
    out.append(check("x @ w 33 x 70 x 65", lambda: gm.gemm(x, w),
                     lambda: ref.gemm(x, w), x.double() @ w.double()))
    for b in BATCHES:
        for w in layers:
            k, n = w.shape
            g = torch.randn((b, n), generator=gen, device="cuda")
            x = torch.randn((b, k), generator=gen, device="cuda")
            out.append(check(f"dx {b} x {n} x {k}", dx_fn(g, w),
                             lambda: ref.gemm_nt(g, w),
                             g.double() @ w.double().t()))
            out.append(check(f"dw {k} x {b} x {n}", dw_fn(x, g),
                             lambda: ref.gemm_tn(x, g),
                             x.double().t() @ g.double()))
    return out


def timings(layers, gen) -> dict:
    out = {}
    for m in BATCHES:
        xs = [torch.randn((m, w.shape[0]), generator=gen, device="cuda")
              for w in layers]
        for name, fn in (("kernel", gm.gemm), ("matmul", torch.matmul)):
            def six(fn=fn):
                for x, w in zip(xs, layers):
                    fn(x, w)
            dev, kernels = device_ms(six)
            out[f"forward_{m}_{name}"] = {"ms": events_ms(six),
                                          "device_ms": dev,
                                          "kernels": kernels}
        gs = [torch.randn((m, w.shape[1]), generator=gen, device="cuda")
              for w in layers]
        for i, (x, g, w) in enumerate(zip(xs, gs, layers)):
            for what, kern, lib in (
                    ("x @ w", lambda: gm.gemm(x, w), lambda: x @ w),
                    ("dx", dx_fn(g, w), lambda: g @ w.t()),
                    ("dw", dw_fn(x, g), lambda: x.t() @ g)):
                out[f"layer{i}_{what}_{m}"] = [device_ms(kern)[0],
                                               device_ms(lib)[0]]
        for name, dx, dw in (
                ("kernel", dx_fn, dw_fn),
                ("matmul", lambda g, w: lambda: torch.matmul(g, w.t()),
                 lambda x, g: lambda: torch.matmul(x.t(), g))):
            calls = [dx(g, w) for g, w in zip(gs, layers)] + [
                dw(x, g) for x, g in zip(xs, gs)]

            def backward(calls=calls):
                for c in calls:
                    c()
            dev, kernels = device_ms(backward)
            out[f"backward_{m}_{name}"] = {"ms": events_ms(backward),
                                           "device_ms": dev,
                                           "kernels": kernels}
    return out


def train_step() -> dict:
    """One sparse train step of DLRM(1) at batch 32, as the tree runs it:
    kernels on the card and the gemm's device ms, from the profiler."""
    cfg = DLRM_CONFIGS["dlrm1"]
    params = dlrm.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                       device="cuda")
    opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L, sparse=True)
    state = [opt.init(params)]
    b = DLRMSynthetic(cfg, seed=21).ragged_batch(
        32, max_l=MAX_L, pad_to=32 * cfg.n_tables * MAX_L)
    batch = {k: torch.from_numpy(b[k]).cuda()
             for k in ("dense", "indices", "offsets", "labels")}

    def one():
        _, state[0], _, _ = step(params, state[0], batch)
    for _ in range(3):
        one()
    torch.cuda.synchronize()
    reps = 10
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            one()
        torch.cuda.synchronize()
    kernels, gemm_us = 0, 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        low = e.key.lower()
        if t > 0 and "memcpy" not in low and "memset" not in low:
            kernels += e.count
            if any(s in e.key for s in GEMM_SYMBOLS):
                gemm_us += t
    return {"kernels_per_step": kernels / reps,
            "gemm_device_ms_per_step": gemm_us / 1e3 / reps}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=pathlib.Path,
                    help="also write the last line's object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(ROOT, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    _build.build_all()
    print(_build.build_logs()["gemm"], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = DLRM_CONFIGS["dlrm1"]
    params = dlrm.init(gen, cfg, device="cuda")
    layers = [w for w, _ in params["bottom"]] + [w for w, _ in params["top"]]
    result = {"tree": str(ROOT), "layouts": HAS_LAYOUTS}
    if HAS_LAYOUTS:
        a = torch.randn((5, 7), generator=gen, device="cuda")
        b = torch.randn((7, 9), generator=gen, device="cuda")
        check("first launch x @ w 5 x 7 x 9", lambda: gm.gemm(a, b),
              lambda: ref.gemm(a, b), a.double() @ b.double())
        rows = accuracy(layers, gen)
        result["accuracy_ok"] = all(
            r["within_tol"] and r["deterministic"]
            and r.get("rows_independent_of_m", True) for r in rows)
        result["worst_kernel_vs_fp64"] = max(r["kernel_vs_fp64"]
                                             for r in rows)
    result["times"] = timings(layers, gen)
    result["train_step"] = train_step()
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
