#!/usr/bin/env python3
"""A check of the port's interaction stage and ``fused_segment_sum`` at
the serving and training path's calls.

    python3 examples/torch_interaction_segment_check.py [--tree DIR]
                                                       [--json FILE]
    python3 examples/torch_interaction_segment_check.py --turns PARENT
                                                       [--procs 5]
                                                       [--json FILE]

The calls, at DLRM(1)'s widths (5 tables, F = 6, D = 32): the dense
engine's interaction stage forward (``dense_engine.feature_interaction``)
at batch 32 and 2048; its backward at both batches (autograd of the
stage's output alone, as the DLRM head drops the features, on a graph
kept across calls); and ``fused_segment_sum`` over the serving path's
dense ids, 160 x 40 and 10,240 x 40 (poisson bags, mean 20), into the
1,000,001 x 32 arena, and over id matrices of the same shapes whose every
id is the null row (``segment_*_null``: the same reads, all hits on one
row in L1, so the time left is what the reads' issue costs, not the L2's
or the HBM's). For each: the device ms a call and the kernels a
call from the profiler (the median of five windows of 20 calls), ms a
call with CUDA events around back-to-back calls (host launch included),
and whether it is right: the stage within 1e-5 of a plain composition
computed here (cat, matmul, the triangle, cat; its autograd for the
backward), ``fused_segment_sum`` bit for bit against a loop adding a
bag's rows in order of j, each equal on a second call. Then the kernels
on the card of a served forward (``dlrm.forward_ragged`` at batch 32) and
of a train step of each mode (``make_train_step_ragged``), with the
interaction kernels among them. It builds the kernels first and prints
ptxas's report (registers and spills) for both sources.

``--tree DIR`` imports ``repro_torch`` from DIR/src, so one card can time
another checkout. ``--turns PARENT`` runs this script in ``--procs``
processes on each tree in turns (parent, this tree, this tree, parent,
...) and prints, per tree and call, the median and quartiles of the
processes' device ms. The last line is one JSON object.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCHES = (32, 2048)
MAX_L = 40
WINDOWS = 5


def _args() -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=pathlib.Path, default=ROOT,
                    help="the checkout whose src/repro_torch is timed")
    ap.add_argument("--turns", type=pathlib.Path,
                    help="time this tree against PARENT in turns")
    ap.add_argument("--procs", type=int, default=5)
    ap.add_argument("--json", type=pathlib.Path,
                    help="also write the last line's object here")
    return ap.parse_args()


def turns(parent: pathlib.Path, procs: int) -> dict:
    """--procs processes on each tree, in the order P C C P P C C P ..."""
    import numpy as np
    order = [("parent", "change", "change", "parent")[i % 4]
             for i in range(2 * procs)]
    runs = {"parent": [], "change": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, who in enumerate(order):
            out = pathlib.Path(tmp) / f"{i}.json"
            tree = parent if who == "parent" else ROOT
            subprocess.run([sys.executable, __file__, "--tree", str(tree),
                            "--json", str(out)], check=True,
                           stdout=subprocess.DEVNULL)
            runs[who].append(json.loads(out.read_text()))
    summary = {}
    for who, results in runs.items():
        for call in results[0]["calls"]:
            dev = [r["calls"][call]["device_ms"] for r in results]
            q1, med, q3 = np.percentile(dev, [25, 50, 75])
            first = results[0]["calls"][call]
            summary.setdefault(call, {})[who] = {
                "device_ms_median": med, "device_ms_q1": q1,
                "device_ms_q3": q3, "device_ms": dev,
                "ms": [r["calls"][call]["ms"] for r in results],
                "kernels_per_call": first["kernels"],
                "right": all(r["calls"][call]["right"] for r in results)}
            print(f"{call:16s} {who:7s} device ms median {med:.5f} "
                  f"[{q1:.5f}, {q3:.5f}] over {len(dev)} processes; "
                  f"kernels a call {first['kernels']}; right "
                  f"{summary[call][who]['right']}", flush=True)
    for who, results in runs.items():
        print(f"{who:7s} kernels: {json.dumps(results[0]['paths'])}",
              flush=True)
    print(runs["change"][0]["nvidia_smi"], flush=True)
    return {"turns": summary, "order": order,
            "paths": {who: r[0]["paths"] for who, r in runs.items()},
            "nvidia_smi": runs["change"][0]["nvidia_smi"]}


def main() -> None:
    args = _args()
    if args.turns is not None:
        import torch
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        result = turns(args.turns.resolve(), args.procs)
        result["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(result))
        if args.json is not None:
            args.json.write_text(json.dumps(result))
        return
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.configs.dlrm import DLRM_CONFIGS
    from repro_torch.core import dense_engine as de
    from repro_torch.core import dlrm
    from repro_torch.core import sparse_engine as se
    from repro_torch.data import DLRMSynthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_dispatch as fd

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(args.tree, torch.__version__, torch.version.cuda, smi, flush=True)
    _build.build_all()
    logs = _build.build_logs()
    for name in ("interaction", "fused_segment_sum"):
        print(f"--- nvcc {name}\n{logs[name].strip()}", flush=True)

    def profile(fn, reps: int = 20):
        """(device ms a call, kernels a call, {kernel: count a call}):
        medians over WINDOWS profiler windows of ``reps`` calls; copies
        and fills count in the time, not among the kernels."""
        fn()
        torch.cuda.synchronize()
        dev, count, names = [], [], {}
        for _ in range(WINDOWS):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            us, n = 0.0, 0
            for e in p.key_averages():
                t = getattr(e, "self_device_time_total", None)
                if t is None:
                    t = getattr(e, "self_cuda_time_total", 0.0)
                if t <= 0:
                    continue
                us += t
                low = e.key.lower()
                if "memcpy" not in low and "memset" not in low:
                    n += e.count
                    names[e.key] = e.count / reps
            if us > 0:
                dev.append(us / 1e3 / reps)
                count.append(n / reps)
        return float(np.median(dev)), float(np.median(count)), names

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

    def plain_stage(bot, emb):
        feats = torch.cat([bot[:, None, :], emb], dim=1)
        z = torch.matmul(feats, feats.transpose(1, 2))
        f = feats.shape[1]
        li, lj = torch.tril_indices(f, f, offset=-1, device=bot.device)
        return torch.cat([bot, z[:, li, lj]], dim=-1)

    def in_order(table, ids):
        acc = torch.zeros((ids.shape[0], table.shape[1]), device="cuda")
        for j in range(ids.shape[1]):
            acc = acc + table[ids[:, j]]
        return acc

    cfg = DLRM_CONFIGS["dlrm1"]
    spec = dlrm.arena_spec(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dlrm.init(gen, cfg, device="cuda")
    calls = {}
    for b in BATCHES:
        t, d = cfg.n_tables, cfg.emb_dim
        p = (t + 1) * t // 2
        bot = torch.randn((b, d), generator=gen, device="cuda")
        emb = torch.randn((b, t, d), generator=gen, device="cuda")
        g = torch.randn((b, d + p), generator=gen, device="cuda")

        def fwd(bot=bot, emb=emb):
            with torch.no_grad():
                return de.feature_interaction(bot, emb)[0]
        want = plain_stage(bot, emb)
        calls[f"stage_fwd_{b}"] = (
            fwd, lambda got, again, want=want: bool(
                torch.allclose(got, want, rtol=1e-5, atol=1e-5)
                and torch.equal(got, again)))
        lb, le = bot.clone().requires_grad_(), emb.clone().requires_grad_()
        out = de.feature_interaction(lb, le)[0]
        pb, pe = bot.clone().requires_grad_(), emb.clone().requires_grad_()
        want_b = torch.autograd.grad(plain_stage(pb, pe), (pb, pe), g)

        def bwd(out=out, lb=lb, le=le, g=g):
            return torch.autograd.grad(out, (lb, le), g, retain_graph=True)
        calls[f"stage_bwd_{b}"] = (
            bwd, lambda got, again, want=want_b: all(
                torch.allclose(x, y, rtol=1e-5, atol=1e-5)
                and torch.equal(x, z) for x, y, z in zip(got, want, again)))
    for b in BATCHES:
        rb = DLRMSynthetic(cfg, seed=12 if b > 32 else 11).ragged_batch(
            b, dist="poisson", max_l=MAX_L, pad_to=b * cfg.n_tables * MAX_L)
        off = torch.from_numpy(rb["offsets"]).cuda()
        flat = se.flatten_ragged_indices(
            spec, torch.from_numpy(rb["indices"]).cuda(), off)
        ids = se.ragged_dense_ids(flat, off, max_l=MAX_L, fill=spec.null_row)
        null = torch.full_like(ids, spec.null_row)
        for name, x in ((f"segment_{b}", ids), (f"segment_{b}_null", null)):
            want = in_order(params["arena"], x)
            calls[name] = (
                lambda x=x: fd.fused_segment_sum(params["arena"], x),
                lambda got, again, want=want: bool(
                    torch.equal(got, want) and torch.equal(got, again)))

    result = {"tree": str(args.tree), "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0), "calls": {},
              "paths": {}}
    for name, (fn, right) in calls.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        dev, kernels, names = profile(fn)
        row = {"right": right(got, again), "device_ms": dev,
               "kernels": kernels, "by_kernel": names,
               "ms": events_ms(fn)}
        result["calls"][name] = row
        print(name, json.dumps(row), flush=True)

    # kernels of a served forward and of a train step of each mode
    rb = DLRMSynthetic(cfg, seed=7).ragged_batch(32, dist="poisson",
                                                 max_l=MAX_L)
    batch = {k: torch.from_numpy(rb[k]).cuda()
             for k in ("dense", "indices", "offsets", "labels")}

    def forward():
        with torch.inference_mode():
            return dlrm.forward_ragged(params, cfg, batch["dense"],
                                       batch["indices"], batch["offsets"],
                                       max_l=MAX_L)
    paths = {"forward": forward}
    for sparse in (True, False):
        opt, step = dlrm.make_train_step_ragged(cfg, max_l=MAX_L,
                                                sparse=sparse)
        state = [opt.init(params)]

        def one(step=step, state=state):
            _, state[0], _, _ = step(params, state[0], batch)
        paths["step_sparse" if sparse else "step_dense"] = one
    for name, fn in paths.items():
        dev, kernels, names = profile(fn, reps=5)
        result["paths"][name] = {
            "kernels": kernels, "device_ms": dev,
            "interaction": {k: v for k, v in names.items()
                            if "interaction" in k}}
        print(name, json.dumps(result["paths"][name]), flush=True)
    if args.json is not None:
        args.json.write_text(json.dumps(result))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
