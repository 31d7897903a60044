#!/usr/bin/env python3
"""Every serving plan of the port's ``RecEngine`` on the card: what a
served micro-batch costs the host and the device.

    python3 examples/torch_graph_serving_check.py [--tree DIR] [--json FILE]
    python3 examples/torch_graph_serving_check.py --turns PARENT [--procs 5]
                                                  [--json FILE]

DLRM(1) at full size (5 tables of 200,000 rows, D = 32, seeded params),
``max_l`` 40, micro-batches of 32, on the plans

* ``fp``: the fp arena (``source="ragged"``);
* ``cached``: a 4,096-row hot cache over the fp arena, ranked by a warm
  trace; ``int8``: the same over an int8 cold arena;
* ``fixed``: the fixed layout (bags of exactly 20 ids);
* ``flat``: a source that implements ``reduce_flat`` alone (its lookups
  run on ``sparse_lengths_sum``);
* ``tiered_int4``, ``tiered_host``: hot 4,096 fp rows, a 65,536-row int8
  warm tier and an int4 cold tier, or no warm tier and a host cold tier
  behind a 16,384-row staging arena.

Each plan's engine runs ``warmup()`` (on a tree whose engine captures
graphs, every (path, bucket) pair's), then serves 2,048 requests as
``chip_smoke.py`` phase 3 does (the client sends 32 at once, one
``step`` serves them): p50 and p95 request latency. Then a plain pass of
64 micro-batches gives the host ms a micro-batch (the host clock over
the pass, which ends in the last probabilities on the host), and 16 more
under ``torch.profiler`` tracing the card give the device busy ms and the
kernels a micro-batch; the idle share is 1 - busy / host ms. The first
four served micro-batches are held bit for bit against the eager serve
step (``dlrm.make_ragged_serve_step`` or ``make_serve_step``) over the
same padded batch, each right after its step (a host tier then still
holds the rows it staged for it).

``--tree DIR`` imports ``repro_torch`` from DIR/src, so one card can time
another checkout (its engine may serve eagerly). ``--turns PARENT`` runs
this script in ``--procs`` processes on each tree in turns (parent, this
tree, this tree, parent, ...) and prints, per tree and plan, the median
and quartiles of the processes' numbers and each process's numbers beside
its place in the order (from 1). The last line is one JSON object.
"""
import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUCKET = 32
MAX_L = 40
N_REQUESTS = 2048
PLAIN_BATCHES = 64
PROFILED_BATCHES = 16
CHECKED_BATCHES = 4
CACHE_K = 4096
WARM = 4096
PLANS = ("fp", "cached", "int8", "fixed", "flat", "tiered_int4",
         "tiered_host")
SUMMARY = ("p50_ms", "p95_ms", "host_ms_per_batch", "device_busy_ms",
           "idle_share", "kernels_per_batch")


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


def _quartiles(vals: list) -> dict:
    import numpy as np
    q1, med, q3 = np.percentile(vals, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "values": vals}


def turns(parent: pathlib.Path, procs: int) -> dict:
    """--procs processes on each tree, in the order P C C P P C C P ..."""
    order = [("parent", "change", "change", "parent")[i % 4]
             for i in range(2 * procs)]
    runs = {"parent": [], "change": []}
    places = {"parent": [], "change": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, who in enumerate(order):
            out = pathlib.Path(tmp) / f"{i}.json"
            tree = parent if who == "parent" else ROOT
            subprocess.run([sys.executable, __file__, "--tree", str(tree),
                            "--json", str(out)], check=True,
                           stdout=subprocess.DEVNULL)
            runs[who].append(json.loads(out.read_text()))
            places[who].append(i + 1)
    summary = {}
    for who, results in runs.items():
        for plan in PLANS:
            row = {k: _quartiles([r["plans"][plan][k] for r in results])
                   for k in SUMMARY}
            row["equal_to_eager"] = all(r["plans"][plan]["equal_to_eager"]
                                        for r in results)
            summary.setdefault(plan, {})[who] = row
            cells = ", ".join(f"{k} {v['median']:.4f} [{v['q1']:.4f}, "
                              f"{v['q3']:.4f}]" for k, v in row.items()
                              if isinstance(v, dict))
            print(f"{plan:12s} {who:7s} {cells}; equal to eager "
                  f"{row['equal_to_eager']}", flush=True)
            for k in ("host_ms_per_batch", "p50_ms"):
                cells = " ".join(f"#{at} {x:.4f}" for at, x in
                                 zip(places[who], row[k]["values"]))
                print(f"  {plan} {who} {k} by process: {cells}", flush=True)
    smi = runs["change"][0]["nvidia_smi"]
    print(smi, flush=True)
    return {"turns": summary, "order": order, "places": places,
            "nvidia_smi": smi}


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
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(result))
        return
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.configs.dlrm import DLRM_CONFIGS
    from repro_torch.core import dlrm
    from repro_torch.core import embedding_source as es
    from repro_torch.core import sparse_engine as se
    from repro_torch.data import DLRMSynthetic
    from repro_torch.kernels import _build, ops
    from repro_torch.serving import RecEngine, requests_from_ragged_batch
    from repro_torch.storage import TierPolicy

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(args.tree, torch.__version__, torch.version.cuda, smi, flush=True)
    _build.build_all()
    cfg = DLRM_CONFIGS["dlrm1"]
    params = dlrm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                       device="cuda")
    spec = dlrm.arena_spec(cfg)
    warm = DLRMSynthetic(cfg, seed=11).ragged_batch(WARM, dist="poisson",
                                                    max_l=MAX_L)
    counts = se.trace_row_counts(spec, warm["indices"], warm["offsets"])

    @dataclasses.dataclass(frozen=True)
    class FlatArena(es.EmbeddingSource):
        """A source with ``reduce_flat`` alone."""
        arena: torch.Tensor

        @property
        def out_dtype(self) -> torch.dtype:
            return self.arena.dtype

        def reduce_flat(self, spec, flat, offsets, *, max_l):
            return ops.sparse_lengths_sum(self.arena, flat, offsets,
                                          max_l=max_l).float()
    es.register_source(FlatArena, ("arena",), ())

    plans = {
        "fp": dict(source="ragged"),
        "cached": dict(source="cached", cache_k=CACHE_K,
                       cache_trace=counts),
        "int8": dict(source="cached", cache_k=CACHE_K, cache_trace=counts,
                     quantize_cold=True),
        "fixed": dict(source="fixed"),
        "flat": dict(source=FlatArena(params["arena"])),
        "tiered_int4": dict(source=es.SourceSpec(tiers=TierPolicy(
            hot=4096, warm=65_536, cold="int4")), cache_trace=counts),
        "tiered_host": dict(source=es.SourceSpec(tiers=TierPolicy(
            hot=4096, warm=0, cold="host", staging_rows=16_384,
            max_stage_per_batch=4096)), cache_trace=counts)}

    def requests(fixed: bool, seed: int, n: int) -> list:
        data = DLRMSynthetic(cfg, seed=seed)
        if not fixed:
            return requests_from_ragged_batch(
                data.ragged_batch(n, dist="poisson", max_l=MAX_L),
                cfg.n_tables)
        b = data.batch(n)
        m, t, n_l = b["indices"].shape
        return requests_from_ragged_batch(
            {"dense": b["dense"], "indices": b["indices"].reshape(-1),
             "offsets": (np.arange(m * t + 1) * n_l).astype(np.int32)},
            cfg.n_tables)

    def drive(engine, reqs, stamp: bool = False, check=None) -> bool:
        """Serve ``reqs`` 32 at a time; ``check(mb)`` holds each of the
        first CHECKED_BATCHES micro-batches right after its step, while a
        host tier still holds the rows it staged for it."""
        equal = True
        for i in range(0, len(reqs), BUCKET):
            mb = reqs[i:i + BUCKET]
            sent = time.monotonic()
            for r in mb:
                if stamp:
                    r.submitted_mono = sent
                engine.submit(r)
            engine.step()
            if check is not None and i < CHECKED_BATCHES * BUCKET:
                equal &= check(mb)
        return equal

    result = {"tree": str(args.tree), "nvidia_smi": smi, "plans": {}}
    for name, plan in plans.items():
        fixed = name == "fixed"
        engine = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                           device="cuda", **plan)
        t0 = time.perf_counter()
        engine.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        step = (dlrm.make_serve_step(cfg) if fixed
                else dlrm.make_ragged_serve_step(cfg, max_l=MAX_L))

        def check(mb):
            batch, _ = engine._assemble(mb, BUCKET)
            want = (step(engine.params, batch) if fixed
                    else step(engine.params, batch, engine.source))
            got = np.array([r.prob for r in mb], np.float32)
            return bool(np.array_equal(got, want.cpu().numpy()))
        reqs = requests(fixed, 7, N_REQUESTS)
        equal = drive(engine, reqs, stamp=True, check=check)
        stats = engine.stats()
        plain = requests(fixed, 8, PLAIN_BATCHES * BUCKET)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drive(engine, plain)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / PLAIN_BATCHES
        traced = requests(fixed, 9, PROFILED_BATCHES * BUCKET)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            drive(engine, traced)
            torch.cuda.synchronize()
        busy_us, kernels = 0.0, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us <= 0:
                continue
            busy_us += us
            low = e.key.lower()
            if "memcpy" not in low and "memset" not in low:
                kernels += e.count
        busy = busy_us / 1e3 / PROFILED_BATCHES
        row = {"p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
               "p99_ms": stats["p99_ms"], "host_ms_per_batch": host_ms,
               "device_busy_ms": busy, "idle_share": 1.0 - busy / host_ms,
               "kernels_per_batch": kernels / PROFILED_BATCHES,
               "warmup_s": warmup_s, "equal_to_eager": equal,
               "captures": getattr(engine, "captures", None)}
        result["plans"][name] = row
        print(f"{name:12s} {json.dumps(row)}", flush=True)
        if not equal:
            sys.exit(f"{name}: served probabilities differ from the eager "
                     "serve step")
        del engine
    if args.json is not None:
        args.json.write_text(json.dumps(result))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
