#!/usr/bin/env python3
"""A check of the port's cached and int4 gathers at the serving path's
calls.

    python3 examples/torch_cached_int4_check.py [--tree DIR] [--json FILE]
    python3 examples/torch_cached_int4_check.py --turns PARENT [--procs 5]
                                                [--json FILE]

The calls, at DLRM(1)'s widths (5 tables of 200,000 rows, D = 32, bags
of the serving path's poisson ids, max_l 40), at 160 and 10,240 bags
(batch 32 and 2048):

* ``cached_*``: ``fused_cached_segment_sum`` over a K = 4,096 hot cache
  ranked by a warm trace, on the split of the dense ids (slots, cold
  ids) made beforehand: the TPU kernel's form;
* ``stage_*``: ``CachedSource.reduce_dense`` over the same cache and an
  fp arena, the cached plan's whole embedding stage as it serves (the
  hit split and the reduce: on a tree with the stage form one launch,
  before it the split's torch ops and the kernel);
* ``int4_*``: ``fused_int4_segment_sum`` over the cold tier of
  ``TierPolicy(hot=4096, warm=65536, cold="int4")`` (930,368 rows of 16
  bytes and a scale), on the cold ids the tiered source hands it;
* ``*_null``: the same calls on an id matrix whose every id is the null
  row (every read an L1 hit on one row, so the time left is what the
  reads' issue costs).

For each: device ms a call and kernels a call from the profiler (medians
of five windows of 20 calls), ms a call with CUDA events around
back-to-back calls (host launch included), the library call or
reference point beside it (``F.embedding_bag`` with ``mode="sum"`` over
the fp arena on the same bags for the cached calls, the uncached sum
they equal; over the dequantized cold tier for the int4 calls, no
PyTorch call reducing int4 rows), and whether the call is right: the
cached and stage calls bit for bit against a loop adding a bag's arena
rows in order of j (a coherent cache equals the uncached sum), the int4
calls bit for bit against the same loop over ``int4_unpack``, each
equal on a second call. Then the kernels on the card of a served
forward on the cached plan and on the int4-tiered plan
(``dlrm.forward_ragged`` at batch 32), and ptxas's registers and spills
for both sources.

Then the served requests on the fp and the cached plan, as
``chip_smoke.py`` phases 3 and 5 serve them: a ``RecEngine`` (micro-
batches of 32, the cached plan's K = 4,096 ranked by the warm trace)
serves 2,048 poisson requests, the client sending 32 at once and one
engine step serving them; the engine's p50 and p95 latency ms, and the
host ms a micro-batch of a plain pass of 64 micro-batches (the host
clock around it, the card synchronised at its end).

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
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCHES = (32, 2048)
MAX_L = 40
CACHE_K = 4096
WINDOWS = 5
BUCKET = 32
N_REQUESTS = 2048
PLAIN_BATCHES = 64


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
            row = {}
            for key in ("device_ms", "library_device_ms"):
                vals = [r["calls"][call][key] for r in results]
                q1, med, q3 = np.percentile(vals, [25, 50, 75])
                row.update({f"{key}_median": med, f"{key}_q1": q1,
                            f"{key}_q3": q3, key: vals})
            first = results[0]["calls"][call]
            row.update({
                "ms": [r["calls"][call]["ms"] for r in results],
                "kernels_per_call": first["kernels"],
                "right": all(r["calls"][call]["right"] for r in results)})
            summary.setdefault(call, {})[who] = row
            print(f"{call:18s} {who:7s} device ms median "
                  f"{row['device_ms_median']:.5f} [{row['device_ms_q1']:.5f},"
                  f" {row['device_ms_q3']:.5f}] over {len(results)} "
                  f"processes (library {row['library_device_ms_median']:.5f});"
                  f" kernels a call {first['kernels']}; right {row['right']}",
                  flush=True)
    serving = {}
    for who, results in runs.items():
        for plan in results[0]["serving"]:
            row = {}
            for key in ("p50_ms", "p95_ms", "host_ms_per_batch"):
                vals = [r["serving"][plan][key] for r in results]
                q1, med, q3 = np.percentile(vals, [25, 50, 75])
                row.update({f"{key}_median": med, f"{key}_q1": q1,
                            f"{key}_q3": q3, key: vals})
            serving.setdefault(plan, {})[who] = row
            cells = ", ".join(
                f"{key} {row[key + '_median']:.4f} [{row[key + '_q1']:.4f},"
                f" {row[key + '_q3']:.4f}]"
                for key in ("p50_ms", "p95_ms", "host_ms_per_batch"))
            print(f"serve {plan:6s} {who:7s} medians [quartiles]: {cells}",
                  flush=True)
    for who, results in runs.items():
        print(f"{who:7s} kernels: {json.dumps(results[0]['paths'])}",
              flush=True)
    print(runs["change"][0]["nvidia_smi"], flush=True)
    return {"turns": summary, "serving": serving, "order": order,
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
    import torch.nn.functional as F

    from repro_torch.configs.dlrm import DLRM_CONFIGS
    from repro_torch.core import dlrm
    from repro_torch.core import embedding_source as es
    from repro_torch.core import sparse_engine as se
    from repro_torch.data import DLRMSynthetic
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.serving import RecEngine, requests_from_ragged_batch
    from repro_torch.storage import tiered as st

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(args.tree, torch.__version__, torch.version.cuda, smi, flush=True)
    _build.build_all()
    logs = _build.build_logs()
    for name in ("fused_cached_segment_sum", "fused_int4_segment_sum"):
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

    def in_order(table, ids):
        acc = torch.zeros((ids.shape[0], table.shape[1]), device="cuda")
        for j in range(ids.shape[1]):
            acc = acc + table[ids[:, j]]
        return acc

    cfg = DLRM_CONFIGS["dlrm1"]
    spec = dlrm.arena_spec(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dlrm.init(gen, cfg, device="cuda")
    arena = params["arena"]
    warm = DLRMSynthetic(cfg, seed=17).ragged_batch(4096, dist="poisson",
                                                    max_l=MAX_L)
    counts = se.trace_row_counts(spec, warm["indices"], warm["offsets"])
    cache = se.build_hot_cache(arena, spec, counts, CACHE_K)
    cached = es.CachedSource(hot=cache, cold=es.FpArena(arena),
                             coherent=True)
    tiered = st.build_tiered(arena, spec, st.TierPolicy(
        hot=4096, warm=65_536, cold="int4"), counts)
    cold = tiered.cold
    table4 = ops.int4_unpack(cold.packed, cold.scales, cold.dim)

    def cold_ids_of(dense):
        h, w, c = tiered.n_hot, tiered.n_warm, tiered.n_cold
        ts = tiered.tier_slot[dense]
        return torch.where(ts >= h + w, torch.clamp(ts - (h + w), max=c), c)

    def serving_ids(b):
        rb = DLRMSynthetic(cfg, seed=12 if b > 32 else 11).ragged_batch(
            b, dist="poisson", max_l=MAX_L, pad_to=b * cfg.n_tables * MAX_L)
        off = torch.from_numpy(rb["offsets"]).cuda()
        flat = se.flatten_ragged_indices(
            spec, torch.from_numpy(rb["indices"]).cuda(), off)
        return se.ragged_dense_ids(flat, off, max_l=MAX_L,
                                   fill=spec.null_row)

    calls = {}
    for b in BATCHES:
        dense = serving_ids(b)
        n = dense.shape[0]
        for tag, x in (("", dense),
                       ("_null", torch.full_like(dense, spec.null_row))):
            want = in_order(arena, x)
            slots = cache.slot_of[x]
            cold_x = torch.where(slots < cache.k, spec.null_row, x)

            def cached_call(slots=slots, cold_x=cold_x):
                return fd.fused_cached_segment_sum(cache.hot_rows, arena,
                                                   slots, cold_x)

            def stage_call(x=x):
                with torch.inference_mode():
                    return cached.reduce_dense(spec, x)
            library = (lambda x=x: F.embedding_bag(x, arena, mode="sum"))
            right = (lambda got, again, want=want: bool(
                torch.equal(got, want) and torch.equal(got, again)))
            calls[f"cached_{n}{tag}"] = (cached_call, library, right)
            calls[f"stage_{n}{tag}"] = (stage_call, library, right)
            ids4 = (cold_ids_of(x) if not tag else
                    torch.full_like(x, cold.packed.shape[0] - 1))
            want4 = in_order(table4, ids4)
            calls[f"int4_{n}{tag}"] = (
                lambda ids4=ids4: fd.fused_int4_segment_sum(
                    cold.packed, cold.scales, ids4, dim=cold.dim),
                lambda ids4=ids4: F.embedding_bag(ids4, table4, mode="sum"),
                lambda got, again, want=want4: bool(
                    torch.equal(got, want) and torch.equal(got, again)))

    result = {"tree": str(args.tree), "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0), "calls": {},
              "paths": {}}
    for name, (fn, library, right) in calls.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        dev, kernels, names = profile(fn)
        lib_dev, _, _ = profile(library)
        row = {"right": right(got, again), "device_ms": dev,
               "kernels": kernels, "by_kernel": names,
               "ms": events_ms(fn), "library_device_ms": lib_dev,
               "library_ms": events_ms(library)}
        result["calls"][name] = row
        print(name, json.dumps(row), flush=True)

    # kernels of a served forward on the cached and int4-tiered plans
    rb = DLRMSynthetic(cfg, seed=7).ragged_batch(32, dist="poisson",
                                                 max_l=MAX_L)
    batch = {k: torch.from_numpy(rb[k]).cuda()
             for k in ("dense", "indices", "offsets")}
    for name, source in (("forward_cached", cached),
                         ("forward_int4", tiered)):
        def forward(source=source):
            with torch.inference_mode():
                return dlrm.forward_ragged(params, cfg, batch["dense"],
                                           batch["indices"],
                                           batch["offsets"], max_l=MAX_L,
                                           source=source)
        dev, kernels, names = profile(forward, reps=5)
        result["paths"][name] = {
            "kernels": kernels, "device_ms": dev,
            "gathers": {k: v for k, v in names.items()
                        if "segment_sum" in k}}
        print(name, json.dumps(result["paths"][name]), flush=True)

    def requests(seed, n):
        return requests_from_ragged_batch(DLRMSynthetic(cfg, seed=seed)
                                          .ragged_batch(n, dist="poisson",
                                                        max_l=MAX_L),
                                          cfg.n_tables)

    result["serving"] = {}
    for name, plan in (("fp", {}),
                       ("cached", {"source": "cached", "cache_k": CACHE_K,
                                   "cache_trace": counts})):
        engine = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                           device="cuda", **plan)
        engine.warmup()
        reqs = requests(7, N_REQUESTS)
        for i in range(0, len(reqs), BUCKET):
            sent = time.monotonic()
            for r in reqs[i:i + BUCKET]:
                r.submitted_mono = sent
                engine.submit(r)
            engine.step()
        engine.drain()
        stats = engine.stats()
        plain = requests(8, PLAIN_BATCHES * BUCKET)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(plain), BUCKET):
            for r in plain[i:i + BUCKET]:
                engine.submit(r)
            engine.step()
        torch.cuda.synchronize()
        result["serving"][name] = {
            "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
            "host_ms_per_batch": (time.perf_counter() - t0) * 1e3
            / PLAIN_BATCHES}
        print(f"serve_{name}", json.dumps(result["serving"][name]),
              flush=True)
    if args.json is not None:
        args.json.write_text(json.dumps(result))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
