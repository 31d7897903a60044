#!/usr/bin/env python3
"""A check of the port's ``embedding_bag`` and ``sparse_lengths_sum`` at
the paths' calls, and of their wrappers' host cost.

    python3 examples/torch_sls_bag_check.py [--tree DIR] [--json FILE]
    python3 examples/torch_sls_bag_check.py --turns PARENT [--procs 5]
                                            [--json FILE]

The calls, at DLRM(1)'s widths (5 tables of 200,000 rows, D = 32), at
batch 32 and 2048:

* ``bag_*``: ``embedding_bag`` over the fixed layout's (B*T, 20) arena
  ids (160 and 10,240 bags);
* ``gather_*``: ``gather_rows`` over the first id of each of those bags;
* ``sls_*``: ``sparse_lengths_sum`` over the serving path's poisson
  stream (mean 20, max 40) with its padded tail, ``max_l`` 40;
* ``host_flat_*``: ``HostTier.reduce_flat`` as it serves (the slot
  gather, then ``sparse_lengths_sum`` with ``max_l`` the stream's
  length) over a 16,384-row staging arena and a slot map of the arena's
  rows;
* ``*_row0``: the same calls on ids that are all row 0 (every read an L1
  hit on one row, so the time left is what the reads' issue costs).

For each: device ms a call and kernels a call from the profiler (medians
of five windows of 20 calls), ms a call with CUDA events around
back-to-back calls (host launch included), beside ``fused_segment_sum``
over the same bags as a dense id matrix (fill slots on the arena's zero
null row) and the one PyTorch call of the same function
(``F.embedding_bag``, with offsets for the stream; ``F.embedding`` for the
row gather), each timed the same two ways; for the kernel calls (not the
host tier's flat form) the plain version of ``kernels.ref`` timed the
same two ways and the least time the card could take, ``bound_ms``: the
larger of the bytes (the ids and offsets read once, each row the call
touches read once, the output written once) over 3.35 TB/s and the adds
over 67 TFLOP/s (fp32); and whether the call is right: bit for bit
against a loop adding a bag's rows in order of position and against
``fused_segment_sum`` over the same bags, and equal on a second call.

The wrappers' host cost: before any profiler runs in the process, the
host clock over 1,000 calls without a synchronize (the enqueue alone)
and CUDA events around 20 back-to-back calls, for ``fused_segment_sum``
(160 x 40), ``embedding_bag`` (160 x 20), ``gather_rows`` and
``sparse_lengths_sum`` (160 bags), with cProfile's top entries of the
1,000 calls; the host clock of each wrapper's launch plan alone,
computed (``plan_us``, the SM count's lookup included) and through a
cache (``plan_cached_us``); then the host clock once more after the
profiler has run.

Then the kernels on the card of a served forward on the fixed plan
(``dlrm.forward`` over the fp arena, one ``embedding_bag``) and on the
flat route (``dlrm.forward_ragged`` over a ``reduce_flat``-only source,
one ``sparse_lengths_sum``), and both served as ``chip_smoke.py`` phase
7 serves them, 2,048 requests in micro-batches of 32: the fixed plan by a
``RecEngine``, the client sending 32 at once and one engine step serving
them (p50 and p95 request latency ms); the flat route by the ragged
serve step over the ``reduce_flat``-only source, which no engine takes
(p50 and p95 ms of a micro-batch, from its ids on the card to its
probabilities on the host); for both the host ms a micro-batch of a
plain pass of 64 micro-batches. ptxas's registers and spills for both sources
and each kernel's plan at these calls are printed first.

``--tree DIR`` imports ``repro_torch`` from DIR/src, so one card can time
another checkout. ``--turns PARENT`` runs this script in ``--procs``
processes on each tree in turns (parent, this tree, this tree, parent,
...) and prints, per tree and call, the median and quartiles of the
processes' numbers; for the served plans and the wrappers' host cost it
also prints each process's numbers beside its place in the order (from
1). The last line is one JSON object.
"""
import argparse
import cProfile
import dataclasses
import functools
import io
import json
import pathlib
import pstats
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCHES = (32, 2048)
MAX_L = 40
WINDOWS = 5
BUCKET = 32
N_REQUESTS = 2048
PLAIN_BATCHES = 64
STAGING = 16_384
HOST_CALLS = 1000
SUMMARY = ("device_ms", "ms", "fused_device_ms", "fused_ms",
           "library_device_ms", "library_ms", "plain_device_ms", "plain_ms",
           "bound_ms")
# the card's rates for the bound (H100 SXM: HBM3, fp32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


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

    def by_process(label: str, who: str, row: dict, fmt: str) -> None:
        for key, v in row.items():
            cells = " ".join(f"#{at} {x:{fmt}}"
                             for at, x in zip(places[who], v["values"]))
            print(f"  {label} {who:7s} {key:18s} by process: {cells}",
                  flush=True)
    for who, results in runs.items():
        for call, first in results[0]["calls"].items():
            row = {key: _quartiles([r["calls"][call][key] for r in results])
                   for key in SUMMARY if first.get(key) is not None}
            row["kernels_per_call"] = first["kernels"]
            row["right"] = all(r["calls"][call]["right"] for r in results)
            summary.setdefault(call, {})[who] = row
            cells = ", ".join(f"{k} {v['median']:.5f} [{v['q1']:.5f}, "
                              f"{v['q3']:.5f}]" for k, v in row.items()
                              if isinstance(v, dict))
            print(f"{call:16s} {who:7s} {cells}; kernels a call "
                  f"{first['kernels']}; right {row['right']}", flush=True)
        for name in results[0]["host"]:
            row = {key: _quartiles([r["host"][name][key] for r in results])
                   for key in results[0]["host"][name]}
            # each wrapper's events time against fused_segment_sum's in
            # the same process
            row["events_vs_fused"] = _quartiles(
                [r["host"][name]["events_ms"]
                 / r["host"]["fused_segment_sum"]["events_ms"]
                 for r in results])
            summary.setdefault(f"host_{name}", {})[who] = row
            cells = ", ".join(f"{k} {v['median']:.4f} [{v['q1']:.4f}, "
                              f"{v['q3']:.4f}]" for k, v in row.items())
            print(f"host {name:20s} {who:7s} {cells}", flush=True)
            by_process(f"host {name}", who, row, ".4f")
        for plan in results[0]["serving"]:
            row = {key: _quartiles([r["serving"][plan][key]
                                    for r in results])
                   for key in ("p50_ms", "p95_ms", "host_ms_per_batch")}
            summary.setdefault(f"serve_{plan}", {})[who] = row
            cells = ", ".join(f"{k} {v['median']:.4f} [{v['q1']:.4f}, "
                              f"{v['q3']:.4f}]" for k, v in row.items())
            print(f"serve {plan:6s} {who:7s} {cells}", flush=True)
            by_process(f"serve {plan}", who, row, ".4f")
        print(f"{who:7s} kernels: {json.dumps(results[0]['paths'])}",
              flush=True)
    print(runs["change"][0]["nvidia_smi"], flush=True)
    return {"turns": summary, "order": order, "places": places,
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
    from repro_torch.core import hybrid
    from repro_torch.core import sparse_engine as se
    from repro_torch.data import DLRMSynthetic
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import fused_dispatch as fd
    from repro_torch.serving import RecEngine, requests_from_ragged_batch
    from repro_torch.storage.host_store import HostTier

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(args.tree, torch.__version__, torch.version.cuda, smi, flush=True)
    _build.build_all()
    logs = _build.build_logs()
    for name in ("embedding_bag", "sparse_lengths_sum"):
        print(f"--- nvcc {name}\n{logs[name].strip()}", flush=True)
    planned = hasattr(eg, "sls_plan")

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

    def host_us(fn) -> float:
        """Host clock over HOST_CALLS calls, no synchronize inside."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / HOST_CALLS * 1e6

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
    null = spec.null_row
    staging = 0.01 * torch.randn((STAGING + 1, arena.shape[1]),
                                 generator=gen, device="cuda")
    staging[STAGING] = 0.0
    # a slot map of every arena row into the staging arena (the null row
    # onto its zero slot), as a host tier with every touched row staged
    slot_of = (torch.arange(arena.shape[0], device="cuda",
                            dtype=torch.int64) * 7919 % STAGING).int()
    slot_of[null] = STAGING
    host_tier = HostTier(staging=staging, slot_of=slot_of)

    def fixed_ids(b):
        fb = DLRMSynthetic(cfg, seed=31 if b == 32 else 32).batch(b)
        return se.flatten_indices(spec,
                                  torch.from_numpy(fb["indices"]).cuda())

    def stream(b):
        rb = DLRMSynthetic(cfg, seed=11 if b == 32 else 12).ragged_batch(
            b, dist="poisson", max_l=MAX_L, pad_to=b * cfg.n_tables * MAX_L)
        off = torch.from_numpy(rb["offsets"]).cuda()
        flat = se.flatten_ragged_indices(
            spec, torch.from_numpy(rb["indices"]).cuda(), off)
        return flat, off

    def as_dense(flat, off, max_l):
        return se.ragged_dense_ids(flat, off, max_l=max_l, fill=null)

    def bound_ms(n_ids: int, rows: torch.Tensor, n_out: int) -> float:
        """The larger of the bytes (n_ids int32 ids and offsets read once,
        each distinct row of ``rows`` read once, n_out rows written once)
        over the HBM rate and the adds (one a position and column) over
        the fp32 rate."""
        d = arena.shape[1]
        n_bytes = 4 * (n_ids + torch.unique(rows).numel() * d + n_out * d)
        adds = rows.numel() * d
        return max(n_bytes / HBM_BYTES_PER_S, adds / FP32_FLOPS_PER_S) * 1e3

    # every call: (kernel, fused_segment_sum's table and dense ids over the
    # same bags, library call, the in-order sum it must equal, the plain
    # version, bound ms); the fixed layout's ids are a dense matrix as they
    # are
    calls = {}
    for b in BATCHES:
        ids = fixed_ids(b)
        flat, off = stream(b)
        n_bags = ids.shape[0]
        for tag, row0 in (("", False), ("_row0", True)):
            x = torch.zeros_like(ids) if row0 else ids
            calls[f"bag_{n_bags}{tag}"] = (
                lambda x=x: eg.embedding_bag(arena, x), arena, x,
                lambda x=x: F.embedding_bag(x, arena, mode="sum"),
                in_order(arena, x),
                lambda x=x: ref.embedding_bag(arena, x),
                bound_ms(x.numel(), x, n_bags))
            one = x[:, 0].contiguous()
            calls[f"gather_{n_bags}{tag}"] = (
                lambda one=one: eg.gather_rows(arena, one), arena,
                one[:, None],
                lambda one=one: F.embedding(one, arena), arena[one],
                lambda one=one: ref.gather_rows(arena, one),
                bound_ms(one.numel(), one, n_bags))
            f = torch.zeros_like(flat) if row0 else flat
            v = f[:int(off[-1])]
            dense = as_dense(f, off, MAX_L)
            calls[f"sls_{n_bags}{tag}"] = (
                lambda f=f, off=off: eg.sparse_lengths_sum(arena, f, off,
                                                           max_l=MAX_L),
                arena, dense,
                lambda v=v, off=off: F.embedding_bag(
                    v, arena, off, mode="sum", include_last_offset=True),
                in_order(arena, dense),
                lambda f=f, off=off: ref.sparse_lengths_sum(arena, f, off,
                                                            max_l=MAX_L),
                bound_ms(v.numel() + off.numel(), v, n_bags))
            if row0:
                continue
            slots = slot_of[flat]

            def host_flat(flat=flat, off=off):
                with torch.inference_mode():
                    return host_tier.reduce_flat(spec, flat, off,
                                                 max_l=MAX_L)
            sdense = se.ragged_dense_ids(slots, off, max_l=MAX_L,
                                         fill=STAGING)
            calls[f"host_flat_{n_bags}"] = (
                host_flat, staging, sdense,
                lambda sv=slots[:int(off[-1])], off=off: F.embedding_bag(
                    sv, staging, off, mode="sum", include_last_offset=True),
                in_order(staging, sdense), None, None)

    result = {"tree": str(args.tree), "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0), "calls": {},
              "host": {}, "paths": {}, "plans": {}}
    if planned:
        sms = _build.sm_count(arena.device)
        for n_bags in (160, 10_240):
            result["plans"][f"bag_{n_bags}"] = eg.bag_plan(n_bags, 20, 32,
                                                           sms)._asdict()
            result["plans"][f"gather_{n_bags}"] = eg.bag_plan(
                n_bags, 1, 32, sms)._asdict()
            result["plans"][f"sls_{n_bags}"] = eg.sls_plan(
                n_bags, MAX_L, 32, sms)._asdict()
            result["plans"][f"host_flat_{n_bags}"] = eg.sls_plan(
                n_bags, n_bags * MAX_L, 32, sms)._asdict()
        print("plans", json.dumps(result["plans"]), flush=True)

    # -- the wrappers' host cost, before any profiler runs in the process
    dense160 = as_dense(*stream(32), MAX_L)
    host_calls = {
        "fused_segment_sum": lambda: fd.fused_segment_sum(arena, dense160),
        "embedding_bag": calls["bag_160"][0],
        "gather_rows": calls["gather_160"][0],
        "sparse_lengths_sum": calls["sls_160"][0]}
    # the same launches without the wrapper: the C entry called with its
    # arguments made beforehand ("c_us"), and through _build.launch, which
    # adds the device guard and the current stream's lookup ("launch_us")
    sms = _build.sm_count(arena.device)
    bag_ids = fixed_ids(32)
    sls_flat, sls_off = stream(32)

    def entry(kernel, symbol, argtypes, *c_args):
        fn_c = _build.function(kernel, symbol, argtypes)
        return fn_c, kernel, c_args

    d = arena.shape[1]
    out = torch.empty((bag_ids.shape[0], d), device="cuda")
    fp = fd.segment_plan(dense160.shape[0], MAX_L, d, sms)
    keep = []                  # the id tensors the bare calls read
    bare = {"fused_segment_sum": entry(
        "fused_segment_sum", "fused_segment_sum_f32", fd._ARGS,
        arena.data_ptr(), dense160.data_ptr(), out.data_ptr(),
        dense160.shape[0], MAX_L, d, *fp)}
    for name, n_l in (("embedding_bag", 20), ("gather_rows", 1)):
        ids = bag_ids if n_l > 1 else bag_ids[:, 0].contiguous()
        c_args = (arena.data_ptr(), ids.data_ptr(), out.data_ptr(),
                bag_ids.shape[0], n_l, d)
        if planned:
            c_args += tuple(eg.bag_plan(bag_ids.shape[0], n_l, d, sms))
        keep.append(ids)
        bare[name] = entry("embedding_bag", "embedding_bag_f32",
                           eg._BAG_ARGS, *c_args)
    n_bags = sls_off.numel() - 1
    c_args = (arena.data_ptr(), sls_flat.data_ptr(), sls_off.data_ptr(),
            out.data_ptr(), sls_flat.numel(), n_bags, MAX_L, d)
    if planned:
        c_args += tuple(eg.sls_plan(n_bags, MAX_L, d, sms))
    bare["sparse_lengths_sum"] = entry(
        "sparse_lengths_sum", "sparse_lengths_sum_f32", eg._SLS_ARGS, *c_args)
    stream_ptr = torch.cuda.current_stream().cuda_stream
    # each wrapper's launch plan, as the wrapper asks for it: (module,
    # function, shapes)
    plan_of = {"fused_segment_sum": (fd, "segment_plan",
                                     (dense160.shape[0], MAX_L, d))}
    if planned:
        plan_of.update({
            "embedding_bag": (eg, "bag_plan", (bag_ids.shape[0], 20, d)),
            "gather_rows": (eg, "bag_plan", (bag_ids.shape[0], 1, d)),
            "sparse_lengths_sum": (eg, "sls_plan", (n_bags, MAX_L, d))})
    for name, fn in host_calls.items():
        fn_c, kernel, c_args = bare[name]
        c_us = host_us(lambda: fn_c(*c_args, stream_ptr))
        launch_us = host_us(lambda: _build.launch(fn_c, kernel, arena.device,
                                                  *c_args))
        us = host_us(fn)
        ev = events_ms(fn)
        row = {"host_us": us, "events_ms": ev, "c_us": c_us,
               "launch_us": launch_us}
        if name in plan_of:
            # the plan alone, with the SM count it is given, computed and
            # through a cache
            mod, attr, shape = plan_of[name]
            plan = getattr(mod, attr)
            plan = getattr(plan, "__wrapped__", plan)
            cached = functools.lru_cache(maxsize=None)(plan)
            row["plan_us"] = host_us(
                lambda: plan(*shape, _build.sm_count(arena.device)))
            row["plan_cached_us"] = host_us(
                lambda: cached(*shape, _build.sm_count(arena.device)))
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(HOST_CALLS):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(8)
        result["host"][name] = row
        print(f"host {name}: {us:.2f} us a call over {HOST_CALLS} calls "
              f"without a synchronize (the C entry alone {c_us:.2f}, through "
              f"_build.launch {launch_us:.2f}); events {ev:.4f} ms a call; "
              f"{json.dumps(row)}\n{text.getvalue().strip()}", flush=True)

    for name, (fn, table, dense, library, want, plain,
               bound) in calls.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        fused = (lambda table=table, dense=dense:
                 fd.fused_segment_sum(table, dense))
        ref_fused = fused()
        right = bool(torch.equal(got, want) and torch.equal(got, again)
                     and torch.equal(got, ref_fused))
        dev, kernels, names = profile(fn)
        row = {"right": right, "device_ms": dev, "kernels": kernels,
               "by_kernel": names, "ms": events_ms(fn),
               "fused_device_ms": profile(fused)[0],
               "fused_ms": events_ms(fused),
               "library_device_ms": profile(library)[0],
               "library_ms": events_ms(library), "bound_ms": bound}
        if plain is not None:
            row["plain_device_ms"] = profile(plain)[0]
            row["plain_ms"] = events_ms(plain)
        result["calls"][name] = row
        print(name, json.dumps(row), flush=True)

    for name, fn in host_calls.items():
        result["host"][name]["host_us_after"] = host_us(fn)
        print(f"host {name}: {result['host'][name]['host_us_after']:.2f} us "
              f"a call after the profiler ran", flush=True)

    @dataclasses.dataclass(frozen=True)
    class FlatArena(es.EmbeddingSource):
        """``reduce_flat`` alone: the base class's ``reduce_dense`` runs
        it on uniform offsets, so lookups go through sparse_lengths_sum."""
        arena: torch.Tensor

        @property
        def out_dtype(self) -> torch.dtype:
            return self.arena.dtype

        def reduce_flat(self, spec, flat, offsets, *, max_l):
            return ops.sparse_lengths_sum(self.arena, flat, offsets,
                                          max_l=max_l).float()

    # kernels of a served forward on the fixed plan and the flat route
    fb = DLRMSynthetic(cfg, seed=7).batch(32)
    rb = DLRMSynthetic(cfg, seed=7).ragged_batch(32, dist="poisson",
                                                 max_l=MAX_L)
    fdense = torch.from_numpy(fb["dense"]).cuda()
    fidx = torch.from_numpy(fb["indices"]).cuda()
    rdev = {k: torch.from_numpy(rb[k]).cuda()
            for k in ("dense", "indices", "offsets")}
    flat_src = FlatArena(arena)

    def forward_fixed():
        with torch.inference_mode():
            return dlrm.forward(params, cfg, fdense, fidx)

    def forward_flat():
        with torch.inference_mode():
            return dlrm.forward_ragged(params, cfg, rdev["dense"],
                                       rdev["indices"], rdev["offsets"],
                                       max_l=MAX_L, source=flat_src)
    for name, fn in (("forward_fixed", forward_fixed),
                     ("forward_flat", forward_flat)):
        dev, kernels, names = profile(fn, reps=5)
        result["paths"][name] = {
            "kernels": kernels, "device_ms": dev,
            "gathers": {k: v for k, v in names.items()
                        if "embedding_bag" in k or "sparse_lengths" in k}}
        print(name, json.dumps(result["paths"][name]), flush=True)

    def fixed_requests(seed, n):
        b = DLRMSynthetic(cfg, seed=seed).batch(n)
        m, t, n_l = b["indices"].shape
        return requests_from_ragged_batch(
            {"dense": b["dense"], "indices": b["indices"].reshape(-1),
             "offsets": (np.arange(m * t + 1) * n_l).astype(np.int32),
             "labels": b["labels"]}, cfg.n_tables)

    result["serving"] = {}
    engine = RecEngine(cfg, params, max_l=MAX_L, max_batch=BUCKET,
                       device="cuda", source="fixed")
    engine.warmup()
    reqs = fixed_requests(7, N_REQUESTS)
    for i in range(0, len(reqs), BUCKET):
        sent = time.monotonic()
        for r in reqs[i:i + BUCKET]:
            r.submitted_mono = sent
            engine.submit(r)
        engine.step()
    engine.drain()
    stats = engine.stats()
    plain = fixed_requests(8, PLAIN_BATCHES * BUCKET)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(plain), BUCKET):
        for r in plain[i:i + BUCKET]:
            engine.submit(r)
        engine.step()
    torch.cuda.synchronize()
    result["serving"]["fixed"] = {
        "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
        "host_ms_per_batch": (time.perf_counter() - t0) * 1e3
        / PLAIN_BATCHES}

    # the flat route: no engine serves a reduce_flat-only source, so, as
    # chip_smoke.py phase 7 does, the ragged serve step over it, one
    # micro-batch of 32 at a time (its slice on the card, split
    # beforehand); a micro-batch's latency runs to its probabilities on
    # the host
    def flat_batches(seed, n):
        rb = DLRMSynthetic(cfg, seed=seed).ragged_batch(
            n, dist="poisson", max_l=MAX_L)
        dev = {k: torch.from_numpy(rb[k]).cuda()
               for k in ("dense", "indices", "offsets")}
        m = n // BUCKET
        idx_s, off_s = hybrid.split_ragged_microbatches(
            dev["indices"], dev["offsets"], m, MAX_L)
        dense_s = dev["dense"].reshape(m, BUCKET, -1)
        return [{"dense": dense_s[i], "indices": idx_s[i],
                 "offsets": off_s[i]} for i in range(m)]
    step = dlrm.make_ragged_serve_step(cfg, max_l=MAX_L)
    for mb in flat_batches(6, 4 * BUCKET):
        step(params, mb, flat_src)
    lat = []
    for mb in flat_batches(7, N_REQUESTS):
        t0 = time.perf_counter()
        step(params, mb, flat_src).cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    plain = flat_batches(8, PLAIN_BATCHES * BUCKET)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for mb in plain:
        step(params, mb, flat_src)
    torch.cuda.synchronize()
    result["serving"]["flat"] = {
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "host_ms_per_batch": (time.perf_counter() - t0) * 1e3
        / PLAIN_BATCHES}
    for name, row in result["serving"].items():
        print(f"serve_{name}", json.dumps(row), flush=True)
    if args.json is not None:
        args.json.write_text(json.dumps(result))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
