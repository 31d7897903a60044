#!/usr/bin/env python3
"""A check of the port's ``sls_grad_table`` at the training path's calls.

    python3 examples/torch_sls_grad_check.py [--tree DIR] [--json FILE]
    python3 examples/torch_sls_grad_check.py --turns PARENT [--procs 5]
                                              [--json FILE]

The three calls: the dense-gradient backward over DLRM(1)'s dense ids at
batch 32 (6,400 positions) and at batch 2048 (409,600) into the
1,000,001 x 32 table with the null row skipped, and the sparse step's
row gradients at batch 32 (6,400 positions of unique-row ids into 6,400
rows). For each: whether it equals the plain version on the CPU bit for
bit and repeats on a second launch; device ms a call and kernels a call
from the profiler (the median of five windows of 20 calls); ms a call
with CUDA events around back-to-back calls (host launch included); the
device ms of ``zeros`` + ``index_add_`` on the same inputs; and that of
``zero_`` on a table of the output's shape, the output write alone. On a
tree whose wrapper takes a ``grad_plan``, the kernel is also timed with
a contiguous plan (each block one range of 8,192 rows) beside the
granule-interleaved one the wrapper uses. It builds the kernels first
and prints ptxas's report for ``sls_grad_table``.

``--tree DIR`` imports ``repro_torch`` from DIR/src, so one card can
time another checkout. ``--turns PARENT`` runs this script in ``--procs``
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
    import numpy as np
    summary = {}
    for who, results in runs.items():
        for call in results[0]["calls"]:
            dev = [r["calls"][call]["device_ms"] for r in results]
            q1, med, q3 = np.percentile(dev, [25, 50, 75])
            summary.setdefault(call, {})[who] = {
                "device_ms_median": med, "device_ms_q1": q1,
                "device_ms_q3": q3, "device_ms": dev,
                "kernels_per_call": results[0]["calls"][call]["kernels"],
                "exact": all(r["calls"][call]["exact"] for r in results)}
            print(f"{call:22s} {who:7s} device ms median {med:.5f} "
                  f"[{q1:.5f}, {q3:.5f}] over {len(dev)} processes; "
                  f"kernels a call "
                  f"{results[0]['calls'][call]['kernels']}", flush=True)
    print(runs["change"][0]["nvidia_smi"], flush=True)
    return {"turns": summary, "order": order,
            "nvidia_smi": runs["change"][0]["nvidia_smi"],
            "library_device_ms": {c: v["library_device_ms"] for c, v in
                                  runs["change"][0]["calls"].items()},
            "contiguous_device_ms": {
                c: v.get("contiguous_device_ms")
                for c, v in runs["change"][0]["calls"].items()}}


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
    from repro_torch.core import dlrm
    from repro_torch.core import sparse_engine as se
    from repro_torch.data import DLRMSynthetic
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.training import unique_padded

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(args.tree, torch.__version__, torch.version.cuda, smi, flush=True)
    _build.build_all()
    print(_build.build_logs()["sls_grad_table"], flush=True)

    def kernel_times(fn) -> tuple:
        """(device ms a call, kernels a call): medians over WINDOWS
        profiler windows of 20 calls."""
        fn()
        torch.cuda.synchronize()
        dev, count = [], []
        for _ in range(WINDOWS):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            us, n = 0.0, 0
            for e in p.key_averages():
                t = getattr(e, "self_device_time_total", None)
                if t is None:
                    t = getattr(e, "self_cuda_time_total", 0.0)
                if t > 0:
                    us += t
                    n += e.count
            if us > 0:
                dev.append(us / 1e3 / 20)
                count.append(n / 20)
        return float(np.median(dev)), float(np.median(count))

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

    cfg = DLRM_CONFIGS["dlrm1"]
    spec = dlrm.arena_spec(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = {}
    for b in BATCHES:
        rb = DLRMSynthetic(cfg, seed=13).ragged_batch(
            b, dist="poisson", max_l=MAX_L, pad_to=b * cfg.n_tables * MAX_L)
        idx = torch.from_numpy(rb["indices"]).cuda()
        off = torch.from_numpy(rb["offsets"]).cuda()
        flat = se.flatten_ragged_indices(spec, idx, off)
        ids = se.ragged_dense_ids(flat, off, max_l=MAX_L,
                                  fill=spec.null_row).reshape(-1)
        n_bags = b * cfg.n_tables
        calls[f"dense_{b}"] = (
            torch.randn((n_bags, spec.dim), generator=gen, device="cuda"),
            ids, torch.arange(n_bags + 1, dtype=torch.int32,
                              device="cuda") * MAX_L,
            spec.total_rows, spec.null_row)
    rb = DLRMSynthetic(cfg, seed=14).ragged_batch(
        32, max_l=MAX_L, pad_to=32 * cfg.n_tables * MAX_L)
    idx = torch.from_numpy(rb["indices"]).cuda()
    off = torch.from_numpy(rb["offsets"]).cuda()
    flat = se.flatten_ragged_indices(spec, idx, off)
    _, inv = unique_padded(flat, spec.null_row)
    calls["sparse_step_32"] = (
        torch.randn((off.numel() - 1, spec.dim), generator=gen,
                    device="cuda"), inv.to(torch.int32), off, flat.numel(),
        None)

    result = {"tree": str(args.tree), "nvidia_smi": smi,
              "device": torch.cuda.get_device_name(0), "calls": {}}
    for name, (g, ids, off, n_rows, skip) in calls.items():
        def kernel(g=g, ids=ids, off=off, n_rows=n_rows, skip=skip):
            return eg.sls_grad_table(g, ids, off, n_rows=n_rows,
                                     skip_row=skip)
        got, again = kernel(), kernel()
        want = ref.sls_grad_table(g.cpu(), ids.cpu(), off.cpu(), n_rows)
        if skip is not None:
            want[skip] = 0.0
        pos = torch.arange(ids.numel(), device="cuda", dtype=torch.int32)
        bag = torch.clamp(torch.searchsorted(off[1:], pos, right=True),
                          max=g.shape[0] - 1)
        keep = pos < off[-1]
        if skip is not None:
            keep &= ids != skip
        valid = keep.float()[:, None]

        def library(g=g, ids=ids, n_rows=n_rows, bag=bag, valid=valid):
            return torch.zeros(n_rows, g.shape[1], device="cuda").index_add_(
                0, ids, g[bag] * valid)
        dev, kernels = kernel_times(kernel)
        table = torch.empty((n_rows, g.shape[1]), device="cuda")
        row = {"exact": bool(torch.equal(got.cpu(), want)
                             and torch.equal(got, again)),
               "device_ms": dev, "kernels": kernels,
               "ms": events_ms(kernel),
               "library_device_ms": kernel_times(library)[0],
               # the output write alone: zero_ of a table of this shape
               "zero_device_ms": kernel_times(table.zero_)[0]}
        if hasattr(eg, "grad_plan"):
            row["contiguous_device_ms"] = contiguous_ms(
                eg, _build, kernel_times, g, ids, off, n_rows, skip, got)
        result["calls"][name] = row
        print(name, json.dumps(row), flush=True)
    if args.json is not None:
        args.json.write_text(json.dumps(result))
    print(json.dumps(result))


def contiguous_ms(eg, _build, kernel_times, g, ids, off, n_rows, skip, want):
    """Device ms of the kernels under a contiguous plan: 8,192-row
    granules, one a block, so block q owns rows [8192 q, 8192 (q + 1));
    its result must equal the wrapper's."""
    import torch
    n, dim = ids.numel(), g.shape[1]
    p = eg.grad_plan(n, n_rows, dim)
    granule = 8192
    blocks = 1 << (max(1, -(-n_rows // granule)) - 1).bit_length()
    p = p._replace(blocks=blocks, granule=granule, rows_per_block=granule,
                   smem_bytes=eg.smem_bytes(dim, p.chunk, p.tile, granule),
                   work_words=(2 * n + 2 * -(-n // eg.TILE) * blocks
                               if p.partition else 0))
    fn = _build.function("sls_grad_table", "sls_grad_table_f32", eg._ARGS)

    def kernel():
        out = torch.empty((n_rows, dim), device="cuda")
        work = torch.empty(p.work_words, dtype=torch.int32, device="cuda")
        _build.launch(fn, "sls_grad_table", g.device, g.data_ptr(),
                      ids.data_ptr(), off.data_ptr(), out.data_ptr(),
                      work.data_ptr(), n, g.shape[0], n_rows, dim,
                      -1 if skip is None else skip, p.blocks, p.granule,
                      p.chunk, p.tile, p.rows_per_block, p.smem_bytes,
                      int(p.partition))
        return out
    if not torch.equal(kernel(), want):
        raise RuntimeError("the contiguous plan gives other bits")
    return kernel_times(kernel)[0]


if __name__ == "__main__":
    main()
