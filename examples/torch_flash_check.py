#!/usr/bin/env python3
"""A short check of the port's flash attention kernel on one card.

    python3 examples/torch_flash_check.py

Builds the CUDA kernels and prints ptxas's report for ``flash_attention``
(registers a thread, shared memory, spills); launches the kernel once at
a small shape and holds it against its plain version (``kernels/ref.py``)
before anything larger, at hd 64 and at hd 256; then, at fourteen bf16
shapes (smollm-360m's heads at S = 2048 and 4096, causal and, at 2048,
not; hd 80 with a window; hd 128; recurrentgemma-9b's 16/1 heads of 256
with its window of 2048 at S = 2048 and 4096; seamless-m4t's encoder, 16
heads of 64 not causal at S = 3200; the smoke configs' hd 16 and 20, the
last padded to 32; lengths that are no multiple of the kernel's 64- or
128-row q tile and its 64- or 128-key kv tile), prints the largest
difference, whether it is within 2^-7 (1 + |plain|), and whether two
launches give the same bits. Then it times the kernel and
``F.scaled_dot_product_attention`` (kv heads repeated before the timing;
a window as an explicit boolean band mask, except where S <= window and
the band is the causal triangle) with CUDA events at the first eight
shapes, the wrapper's host time a call, and ``api.prefill`` of
smollm-360m at full width (seeded weights) at 2,048 and 4,096 tokens.
``chip_smoke.py`` phases 10, 17 and 18 run the full check; this is the
quick one for a first build.

It imports ``repro_torch`` from the ``src`` beside it and calls only the
wrapper's public entry, so a copy placed in an older checkout times that
checkout's kernel: run the two in turns to compare them on one card.
"""
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (B, S, H, KH, hd, causal, window); the first TIMED are timed
CASES = [(1, 2048, 15, 5, 64, True, None), (1, 4096, 15, 5, 64, True, None),
         (1, 4096, 32, 8, 80, True, 512), (1, 2048, 20, 20, 128, True, None),
         (1, 2048, 15, 5, 64, False, None),
         (1, 2048, 16, 1, 256, True, 2048), (1, 4096, 16, 1, 256, True, 2048),
         (1, 3200, 16, 16, 64, False, None),
         (2, 100, 3, 1, 20, True, None), (2, 2049, 4, 2, 16, True, 16),
         (2, 100, 4, 4, 16, True, None), (1, 300, 4, 2, 64, True, 37),
         (2, 100, 16, 1, 256, True, 2048), (1, 2049, 16, 1, 256, True, 2048)]
TIMED = 8
PREFILL_LENGTHS = (2048, 4096)


def time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel(q, k, v, causal, window):
    return fa.flash_attention_gqa(q, k, v, causal=causal, window=window)


def check(q, k, v, causal, window) -> str:
    got = kernel(q, k, v, causal, window)
    again = kernel(q, k, v, causal, window)
    s = q.shape[1]
    blk = 512 if any(s % c == 0 for c in range(64, 513)) else s
    want = ref.flash_attention_gqa(q, k, v, causal=causal, window=window,
                                   bq=blk, bk=blk)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    within = bool((err <= 2 ** -7 * (1 + want.float().abs())).all())
    return (f"max abs {err.max().item():.3e} within tol {within} finite "
            f"{torch.isfinite(got).all().item()} deterministic "
            f"{torch.equal(got, again)}")


def host_us(q, k, v, calls: int = 200, trials: int = 7) -> list:
    """Host microseconds a wrapper call, at a shape whose kernel takes
    less than that, so the card keeps up and the loop times the host."""
    for _ in range(10):
        kernel(q, k, v, True, None)
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(calls):
            kernel(q, k, v, True, None)
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return out


def prefill_times() -> None:
    from repro_torch.configs import registry
    from repro_torch.models import api
    cfg = registry.get_arch("smollm-360m")
    params = api.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      device="cuda")
    for s in PREFILL_LENGTHS:
        tok = torch.from_numpy(np.random.RandomState(s).randint(
            0, cfg.vocab_size, (1, s)).astype(np.int32)).cuda()
        for _ in range(2):
            api.prefill(params, cfg, {"tokens": tok}, s)
        torch.cuda.synchronize()
        walls, hosts = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            api.prefill(params, cfg, {"tokens": tok}, s)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            hosts.append((t1 - t0) * 1e3)
        print(f"prefill S {s}: wall ms median {statistics.median(walls):.2f} "
              f"{[round(x, 2) for x in walls]}, host enqueue ms median "
              f"{statistics.median(hosts):.2f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(ROOT, torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print("build", time.perf_counter() - t0, flush=True)
    print(_build.build_logs()["flash_attention"], flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)

    for d in (64, 256):
        q, k, v = rnd(1, 256, 2, d), rnd(1, 256, 1, d), rnd(1, 256, 1, d)
        print(f"first launch, hd {d}", check(q, k, v, True, None),
              flush=True)
    for b, s, h, kh, d, causal, w in CASES:
        q, k, v = rnd(b, s, h, d), rnd(b, s, kh, d), rnd(b, s, kh, d)
        print(b, s, h, kh, d, causal, w, check(q, k, v, causal, w),
              flush=True)
    for b, s, h, kh, d, causal, w in CASES[:TIMED]:
        q, k, v = rnd(b, s, h, d), rnd(b, s, kh, d), rnd(b, s, kh, d)
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(h // kh, 1)
                  for t in (k, v))
        mask = None
        if w is not None and s > w:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - w))
        ms = time_ms(lambda: kernel(q, k, v, causal, w))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None))
        print(b, s, h, kh, d, causal, w, "kernel ms", ms, "sdpa ms", sdpa,
              "(band as a mask)" if mask is not None else "", flush=True)
    q, k = rnd(1, 128, 15, 64), rnd(1, 128, 5, 64)
    us = host_us(q, k, k)
    print(f"wrapper host us a call (S 128, 15/5 x 64): median "
          f"{statistics.median(us):.2f} {[round(x, 2) for x in us]}",
          flush=True)
    prefill_times()


if __name__ == "__main__":
    main()
