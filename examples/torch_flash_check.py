#!/usr/bin/env python3
"""A short first check of the port's flash attention kernel on one card.

    python3 examples/torch_flash_check.py

Builds the CUDA kernels, prints ptxas's report for ``flash_attention``,
holds the kernel against its plain version (``kernels/ref.py``) at eight
bf16 shapes (smollm-360m's heads at S = 2048 and 4096, hd 80 with a
window, hd 128, the smoke configs' hd 16 and 20, lengths that are no
multiple of the 64-row tile) and prints the largest difference of each;
then times the kernel, ``F.scaled_dot_product_attention`` on the same
inputs (kv heads repeated before the timing) and the plain version at
smollm-360m's shape, with CUDA events. ``chip_smoke.py`` phase 10 runs
the full check; this is the quick one for a first build.
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (B, S, H, KH, hd, window)
CASES = [(1, 2048, 15, 5, 64, None), (1, 4096, 15, 5, 64, None),
         (1, 4096, 32, 8, 80, 512), (1, 2048, 20, 20, 128, None),
         (2, 100, 3, 1, 20, None), (2, 2049, 4, 2, 16, 16),
         (2, 100, 4, 4, 16, None), (1, 300, 4, 2, 64, 37)]


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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    _build.build_all()
    print("build", time.perf_counter() - t0)
    print(_build.build_logs()["flash_attention"])
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)

    for b, s, h, kh, d, w in CASES:
        q, k, v = rnd(b, s, h, d), rnd(b, s, kh, d), rnd(b, s, kh, d)
        got = fa.flash_attention_gqa(q, k, v, causal=True, window=w)
        want = ref.flash_attention_gqa(q, k, v, causal=True, window=w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        print(b, s, h, kh, d, w, "max abs", err.max().item(), "finite",
              torch.isfinite(got).all().item(), "n>1e-2",
              int((err > 1e-2).sum()), "max |want|",
              want.float().abs().max().item())
    for s in (2048, 4096):
        q, k, v = rnd(1, s, 15, 64), rnd(1, s, 5, 64), rnd(1, s, 5, 64)
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(3, 1) for t in (k, v))
        print(s, "kernel ms", time_ms(lambda: fa.flash_attention_gqa(q, k, v)),
              "sdpa ms", time_ms(lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True)),
              "plain ms", time_ms(lambda: ref.flash_attention_gqa(q, k, v),
                                  reps=3))


if __name__ == "__main__":
    main()
