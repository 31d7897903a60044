"""The port's flash attention (its plain version, as a CPU tensor runs it)
against the reference's Pallas kernel in interpret mode, on the same
numpy inputs; the op's backward by recompute; and the wrapper's guards.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.

Tolerances, the reference's own (tests/test_kernels.py): f32 2e-5 (the
same blocked online softmax, matmuls summed in another order); bf16 5e-2
(outputs rounded to bf16, P rounded to bf16 before the PV product on
both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_fa
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _both(a, dtype):
    j_dt, t_dt = _DTYPES[dtype]
    return jnp.asarray(a, j_dt), torch.from_numpy(a).to(t_dt)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# the JAX test's grid (tests/test_kernels.py), plus a window that masks
# whole kv blocks (window 16 with blocks of 32: a q block's earliest kv
# blocks hold no key of its band), and kimi-k2's hd 112 and
# recurrentgemma-9b's hd 256, with and without a window
@pytest.mark.parametrize("s,d,causal,window,bq,bk",
                         [(128, 64, True, None, 64, 64),
                          (96, 32, False, None, 32, 32),
                          (128, 64, True, 32, 64, 32),
                          (100, 16, True, None, 64, 64),
                          (128, 16, True, 16, 32, 32),
                          (128, 112, True, None, 64, 64),
                          (100, 112, True, 32, 64, 32),
                          (128, 256, True, 48, 64, 32),
                          (100, 256, True, None, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_kernel(s, d, causal, window, bq, bk,
                                               dtype):
    rng = np.random.RandomState(s + d + (window or 0))
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.randn(2, s, d).astype(np.float32), dtype)
        for _ in range(3))
    got = ref.flash_attention(tq, tk, tv, causal=causal, window=window,
                              bq=bq, bk=bk)
    assert got.dtype == tq.dtype and got.shape == (2, s, d)
    want = j_fa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                bq=bq, bk=bk, interpret=True)
    _close(got, want, _TOL[dtype])
    # the op on CPU tensors is the plain version (default blocks)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=causal,
                                           window=window),
                       ref.flash_attention(tq, tk, tv, causal=causal,
                                           window=window))


@pytest.mark.parametrize("h,kh,window", [(8, 2, None), (6, 3, 24),
                                         (4, 4, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gqa_matches_reference_wrapper(h, kh, window, dtype):
    rng = np.random.RandomState(h * 10 + kh)
    (jq, tq), = [_both(rng.randn(2, 64, h, 32).astype(np.float32), dtype)]
    (jk, tk), (jv, tv) = (_both(rng.randn(2, 64, kh, 32).astype(np.float32),
                                dtype) for _ in range(2))
    got = ops.flash_attention_gqa(tq, tk, tv, causal=True, window=window)
    assert got.shape == (2, 64, h, 32) and got.dtype == tq.dtype
    want = j_fa.flash_attention_gqa(jq, jk, jv, causal=True, window=window,
                                    interpret=True)
    _close(got, want, _TOL[dtype])


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_op_backward_recomputes_through_the_chunked_path(
        window):
    """The reference's kernel has no backward; the port's op recomputes
    through ``models.layers._sdpa_chunked`` (what ``jax.grad`` takes off
    the TPU): its gradients equal autograd through that path bit for bit,
    in both forms of the op."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, h, 16, generator=gen).requires_grad_()
               for h in (2, 1, 1))
    g = torch.randn(1, 8, 2, 16, generator=gen)
    got = torch.autograd.grad(
        ops.flash_attention_gqa(q, k, v, window=window), (q, k, v), g)
    pos = torch.arange(8)
    ref_out = layers._sdpa_chunked(q.reshape(1, 8, 1, 2, 16), k, v, pos, pos,
                                   True, window, 8, 8)
    want = torch.autograd.grad(ref_out.reshape(1, 8, 2, 16), (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the (BH, S, d) form: one head a row
    x = q[0].transpose(0, 1).detach().requires_grad_()
    (dx,) = torch.autograd.grad(ops.flash_attention(x, x, x).sum(), (x,))
    ref_x = layers._sdpa_chunked(x[:, :, None, None], x[:, :, None],
                                 x[:, :, None], pos, pos, True, None, 8, 8)
    (want_x,) = torch.autograd.grad(ref_x.sum(), (x,))
    assert torch.equal(dx, want_x)


def test_reference_flash_kernel_has_no_gradient():
    """The contract gap the op follows (ROADMAP Queue 3): ``jax.grad``
    through the Pallas kernel raises, though its docstring promises a
    recompute."""
    q = jnp.ones((1, 32, 8), jnp.float32)
    with pytest.raises(Exception):
        jax.grad(lambda x: j_fa.flash_attention(
            x, x, x, bq=16, bk=16, interpret=True).sum())(q)


# ---------------------------------------------------------------------------
# guards: dispatch by device, what the wrapper takes
# ---------------------------------------------------------------------------

def _qkv(dtype=torch.bfloat16, d=16, h=2, kh=1, device="cpu"):
    return (torch.zeros(1, 4, h, d, dtype=dtype, device=device),
            torch.zeros(1, 4, kh, d, dtype=dtype, device=device),
            torch.zeros(1, 4, kh, d, dtype=dtype, device=device))


@pytest.mark.parametrize("op", ["flash_attention_gqa", "flash_attention"])
def test_op_refuses_devices_other_than_cpu_and_cuda(op):
    q, k, v = _qkv(device="meta")
    args = (q, k, v) if op == "flash_attention_gqa" else (q[:, :, 0],
                                                          k[:, :, 0],
                                                          v[:, :, 0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(ops, op)(*args)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("int64", "bfloat16"),
    ("float32", "bfloat16"),
    ("d112", "CUDA device"),
    ("d96", "not instantiated"),
    ("d32", "not instantiated"),
    ("heads", "evenly"),
    ("window", "window"),
    ("rank", "4 dims"),
])
def test_wrapper_guards(case, match):
    """The wrapper launches its kernel or raises, and never computes on
    the CPU."""
    kw = {}
    if case in ("int64", "float32"):
        q, k, v = _qkv(dtype=getattr(torch, case))
    elif case.startswith("d"):
        q, k, v = _qkv(d=int(case[1:]))
    elif case == "heads":
        q, k, v = _qkv(h=3, kh=2)
    elif case == "rank":
        q, k, v = (t[0] for t in _qkv())
    else:
        q, k, v = _qkv()
        kw = {"window": 0} if case == "window" else {}
    before = t_fa.launches
    with pytest.raises(ValueError, match=match):
        t_fa.flash_attention_gqa(q, k, v, **kw)
    assert t_fa.launches == before


def test_wrapper_instantiates_every_head_dim_the_configs_reach():
    """Every GQA config's head dim (MLA attends through the chunked path,
    never the kernel; RWKV has no attention): kimi-k2's 112 with the MoE
    decoders, recurrentgemma-9b's 256 and seamless-m4t's 64."""
    from repro_torch.configs import registry
    dims = {c.attention.resolved_head_dim(c.d_model)
            for table in (registry.ARCHS, registry.SMOKE_ARCHS)
            for c in table.values() if c.attention.kind == "gqa"}
    assert dims == {16, 20, 64, 80, 112, 128, 256} == set(t_fa.HEAD_DIMS)


# ---------------------------------------------------------------------------
# the wrapper's own decisions, on the CPU
# ---------------------------------------------------------------------------

def _registry_heads():
    """(hd, H, KH) of every config the registry holds."""
    from repro_torch.configs import registry
    out = set()
    for table in (registry.ARCHS, registry.SMOKE_ARCHS):
        for c in table.values():
            a = c.attention
            out.add((a.resolved_head_dim(c.d_model), a.n_heads,
                     a.n_kv_heads))
    return sorted(out)


@pytest.mark.parametrize("d,route,depth", [
    (16, "tma", 16), (20, "pad", 32), (64, "tma", 64), (80, "tma", 80),
    (112, "pad", 128), (128, "tma", 128), (256, "tma", 256)])
def test_route_and_depth_per_head_dim(d, route, depth):
    """hd 20 is padded to 32 (its 40-byte head stride breaks TMA's rule)
    and hd 112 to 128 (as itself it would take a third panel): the
    smallest instantiated depth at or above; every other head dim runs as
    it is."""
    assert d in t_fa.HEAD_DIMS
    assert t_fa.route(d) == route and t_fa.depth(d) == depth


@pytest.mark.parametrize("hd,h,kh", _registry_heads())
def test_tma_stride_rule_holds_for_every_registry_config(hd, h, kh):
    dp = t_fa.depth(hd)
    assert t_fa.tma_strides_ok(dp, h) and t_fa.tma_strides_ok(dp, kh)
    # the unpadded hd 20 is what the pad route exists for
    assert t_fa.tma_strides_ok(hd, kh) == (hd != 20)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 512)])
@pytest.mark.parametrize("d", [16, 20, 64, 80, 112, 128, 256])
def test_c_entry_scalars_per_head_dim(d, causal, window):
    """The C entry runs at the padded depth, stores the true head dim's
    columns and scales by the true head dim (hd 20: 20**-0.5, not
    32**-0.5), folded with log2(e) for the kernel's exp2."""
    dp, d_out, scale_log2, c, w = t_fa.c_args(d, causal, window)
    assert dp == t_fa.depth(d) and d_out == d <= dp
    np.testing.assert_allclose(scale_log2 / np.log2(np.e), d ** -0.5,
                               rtol=1e-12)
    assert c == int(causal) and w == (window or 0)


def test_launch_error_names_the_failing_call():
    assert "CUresult 1" in t_fa.launch_error(t_fa.ENCODE_ERROR + 1)
    assert "failed to launch" in t_fa.launch_error(1)


@pytest.mark.parametrize("d", [16, 64, 80, 128, 256])
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_wrapper_refuses_inputs_off_tma_alignment(which, d):
    """TMA reads 16-byte aligned addresses: a view two bytes into its
    storage is refused before any launch (and before the device check),
    at every head dim that goes to the kernel as it is."""
    q, k, v = _qkv(d=d)
    t = {"q": q, "k": k, "v": v}[which]
    shifted = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    args = {"q": q, "k": k, "v": v, which: shifted}
    before = t_fa.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        t_fa.flash_attention_gqa(args["q"], args["k"], args["v"])
    assert t_fa.launches == before


def test_wrapper_pads_hd_112_to_depth_128_before_its_checks():
    """hd 112 goes through the pad route too: a misaligned view is copied
    to depth 128, so only the device check remains to refuse a CPU
    tensor; the C entry stores 112 columns scaled by 112**-0.5."""
    q, k, v = _qkv(d=112)
    shifted = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    with pytest.raises(ValueError, match="CUDA device"):
        t_fa.flash_attention_gqa(shifted, k, v)
    dp, d_out, scale_log2, _, _ = t_fa.c_args(112, True, None)
    assert (dp, d_out) == (128, 112)
    assert t_fa.tma_strides_ok(dp, 64) and t_fa.tma_strides_ok(dp, 8)


def test_wrapper_pads_hd_20_before_its_checks():
    """hd 20 goes through the pad route: a misaligned view is copied, so
    only the device check remains to refuse a CPU tensor."""
    q, k, v = _qkv(d=20)
    shifted = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    with pytest.raises(ValueError, match="CUDA device"):
        t_fa.flash_attention_gqa(shifted, k, v)
