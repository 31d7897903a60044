"""The port's ``gemm`` in its three layouts -- ``x @ w``, ``a @ b^T``
(dx) and ``a^T @ b`` (dw) -- against the JAX reference's Pallas kernel
(interpret=True) on the transposed operands and its XLA oracle; the
backward that reads w and x in place; the tiling plan's design rules;
and the wrappers' guards.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds both
tilings against the plain versions there, bit-for-bit rules included);
here a CPU tensor takes the plain versions in ``kernels/ref.py``.

Tolerance, fp32 on both sides, summed in different orders (torch's CPU
BLAS against XLA's dot): rtol = atol = 1e-5. The inputs have the path's
magnitudes -- activations and gradients O(1), weights He-scaled
(std sqrt(2 / fan_in)) -- so every product sums up to 512 terms into an
O(1) result (dw: up to 65 O(1) terms into O(10)), whose rounding
differences stay near sqrt(K) * 6e-8 of the partial sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm as j_gm
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.configs.dlrm import DLRM_CONFIGS
from repro_torch.core import dlrm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import gemm as t_gm

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

# the DLRM(1) layers' (K, N) with the path's ragged edges: K = 13 and 47,
# N = 1, and the two 512 x 256 layers
LAYERS = [(13, 512), (47, 512), (512, 256), (256, 1)]
ROWS = (1, 8, 31, 64, 65)
CASES = [(m, k, n) for m in ROWS for k, n in LAYERS] + [(2048, 512, 256)]


def _inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * np.sqrt(2.0 / k)).astype(np.float32)
    return x, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
@pytest.mark.parametrize("m,k,n", CASES)
def test_layouts_match_the_pallas_kernel(layout, m, k, n):
    x, w = _inputs(m, k, n, seed=m * 1000 + k + n)
    if layout == "nn":
        got = ops.gemm(_t(x), _t(w))
    elif layout == "nt":
        got = ops.gemm_nt(_t(x), _t(w.T))     # b stored (N, K)
    else:
        got = ops.gemm_tn(_t(x.T), _t(w))     # a stored (K, M)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    for want in (j_gm.gemm(jnp.asarray(x), jnp.asarray(w), interpret=True),
                 j_ref.gemm(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n", [(32, 13, 512), (32, 512, 256),
                                   (8, 256, 1), (65, 47, 64)])
def test_backward_matches_jax_grad(m, k, n):
    x, w = _inputs(m, k, n, seed=m + k + n)
    gy = np.random.RandomState(n).randn(m, n).astype(np.float32)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ops.gemm(tx, tw).backward(_t(gy))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(j_ops.gemm(a, b) * gy),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


def _count_plain(monkeypatch):
    """Record every call of the three plain versions with its operands."""
    calls = []
    for name in ("gemm", "gemm_nt", "gemm_tn"):
        fn = getattr(ref, name)

        def spy(a, b, fn=fn, name=name):
            calls.append((name, a, b))
            return fn(a, b)
        monkeypatch.setattr(ref, name, spy)
    return calls


def test_backward_reads_w_and_x_in_place(monkeypatch):
    """dx = gemm_nt(g, w) and dw = gemm_tn(x, g) on the saved tensors
    themselves: no transposed copy reaches either product."""
    x, w = _inputs(32, 47, 64, seed=3)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = ops.gemm(tx, tw)
    calls = _count_plain(monkeypatch)
    y.backward(torch.ones_like(y))
    assert [c[0] for c in calls] == ["gemm_nt", "gemm_tn"]
    (_, g, w_seen), (_, x_seen, g2) = calls
    assert w_seen.data_ptr() == tw.data_ptr() and w_seen.shape == (47, 64)
    assert x_seen.data_ptr() == tx.data_ptr() and x_seen.shape == (32, 47)
    assert g.data_ptr() == g2.data_ptr()
    assert all(t.is_contiguous() for c in calls for t in c[1:])


def test_backward_skips_dx_where_nothing_needs_it(monkeypatch):
    x, w = _inputs(8, 13, 512, seed=4)
    tw = _t(w).requires_grad_()
    y = ops.gemm(_t(x), tw)
    calls = _count_plain(monkeypatch)
    y.backward(torch.ones_like(y))
    assert [c[0] for c in calls] == ["gemm_tn"]


def test_train_step_backward_runs_no_transposed_gemm(monkeypatch):
    """Through a whole MLP: one forward gemm a layer, dw of every layer
    and dx of every layer but the first, each on its operands in place."""
    cfg = DLRM_CONFIGS["dlrm1"]
    gen = torch.Generator().manual_seed(0)
    params = [(w.requires_grad_(), b) for w, b in
              dlrm.de.init_mlp(gen, (cfg.dense_features,) + cfg.bottom_mlp)]
    x = torch.randn((32, cfg.dense_features), generator=gen)
    calls = _count_plain(monkeypatch)
    y = dlrm.de.mlp_apply(params, x)
    y.sum().backward()
    names = [c[0] for c in calls]
    layers = len(params)
    assert names.count("gemm") == layers
    assert names.count("gemm_tn") == layers
    assert names.count("gemm_nt") == layers - 1
    ws = {w.data_ptr() for w, _ in params}
    assert {c[2].data_ptr() for c in calls if c[0] == "gemm_nt"} <= ws


# ---------------------------------------------------------------- plan

def _dlrm1_shapes():
    """(M, K, N) of every forward, dx and dw product of DLRM(1)'s six
    layers at batch 1, 8, 32 and 2048."""
    cfg = DLRM_CONFIGS["dlrm1"]
    dims = [(cfg.dense_features,) + cfg.bottom_mlp,
            (dlrm.top_mlp_in_dim(cfg),) + cfg.top_mlp]
    layers = [(d[i], d[i + 1]) for d in dims for i in range(len(d) - 1)]
    return [s for b in (1, 8, 32, 2048) for k, n in layers
            for s in ((b, k, n), (b, n, k), (k, b, n))]


@pytest.mark.parametrize("m,k,n", sorted(set(_dlrm1_shapes())))
def test_every_dlrm1_product_has_a_plan(m, k, n):
    p = t_gm.plan(m, k, n)
    tc = m > t_gm.CLUSTER_ROWS and k > t_gm.SPLIT_FROM and n > t_gm.NARROW_N
    assert p.route == ("tf32x3" if tc else "cluster")
    assert 1 <= p.split <= t_gm.MAX_SPLIT
    assert p.slice % (t_gm.TC_TILE_K if tc else 4) == 0
    assert p.split * p.slice >= k > (p.split - 1) * p.slice


@pytest.mark.parametrize("k", [1, 13, 32, 47, 64, 65, 70, 256, 512, 577,
                               2048])
def test_split_never_depends_on_m(k):
    """The summation order of output (r, c) -- route, split and slice -- is
    one for every M of a route: a row's bits do not depend on M
    (pipelined micro-batches equal the single-shot forward). Up to 64
    rows it does not depend on N either."""
    cluster = {t_gm.plan(m, k, n) for m in range(1, t_gm.CLUSTER_ROWS + 1)
               for n in (1, 32, 65, 256, 512)}
    assert len(cluster) == 1
    for n in (1, 32, 65, 256, 512):
        assert len({t_gm.plan(m, k, n) for m in (65, 100, 512, 2048)}) == 1
    for p in cluster | {t_gm.plan(2048, k, n) for n in (1, 256)}:
        assert 1 <= p.split <= 8
        assert p.split * p.slice >= k > (p.split - 1) * p.slice


@pytest.mark.parametrize("k,split", [(13, 1), (47, 1), (32, 1), (64, 1),
                                     (65, 3), (70, 3), (256, 8), (512, 8),
                                     (2048, 8)])
def test_cluster_split_sizes(k, split):
    p = t_gm.plan(32, k, 256)
    assert p.route == "cluster" and p.split == split
    assert p.slice == (-(-k // split) + 3) // 4 * 4


@pytest.mark.parametrize("k,n,split,depth", [
    (512, 256, 2, 256), (2048, 256, 8, 256), (256, 512, 1, 256),
    (512, 47, 8, 64), (70, 65, 2, 64)])
def test_tensor_core_split_sizes(k, n, split, depth):
    assert t_gm.plan(2048, k, n) == ("tf32x3", split, depth)


@pytest.mark.parametrize("k,n", [(13, 512), (47, 512), (256, 32), (256, 1),
                                 (32, 256), (1, 256), (2048, 32)])
def test_small_k_or_narrow_n_stays_on_the_cuda_cores(k, n):
    """A product with K <= 64 or N <= 32 takes the split-K tiling at any
    M, with the plan it has at M = 32: its rows' bits never depend on M."""
    for m in (1, 64, 65, 512, 2048):
        assert t_gm.plan(m, k, n) == t_gm.plan(32, k, n)
        assert t_gm.plan(m, k, n).route == "cluster"


@pytest.mark.parametrize("m", [65, 66, 512, 2048])
def test_above_64_rows_a_wide_deep_product_takes_the_tensor_cores(m):
    assert t_gm.plan(m, 512, 256).route == "tf32x3"
    assert t_gm.plan(m - 1 if m == 65 else 64, 512, 256).route == "cluster"


def test_plan_refuses_an_empty_product():
    with pytest.raises(ValueError, match="empty"):
        t_gm.plan(0, 13, 512)


# ---------------------------------------------------------------- guards

_NEW = {"gemm_nt": (t_gm.gemm_nt, ((2, 3), (4, 3))),
        "gemm_tn": (t_gm.gemm_tn, ((3, 2), (3, 4)))}


def _refuses(fn, a, b, match):
    before = t_gm.launches
    with pytest.raises(ValueError, match=match):
        fn(a, b)
    assert t_gm.launches == before


@pytest.mark.parametrize("name", sorted(_NEW))
def test_new_wrappers_refuse_cpu_tensors(name):
    fn, (sa, sb) = _NEW[name]
    _refuses(fn, torch.ones(sa), torch.ones(sb), "CUDA device")


@pytest.mark.parametrize("name", sorted(_NEW))
def test_new_wrappers_refuse_non_contiguous(name):
    fn, (sa, sb) = _NEW[name]
    _refuses(fn, torch.ones(sa[::-1]).t(), torch.ones(sb), "contiguous")
    _refuses(fn, torch.ones(sa), torch.ones(sb[::-1]).t(), "contiguous")


@pytest.mark.parametrize("name", sorted(_NEW))
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_new_wrappers_refuse_non_fp32(name, dtype):
    fn, (sa, sb) = _NEW[name]
    _refuses(fn, torch.ones(sa, dtype=dtype), torch.ones(sb), "float32")


@pytest.mark.parametrize("name", sorted(_NEW) + ["gemm"])
def test_wrappers_refuse_mismatched_operands(name):
    fn = t_gm.gemm if name == "gemm" else _NEW[name][0]
    _refuses(fn, torch.ones(2, 3), torch.ones(5, 7), "contraction mismatch")
    _refuses(fn, torch.ones(2, 3, 1), torch.ones(3, 3), "2-d")


@pytest.mark.parametrize("name", ["gemm_nt", "gemm_tn"])
def test_ops_refuse_mixed_devices(name):
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(ops, name)(torch.ones(3, 3), torch.ones(3, 3, device="meta"))
