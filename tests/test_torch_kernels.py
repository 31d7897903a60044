"""The port's kernels (plain versions, as a CPU tensor runs them) against
the JAX reference's Pallas kernels (interpret=True) and XLA oracles, on
the same numpy inputs; plus the no-fallback guards of the kernel
wrappers and the build.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds each one against its plain version there. Nothing here imports
triton or needs nvcc.

Tolerances (fp32 everywhere; XLA and torch sum in different orders):
  * gemm: K <= 64 products of O(1) values -> rtol=atol=1e-5;
  * fused_segment_sum: <= 9 terms of O(1) -> atol=1e-5, and the
    reference's own ~1e-2-scale arena case -> atol=1e-6;
  * interaction: D <= 32 products of O(1) -> rtol=atol=1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import feature_interaction as j_fi
from repro.kernels import fused_dispatch as j_fd
from repro.kernels import gemm as j_gm
from repro.kernels import ref as j_ref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import embedding_gather as t_eg
from repro_torch.kernels import feature_interaction as t_fi
from repro_torch.kernels import fused_dispatch as t_fd
from repro_torch.kernels import gemm as t_gm

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# gemm (dense engine)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(4, 13, 16), (8, 47, 64), (3, 16, 1),
                                   (1, 5, 7), (32, 64, 16)])
def test_gemm_matches_jax(m, k, n):
    rng = np.random.RandomState(m * 100 + k)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    got = ops.gemm(_t(x), _t(w))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    for want in (j_gm.gemm(jnp.asarray(x), jnp.asarray(w), interpret=True),
                 j_ref.gemm(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fused_segment_sum (sparse engine)
# ---------------------------------------------------------------------------

def _dense_case(rng, v, b, l):
    """(b, l) ids with short bags filled by the zero null row v - 1."""
    ids = rng.randint(0, v - 1, (b, l))
    lens = rng.randint(0, l + 1, b)
    for i in range(b):
        ids[i, lens[i]:] = v - 1
    return ids.astype(np.int32)


@pytest.mark.parametrize("v,d,b,l", [(100, 32, 4, 1), (257, 16, 8, 6),
                                     (64, 8, 3, 9), (20, 16, 5, 0)])
def test_fused_segment_sum_matches_jax(v, d, b, l):
    rng = np.random.RandomState(v + d + b + l)
    table = rng.randn(v, d).astype(np.float32)
    table[v - 1] = 0.0
    ids = _dense_case(rng, v, b, l)
    got = ops.fused_segment_sum(_t(table), _t(ids), null_row=v - 1)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    for want in (j_ref.fused_segment_sum(jnp.asarray(table),
                                         jnp.asarray(ids)),
                 j_fd.fused_segment_sum(jnp.asarray(table), jnp.asarray(ids),
                                        interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_fused_segment_sum_bags_of_40_small_rows():
    """The serving shape class: bags up to max_l = 40 of ~1e-2 rows."""
    rng = np.random.RandomState(40)
    table = (0.01 * rng.randn(500, 32)).astype(np.float32)
    table[-1] = 0.0
    ids = _dense_case(rng, 500, 12, 40)
    got = ops.fused_segment_sum(_t(table), _t(ids))
    want = j_fd.fused_segment_sum(jnp.asarray(table), jnp.asarray(ids),
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# interaction (dense engine, batched X X^T)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,f,d", [(4, 4, 16), (1, 6, 32), (7, 3, 8)])
def test_interaction_matches_jax(b, f, d):
    x = np.random.RandomState(b * f * d).randn(b, f, d).astype(np.float32)
    got = ops.interaction(_t(x))
    assert got.shape == (b, f, f)
    for want in (j_fi.interaction(jnp.asarray(x), interpret=True),
                 j_ref.interaction(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,f,d", [(4, 4, 16), (2, 6, 32), (3, 2, 8)])
def test_interaction_tril_matches_jax(b, f, d):
    x = np.random.RandomState(f + d).randn(b, f, d).astype(np.float32)
    got = ops.interaction_tril(_t(x))
    want = j_ref.interaction_tril(jnp.asarray(x))
    assert got.shape == (b, f * (f - 1) // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ref.interaction_tril(_t(x)).numpy(),
                                  got.numpy())


def test_mlp_ref_matches_jax():
    rng = np.random.RandomState(5)
    dims = (13, 24, 8, 1)
    ws = [rng.randn(a, b).astype(np.float32) for a, b in zip(dims, dims[1:])]
    bs = [rng.randn(b).astype(np.float32) for b in dims[1:]]
    x = rng.randn(6, 13).astype(np.float32)
    got = ref.mlp(_t(x), [_t(w) for w in ws], [_t(b) for b in bs])
    want = j_ref.mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(b) for b in bs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# no fallback: dispatch by device, wrappers take CUDA tensors only
# ---------------------------------------------------------------------------

_OPS = {
    "gemm": lambda dev: ops.gemm(torch.ones(2, 3, device=dev),
                                 torch.ones(3, 4, device=dev)),
    "fused_segment_sum": lambda dev: ops.fused_segment_sum(
        torch.ones(5, 4, device=dev),
        torch.zeros(2, 3, dtype=torch.int32, device=dev)),
    "interaction": lambda dev: ops.interaction(torch.ones(2, 3, 4,
                                                          device=dev)),
    "sls_grad_table": lambda dev: ops.sls_grad_table(
        torch.ones(2, 4, device=dev),
        torch.zeros(3, dtype=torch.int32, device=dev),
        torch.tensor([0, 1, 3], dtype=torch.int32, device=dev), n_rows=5),
}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_ops_refuse_devices_other_than_cpu_and_cuda(name):
    with pytest.raises(ValueError, match="CUDA tensors"):
        _OPS[name]("meta")


def test_ops_refuse_mixed_devices():
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gemm(torch.ones(2, 3), torch.ones(3, 4, device="meta"))


_WRAPPERS = {
    "fused_segment_sum": lambda: t_fd.fused_segment_sum(
        torch.ones(5, 4), torch.zeros(2, 3, dtype=torch.int32)),
    "gemm": lambda: t_gm.gemm(torch.ones(2, 3), torch.ones(3, 4)),
    "interaction": lambda: t_fi.interaction(torch.ones(2, 3, 4)),
    "sls_grad_table": lambda: t_eg.sls_grad_table(
        torch.ones(2, 4), torch.zeros(3, dtype=torch.int32),
        torch.tensor([0, 1, 3], dtype=torch.int32), n_rows=5),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A wrapper launches its kernel or raises; it never computes on the
    CPU (and never builds anything to find that out)."""
    before = {m: m.launches for m in (t_fd, t_gm, t_fi, t_eg)}
    with pytest.raises(ValueError, match="CUDA device"):
        _WRAPPERS[name]()
    assert {m: m.launches for m in (t_fd, t_gm, t_fi, t_eg)} == before


@pytest.mark.parametrize("ids_dtype,msg", [(torch.int64, "int32"),
                                           (torch.float32, "int32")])
def test_fused_wrapper_takes_int32_ids_only(ids_dtype, msg):
    with pytest.raises(ValueError, match=msg):
        t_fd.fused_segment_sum(torch.ones(5, 4),
                               torch.zeros(2, 3, dtype=ids_dtype))


@pytest.mark.parametrize("ids_dtype", [torch.int64, torch.float32])
def test_sls_grad_table_wrapper_takes_int32_ids_only(ids_dtype):
    with pytest.raises(ValueError, match="int32"):
        t_eg.sls_grad_table(torch.ones(2, 4), torch.zeros(3, dtype=ids_dtype),
                            torch.tensor([0, 1, 3], dtype=torch.int32),
                            n_rows=5)


def test_kernel_wrappers_refuse_non_contiguous():
    with pytest.raises(ValueError, match="contiguous"):
        t_gm.gemm(torch.ones(3, 2).t(), torch.ones(3, 4))


def test_build_targets_sm90a_with_a_c_interface(tmp_path):
    cmd = _build.nvcc_command("nvcc", tmp_path / "k.cu", tmp_path / "k.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert [p.stem for p in _build.sources()] == [
        "fused_segment_sum", "gemm", "interaction", "sls_grad_table"]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler error surfaces as an exception carrying nvcc's output;
    nothing falls back and no library is left behind."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    fake = bin_dir / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: deliberate failure' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="deliberate failure"):
        _build.build_all()
    assert not list((tmp_path / "build").rglob("*.so*"))
    logs = _build.build_logs()
    assert set(logs) == {"fused_segment_sum", "gemm", "interaction",
                         "sls_grad_table"}
