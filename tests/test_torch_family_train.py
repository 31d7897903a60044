"""Training of the MoE, MLA, vision-prefix, recurrent, RWKV and
encoder-decoder LM families against the JAX package at the smoke
configs: the flash op's backward at the families' attention shapes (not causal; depths 112, 128 and 256 with a
window shorter than S), layerwise Adafactor on the MoE decoders' stacked
expert leaves (kimi-k2, arctic with its dense residual), gradient
accumulation (``microbatches=2``) on a MoE decoder, recurrentgemma and
seamless-m4t (frames split with the tokens), remat on against off on
the MoE decoders and the encoder-decoder, Adafactor's and AdamW's
in-place updates against their out-of-place formulas, and the card
script's routing pin keyed by layer and its CPU reference worker (its
spies kept to their own thread, its checks settled in order). Params
come from the
reference's ``api.init`` through numpy; every test runs on one CPU
thread.

Tolerances:
  * within the port, exactly: the op's backward against autograd
    through ``_sdpa_chunked`` (the same ops on the same blocks), remat
    on against off (the recompute runs the forward's ops again, routing
    included), Adafactor's in-place ops against the same ops out of
    place (the same elementwise roundings).
  * fp32 steps against the reference's jitted ones: losses and grad
    norms within 1e-5 relative (the same fp32 math summed in other
    orders; seen below 1e-6). Params within 1e-5 but for at most 1e-3
    of the elements, and none further apart than 2 lr a step: an
    AdamW step moves a param by ~lr sign(g), and so does Adafactor's on
    a vector leaf (g / sqrt(g^2 + eps) at its first step), so an element
    whose gradient is within rounding of zero may step the other way on
    one side. Adafactor's factored second moments within 1e-4 relative
    of the leaf's largest (means of squared gradients).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.configs import registry as j_registry
from repro.models import api as j_api
from repro_torch import optim as t_optim
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import api, layers
from repro_torch.optim import tree_leaves, tree_map

torch.set_num_threads(1)

LR_ADAMW = 3e-4                    # default_optimizer's
LR_ADAFACTOR = 1e-4                # default_optimizer's for the big MoEs
CLIP = 0.1                         # below every smoke grad norm


def _cfgs(arch, dtype="float32"):
    return (registry.get_smoke(arch).replace(dtype=dtype),
            j_registry.get_smoke(arch).replace(dtype=dtype))


_PARAMS = {}


def _params(arch, dtype="float32"):
    """(port params on the CPU, JAX params) from the reference's init; a
    fresh port copy each call (the train step works in place)."""
    if (arch, dtype) not in _PARAMS:
        _, j_cfg = _cfgs(arch, dtype)
        _PARAMS[arch, dtype] = j_api.init(jax.random.PRNGKey(0), j_cfg)[0]
    j_params = _PARAMS[arch, dtype]
    return (api.params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu"),
            j_params)


def _batch(cfg, b, s, seed):
    """(port batch, JAX batch): a vlm model's patches or an
    encoder-decoder's frames drawn first, then the tokens."""
    rng = np.random.RandomState(seed)
    t, j = {}, {}
    if cfg.family == "vlm":
        extra = ("patches", cfg.n_frontend_tokens)
    elif cfg.is_encdec:
        extra = ("frames", cfg.enc_memory_len)
    else:
        extra = None
    if extra is not None:
        a = rng.randn(b, extra[1], cfg.d_model).astype(np.float32)
        t[extra[0]], j[extra[0]] = torch.from_numpy(a), jnp.asarray(a)
    toks = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    t["tokens"], j["tokens"] = torch.from_numpy(toks), jnp.asarray(toks)
    return t, j


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _params_close(got, want, lr, n_steps):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for name in g:
        err = np.abs(g[name].float().numpy() - _np(w[name]))
        assert (err > 1e-5).mean() <= 1e-3, (name, err.max())
        assert err.max() <= 2 * lr * n_steps + 1e-5, (name, err.max())


def _run_steps(arch, n_steps, optimizer=None, microbatches=1, b=4, s=16):
    """``n_steps`` of the port's and the reference's jitted train step
    (fp32, clipped at CLIP) from the same params on the same batches:
    (port params, port state, JAX params, JAX state)."""
    cfg, j_cfg = _cfgs(arch)
    params, j_params = _params(arch)
    t_opt, j_opt = optimizer if optimizer is not None else (None, None)
    name, opt, step = api.make_train_step(cfg, optimizer=t_opt,
                                          grad_clip=CLIP,
                                          microbatches=microbatches)
    j_name, j_opt, j_step = j_api.make_train_step(
        j_cfg, optimizer=j_opt, grad_clip=CLIP, microbatches=microbatches)
    assert name == j_name
    state, j_state = opt.init(params), j_opt.init(j_params)
    j_step = jax.jit(j_step)
    for i in range(n_steps):
        tb, jb = _batch(cfg, b, s, seed=30 + i)
        new, state, m = step(params, state, tb)
        assert new is params                       # in place
        j_params, j_state, j_m = j_step(j_params, j_state, jb)
        assert float(j_m["grad_norm"]) > CLIP      # the clip bites
        np.testing.assert_allclose(m["loss"].item(), float(j_m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(j_m["grad_norm"]), rtol=1e-5)
    return params, state, j_params, j_state


# ---------------------------------------------------------------------------
# (i) the flash op's backward at the families' attention shapes
# ---------------------------------------------------------------------------

# (S, kv heads, group, head dim, causal, window, dtype): seamless's
# encoder (not causal, its frames no multiple of the 1,024-row chunk:
# blocks of 800) in both dtypes; kimi-k2's 112, arctic's and internvl2's
# 128 and recurrentgemma's 256, each with a window shorter than S, in
# bf16, the dtype they train in
BWD_CASES = [(3200, 1, 1, 64, False, None, "float32"),
             (3200, 1, 1, 64, False, None, "bfloat16"),
             (2048, 1, 2, 112, True, 300, "bfloat16"),
             (2048, 1, 2, 128, True, 300, "bfloat16"),
             (2048, 1, 2, 256, True, 1024, "bfloat16")]
BWD_IDS = ["hd64_not_causal_3200_fp32", "hd64_not_causal_3200_bf16",
           "hd112_window", "hd128_window", "hd256_window"]


@pytest.mark.parametrize("s,kh,g,hd,causal,window,dtype", BWD_CASES,
                         ids=BWD_IDS)
def test_op_backward_is_autograd_through_the_chunked_path(s, kh, g, hd,
                                                          causal, window,
                                                          dtype):
    """The op's gradients equal autograd through ``_sdpa_chunked`` at the
    op's chunks bit for bit, and two backward passes agree bit for bit."""
    rng = np.random.RandomState(hd)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.randn(1, s, *shape).astype(np.float32))
               .to(dt).requires_grad_()
               for shape in ((kh * g, hd), (kh, hd), (kh, hd)))
    up = torch.from_numpy(rng.randn(1, s, kh * g, hd).astype(np.float32)
                          ).to(dt)

    def op():
        return ops.flash_attention_gqa(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(op(), (q, k, v), up)
    again = torch.autograd.grad(op(), (q, k, v), up)
    pos = torch.arange(s)
    want = torch.autograd.grad(layers._sdpa_chunked(
        q.reshape(1, s, kh, g, hd), k, v, pos, pos, causal, window,
        layers.pick_chunk(s, layers.Q_CHUNK),
        layers.pick_chunk(s, layers.KV_CHUNK)).reshape(1, s, kh * g, hd),
        (q, k, v), up)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dt and torch.equal(a, w)
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (ii) layerwise Adafactor on the MoE decoders' stacked expert leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_layers", [8, 2],
                         ids=["whole_stack", "layer_by_layer"])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
def test_adafactor_step_matches_the_jitted_reference(arch, min_layers):
    """One step of layerwise Adafactor (default_optimizer's lr 1e-4),
    against the reference's with the same optimizer: at the smoke
    configs' 2 layers ``min_layers=8`` updates each stacked leaf whole
    (its RMS clip over every layer's experts, as at the cut depths the
    card trains), ``min_layers=2`` one layer at a time (as at full
    depth)."""
    opt = ("adafactor", t_optim.layerwise(t_optim.adafactor(LR_ADAFACTOR),
                                          min_layers=min_layers))
    j_opt = ("adafactor", j_optim.layerwise(j_optim.adafactor(LR_ADAFACTOR),
                                            min_layers=min_layers))
    params, state, j_params, j_state = _run_steps(arch, 1, (opt, j_opt))
    _params_close(params, j_params, LR_ADAFACTOR, 1)
    assert state["step"] == int(j_state["step"]) == 1
    got, want = _leaves(state["fac"]), _leaves(j_state["fac"])
    assert got.keys() == want.keys()
    assert any(k.endswith("/vr") and v.dim() == 3 for k, v in got.items()
               if "/moe/" in k)                # (layers, experts, d)
    for name in got:
        ref = _np(want[name])
        err = np.abs(got[name].numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)


def test_adafactor_in_place_equals_its_out_of_place_formula():
    """The in-place update against the reference's formula written out
    of place, bit for bit, over three steps (step 1's beta = 0, then the
    decayed moments) on bf16 and fp32 leaves, a stacked (L, E, d, ff)
    one among them; the fp32 gradients handed in stay as they were."""
    eps, decay = 1e-30, 0.8
    g = torch.Generator().manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        params = {"experts": torch.randn(2, 3, 8, 5, generator=g).to(dt),
                  "norm": torch.randn(7, generator=g).to(dt),
                  "w": (3 * torch.randn(6, 4, generator=g)).to(dt)}
        p_ref = tree_map(torch.clone, params)
        opt = t_optim.adafactor(1e-2)
        st = opt.init(params)
        fac = tree_map(torch.clone, st["fac"])
        for step in range(1, 4):
            grads = tree_map(lambda t: (torch.randn(
                t.shape, generator=g) * (20.0 if step % 2 else 0.1)).to(dt),
                params)
            kept = tree_map(torch.clone, grads)
            params, st = opt.update(grads, st, params)
            beta = np.float32(1) - np.float32(step) ** np.float32(-decay)
            keep = float(np.float32(1) - beta)
            for name in params:
                p, gr, f = p_ref[name], grads[name], fac[name]
                g32 = gr.float()
                g2 = g32.square() + eps
                if p.dim() >= 2:
                    f["vr"] = f["vr"] * float(beta) + keep * g2.mean(-1)
                    f["vc"] = f["vc"] * float(beta) + keep * g2.mean(-2)
                    denom = (f["vr"][..., None] * f["vc"][..., None, :]
                             / torch.clamp(f["vr"].mean(-1, keepdim=True)
                                           [..., None], min=eps))
                    upd = g32 / torch.sqrt(denom + eps)
                else:
                    f["v"] = f["v"] * float(beta) + keep * g2
                    upd = g32 / torch.sqrt(f["v"] + eps)
                rms = torch.sqrt(upd.square().mean() + eps)
                upd = upd / torch.clamp(rms, min=1.0)
                p.copy_((p.float() - 1e-2 * upd).to(dt))
            for a, b in zip(tree_leaves(params), tree_leaves(p_ref)):
                assert torch.equal(a, b)
            for a, b in zip(tree_leaves(st["fac"]), tree_leaves(fac)):
                assert torch.equal(a, b)
            for a, b in zip(tree_leaves(grads), tree_leaves(kept)):
                assert torch.equal(a, b)


def test_adamw_in_place_equals_its_out_of_place_formula():
    """AdamW's in-place update against the reference's formula written
    out of place, bit for bit, over three steps on bf16 and fp32 leaves;
    the fp32 params' old values and the gradients handed in are read, not
    written, by the update's temporaries."""
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.01, 1e-2
    g = torch.Generator().manual_seed(4)
    for dt in (torch.float32, torch.bfloat16):
        params = {"stack": torch.randn(2, 6, 5, generator=g).to(dt),
                  "norm": torch.randn(7, generator=g).to(dt)}
        p_ref = tree_map(torch.clone, params)
        opt = t_optim.adamw(lr)
        st = opt.init(params)
        m = tree_map(lambda t: torch.zeros(t.shape), params)
        v = tree_map(lambda t: torch.zeros(t.shape), params)
        for step in range(1, 4):
            grads = tree_map(lambda t: (torch.randn(
                t.shape, generator=g) * (20.0 if step % 2 else 0.1)).to(dt),
                params)
            kept = tree_map(torch.clone, grads)
            params, st = opt.update(grads, st, params)
            t = np.float32(step)
            c1 = float(np.float32(1) - np.float32(b1) ** t)
            c2 = float(np.float32(1) - np.float32(b2) ** t)
            lr_t = float(np.float32(lr))
            for name in params:
                p, g32 = p_ref[name], grads[name].float()
                m[name] = m[name] * b1 + (1 - b1) * g32
                v[name] = v[name] * b2 + (1 - b2) * g32.square()
                upd = (m[name] / c1) / (torch.sqrt(v[name] / c2) + eps) \
                    + wd * p.float()
                p.copy_((p.float() - lr_t * upd).to(dt))
            for a, b in zip(tree_leaves(params), tree_leaves(p_ref)):
                assert torch.equal(a, b)
            for a, b in zip(tree_leaves((st["m"], st["v"])),
                            tree_leaves((m, v))):
                assert torch.equal(a, b)
            for a, b in zip(tree_leaves(grads), tree_leaves(kept)):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (iii) gradient accumulation on a MoE decoder, RG-LRU and the enc-dec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["arctic-480b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_accumulated_step_matches_the_scanned_reference(arch):
    """Two steps of the default optimizer (layerwise AdamW at the smoke
    widths) at ``microbatches=2`` over batch 4, against the reference's
    scanned step: a MoE's capacity and aux loss taken per micro-batch of
    2 x 16 tokens, recurrentgemma's RG-LRU blocks and local attention,
    seamless's frames split with its tokens."""
    params, state, j_params, j_state = _run_steps(arch, 2, microbatches=2)
    _params_close(params, j_params, LR_ADAMW, 2)
    assert state["step"] == int(j_state["step"]) == 2


# ---------------------------------------------------------------------------
# remat on against off, routing through the checkpoint's recompute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b",
                                  "seamless-m4t-large-v2"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    """Under the loss's per-layer checkpoint a MoE layer routes again in
    the backward's recompute; the same routing gives the same loss and
    gradients as remat off, bit for bit (fp32 and bf16)."""
    for dtype in ("float32", "bfloat16"):
        cfg, _ = _cfgs(arch, dtype)
        params, _ = _params(arch, dtype)
        tb, _ = _batch(cfg, 2, 16, seed=8)
        out = []
        for remat in (True, False):
            req = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss = api.loss(req, cfg, tb, remat=remat)
            out.append((loss.detach(),
                        torch.autograd.grad(loss, tree_leaves(req))))
        assert torch.equal(out[0][0], out[1][0])
        for a, b in zip(out[0][1], out[1][1]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# chip_smoke.py's train-step routing pin, keyed by layer
# ---------------------------------------------------------------------------

def _chip_smoke():
    """The card script as a module (its ``main`` does not run)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_layer_pin_reuses_each_layers_routes_in_the_recompute():
    """A train step routes each MoE layer twice (the forward, then the
    backward's recompute in reverse layer order). ``layer_routes`` keys
    the pin by layer: pinned to its own recorded routes, a step of
    kimi-k2's 2-layer smoke config gives the same loss, gradients and
    params bit for bit (a pin by call order would hand the recompute of
    layer 1 layer 0's experts), every layer routed twice and no flip; a
    bf16 step pinned to the fp32 step's routes counts its own flips a
    layer."""
    cs = _chip_smoke()
    cfg, _ = _cfgs("kimi-k2-1t-a32b")
    params, _ = _params("kimi-k2-1t-a32b")
    tb, _ = _batch(cfg, 2, 16, seed=9)
    free = cs._fam_step(cfg, tree_map(torch.clone, params), tb)
    routes = free["routes"]["routes"]
    assert len(routes) == cfg.n_layers == 2
    assert free["routes"]["calls"] == [2, 2]
    pinned = cs._fam_step(cfg, tree_map(torch.clone, params), tb, routes)
    assert pinned["loss"] == free["loss"]
    assert pinned["grad_norm"] == free["grad_norm"]
    for a, b in zip(tree_leaves(pinned["grads"]), tree_leaves(free["grads"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(pinned["params"]),
                    tree_leaves(free["params"])):
        assert torch.equal(a, b)
    assert [int(f.sum()) for f in pinned["routes"]["flips"]] == [0, 0]
    c16, _ = _cfgs("kimi-k2-1t-a32b", "bfloat16")
    p16, _ = _params("kimi-k2-1t-a32b", "bfloat16")
    half = cs._fam_step(c16, p16, tb, routes)
    assert half["routes"]["calls"] == [2, 2]
    assert [f.shape for f in half["routes"]["flips"]] == [(32,), (32,)]


# ---------------------------------------------------------------------------
# chip_smoke.py's CPU reference worker
# ---------------------------------------------------------------------------

def test_cpu_reference_worker_sees_only_its_own_spies():
    """The card script runs the CPU path's reference passes on a thread
    of their own while the card's work goes on, both spying on the same
    module functions. A pinned step on the worker, taken while an
    unpinned spy is entered on the main thread, equals the same step
    taken alone bit for bit, its recompute on the worker's thread (every
    layer routed twice there) and none of its routings seen by the main
    thread's spy; a step on the main thread, taken while the worker sits
    inside a pin of its own, equals the unpinned step bit for bit."""
    cs = _chip_smoke()
    cfg, _ = _cfgs("kimi-k2-1t-a32b")
    params, _ = _params("kimi-k2-1t-a32b")
    tb, _ = _batch(cfg, 2, 16, seed=9)

    def step(pin=None):
        return cs._fam_step(cfg, tree_map(torch.clone, params), tb, pin)

    free = step()
    other = [(r + 1) % cfg.moe.n_experts for r in free["routes"]["routes"]]
    pinned = step(other)
    assert pinned["loss"] != free["loss"]
    inside, release = threading.Event(), threading.Event()
    worker = cs.CpuRefs()
    try:
        with cs.layer_routes() as seen:
            got = worker.submit(lambda: step(other)).result(timeout=300)
        assert seen["calls"] == []
        assert got["routes"]["calls"] == [2, 2]
        assert got["loss"] == pinned["loss"]
        for a, b in zip(tree_leaves(got["params"]),
                        tree_leaves(pinned["params"])):
            assert torch.equal(a, b)

        def hold():
            with cs.layer_routes(other) as rec:
                inside.set()
                release.wait(60)
            return rec
        held = worker.submit(hold)
        assert inside.wait(60)
        again = step()
        release.set()
        assert held.result(timeout=60)["calls"] == []
        assert again["loss"] == free["loss"]
        for a, b in zip(tree_leaves(again["params"]),
                        tree_leaves(free["params"])):
            assert torch.equal(a, b)
    finally:
        release.set()
        worker.close()


def test_pending_checks_settle_in_order_and_fail_the_run():
    """A pending check's CPU pass runs on the worker; ``settle`` makes
    the checks in the order handed in, each into its slot, and raises a
    pass's failure there. ``uncounted`` on the worker leaves the card's
    launch counts as the main thread set them."""
    cs = _chip_smoke()
    order, out = [], {}
    cs.Pending("first", out, "a", lambda: 2, lambda r: order.append(r) or r)
    cs.Pending("second", out, "b", lambda: 3, lambda r: order.append(r) or r)
    assert isinstance(out["a"], cs.Pending)
    assert cs.settle()["waited_s"] >= 0
    assert out == {"a": 2, "b": 3} and order == [2, 3]
    assert not cs._CPU_REFS and not cs._PENDING

    def broken():
        cs.fail("the CPU pass disagrees")
    cs.Pending("third", out, "c", broken, lambda r: r)
    with pytest.raises(RuntimeError, match="the CPU pass disagrees"):
        cs.settle()
    cs._PENDING.clear()
    cs._CPU_REFS.pop().close()

    name, k = next(iter(cs.KERNELS.items()))
    inside, release = threading.Event(), threading.Event()

    def hold():
        with cs.uncounted():
            inside.set()
            release.wait(60)
    before = getattr(k["module"], k["counter"])
    worker = cs.CpuRefs()
    try:
        held = worker.submit(hold)
        assert inside.wait(60)
        setattr(k["module"], k["counter"], before + 5)
        release.set()
        held.result(timeout=60)
        assert cs.launch_counts()[name] == before + 5
    finally:
        release.set()
        setattr(k["module"], k["counter"], before)
        worker.close()


def test_at_depth_cuts_each_stack():
    """19(d)'s depth cut: each stack of an encoder-decoder, else the
    decoder's layers."""
    cs = _chip_smoke()
    seam = cs.at_depth(registry.get_arch("seamless-m4t-large-v2"), 2)
    assert (seam.enc_layers, seam.dec_layers, seam.n_layers) == (2, 2, 4)
    assert cs.at_depth(registry.get_arch("rwkv6-7b"), 3).n_layers == 3


def test_bit_sum_sees_a_leaf_move_by_one_ulp():
    """19(c)'s fingerprint of a leaf: equal for equal bits, other after
    one element moves by one ulp, in bf16 and in fp32."""
    cs = _chip_smoke()
    for dtype, ints in ((torch.bfloat16, torch.int16),
                        (torch.float32, torch.int32)):
        t = torch.randn(1000, 7, generator=torch.Generator().manual_seed(5)
                        ).to(dtype)
        moved = t.clone()
        moved.view(ints)[123, 4] += 1
        assert not torch.equal(moved, t)
        assert cs.bit_sum(t.clone()) == cs.bit_sum(t)
        assert cs.bit_sum(moved) != cs.bit_sum(t)
