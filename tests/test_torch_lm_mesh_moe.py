"""The MoE decoders on a (data, model) mesh: kimi-k2 and arctic SMOKE,
tensor-parallel attention beside the expert-parallel MoE on the
S-sharded stream (arctic's dense residual branch reduce-scattered
beside it, the MoE's whole output added once), with AdamW and with
Adafactor across shards, on 4 gloo CPU ranks as (2, 2)
(``distributed.spawn``, started once), against the JAX reference's own
``mesh=`` steps on 4 fake host devices (one subprocess, on the inputs
it saves):

* kimi-k2 SMOKE: 2 AdamW train steps, prefill and 3 decode steps;
* kimi-k2 and arctic SMOKE: 2 steps each of ``("adafactor",
  layerwise(adafactor(1e-3)))``; kimi's (2, 2) Adafactor state restored
  onto (1, 4);
* arctic SMOKE: prefill and 3 decode steps;
* kimi-k2 SMOKE at a decode batch of 32 whose tokens are one token
  repeated, so that its choices overflow an expert's capacity: the
  reference routes its global batch as one there, and so does the
  port's decode (``moe.apply_moe_decode``); ranked as a data rank's 16
  tokens alone, the same choices would keep other slots.

The reference's expert-parallel MoE sizes each rank's capacity from its
own tokens, so its mesh run is not its one-device run (kimi's losses
5.584559 / 5.587296 in bf16): the port's mesh path is held against the
reference's mesh path, which drops what the port drops.

The configs run in fp32 (``dtype="float32"``, both sides): in bf16 a
router logit within rounding of a tie picks another expert on one side
(the port's one-rank kimi SMOKE loss lies 1.6e-4 from the reference's
one-device one, and 512 tokens a rank move logits by 0.3), which hides
what the mesh path adds. In fp32 the two sides run the same math summed
in other orders, and the tolerances are ``tests/
test_torch_family_train.py``'s:

* losses and grad norms rtol 1e-5;
* logits atol 1e-3, rtol 1e-3: the decode cache is bf16 on both sides,
  and an entry within fp32 rounding of a bf16 rounding boundary rounds
  the other way (2^-8 of itself), moving a logit (|logit| <= 0.6 here)
  by ~1e-3 of its scale at most;
* AdamW's params within 1e-5 but for at most 1e-3 of the elements, none
  further apart than 2.02 lr a step (an element whose gradient is
  within rounding of zero may step the other way; |m_hat / sqrt(v_hat)|
  <= 1.0004 over two steps);
* Adafactor's factored statistics (vr, vc, and a vector leaf's v)
  within 1e-4 of the leaf's largest; a statistic reduced over a rank's
  block only (a missing sum over 'model' or 'data') is off by the share
  of the leaf outside the block, about 1/2 at (2, 2);
* Adafactor's params, by the bound ``_adafactor_tol`` derives: a step
  moves an element by lr g k, k = 1 / (sqrt(D) c), D = vr_i vc_j /
  mean(vr) its factored second moment and c = max(1, rms(g / sqrt(D)))
  the leaf's clip. With r = |g_a - g_b| / max(|g_a|, |g_b|) the two
  sides' gradients' gap and d = |k_a / k_b - 1| the gap of their scales
  (from each side's own gradient and statistics), the two steps differ
  by at most max(|step_a|, |step_b|) (1 + d) (r (1 + d) + d); each
  element within that, summed over the steps, plus 1e-5.

Exact: every rank's losses and grad norms against the others', a data
group's logits against each other, the data replicas' blocks; the
(2, 2) Adafactor state restored onto (1, 4) bit for bit.

The rank functions import no JAX: they are pickled to the children by
this module's name, so JAX runs only in the reference's subprocess.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import make_placer
from repro_torch.distributed import collectives, sharding, spawn
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, moe, transformer
from repro_torch.optim import (Optimizer, adafactor, layerwise, tree_map,
                               tree_paths)

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
SHAPE, AXES = (2, 2), ("data", "model")
B, S, MAX_LEN, DECODE = 4, 64, 80, 3
DROP_B = 32                    # the dropping decode batch (global)
LR = {"adamw": 3e-4, "adafactor": 1e-3}
STEP_MAX = 1.01                # AdamW's |m_hat / sqrt(v_hat)|
EPS = 1e-30                    # Adafactor's
CLIP = 1.0                     # make_train_step's grad_clip
RTOL = 1e-5                    # losses, grad norms
FLOOR = 1e-5                   # params: fp32 sums in other orders
FLOOR_SHARE = 1e-3             # AdamW: elements allowed past FLOOR
LOGIT_TOL = 1e-3               # rtol and atol
STAT_TOL = 1e-4                # of the leaf's largest
# (arch, optimizer, steps, serve)
RUNS = (("kimi-k2-1t-a32b", "adamw", 2, True),
        ("kimi-k2-1t-a32b", "adafactor", 2, False),
        ("arctic-480b", "adafactor", 2, True))
KIMI, ARCTIC = "kimi-k2-1t-a32b", "arctic-480b"

# The reference's (2, 2) run: params from api.init(PRNGKey(0)), every
# input drawn from RandomState(7), each leaf saved under
# "<arch>/<opt>/<what>" + its keystr path (bf16 as fp32, exactly); each
# Adafactor step's gradient (unclipped, jax.grad of the loss on the mesh)
# beside it.
REF_CODE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import SMOKE_ARCHS
    from repro.distributed.sharding import use_mesh
    from repro.launch.mesh import make_mesh
    from repro.models import api
    from repro.optim import adafactor, layerwise
    B, S, MAX_LEN, DECODE, DROP_B = 4, 64, 80, 3, 32
    out = {}
    mesh = make_mesh((2, 2), ('data', 'model'))

    def flat(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

    def serve(cfg, params, pre, b, rng, drop=False):
        toks = rng.randint(0, cfg.vocab_size, (b, S)).astype(np.int32)
        out[pre + "prompt"] = toks
        logits, cache = jax.jit(api.make_prefill_step(cfg, MAX_LEN, mesh))(
            params, {"tokens": jnp.asarray(toks)})
        out[pre + "prefill"] = np.asarray(logits)
        dec = jax.jit(api.make_decode_fn(cfg, mesh))
        for i in range(DECODE):
            t = rng.randint(0, cfg.vocab_size, (b,)).astype(np.int32)
            if drop:
                # one token for the whole batch: the same choices
                t[:] = t[0]
            out[pre + f"dtok{i}"] = t
            logits, cache = dec(params, cache, {
                "tokens": jnp.asarray(t), "pos": jnp.int32(S + i)})
            out[pre + f"decode{i}"] = np.asarray(logits)

    for arch, opt_name, steps, do_serve in (
            ("kimi-k2-1t-a32b", "adamw", 2, True),
            ("kimi-k2-1t-a32b", "adafactor", 2, False),
            ("arctic-480b", "adafactor", 2, True)):
        cfg = SMOKE_ARCHS[arch].replace(dtype="float32")
        pre = f"{arch}/{opt_name}/"
        params, _ = api.init(jax.random.PRNGKey(0), cfg)
        flat(pre + "p0", params)
        rng = np.random.RandomState(7)
        opt = None if opt_name == "adamw" else (
            "adafactor", layerwise(adafactor(1e-3)))
        _, o, step = api.make_train_step(cfg, optimizer=opt, mesh=mesh)
        st, p = o.init(params), params

        def lossf(p_, b_):
            with use_mesh(mesh):
                return api.loss(p_, cfg, b_)
        with mesh:
            jstep = jax.jit(step)
            jgrad = jax.jit(jax.grad(lossf))
            for s in range(steps):
                toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
                out[pre + f"tokens{s}"] = toks
                if opt_name == "adafactor":
                    flat(pre + f"g{s + 1}", jgrad(p, {"tokens": jnp.asarray(toks)}))
                p, st, m = jstep(p, st, {"tokens": jnp.asarray(toks)})
                out[pre + f"loss{s}"] = np.asarray(m["loss"])
                out[pre + f"gnorm{s}"] = np.asarray(m["grad_norm"])
                flat(pre + f"p{s + 1}", p)
                flat(pre + f"s{s + 1}", st["m"] if opt_name == "adamw"
                     else st["fac"])
            if do_serve:
                serve(cfg, params, pre, B, rng)
            if arch == "kimi-k2-1t-a32b" and opt_name == "adamw":
                serve(cfg, params, "drop/", DROP_B, np.random.RandomState(5),
                      drop=True)
    np.savez(sys.argv[1], **{k: (v.astype(np.float32)
                                 if v.dtype.name == "bfloat16" else v)
                             for k, v in out.items()})
""")


def _cfg(arch):
    return registry.get_smoke(arch).replace(dtype="float32")


def _template(arch):
    return api.init(torch.Generator().manual_seed(0), _cfg(arch),
                    device="cpu")


def _load(z, prefix, template):
    """The reference's params saved under ``prefix`` as the port's tree,
    in the template's dtypes."""
    def build(t, path=""):
        if isinstance(t, dict):
            return {k: build(t[k], f"{path}[{k!r}]") for k in t}
        return torch.from_numpy(np.array(z[prefix + path])).to(t.dtype)
    return build(template)


def _optimizer(name):
    return None if name == "adamw" else ("adafactor",
                                         layerwise(adafactor(1e-3)))


def _spy(opt_pair, seen):
    """``opt_pair`` whose update records the (clipped) gradients it is
    handed, fp32 copies, in ``seen``."""
    name, opt = opt_pair

    def update(grads, state, params, **kw):
        seen.append(tree_map(lambda g: g.float().clone(), grads))
        return opt.update(grads, state, params, **kw)
    return name, Optimizer(opt.init, update)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _gathered(tree, specs, mesh, shapes):
    """The whole leaves of ``tree`` (this rank's blocks under the logical
    ``specs``), put together on every rank."""
    return tree_map(lambda x, sp, shape: sharding.gather_full(
        x, mesh, sharding.resolve(mesh, sp), shape), tree, specs, shapes)


def _shapes(arch):
    return tree_map(lambda t: tuple(t.shape), _template(arch))


def _state_specs(cfg, name):
    """(the optimizer state's logical specs, whole shapes) of ``name``'s
    tree under ``state["m"]`` or ``state["fac"]``."""
    leaves = transformer.param_leaves(cfg)
    if name == "adamw":
        return (tree_map(lambda l: l.logical, leaves),
                tree_map(lambda l: l.shape, leaves))

    def spec(l):
        s = l.logical
        return ({"vr": s[:-1], "vc": s[:-2] + s[-1:]} if len(l.shape) >= 2
                else {"v": s})

    def shape(l):
        s = l.shape
        return ({"vr": s[:-1], "vc": s[:-2] + s[-1:]} if len(s) >= 2
                else {"v": s})
    return tree_map(spec, leaves), tree_map(shape, leaves)


def _train(cfg, arch, name, mesh, p0, batches):
    blocks = api.shard_params(p0, cfg, mesh)
    seen = []
    opt_pair = _spy(_optimizer(name) or api.default_optimizer(cfg), seen)
    _, opt, step = api.make_train_step(cfg, optimizer=opt_pair, mesh=mesh)
    state = opt.init(blocks)
    specs = api.param_specs(cfg)
    shapes = _shapes(arch)
    st_specs, st_shapes = _state_specs(cfg, name)
    key = "m" if name == "adamw" else "fac"
    losses, gnorms, trail = [], [], []
    place = make_placer("cpu", mesh, api.batch_specs(cfg, mesh))
    for b in batches:
        blocks, state, m = step(blocks, state, place(b))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        # copies: a replicated leaf is gathered as itself, and the next
        # step updates it in place
        trail.append((
            tree_map(torch.clone, _gathered(blocks, specs, mesh, shapes)),
            tree_map(torch.clone, _gathered(state[key], st_specs, mesh,
                                            st_shapes)),
            _gathered(seen[-1], specs, mesh, shapes)))
    return {"losses": losses, "gnorms": gnorms, "trail": trail,
            "blocks": tree_map(torch.clone, blocks)}, (blocks, state)


def _serve(cfg, mesh, blocks, prompt, tokens, routes=None):
    """Prefill and a decode step a token of ``tokens``: each rank's
    logits gathered over 'model' (its share of the batch)."""
    place = make_placer("cpu", mesh, api.batch_specs(cfg, mesh))
    logits, cache = api.make_prefill_step(cfg, MAX_LEN, mesh=mesh)(
        blocks, place({"tokens": prompt}))
    out = [collectives.all_gather(logits, mesh, "model", dim=-1)]
    dec = api.make_decode_fn(cfg, mesh=mesh)
    for i, t in enumerate(tokens):
        mine = place({"tokens": t})["tokens"]
        logits, cache = dec(blocks, cache, {"tokens": mine, "pos": S + i})
        out.append(collectives.all_gather(logits, mesh, "model", dim=-1))
    return out


def _slot_spy(log):
    """``moe._slots`` recording each call's (number of choices, number
    kept, capacity)."""
    real = moe._slots

    def spy(idx, n_experts, capacity):
        slot, valid = real(idx, n_experts, capacity)
        log.append((int(valid.numel()), int(valid.sum()), capacity,
                    idx.clone()))
        return slot, valid
    return real, spy


def _rank(mesh, npz, tmp):
    z = np.load(npz)
    out = {"coords": tuple(mesh.rank(a) for a in AXES)}
    for arch, name, steps, serve in RUNS:
        cfg = _cfg(arch)
        pre = f"{arch}/{name}/"
        p0 = _load(z, pre + "p0", _template(arch))
        batches = [{"tokens": z[pre + f"tokens{s}"]} for s in range(steps)]
        rec, state = _train(cfg, arch, name, mesh, p0, batches)
        if serve:
            # a fresh copy: the step updated the replicated leaves of
            # p0 in place (shard_params hands them on as they are)
            blocks = api.shard_params(_load(z, pre + "p0", _template(arch)),
                                      cfg, mesh)
            rec["logits"] = _serve(cfg, mesh, blocks, z[pre + "prompt"],
                                   [z[pre + f"dtok{i}"]
                                    for i in range(DECODE)])
        if (arch, name) == (KIMI, "adafactor"):
            o_name, opt, _ = api.make_train_step(
                cfg, optimizer=_optimizer(name), mesh=mesh)
            p_sh, s_sh, _ = api.train_state_specs(cfg, o_name, opt, mesh)
            CheckpointManager(Path(tmp) / "ckpt22", device="cpu").save(
                steps, state, shardings=(p_sh, s_sh))
        out[(arch, name)] = rec
    # the dropping decode batch: every _slots call of the decode steps
    cfg = _cfg(KIMI)
    blocks = api.shard_params(_load(z, f"{KIMI}/adamw/p0", _template(KIMI)),
                              cfg, mesh)
    log = []
    real, spy = _slot_spy(log)
    moe._slots = spy
    try:
        out["drop"] = _serve(cfg, mesh, blocks, z["drop/prompt"],
                             [z[f"drop/dtok{i}"] for i in range(DECODE)])
    finally:
        moe._slots = real
    # the decode steps' routes (the prefill's calls come first, one a
    # layer); each also ranked as this data rank's tokens alone
    n_layers = cfg.n_layers
    dec = log[n_layers:]
    b_loc = DROP_B // mesh.size("data")
    d = mesh.rank("data")
    local = []
    for n, kept, cap, idx in dec:
        mine = idx[d * b_loc:(d + 1) * b_loc]
        lcap = moe._capacity(b_loc, cfg.moe)
        _, lvalid = real(mine, cfg.moe.n_experts, lcap)
        _, gvalid = real(idx, cfg.moe.n_experts, cap)
        local.append(bool(torch.equal(
            lvalid, gvalid.view(-1, cfg.moe.top_k)[d * b_loc:(d + 1) * b_loc]
            .reshape(-1))))
    out["drop_routes"] = {"choices": [x[0] for x in dec],
                          "kept": [x[1] for x in dec],
                          "local_same": local}
    return out


# ---------------------------------------------------------------------------
# the reference's run and the ranks'
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The path of the .npz of the reference's inputs and outputs."""
    tmp = tmp_path_factory.mktemp("moeref")
    npz = str(tmp / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", REF_CODE, npz],
                          capture_output=True, text=True, env=env,
                          timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return npz


@pytest.fixture(scope="module")
def z(ref):
    return np.load(ref)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("moeranks")


@pytest.fixture(scope="module")
def ranks(ref, work):
    return spawn(_rank, 4, backend="gloo",
                 init_file=str(work / "rendezvous"), args=(ref, str(work)),
                 timeout_s=120, join_timeout_s=300, mesh_shape=SHAPE,
                 mesh_axes=AXES)


def _np(t):
    return np.asarray(t, np.float64)


def _paths(tree):
    return {p: _np(x) for p, x in tree_paths(tree)}


def _ref_tree(z, prefix, paths):
    return {p: _np(z[prefix + p]) for p in paths}


def _scale(g, st):
    """Adafactor's k = 1 / (sqrt(D) c) of every element of a leaf, from
    its (clipped) gradient ``g`` and the statistics ``st`` the step left
    (fp64)."""
    if "v" in st:
        k0 = 1 / np.sqrt(st["v"] + EPS)
    else:
        vr, vc = st["vr"], st["vc"]
        norm = np.maximum(vr.mean(-1, keepdims=True)[..., None], EPS)
        k0 = 1 / np.sqrt(vr[..., None] * vc[..., None, :] / norm + EPS)
    rms = np.sqrt(np.mean((g * k0) ** 2) + EPS)
    return k0 / max(1.0, rms / CLIP)


def _adafactor_tol(da, db, ga, gb, ka, kb):
    """The most two Adafactor steps ``da``, ``db`` of an element may
    differ by, from the two sides' gradients and scales (module
    docstring)."""
    top = np.maximum(np.abs(ga), np.abs(gb))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(top > 0, np.abs(ga - gb) / top, 0.0)
    d = np.abs(ka / kb - 1)
    return np.maximum(np.abs(da), np.abs(db)) * (1 + d) * (r * (1 + d) + d)


def _stats(st):
    """{param path: its statistics dict} of a flattened Adafactor state
    ({"...['vr']": array, ...})."""
    out = {}
    for path, x in st.items():
        head, _, key = path.rpartition("[")
        out.setdefault(head, {})[key[1:-2]] = x
    return out


# ---------------------------------------------------------------------------
# against the reference's (2, 2) steps
# ---------------------------------------------------------------------------

RUN_IDS = [f"{a}-{o}" for a, o, _, _ in RUNS]


def test_ranks_sit_on_the_mesh(ranks):
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_every_rank_gets_the_same_bits(ranks, run):
    key = run[:2]
    first = ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["losses"] == first["losses"]
        assert r[key]["gnorms"] == first["gnorms"]
        # the params gathered from the blocks
        for (path, a), (_, b) in zip(tree_paths(r[key]["trail"][-1][0]),
                                     tree_paths(first["trail"][-1][0])):
            assert np.array_equal(a, b), (key, path)
    # the data replicas of a model rank hold the same blocks of every
    # leaf not split over 'data' (the experts' hidden dims are)
    mesh = _fake(SHAPE, (0, 0))
    split = {p: "data" in leaf.axes for p, leaf in tree_paths(tree_map(
        lambda l: api.leaf_layout(mesh, l.logical, l.shape),
        transformer.param_leaves(_cfg(run[0]))))}
    assert split["['layers']['moe']['wg']"]
    for m in (0, 1):
        a, b = (r[key]["blocks"] for r in ranks if r["coords"][1] == m)
        for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
            assert split[path] or np.array_equal(x, y), (key, path)
    for d in (0, 1):
        # a data group's logits
        mine = [r for r in ranks if r["coords"][0] == d]
        for what in (("drop",) if key == RUNS[0][:2] else ()) + (
                (key,) if run[3] else ()):
            logits = [(r[what] if what == "drop" else r[what]["logits"])
                      for r in mine]
            for a, b in zip(*logits):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_train_steps_match_the_reference(ranks, z, run):
    arch, name, steps, _ = run
    pre = f"{arch}/{name}/"
    got = ranks[0][(arch, name)]
    np.testing.assert_allclose(
        got["losses"], [float(z[pre + f"loss{s}"]) for s in range(steps)],
        rtol=RTOL)
    gnorms = [float(z[pre + f"gnorm{s}"]) for s in range(steps)]
    np.testing.assert_allclose(got["gnorms"], gnorms, rtol=RTOL)
    paths = list(_paths(got["trail"][0][0]))
    prev_a = prev_b = _ref_tree(z, pre + "p0", paths)
    tol = {p: np.full(prev_a[p].shape, FLOOR) for p in paths}
    for s in range(steps):
        pa = _paths(got["trail"][s][0])
        pb = _ref_tree(z, pre + f"p{s + 1}", paths)
        if name == "adafactor":
            sa = _stats(_paths(got["trail"][s][1]))
            sb = _stats(_ref_tree(z, pre + f"s{s + 1}", list(
                _paths(got["trail"][s][1]))))
            ga = _paths(got["trail"][s][2])
            clip = min(1.0, CLIP / (gnorms[s] + 1e-9))
            gb = {p: clip * g for p, g in _ref_tree(
                z, pre + f"g{s + 1}", paths).items()}
        for p in paths:
            da, db = pa[p] - prev_a[p], pb[p] - prev_b[p]
            if name == "adafactor":
                tol[p] = tol[p] + _adafactor_tol(
                    da, db, ga[p], gb[p], _scale(ga[p], sa[p]),
                    _scale(gb[p], sb[p]))
            else:
                tol[p] = tol[p] + 2 * STEP_MAX * LR[name]
            err = np.abs(pa[p] - pb[p])
            worst = int(np.argmax(err - tol[p]))
            assert err.flat[worst] <= tol[p].flat[worst], (
                pre, s, p, err.flat[worst], tol[p].flat[worst])
            if name == "adamw":
                assert (err > FLOOR).mean() <= FLOOR_SHARE, (pre, s, p)
        prev_a, prev_b = pa, pb


@pytest.mark.parametrize("run", RUNS[1:], ids=RUN_IDS[1:])
def test_adafactor_statistics_match_the_reference(ranks, z, run):
    arch, name, steps, _ = run
    got = ranks[0][(arch, name)]
    for s in range(steps):
        mine = _paths(got["trail"][s][1])
        want = _ref_tree(z, f"{arch}/{name}/s{s + 1}", list(mine))
        for p, x in mine.items():
            np.testing.assert_allclose(
                x, want[p], rtol=0,
                atol=STAT_TOL * np.abs(want[p]).max(), err_msg=p)


SERVED = [(a, o) for a, o, _, serve in RUNS if serve]


@pytest.mark.parametrize("i", range(1 + DECODE))
@pytest.mark.parametrize("run", SERVED, ids=[a for a, _ in SERVED])
def test_prefill_and_decode_match_the_reference(ranks, z, run, i):
    """The whole batch's logits: the data groups' shares, each from its
    'model' rank 0; arctic's dense residual branch is a partial sum over
    'model' and its MoE's output is whole, each counted once."""
    pre = "{}/{}/".format(*run)
    got = np.concatenate([r[run]["logits"][i] for r in ranks
                          if r["coords"][1] == 0])
    want = z[pre + ("prefill" if i == 0 else f"decode{i - 1}")]
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("i", range(1 + DECODE))
def test_a_dropping_decode_batch_matches_the_reference(ranks, z, i):
    got = np.concatenate([r["drop"][i] for r in ranks
                          if r["coords"][1] == 0])
    want = z["drop/" + ("prefill" if i == 0 else f"decode{i - 1}")]
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_the_decode_batch_drops_and_routes_as_one(ranks):
    """The decode steps' MoE saw the global batch (32 tokens, 64
    choices a layer), dropped choices past an expert's capacity, and on
    some data rank kept other slots than a data rank's 16 tokens alone
    would have."""
    for r in ranks:
        routes = r["drop_routes"]
        assert set(routes["choices"]) == {DROP_B * _cfg(KIMI).moe.top_k}
        assert min(routes["kept"]) < DROP_B * _cfg(KIMI).moe.top_k
    assert not all(ok for r in ranks for ok in r["drop_routes"]["local_same"])


# ---------------------------------------------------------------------------
# Adafactor's state restored onto another mesh
# ---------------------------------------------------------------------------

def _fake(shape, coords):
    return Mesh(tuple((a, None, c, n)
                      for a, c, n in zip(AXES, coords, shape)))


@pytest.mark.parametrize("m", range(4))
def test_adafactor_state_restores_onto_another_mesh(ranks, work, m):
    """kimi's (2, 2) Adafactor state after its steps, saved whole once,
    restored onto (1, 4) at each rank's coordinates: the blocks of the
    saved leaves, bit for bit (vr without its param's last spec entry,
    vc without its second-to-last: the experts' vc keeps their split
    over 'model')."""
    cfg, steps = _cfg(KIMI), RUNS[1][2]
    mgr = CheckpointManager(work / "ckpt22", device="cpu")
    assert mgr.steps() == [steps]
    mesh = _fake((1, 4), (0, m))
    name, opt, _ = api.make_train_step(cfg, optimizer=_optimizer("adafactor"),
                                       mesh=mesh)
    p_sh, s_sh, _ = api.train_state_specs(cfg, name, opt, mesh)
    assert s_sh["fac"]["layers"]["moe"]["wg"]["vc"].spec == (
        None, "model", None)
    blocks = api.shard_params(_template(KIMI), cfg, mesh)
    (params, state), manifest = mgr.restore((blocks, opt.init(blocks)),
                                            shardings=(p_sh, s_sh))
    assert state["step"] == steps
    saved = np.load(work / "ckpt22" / f"step_{steps}" / "arrays.npz")
    got = dict(tree_paths((params, state)))
    shardings = dict(_sharding_paths((p_sh, s_sh)))
    for i, path in enumerate(manifest["paths"]):
        if path == "[1]['step']":
            continue
        want = sharding.local_block(torch.from_numpy(saved[f"arr_{i}"]),
                                    mesh, shardings[path].spec)
        assert torch.equal(got[path].float(), want), path
    whole = ranks[0][(KIMI, "adafactor")]["trail"][-1]
    for i, path in enumerate(manifest["paths"]):
        if path.startswith("[1]['fac']"):
            assert np.array_equal(saved[f"arr_{i}"], dict(tree_paths(
                whole[1]))[path[len("[1]['fac']"):]]), path


def _sharding_paths(tree, path=""):
    """(keystr path, Sharding or None) of a shardings tree, in
    ``tree_paths``' naming (a ``Sharding`` is a leaf here)."""
    if tree is None or isinstance(tree, sharding.Sharding):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _sharding_paths(tree[k], f"{path}[{k!r}]")]
    return [pl for i, x in enumerate(tree)
            for pl in _sharding_paths(x, f"{path}[{i}]")]
