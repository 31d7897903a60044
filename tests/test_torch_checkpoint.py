"""The port's checkpoints and fault tolerance against the JAX reference.

``repro_torch.checkpoint.CheckpointManager`` against
``repro.checkpoint.CheckpointManager``: the leaf order and path strings of
``jax.tree_util`` on the group and uniform DLRM states, checkpoints that
either package writes restored by the other leaf for leaf and path for
path, keep-N and orphan GC on the same sequences of saves, the
reference's crash-consistency case (``tests/test_fleet.py``), an async
save that an in-place step follows, source artifacts of a group with
tiered members across packages, and the sharding refusals (item 13).
``repro_torch.distributed``: the straggler monitor's regressions and
``ResilientTrainer``'s resume against an uninterrupted run. The
launcher's ``--ckpt-dir``/``--resume``.

Tolerances: none. A checkpoint moves bits: restored leaves equal the
saved ones exactly (np.array_equal), and the reference's int32 step
counters come back as the port's Python ints of the same value.
"""
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import dlrm as j_cfgs
from repro.core import dlrm as j_dlrm
from repro.core import embedding_source as j_es
from repro.distributed.fault_tolerance import \
    StragglerMonitor as JStragglerMonitor
from repro.training import make_drifting_zipf as j_make_drifting_zipf
from repro_torch.checkpoint import CheckpointManager, reshard_checkpoint
from repro_torch.configs import dlrm as t_cfgs
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import embedding_source as es
from repro_torch.distributed import (ResilientTrainer, SimulatedFailure,
                                     StragglerMonitor)
from repro_torch.launch import train as t_train
from repro_torch.optim import tree_paths
from repro_torch.storage import TierPolicy
from repro_torch.training import make_drifting_zipf

torch.set_num_threads(1)

HET, J_HET = t_cfgs.DLRM_HET_SMOKE, j_cfgs.DLRM_HET_SMOKE
CFG, J_CFG = t_cfgs.DLRM_SMOKE, j_cfgs.DLRM_SMOKE
MAX_L = 4
_KEYS = ("dense", "indices", "offsets", "labels")


def _j_state(cfg, steps: int, seed: int = 0):
    """The reference's (params, opt_state) after ``steps`` sparse steps."""
    params = j_dlrm.init(jax.random.PRNGKey(seed), cfg)
    opt, step = j_dlrm.make_train_step_ragged(cfg, max_l=MAX_L, sparse=True)
    state = opt.init(params)
    gen = j_make_drifting_zipf(cfg, batch_size=4, mean_l=2, max_l=MAX_L,
                               seed=seed)
    for _ in range(steps):
        b = next(gen)
        params, state, _, _ = step(params, state,
                                   {k: jnp.asarray(b[k]) for k in _KEYS})
    return params, state


def _t_state(cfg, steps: int, seed: int = 0):
    """The port's (params, opt_state) after ``steps`` sparse steps, on
    the CPU."""
    params = t_dlrm.init(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
    opt, step = t_dlrm.make_train_step_ragged(cfg, max_l=MAX_L, sparse=True)
    state = opt.init(params)
    gen = make_drifting_zipf(cfg, batch_size=4, mean_l=2, max_l=MAX_L,
                             seed=seed)
    for _ in range(steps):
        b = next(gen)
        params, state, _, _ = step(params, state,
                                   {k: torch.from_numpy(b[k]) for k in _KEYS})
    return params, state


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("cfgs", [(HET, J_HET), (CFG, J_CFG)],
                         ids=["group", "uniform"])
def test_flatten_is_jax_order_and_keystr(cfgs):
    cfg, j_cfg = cfgs
    ours = tree_paths(_t_state(cfg, 0))
    flat, _ = jax.tree_util.tree_flatten_with_path(_j_state(j_cfg, 0))
    assert [p for p, _ in ours] == [jax.tree_util.keystr(p)
                                    for p, _ in flat]
    assert [tuple(np.shape(x)) for _, x in ours] == \
        [tuple(x.shape) for _, x in flat]


def test_flatten_sorts_keys_and_skips_none():
    tree = {"b": [1, None, (2, 3)], "a": {"z": 4, "y": None}, "c": None}
    ours = tree_paths(tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert ours == [(jax.tree_util.keystr(p), x) for p, x in flat]


@pytest.mark.parametrize("cfgs", [(HET, J_HET), (CFG, J_CFG)],
                         ids=["group", "uniform"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, cfgs):
    cfg, j_cfg = cfgs
    j_state = _j_state(j_cfg, 2)
    JCheckpointManager(tmp_path).save(7, j_state, meta={"who": "jax"})
    state, manifest = CheckpointManager(tmp_path, device="cpu").restore(
        _t_state(cfg, 0))
    assert manifest["step"] == 7 and manifest["meta"] == {"who": "jax"}
    got = tree_paths(state)
    flat, _ = jax.tree_util.tree_flatten_with_path(j_state)
    assert [p for p, _ in got] == manifest["paths"] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    for (_, a), (_, b) in zip(got, flat):
        if isinstance(a, int):
            assert a == int(b) and b.dtype == jnp.int32
        else:
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cfgs", [(HET, J_HET), (CFG, J_CFG)],
                         ids=["group", "uniform"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, cfgs):
    cfg, j_cfg = cfgs
    t_state = _t_state(cfg, 2, seed=3)
    CheckpointManager(tmp_path).save(4, t_state)
    j_state, manifest = JCheckpointManager(tmp_path).restore(
        _j_state(j_cfg, 0))
    assert manifest["step"] == 4
    flat, _ = jax.tree_util.tree_flatten_with_path(j_state)
    assert manifest["paths"] == [jax.tree_util.keystr(p) for p, _ in flat]
    for (_, a), (_, b) in zip(tree_paths(t_state), flat):
        np.testing.assert_array_equal(np.asarray(b), _np(a))
        assert b.dtype == (jnp.int32 if isinstance(a, int) else jnp.float32)


@pytest.mark.parametrize("keep_n", [0, 1, 2, 3])
def test_keep_n_gc_as_the_reference(tmp_path, keep_n):
    ours = CheckpointManager(tmp_path / "t", keep_n=keep_n)
    theirs = JCheckpointManager(tmp_path / "j", keep_n=keep_n)
    arena = torch.arange(8.0).reshape(2, 4)
    for step in (0, 3, 1, 5, 9):
        ours.save(step, {"w": arena + step})
        theirs.save(step, {"w": np.asarray(arena) + step})
        ours.save_source(step, es.VersionedSource(
            source=es.FpArena(arena + step), version=step))
        theirs.save_source(step, j_es.VersionedSource(
            source=j_es.FpArena(jnp.asarray(arena) + step), version=step))
        assert ours.steps() == theirs.steps()
        assert ours.source_steps() == theirs.source_steps()
        assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
            sorted(p.name for p in (tmp_path / "j").iterdir())
    assert ours.latest_step() == theirs.latest_step() == 9


def test_orphan_gc_sweeps_every_torn_write(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep_n=2)
    for name in ("tmp.3", "tmp.src.8", "tmp.1"):
        (tmp_path / name).mkdir()
    (tmp_path / "tmp.note").write_text("a file, not a writer's debris")
    ckpt.save(4, {"w": torch.ones(3)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4",
                                                          "tmp.note"]


def test_checkpoint_crash_consistency(tmp_path, monkeypatch):
    """The reference's case (tests/test_fleet.py): kill the writer
    between the tmp write and the atomic rename; the latest prior step
    restores intact, and the next successful save sweeps the debris;
    the same for source artifacts."""
    ckpt = CheckpointManager(tmp_path, keep_n=3, device="cpu")
    ckpt.save(1, {"w": torch.arange(4.0)})
    ckpt.save(2, {"w": torch.arange(4.0) + 1})

    real_rename = Path.rename
    die = {"on": True}

    def dying_rename(self, target):
        if die["on"] and self.name.startswith("tmp."):
            raise OSError("writer killed mid-publish")
        return real_rename(self, target)

    monkeypatch.setattr(Path, "rename", dying_rename)
    with pytest.raises(OSError):
        ckpt.save(3, {"w": torch.arange(4.0) + 2})
    assert ckpt.latest_step() == 2
    state, manifest = ckpt.restore({"w": torch.zeros(4)})
    assert manifest["step"] == 2
    assert torch.equal(state["w"], torch.arange(4.0) + 1)
    assert any(p.name == "tmp.3" for p in tmp_path.iterdir())

    die["on"] = False
    ckpt.save(4, {"w": torch.arange(4.0) + 3})
    assert not list(tmp_path.glob("tmp.*"))
    assert ckpt.latest_step() == 4

    arena = torch.arange(32.0).reshape(8, 4)
    ckpt.save_source(5, es.VersionedSource(source=es.FpArena(arena),
                                           version=1))
    die["on"] = True
    with pytest.raises(OSError):
        ckpt.save_source(6, es.VersionedSource(
            source=es.FpArena(arena + 1), version=2))
    vs, manifest = ckpt.restore_source()
    assert manifest["step"] == 5 and vs.version == 1
    assert any(p.name == "tmp.src.6" for p in tmp_path.iterdir())
    die["on"] = False
    ckpt.save_source(7, es.VersionedSource(source=es.FpArena(arena + 2),
                                           version=3))
    assert not list(tmp_path.glob("tmp.*"))
    assert ckpt.latest_source_step() == 7
    vs, _ = ckpt.restore_source()
    assert torch.equal(vs.source.arena, arena + 2)


def test_save_async_keeps_the_state_before_an_in_place_step(tmp_path):
    """The step after ``save_async`` rewrites the same tensors: the
    checkpoint holds the state as it was when ``save_async`` returned."""
    params, state = _t_state(HET, 1)
    want = [(p, _np(x).copy()) for p, x in tree_paths((params, state))]
    ckpt = CheckpointManager(tmp_path, device="cpu")
    ckpt.save_async(0, (params, state))
    opt, step = t_dlrm.make_train_step_ragged(HET, max_l=MAX_L, sparse=True)
    b = next(make_drifting_zipf(HET, batch_size=4, mean_l=2, max_l=MAX_L,
                                seed=9))
    new, _, _, _ = step(params, state,
                        {k: torch.from_numpy(b[k]) for k in _KEYS})
    assert new["tables"][0] is params["tables"][0]
    assert not np.array_equal(params["tables"][0].numpy(), want[7][1])
    ckpt.wait()
    got, _ = ckpt.restore(_t_state(HET, 0))
    for (p, a), (q, b) in zip(want, tree_paths(got)):
        assert p == q
        np.testing.assert_array_equal(a, _np(b))


def test_save_async_raises_the_writer_error_at_wait(tmp_path, monkeypatch):
    ckpt = CheckpointManager(tmp_path)

    def refuse(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", refuse)
    ckpt.save_async(0, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    ckpt.wait()                      # the error is raised once


def test_restore_refusals(tmp_path):
    ckpt = CheckpointManager(tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"w": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_source()
    ckpt.save(0, {"w": torch.zeros(2), "v": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore({"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"w": torch.zeros(2), "v": torch.zeros(4)})
    with pytest.raises(TypeError, match="VersionedSource"):
        ckpt.save_source(0, b"not an artifact")


def test_sharded_restores_name_their_item(tmp_path):
    """Restoring onto a mesh is ported (item 13; tests/test_torch_sharded
    and test_torch_sharded_dist.py): a sharding is the port's Mesh or
    None, and anything else is refused."""
    ckpt = CheckpointManager(tmp_path, device="cpu")
    ckpt.save(0, {"w": torch.zeros(2)})
    with pytest.raises(TypeError, match="Mesh"):
        ckpt.restore({"w": torch.zeros(2)}, shardings={"w": object()})
    with pytest.raises(TypeError, match="Mesh"):
        reshard_checkpoint(tmp_path, {"w": torch.zeros(2)}, object(),
                           device="cpu")


def test_restore_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(0, {"w": torch.zeros(2)})
    ckpt.save_source(0, es.VersionedSource(
        source=es.FpArena(torch.zeros(3, 2)), version=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore({"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore_source()
    state, _ = CheckpointManager(tmp_path, device="cpu").restore(
        {"w": torch.zeros(2)})
    assert state["w"].device.type == "cpu"


def test_bf16_leaves_round_trip_exactly(tmp_path):
    w = (torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16))
    ckpt = CheckpointManager(tmp_path, device="cpu")
    ckpt.save(0, {"w": w, "n": 3})
    got, manifest = ckpt.restore({"w": torch.zeros_like(w), "n": 0})
    assert torch.equal(got["w"], w) and got["w"].dtype == torch.bfloat16
    assert got["n"] == 3 and manifest["dtypes"] == ["int64", "float32"]


def _tiered_group(seed=0):
    """DLRM_HET_SMOKE's tables, the first tiered with a host cold tier,
    the second tiered int4, the third cached."""
    plans = (es.TablePlan(rows=2000, dim=16,
                          tiers=TierPolicy(hot=32, warm=200, cold="host",
                                           staging_rows=64,
                                           max_stage_per_batch=16)),
             es.TablePlan(rows=150, dim=8,
                          tiers=TierPolicy(hot=8, warm=40)),
             es.TablePlan(rows=9, dim=4, cache_k=3))
    params = t_dlrm.init(torch.Generator().manual_seed(seed), HET,
                         device="cpu")
    return es.SourceSpec(tables=plans).build(params["tables"], None)


def test_source_artifact_of_a_tiered_group_round_trips(tmp_path):
    """``save_source``/``restore_source`` of a group whose members are a
    host-tiered, an int4-tiered and a cached table: every tensor back
    bit for bit, the host store dropped (``None``), and the reference
    reads the port's artifact."""
    group = _tiered_group()
    ckpt = CheckpointManager(tmp_path, device="cpu")
    ckpt.save_source(12, es.VersionedSource(source=group, version=4))
    vs, manifest = ckpt.restore_source()
    assert manifest["step"] == 12 and manifest["version"] == 4
    assert vs.version == 4
    s_a, leaves_a = es.source_structure(group)
    s_b, leaves_b = es.source_structure(vs.source)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert torch.equal(a, b)
    assert group.members[0].cold.store is not None
    assert vs.source.members[0].cold.store is None
    j_vs, j_manifest = JCheckpointManager(tmp_path).restore_source()
    assert j_manifest == manifest and j_vs.version == 4
    j_leaves = jax.tree_util.tree_leaves(j_vs.source)
    assert len(j_leaves) == len(leaves_a)
    for a, b in zip(leaves_a, j_leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# distributed.fault_tolerance
# ---------------------------------------------------------------------------

def test_straggler_monitor_consecutive_stragglers_all_flagged():
    """The reference's regression: flagged outliers stay out of the
    median window, so a run of stragglers cannot mask the next one; the
    port's monitor flags what the reference's does."""
    ours, theirs = (StragglerMonitor(threshold=2.0, window=8),
                    JStragglerMonitor(threshold=2.0, window=8))
    durations = [1.0] * 8 + [3.0, 3.0, 3.0, 3.0, 5.0, 1.0, 9.0]
    flags = [(ours.record(s, d), theirs.record(s, d))
             for s, d in enumerate(durations)]
    assert all(a == b for a, b in flags)
    assert [a for a, _ in flags] == [False] * 8 + [True] * 5 + [False, True]
    assert ours.events == theirs.events
    assert all(e["median"] == 1.0 for e in ours.events)
    assert set(ours.durations) == {1.0}


def test_straggler_monitor_calls_back():
    seen = []
    mon = StragglerMonitor(threshold=2.0, window=8,
                           on_straggler=lambda s, d: seen.append((s, d)))
    for step in range(8):
        mon.record(step, 1.0)
    assert mon.record(8, 10.0) and mon.record(9, 10.0)
    assert seen == [(8, 10.0), (9, 10.0)]


def _in_place_run(tmp_path, fail_at, ckpt_every=2, total=7):
    """A ResilientTrainer over an in-place step (w += g(step), the
    port's idiom), optionally crashing once at ``fail_at``."""
    resumes = []

    def step_fn(w, state, batch):
        w.add_(batch)
        state["n"] += 1
        return w, state, float(w.sum())

    rt = ResilientTrainer(step_fn, CheckpointManager(tmp_path,
                                                     device="cpu"),
                          ckpt_every=ckpt_every, on_resume=resumes.append)
    state, loss = rt.run((torch.zeros(3), {"n": 0}),
                         lambda s: torch.full((3,), float(s + 1)) ** 0.5,
                         total, fail_at=fail_at)
    return state, loss, rt.restarts, resumes


@pytest.mark.parametrize("fail_at", [0, 2, 3, 6])
def test_resilient_trainer_resumes_to_the_uninterrupted_state(tmp_path,
                                                              fail_at):
    """A crash at ``fail_at`` restores the latest checkpoint and replays
    the step-seeded batches: the final state equals an uninterrupted
    run's bit for bit. The restored tensors are new, so nothing of the
    crashed run's in-place state survives."""
    want, _, _, _ = _in_place_run(tmp_path / "clean", None)
    got, loss, restarts, resumes = _in_place_run(tmp_path / "crash",
                                                 fail_at)
    assert restarts == 1
    assert resumes == [fail_at - fail_at % 2]
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert loss == float(want[0].sum())


def test_resilient_trainer_restart_without_a_checkpoint_follows_the_reference(
        tmp_path):
    """A crash before the first checkpoint restarts at step 0 from the
    state as the crash left it, in both packages: the steps before the
    crash are applied twice, so the run ends away from an uninterrupted
    one (ROADMAP Queue 3). The port pins the reference's behaviour."""
    from repro.distributed.fault_tolerance import \
        ResilientTrainer as JResilientTrainer

    def j_step(w, state, batch):
        return w + batch, {"n": state["n"] + 1}, float(jnp.sum(w + batch))

    j_rt = JResilientTrainer(j_step, JCheckpointManager(tmp_path / "j"),
                             ckpt_every=2)
    j_state, _ = j_rt.run(
        (jnp.zeros(3), {"n": jnp.int32(0)}),
        lambda s: jnp.full((3,), float(s + 1), jnp.float32) ** 0.5, 7,
        fail_at=1)
    got, _, restarts, resumes = _in_place_run(tmp_path / "t", 1)
    want, _, _, _ = _in_place_run(tmp_path / "clean", None)
    assert restarts == j_rt.restarts == 1 and resumes == [0]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_state[0]))
    assert got[1]["n"] == int(j_state[1]["n"]) == 8
    assert not torch.equal(got[0], want[0])


def test_resilient_trainer_gives_up_after_max_restarts(tmp_path):
    def step_fn(w, state, batch):
        raise SimulatedFailure("node lost")

    rt = ResilientTrainer(step_fn, CheckpointManager(tmp_path,
                                                     device="cpu"),
                          max_restarts=2)
    with pytest.raises(SimulatedFailure):
        rt.run((torch.zeros(1), {}), lambda s: None, 3)
    assert rt.restarts == 3


# ---------------------------------------------------------------------------
# the launcher's --ckpt-dir / --resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True], ids=["fixed", "ragged"])
def test_launcher_checkpoints_and_resumes(tmp_path, ragged):
    """``--ckpt-dir`` saves every ``--ckpt-every`` steps (keep 3); a
    ``--resume`` run starts after the latest one from its state, as
    restored by the manager."""
    base = ["--smoke", "--device", "cpu", "--batch-size", "8",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"] + (["--ragged"] if ragged else [])
    out = io.StringIO()
    with redirect_stdout(out):
        loss = t_train.main(base + ["--steps", "8"])
    lines = out.getvalue().splitlines()
    assert lines[-2:] == ["straggler events: 0", f"final loss {loss:.4f}"]
    ckpt = CheckpointManager(tmp_path, device="cpu")
    assert ckpt.steps() == [3, 5, 7]
    manifest = json.loads((tmp_path / "step_7" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 7
    assert manifest["paths"][0] == "[0]['arena']"
    out = io.StringIO()
    with redirect_stdout(out):
        t_train.main(base + ["--steps", "10", "--resume"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "resumed from step 7"
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "8"],
                                                     ["step", "9"]]
    assert ckpt.steps() == [5, 7, 9]


def test_launcher_without_checkpoints_is_unchanged(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        t_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                      "--batch-size", "8", "--resume", "--ckpt-dir",
                      str(tmp_path)])
    assert "resumed" not in out.getvalue()
    assert not list(tmp_path.iterdir())
