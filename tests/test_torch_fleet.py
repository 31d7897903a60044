"""The port's fleet against the JAX reference's, and its protocol laws.

``repro_torch.fleet.chaos`` is a copy of the reference's JAX-free module:
its schedule, counters and delivery order equal the reference's decision
for decision. ``FleetRunner`` on ``DLRM_HET_SMOKE`` under the
reference bench's plan (``FaultPlan(seed=6, ...)``) gives the
reference's transcript exactly: per-round delivery stats, versions,
drops, dups, stale injections and rejections, per-version hit rates per
model and replica, recovery bumps, a replica's restart from disk and a
trainer crash and resume with its restarts, versions, histograms and
step count. None of these depends on the params, which the two packages
initialise from different generators; they depend on the batches, the
rankings and the chaos seeds, which are shared.

Within the port: the chaos invariants over seeded fault mixes (stale
injected == rejected, bit-exact recovery within 3 bumps with no new
graph capture, attribution only to published versions), the A/B head
semantics, a restarted replica's exactness, a crashed and resumed
trainer's params bit for bit against an uninterrupted control trainer,
the double observation of replayed steps, the per-round spans, the
refusals, and a ``Replica`` taking a mesh and the publisher's shard
padding (a sharded publisher's run is ``tests/test_torch_lm_mesh.py``'s).

Tolerances: none; every comparison is exact (integers, versions, hit
rates computed from integer counts, probabilities and params bit for
bit within the port).
"""
import inspect

import numpy as np
import pytest
import torch

from repro import fleet as j_fleet
from repro import obs as j_obs
from repro_torch import obs
from repro_torch.configs.dlrm import DLRM_SMOKE
from repro_torch.core import dlrm as t_dlrm
from repro_torch.fleet import (CLEAN, ChaosChannel, FaultPlan, FleetRunner,
                               Replica, chaos)
from repro_torch.fleet.runner import _serve_batch
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import tree_leaves
from repro_torch.training import OnlineGroupTrainer
from repro_torch.training.online import _dense_head

torch.set_num_threads(1)

MIXES = (
    FaultPlan(drop=0.3, dup=0.3, delay=0.6, max_delay=3),
    FaultPlan(drop=0.0, dup=0.5, delay=0.8, max_delay=2),
)
BENCH_PLAN = FaultPlan(seed=6, drop=0.3, dup=0.3, delay=0.6, max_delay=3)


# ---------------------------------------------------------------------------
# the chaos copy
# ---------------------------------------------------------------------------

def _channel_run(chan, n=8):
    fates, delivered = [], []
    for v in range(1, n + 1):
        fates.append(chan.send(f"blob{v}".encode(), v))
        delivered += chan.poll()
    delivered += chan.flush()
    return fates, delivered, (chan.sends, chan.dropped, chan.duplicated,
                              chan.delayed, chan.in_flight)


@pytest.mark.parametrize("plan", MIXES + (BENCH_PLAN, CLEAN),
                         ids=["lossy", "dup_delay", "bench", "clean"])
@pytest.mark.parametrize("seed", [0, 6, 107, 100_207])
def test_chaos_schedule_equals_the_reference(plan, seed):
    j_plan = j_fleet.FaultPlan(**{f: getattr(plan, f) for f in
                                  ("drop", "dup", "delay", "max_delay")})
    tel, j_tel = obs.Telemetry(), j_obs.Telemetry()
    ours = _channel_run(ChaosChannel(plan.with_seed(seed), telemetry=tel))
    theirs = _channel_run(j_fleet.ChaosChannel(j_plan.with_seed(seed),
                                               telemetry=j_tel))
    assert ours == theirs
    assert [(e.kind, e.version, e.attrs) for e in tel.events.query()] == \
        [(e.kind, e.version, e.attrs) for e in j_tel.events.query()]


def test_chaos_module_is_the_reference_copy():
    """The copy differs from the reference's module in its telemetry
    import alone."""
    ours = inspect.getsource(chaos).splitlines()
    theirs = inspect.getsource(j_fleet.chaos).splitlines()
    diff = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(ours) == len(theirs)
    assert diff == [("from repro_torch import obs", "from repro import obs")]


@pytest.mark.parametrize("seed", [0, 500, 1000])
def test_chaos_schedule_replays_from_seed(seed):
    for plan in MIXES:
        p = plan.with_seed(seed)
        f1, d1, c1 = _channel_run(ChaosChannel(p))
        f2, d2, c2 = _channel_run(ChaosChannel(p))
        assert f1 == f2 and d1 == d2 and c1 == c2
        n_copies = sum(0 if f["dropped"] else (2 if f["duplicated"] else 1)
                       for f in f1)
        assert len(d1) == n_copies
        assert [f["send"] for f in f1] == list(range(1, 9))


def test_chaos_clean_plan_is_perfect_transport():
    chan = ChaosChannel(CLEAN)
    for v in (1, 2, 3):
        chan.send(f"b{v}".encode(), v)
        assert [x[0] for x in chan.poll()] == [v]
    assert chan.dropped == chan.duplicated == chan.delayed == 0
    assert chan.in_flight == 0


# ---------------------------------------------------------------------------
# the fleet transcript against the reference
# ---------------------------------------------------------------------------

def _hit_rates(fr):
    return {"ref": {m: e.telemetry.events.hit_rate_by_version()
                    for m, e in fr.ref.items()},
            "replicas": [{m: rep.hit_rate_by_version(m) for m in ("a", "b")}
                         for rep in fr.replicas]}


def _replicas(fr):
    return [{"versions": rep.versions(), "stale": rep.stale_injected,
             "rejected": rep.stale_rejections(), "applied": rep.applied,
             "counts": (rep.channel.sends, rep.channel.dropped,
                        rep.channel.duplicated, rep.channel.delayed),
             "schedule": rep.channel.schedule}
            for rep in fr.replicas]


def _transcript(make):
    """The bench scenario on one package's FleetRunner: six chaos rounds,
    recovery, a replica's restart from disk and recovery, a trainer
    crash and resume and recovery."""
    fr = make()
    out = {"rounds": [fr.round() for _ in range(6)]}
    out["after_chaos"] = _replicas(fr)
    out["hit_rates"] = _hit_rates(fr)
    rec = fr.recover(k=3)
    out["recover"] = (rec["bumps"], rec["exact"])
    rep = fr.crash_replica(0)
    out["restore_events"] = sorted(
        (e.version, e.attrs["step"], e.attrs["model"])
        for eng in rep.engines.values()
        for e in eng.telemetry.events.query("replica_restore"))
    rec = fr.recover(k=3)
    out["recover_restart"] = (rec["bumps"], rec["exact"])
    res = fr.run_trainer_with_crash(extra_steps=6, fail_after=3,
                                    ckpt_every=2)
    out["crash"] = (res["restarts"], res["resume_events"], res["version"])
    out["trainer"] = (fr.trainer.steps, fr.trainer.version, fr.next_step,
                      [h.tolist() for h in fr.trainer.hists])
    out["ckpt_steps"] = (fr.ckpt.steps(), fr.ckpt.source_steps())
    rec = fr.recover(k=3)
    out["recover_crash"] = (rec["bumps"], rec["exact"])
    out["final"] = _replicas(fr)
    out["final_hit_rates"] = _hit_rates(fr)
    return fr, out


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    base = tmp_path_factory.mktemp("fleet")
    ours = _transcript(lambda: FleetRunner(
        n_replicas=2, plan=BENCH_PLAN, seed=0, ckpt_dir=base / "t",
        device="cpu"))
    j_plan = j_fleet.FaultPlan(seed=6, drop=0.3, dup=0.3, delay=0.6,
                               max_delay=3)
    theirs = _transcript(lambda: j_fleet.FleetRunner(
        n_replicas=2, plan=j_plan, seed=0, ckpt_dir=base / "j"))
    return ours, theirs


@pytest.mark.parametrize("part", [
    "rounds", "after_chaos", "hit_rates", "recover", "restore_events",
    "recover_restart", "crash", "trainer", "ckpt_steps", "recover_crash",
    "final", "final_hit_rates"])
def test_fleet_transcript_equals_the_reference(transcripts, part):
    (_, ours), (_, theirs) = transcripts
    assert ours[part] == theirs[part]


def test_bench_plan_injects_stale_and_recovers_exactly(transcripts):
    """The pinned plan drops, duplicates and reorders on every replica,
    and the port recovers bit-exact within 3 bumps with no capture."""
    fr, t = transcripts[0]
    chaos_reps = t["after_chaos"]
    assert all(r["stale"] > 0 and r["stale"] == r["rejected"]
               for r in chaos_reps)
    assert sum(r["counts"][1] for r in chaos_reps) > 0
    assert sum(r["counts"][2] for r in chaos_reps) > 0
    for key in ("recover", "recover_restart", "recover_crash"):
        bumps, exact = t[key]
        assert bumps <= 3 and all(all(v) for v in exact.values())
    assert all(n == 0 for rep in fr.replicas
               for n in rep.recompiles().values())


# ---------------------------------------------------------------------------
# the port's own laws
# ---------------------------------------------------------------------------

def _assert_fleet_invariants(fr, published_versions):
    """The reference suite's three assertions: stale injected ==
    rejected (and == reorder events), bit-exact recovery within 3 bumps
    with no new capture, attribution only to published versions."""
    for rep in fr.replicas:
        assert rep.stale_injected == rep.stale_rejections(), rep.name
        reordered = sum(
            len(e.telemetry.events.query("broadcast_reordered"))
            for e in rep.engines.values())
        assert reordered == rep.stale_injected, rep.name
        v = rep.versions()
        assert v["a"] == v["b"], v
    rec = fr.recover(k=3)
    assert all(all(flags) for flags in rec["exact"].values()), rec
    assert rec["bumps"] <= 3
    for per_model in rec["recompiles"]:
        assert all(n == 0 for n in per_model.values()), per_model
    for rep in fr.replicas:
        for model in ("a", "b"):
            hrv = rep.hit_rate_by_version(model)
            assert set(hrv) <= set(published_versions) | {0}, (model, hrv)
            assert all(r is None or 0.0 <= r <= 1.0 for r in hrv.values())


@pytest.mark.parametrize("plan", MIXES, ids=["lossy", "dup_delay"])
@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_fleet_chaos_property(seed, plan):
    fr = FleetRunner(n_replicas=2, plan=plan.with_seed(seed), seed=seed,
                     device="cpu")
    for _ in range(3):
        fr.round()
    _assert_fleet_invariants(fr, list(range(1, fr.trainer.version + 1)))


def test_ab_heads():
    """After the bench plan's chaos and recovery, variant B's dense head
    is the frozen candidate and variant A's the trainer's, bit for
    bit."""
    fr = FleetRunner(n_replicas=2, plan=BENCH_PLAN, seed=0, device="cpu")
    for _ in range(6):
        fr.round()
    fr.recover(k=3)
    want_a = tree_leaves(_dense_head(fr.trainer.params))
    want_b = tree_leaves(fr.head_b)
    for rep in fr.replicas:
        got_b = tree_leaves(_dense_head(rep.engines["b"].params))
        assert all(torch.equal(g, w) for g, w in zip(got_b, want_b))
        got_a = tree_leaves(_dense_head(rep.engines["a"].params))
        assert all(torch.equal(g, w) for g, w in zip(got_a, want_a))
        # the engines own their tensors (the snapshot rule)
        mine = {t.data_ptr() for t in tree_leaves(fr.trainer.params)}
        assert not mine & {t.data_ptr()
                           for t in tree_leaves(rep.engines["a"].params)}


def test_replica_restart_restores_from_checkpoint(tmp_path):
    fr = FleetRunner(n_replicas=2, plan=BENCH_PLAN, seed=1,
                     ckpt_dir=tmp_path, device="cpu")
    for _ in range(2):
        fr.round()
    rep = fr.crash_replica(0)
    restores = [e for eng in rep.engines.values()
                for e in eng.telemetry.events.query("replica_restore")]
    assert len(restores) == len(rep.engines)
    vs, manifest = fr.ckpt.restore_source()
    assert all(e.version == vs.version for e in restores)
    assert all(e.attrs["step"] == manifest["step"] for e in restores)
    assert rep.versions() == {"a": vs.version, "b": vs.version}
    assert fr.all_exact()
    rec = fr.recover(k=3)
    assert rec["bumps"] == 0
    assert all(n == 0 for per in rec["recompiles"] for n in per.values())


def _control(fr):
    ctl = OnlineGroupTrainer(
        fr.cfg, t_dlrm.init(torch.Generator().manual_seed(fr.seed), fr.cfg,
                            device="cpu"),
        max_l=fr.max_l, plans=t_dlrm.table_plans(fr.cfg, cache_k=64),
        refresh_every=fr.trainer.refresh_every, device="cpu")
    for step in range(fr.next_step):
        ctl.train_step(fr.batch_fn(step))
    return ctl


def test_trainer_crash_resume_is_bit_identical(tmp_path):
    """ResilientTrainer through a mid-run crash: the resumed trainer's
    params equal an uninterrupted control trainer's fed the same
    step-seeded batches bit for bit; the version stays monotone; the
    restored tensors are the trainer's live state (no pre-crash tensor
    in the params, the optimizer state or the caches); the fleet then
    recovers to exactness."""
    fr = FleetRunner(n_replicas=1, plan=BENCH_PLAN.with_seed(2), seed=2,
                     ckpt_dir=tmp_path, device="cpu")
    fr.round()
    t = fr.trainer
    v_before = t.version
    before = {x.data_ptr() for x in tree_leaves((t.params, t.opt_state))
              if isinstance(x, torch.Tensor)}
    res = fr.run_trainer_with_crash(extra_steps=6, fail_after=3,
                                    ckpt_every=2)
    assert res["restarts"] == 1 and res["resume_events"] == 1
    assert res["version"] >= v_before
    live = [x for x in tree_leaves((t.params, t.opt_state))
            if isinstance(x, torch.Tensor)]
    assert not before & {x.data_ptr() for x in live}
    for c, arena in zip(t.caches, t.params["tables"]):
        assert torch.equal(c.hot_rows[:-1], arena[c.hot_ids.long()])
    ctl = _control(fr)
    got, want = tree_leaves(t.params), tree_leaves(ctl.params)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got_s, want_s = (tree_leaves(x.opt_state) for x in (t, ctl))
    assert all(torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w
               for g, w in zip(got_s, want_s))
    rec = fr.recover(k=3)
    assert all(all(flags) for flags in rec["exact"].values()), rec


def test_replayed_steps_are_observed_twice(tmp_path):
    """The histograms, ``steps`` and the version are not checkpointed,
    as in the reference: the steps replayed after the crash are counted
    and observed again, so the trainer's histograms are the control's
    plus the replayed batches' counts (decayed as they came)."""
    fr = FleetRunner(n_replicas=1, seed=2, ckpt_dir=tmp_path, device="cpu")
    fr.round()
    start = fr.next_step
    fr.run_trainer_with_crash(extra_steps=6, fail_after=3, ckpt_every=2)
    ctl = _control(fr)
    # checkpoints at start-1 (the seed) and start+1; the crash at start+3
    # resumes at start+2, so step start+2 runs twice
    assert fr.trainer.steps == ctl.steps + 1
    replay = OnlineGroupTrainer(
        fr.cfg, t_dlrm.init(torch.Generator().manual_seed(fr.seed), fr.cfg,
                            device="cpu"),
        max_l=fr.max_l, plans=t_dlrm.table_plans(fr.cfg, cache_k=64),
        refresh_every=10**9, device="cpu")
    for step in list(range(start + 3)) + list(range(start + 2,
                                                    fr.next_step)):
        replay.observe(fr.batch_fn(step))
    for a, b in zip(fr.trainer.hists, replay.hists):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b)
               for a, b in zip(fr.trainer.hists, ctl.hists))


def test_round_timings(tmp_path):
    """A round's parts are spans on the trainer's telemetry, recorded
    only with its tracing on: one ``fleet_round`` trace a round, its
    version, chaos flag and blob size as attributes."""
    fr = FleetRunner(n_replicas=2, plan=BENCH_PLAN, ckpt_dir=tmp_path,
                     device="cpu")
    tracer = fr.trainer.telemetry.tracer
    fr.round()
    assert not tracer.enabled and tracer.spans() == []
    tracer.enabled = True
    fr.round()
    fr.recover(k=3)
    traces = list(tracer.traces().values())
    assert len(traces) == fr.rounds - 1
    for spans in traces:
        names = sorted(x.name for x in spans)
        assert names == ["fleet_deliver", "fleet_deliver", "fleet_round",
                         "fleet_save_source", "fleet_serialize",
                         "fleet_train"]
        assert all(x.end is not None and x.duration_ms > 0 for x in spans)
        assert [x.attrs["replica"] for x in spans
                if x.name == "fleet_deliver"] == ["replica0", "replica1"]
    root = tracer.spans("fleet_round")
    assert [x.attrs["chaos"] for x in root] == [True] + [False] * (
        fr.rounds - 2)
    assert root[0].attrs["version"] == fr.trainer.version - (fr.rounds - 2)
    assert root[-1].attrs["blob_bytes"] == len(fr.artifact().serialize())


def test_fleet_refusals(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="heterogeneous"):
        FleetRunner(DLRM_SMOKE, device="cpu")
    fr = FleetRunner(n_replicas=1, device="cpu")
    with pytest.raises(ValueError, match="ckpt_dir"):
        fr.crash_replica(0)
    with pytest.raises(ValueError, match="ckpt_dir"):
        fr.run_trainer_with_crash(extra_steps=1, fail_after=0)
    vs = fr.artifact()
    # a mesh and the publisher's shard padding are taken, as the
    # reference's Replica takes them: the mesh goes to each engine, which
    # serves the broadcast source as it is, and the placeholder arena is
    # padded for the shards
    one = Replica("r", fr.cfg, vs, ChaosChannel(CLEAN), max_l=fr.max_l,
                  batch_size=fr.batch_size, heads={"a": dict(vs.head)},
                  device="cpu")
    mesh = Mesh((("model", None, 0, 1),))
    rep = Replica("r", fr.cfg, vs, ChaosChannel(CLEAN), max_l=fr.max_l,
                  batch_size=fr.batch_size, heads={"a": dict(vs.head)},
                  device="cpu", mesh=mesh, shards=2)
    assert rep.mesh is mesh
    probe = fr.batch_fn(0)
    assert _serve_batch(rep.engines["a"], fr.cfg, probe) \
        == _serve_batch(one.engines["a"], fr.cfg, probe)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRunner(n_replicas=1)


def test_chaos_replica_matches_reference_outcomes():
    """One replica fed by hand: deliver's outcomes ('applied',
    'republish', 'stale') and the engines' versions follow the
    reference's rules on an in-order, duplicated and reordered
    sequence."""
    fr = FleetRunner(n_replicas=1, device="cpu")
    rep = fr.replicas[0]
    blobs = {}
    for _ in range(2):
        fr._train_one_refresh()
        blobs[fr.trainer.version] = fr.artifact().serialize()
    assert rep.deliver(3, blobs[3]) == "applied"
    assert rep.deliver(3, blobs[3]) == "republish"
    assert rep.deliver(2, blobs[2]) == "stale"
    assert rep.versions() == {"a": 3, "b": 3}
    assert rep.stale_injected == rep.stale_rejections() == 2
    assert rep.applied == 2
