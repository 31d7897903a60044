"""Fleet runner: one trainer, N chaos-fed replicas, A/B model variants.

The topology the Centaur broadcast protocol was built for, run end to
end (the port of ``repro/fleet/runner.py``):

* ONE ``OnlineGroupTrainer`` owns the shared sparse state (a
  heterogeneous ``TableGroupSource``) and trains variant A's dense head
  beside it;
* TWO DLRM variants (A = the trained head, B = a frozen candidate head)
  serve over that one shared group. Each variant has its own
  ``RecEngine`` a replica with its own telemetry, so per-version hit-rate
  attribution (``telemetry.events.hit_rate_by_version()``) is per model;
* every broadcast is a ``VersionedSource`` blob carrying the dense head
  (``include_head=True``): a replica adopts everything it serves from the
  blob, through one seeded ``ChaosChannel`` a replica
  (drop/duplicate/delay/reorder);
* crash scenarios: a replica restarts from
  ``CheckpointManager.restore_source`` (``replica_restore`` event), the
  trainer crashes and resumes through ``ResilientTrainer`` with step-seeded
  batches (``trainer_resume`` event).

Recovery is asserted on exactness: after at most K clean version bumps
every replica's output for a fixed probe batch equals a trainer-synced
reference engine's bit for bit, with no new CUDA graph capture since
``warmup()`` (``Replica.recompiles``; the reference counts compile-cache
entries), since every swap is copied into the captured tensors.

With tracing on in the trainer's telemetry, every round records its
parts as spans there (``FleetRunner.round``). Everything runs on the
card unless ``device="cpu"``. A ``Replica`` of a publisher that trains
on a mesh takes ``shards`` (the publisher's arena padding) and ``mesh``
(handed to each engine), as the reference's.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.configs.dlrm import DLRM_HET_SMOKE
from repro_torch.core import dlrm
from repro_torch.core import embedding_source as es
from repro_torch.distributed.fault_tolerance import ResilientTrainer
from repro_torch.fleet.chaos import CLEAN, ChaosChannel, FaultPlan
from repro_torch.serving.rec_engine import (RecEngine,
                                            requests_from_ragged_batch)
from repro_torch.training.online import (OnlineGroupTrainer, _dense_head,
                                         make_drifting_zipf)

__all__ = ["FleetRunner", "Replica"]

MODELS = ("a", "b")        # A = trained head, B = frozen candidate head


def _serve_batch(engine: RecEngine, cfg: DLRMConfig,
                 batch: Dict, rid0: int = 0) -> List[float]:
    """Run one ragged batch through an engine's dispatch/settle path and
    return the served probabilities (fresh request objects every call:
    settle writes into them)."""
    reqs = requests_from_ragged_batch(batch, cfg.n_tables, rid0=rid0)
    ib = engine.dispatch(reqs)
    engine.settle(ib)
    return [r.prob for r in reqs]


def _init(seed: int, cfg: DLRMConfig, device: torch.device,
          shards: int = 1) -> Dict:
    """``dlrm.init`` from a generator seeded with ``seed`` on ``device``
    (the integer the reference hands ``jax.random.PRNGKey``), the arena
    padded for ``shards``."""
    return dlrm.init(torch.Generator(device=device).manual_seed(seed), cfg,
                     shards, device=device)


class Replica:
    """One serving host: a ``RecEngine`` a model variant, fed from one
    chaos channel. Delivery is version-gated per engine: a stale artifact
    (reordered past a newer applied version) goes through the engine's
    refusing ``update_source``, so the rejection is counted on both sides:
    ``stale_injected`` here, the ``stale_rejected`` event and
    ``rec_stale_rejected_total`` counter in the engine.

    ``shards`` is the publisher's arena row padding: the placeholder
    arena of each engine's local init must have the broadcast leaves'
    shapes, or adopting a head would rebind a differently shaped arena.
    ``mesh`` goes to each ``RecEngine``; the broadcast source is served
    as it is (the publisher unwraps it for serving), so the mesh changes
    no value."""

    def __init__(self, name: str, cfg: DLRMConfig,
                 bootstrap: es.VersionedSource, channel: ChaosChannel, *,
                 max_l: int, batch_size: int, heads: Dict[str, Dict],
                 params_seed: int = 0, mesh=None, shards: int = 1,
                 device: Optional[Union[str, torch.device]] = None):
        self.name = name
        self.cfg = cfg
        self.mesh = mesh
        self.channel = channel
        self.max_l = max_l
        self.device = resolve_device(device)
        self.engines: Dict[str, RecEngine] = {}
        # variant A adopts the broadcast head; every other variant keeps
        # its frozen candidate head (only A retrains)
        self.adopt_head = {m: (m == "a") for m in heads}
        self.stale_injected = 0
        self.applied = 0
        for i, (model, head) in enumerate(sorted(heads.items())):
            # a cold remote host: params from a local init (never the
            # trainer's tensors), the dense head from the bootstrap
            # artifact or the frozen candidate; the only sparse state
            # ever served is the broadcast source itself
            base = _init(params_seed * 31 + i + 11, cfg, self.device,
                         shards)
            eng = RecEngine(cfg, {**base, **head}, source=bootstrap.source,
                            max_l=max_l, max_batch=batch_size,
                            buckets=(batch_size,), mesh=mesh,
                            telemetry=obs.Telemetry(), device=self.device)
            eng.update_source(bootstrap.source, version=bootstrap.version)
            eng.warmup()
            self.engines[model] = eng
        # the no-recapture baseline: every later swap and serve must
        # leave each engine's capture count where warmup() left it
        self.capture_baseline = {m: e.captures
                                 for m, e in self.engines.items()}

    def recompiles(self) -> Dict[str, int]:
        """New CUDA graph captures per model since ``warmup()`` (0 on the
        recovery path; always 0 on the CPU, which captures nothing)."""
        return {m: e.captures - self.capture_baseline[m]
                for m, e in self.engines.items()}

    def deliver(self, version: int, blob: bytes) -> str:
        """Apply one artifact to every variant engine; returns the
        outcome ('applied' | 'republish' | 'stale')."""
        vs = es.VersionedSource.deserialize(blob, device=self.device)
        outcome = "applied"
        for model, eng in self.engines.items():
            if vs.version < eng.source_version:
                self.stale_injected += 1
                eng.telemetry.emit(
                    "broadcast_reordered", version=vs.version,
                    served_version=eng.source_version,
                    model=model, replica=self.name)
                try:
                    eng.update_source(vs.source, version=vs.version)
                except ValueError:
                    pass        # counted by the engine's stale gate
                outcome = "stale"
                continue
            if vs.head is not None and self.adopt_head.get(model):
                # head first, then source: the params copy rebinds the old
                # source's arena leaves, then the versioned swap replaces
                # the whole source, so the pair lands as one adoption
                eng.params = {**eng.params, **vs.head}
            if vs.version == eng.source_version:
                outcome = "republish"
            else:
                self.applied += 1
            eng.update_source(vs.source, version=vs.version)
        return outcome

    def pump(self) -> Dict[str, int]:
        """Deliver everything the channel has made deliverable."""
        stats = {"applied": 0, "republish": 0, "stale": 0}
        for version, blob in self.channel.poll():
            stats[self.deliver(version, blob)] += 1
        return stats

    def stale_rejections(self) -> int:
        """Engine-side count of stale-swap rejections across variants,
        from the event log: the witness compared with
        ``stale_injected``."""
        return sum(len(e.telemetry.events.query("stale_rejected"))
                   for e in self.engines.values())

    def versions(self) -> Dict[str, int]:
        return {m: e.source_version for m, e in self.engines.items()}

    def hit_rate_by_version(self, model: str) -> Dict[int, Optional[float]]:
        """Per-version hit-rate attribution for one model variant."""
        return self.engines[model].telemetry.events.hit_rate_by_version()


class FleetRunner:
    """Hosts the trainer, the reference engines and N chaos-fed
    replicas; drives rounds of (train -> rebuild -> broadcast -> pump ->
    serve) and the crash and recovery scenarios."""

    def __init__(self, cfg: Optional[DLRMConfig] = None, *,
                 n_replicas: int = 2, plan: FaultPlan = CLEAN,
                 seed: int = 0, cache_k: int = 64, refresh_every: int = 4,
                 batch_size: int = 8, max_l: int = 4, mean_l: int = 2,
                 drift_per_batch: int = 64, alpha: float = 1.05,
                 ckpt_dir=None, keep_n: int = 3,
                 device: Optional[Union[str, torch.device]] = None):
        from repro_torch.checkpoint import CheckpointManager
        cfg = cfg if cfg is not None else DLRM_HET_SMOKE
        if not cfg.heterogeneous:
            raise ValueError("the fleet topology shares one "
                             "TableGroupSource: it needs a heterogeneous "
                             "config")
        self.cfg = cfg
        self.seed = seed
        self.plan = plan
        self.max_l = max_l
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.trainer = OnlineGroupTrainer(
            cfg, _init(seed, cfg, self.device), max_l=max_l,
            plans=dlrm.table_plans(cfg, cache_k=cache_k),
            refresh_every=refresh_every, device=self.device)
        self.ckpt = (CheckpointManager(ckpt_dir, keep_n=keep_n,
                                       device=self.device)
                     if ckpt_dir is not None else None)
        # variant B: a frozen candidate dense head from a fixed seed, so
        # every B engine (replicas and reference) serves the same model;
        # the A/B pair shares only the sparse TableGroupSource
        self.head_b = _dense_head(_init(seed + 7, cfg, self.device))
        self._gen = make_drifting_zipf(
            cfg, batch_size=batch_size, mean_l=mean_l, max_l=max_l,
            drift_per_batch=drift_per_batch, alpha=alpha, seed=seed)
        self._batches: List[Dict] = []
        self.probe_batch = self.batch_fn(0)
        self.next_step = 0
        self.rounds = 0
        self._restarts = [0] * n_replicas

        # one clean bootstrap bump so every engine starts aligned on v1
        self._train_one_refresh()
        self._bootstrap = self.artifact()
        if self.ckpt is not None:
            self.ckpt.save_source(self.trainer.steps, self._bootstrap)
        self.ref = self._make_reference(self._bootstrap)
        self.replicas = [self._make_replica(i, self._bootstrap)
                         for i in range(n_replicas)]

    # -- data (step-seeded: data-skip determinism for resumes) -------------

    def batch_fn(self, step: int) -> Dict:
        """The batch consumed at optimizer step ``step``, memoized from
        one seeded generator, so a resumed trainer replays exactly the
        batches it would have consumed."""
        while len(self._batches) <= step:
            self._batches.append(next(self._gen))
        return self._batches[step]

    # -- trainer side ------------------------------------------------------

    def _train_one_refresh(self) -> None:
        """Exactly refresh_every steps = exactly one version bump."""
        for _ in range(self.trainer.refresh_every):
            self.trainer.train_step(self.batch_fn(self.next_step))
            self.next_step += 1

    def artifact(self) -> es.VersionedSource:
        """The current broadcast artifact: the full serving source and the
        trained dense head under the trainer's version. It aliases the
        trainer's tensors; every consumer copies."""
        return es.VersionedSource(source=self.trainer.serving_source(),
                                  version=self.trainer.version,
                                  head=_dense_head(self.trainer.params))

    def _make_reference(self, vs: es.VersionedSource
                        ) -> Dict[str, RecEngine]:
        """Trainer-side reference engines, one a variant, always synced
        directly (no chaos): the bit-exactness oracle."""
        ref = {}
        for i, (model, head) in enumerate(
                sorted({"a": _dense_head(self.trainer.params),
                        "b": self.head_b}.items())):
            base = _init(self.seed * 17 + 5 + i, self.cfg, self.device)
            eng = RecEngine(self.cfg, {**base, **head},
                            source=vs.source, max_l=self.max_l,
                            max_batch=self.batch_size,
                            buckets=(self.batch_size,),
                            telemetry=obs.Telemetry(), device=self.device)
            eng.update_source(vs.source, version=vs.version)
            eng.warmup()
            ref[model] = eng
        return ref

    def _sync_reference(self) -> None:
        vs = self.artifact()
        for model, eng in self.ref.items():
            if vs.version <= eng.source_version:
                continue
            if model == "a":
                eng.params = {**eng.params, **vs.head}
            eng.update_source(vs.source, version=vs.version)

    def _make_replica(self, i: int,
                      bootstrap: es.VersionedSource) -> Replica:
        chan_seed = self.plan.seed + 101 * (i + 1) \
            + 100_000 * self._restarts[i]
        channel = ChaosChannel(self.plan.with_seed(chan_seed),
                               name=f"replica{i}")
        return Replica(
            f"replica{i}", self.cfg, bootstrap, channel,
            max_l=self.max_l, batch_size=self.batch_size,
            heads={"a": dict(bootstrap.head), "b": self.head_b},
            params_seed=self.seed * 13 + i, device=self.device)

    # -- the round loop ----------------------------------------------------

    def round(self, *, chaos: bool = True, serve: bool = True) -> Dict:
        """One fleet round: train one refresh interval (one version
        bump), broadcast through each replica's channel (or perfectly,
        when ``chaos=False``), pump deliveries, serve the round's live
        traffic on every engine (reference and replicas) so hit-rate
        attribution accrues per version and per model.

        With tracing on in the trainer's telemetry, the train and
        broadcast are a ``fleet_round`` span (its ``version``, ``chaos``
        and ``blob_bytes`` as attributes) over ``fleet_train``,
        ``fleet_serialize``, ``fleet_save_source`` and one
        ``fleet_deliver`` a replica: host times."""
        span = self.trainer.telemetry.span
        with span("fleet_round", {"chaos": chaos}) as rs:
            with span("fleet_train"):
                self._train_one_refresh()
            with span("fleet_serialize"):
                vs = self.artifact()
                blob = vs.serialize()
            if rs is not None:
                rs.attrs.update(version=self.trainer.version,
                                blob_bytes=len(blob))
            if self.ckpt is not None:
                with span("fleet_save_source"):
                    self.ckpt.save_source(self.trainer.steps, vs)
            self._sync_reference()
            stats = {"version": self.trainer.version, "replicas": []}
            for rep in self.replicas:
                with span("fleet_deliver", {"replica": rep.name}):
                    if chaos:
                        rep.channel.send(blob, self.trainer.version)
                        s = rep.pump()
                    else:
                        s = {"applied": 0, "republish": 0, "stale": 0}
                        s[rep.deliver(self.trainer.version, blob)] += 1
                stats["replicas"].append(s)
        if serve:
            self.serve_round()
        self.rounds += 1
        return stats

    def serve_round(self) -> None:
        """Serve the freshest drift window through every engine: the
        traffic that makes per-version hit rates meaningful (a replica
        stuck on an old version misses the drifted hot set)."""
        batch = self.batch_fn(self.next_step - 1)
        for eng in self.ref.values():
            _serve_batch(eng, self.cfg, batch)
        for rep in self.replicas:
            for eng in rep.engines.values():
                _serve_batch(eng, self.cfg, batch)

    # -- exactness + recovery ----------------------------------------------

    def exactness(self) -> Dict[str, List[bool]]:
        """Per model, per replica: does the replica serve the fixed probe
        batch bit for bit as the trainer-synced reference engine does?"""
        out: Dict[str, List[bool]] = {}
        for model in MODELS:
            want = _serve_batch(self.ref[model], self.cfg,
                                self.probe_batch)
            out[model] = [
                _serve_batch(rep.engines[model], self.cfg,
                             self.probe_batch) == want
                for rep in self.replicas]
        return out

    def all_exact(self) -> bool:
        return all(all(v) for v in self.exactness().values())

    def recover(self, k: int = 3) -> Dict:
        """Clean recovery: drain every channel's in-flight artifacts, then
        run perfect-delivery rounds until all replicas serve bit-exact,
        within ``k`` version bumps. Returns the bump count, the final
        exactness map and the per-replica new captures."""
        for rep in self.replicas:
            for v, blob in rep.channel.flush():
                rep.deliver(v, blob)
        bumps = 0
        while not self.all_exact() and bumps < k:
            self.round(chaos=False)
            bumps += 1
        return {"bumps": bumps, "exact": self.exactness(),
                "recompiles": [rep.recompiles() for rep in self.replicas]}

    # -- crash scenarios ---------------------------------------------------

    def crash_replica(self, i: int) -> Replica:
        """Kill replica ``i`` and cold-restart it from the latest
        checkpointed source artifact (``restore_source``): its channel
        state and engines are lost, its replacement bootstraps from disk
        with a fresh (recorded) chaos seed."""
        if self.ckpt is None:
            raise ValueError("a replica restart needs a ckpt_dir")
        vs, manifest = self.ckpt.restore_source()
        self._restarts[i] += 1
        rep = self._make_replica(i, vs)
        for model, eng in rep.engines.items():
            eng.telemetry.emit("replica_restore", version=vs.version,
                               step=manifest["step"], model=model,
                               replica=rep.name)
        self.replicas[i] = rep
        return rep

    def run_trainer_with_crash(self, *, extra_steps: int,
                               fail_after: int, ckpt_every: int = 4
                               ) -> Dict:
        """Advance the trainer ``extra_steps`` optimizer steps under
        ``ResilientTrainer``, crashing once ``fail_after`` steps in and
        resuming from the latest checkpoint with step-seeded batches. The
        restored tensors become the trainer's live state. The version
        stays monotone through the crash, so replicas never see a
        rollback; the histograms, ``steps`` and the version are not
        checkpointed (as in the reference), so the replayed steps are
        observed twice. Emits ``trainer_resume`` on the restore."""
        t = self.trainer
        start = self.next_step
        # a real resume starts from disk: seed the checkpoint chain with
        # the current state, so the run restores to now, not to step 0
        if self.ckpt is None:
            raise ValueError("a trainer resume needs a ckpt_dir")
        self.ckpt.save(start - 1, (t.params, t.opt_state))

        def step_fn(params, opt_state, batch):
            t.params, t.opt_state = params, opt_state
            loss = t.train_step(batch)
            return t.params, t.opt_state, loss

        def on_resume(step: int) -> None:
            t.telemetry.emit("trainer_resume", version=t.version,
                             step=step, restarts=rt.restarts)

        rt = ResilientTrainer(step_fn, self.ckpt, ckpt_every=ckpt_every,
                              on_resume=on_resume)
        state = (t.params, t.opt_state)
        t0 = time.perf_counter()
        state, _ = rt.run(state, self.batch_fn, start + extra_steps,
                          fail_at=start + fail_after)
        t.params, t.opt_state = state
        self.next_step = start + extra_steps
        return {"restarts": rt.restarts,
                "resume_events": len(t.telemetry.events.query(
                    "trainer_resume")),
                "wall_s": time.perf_counter() - t0,
                "version": t.version}
