"""Deterministic fleet scenarios for the versioned broadcast protocol.

* ``FaultPlan`` / ``ChaosChannel``: seeded drop/duplicate/delay/reorder
  of ``VersionedSource`` blobs between ``OnlineGroupTrainer
  .publish_source`` and a replica's ``RecEngine.update_source`` (the
  reference's ``repro/fleet/chaos.py``, copied: one seed gives the same
  schedule in both packages).
* ``Replica`` / ``FleetRunner``: one trainer, N replicas, two DLRM
  variants A/B over one shared ``TableGroupSource``, per-model
  per-version hit-rate attribution, and crash and recovery scenarios
  (replica restart from ``restore_source``, trainer resume through
  ``ResilientTrainer``) held to bit-exact recovery within K version
  bumps with no new graph capture.
"""
from repro_torch.fleet.chaos import CLEAN, ChaosChannel, FaultPlan
from repro_torch.fleet.runner import FleetRunner, Replica

__all__ = ["CLEAN", "ChaosChannel", "FaultPlan", "FleetRunner",
           "Replica"]
