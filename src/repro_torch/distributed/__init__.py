"""The distributed substrate: the straggler monitor and the
checkpoint/restart trainer (``fault_tolerance``), N ranks of one SPMD
program over ``torch.distributed`` (``spawn``), the collectives of the
sharded paths (``collectives``), the logical axes (``sharding``) and
gradient compression (``compression``)."""
from repro_torch.distributed.fault_tolerance import (ResilientTrainer,
                                                     SimulatedFailure,
                                                     StragglerMonitor)
from repro_torch.distributed.spawn import spawn

__all__ = ["ResilientTrainer", "SimulatedFailure", "StragglerMonitor",
           "spawn"]
