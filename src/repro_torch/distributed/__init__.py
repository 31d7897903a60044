"""Fault tolerance: the straggler monitor and the checkpoint/restart
trainer (``fault_tolerance``). Sharding and gradient compression are
ROADMAP Queue 1, item 13."""
from repro_torch.distributed.fault_tolerance import (ResilientTrainer,
                                                     SimulatedFailure,
                                                     StragglerMonitor)

__all__ = ["ResilientTrainer", "SimulatedFailure", "StragglerMonitor"]
