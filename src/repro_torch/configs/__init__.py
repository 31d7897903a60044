"""DLRM configurations (a copy of the reference's, not an import)."""
from repro_torch.configs.base import DLRMConfig
from repro_torch.configs.dlrm import (DLRM_CONFIGS, DLRM_HET_CONFIGS,
                                      DLRM_HET_SMOKE, DLRM_SMOKE,
                                      make_heterogeneous)

__all__ = ["DLRMConfig", "DLRM_CONFIGS", "DLRM_HET_CONFIGS",
           "DLRM_HET_SMOKE", "DLRM_SMOKE", "make_heterogeneous"]
