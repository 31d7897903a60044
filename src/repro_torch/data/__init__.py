from repro_torch.data.pipeline import Prefetcher, make_placer
from repro_torch.data.synthetic import DLRMSynthetic, LMSynthetic

__all__ = ["DLRMSynthetic", "LMSynthetic", "Prefetcher", "make_placer"]
