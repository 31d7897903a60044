from repro_torch.data.synthetic import DLRMSynthetic

__all__ = ["DLRMSynthetic"]
