"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers, the
plain PyTorch versions (``ref``) and the device-dispatched ``ops``."""
