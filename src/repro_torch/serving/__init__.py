from repro_torch.serving.engine import Batcher, DecodeEngine, Request
from repro_torch.serving.rec_engine import (RecBatcher, RecEngine, RecRequest,
                                            requests_from_ragged_batch)

__all__ = ["Batcher", "DecodeEngine", "RecBatcher", "RecEngine",
           "RecRequest", "Request", "requests_from_ragged_batch"]
