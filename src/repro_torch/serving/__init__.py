from repro_torch.serving.rec_engine import (RecBatcher, RecEngine, RecRequest,
                                            requests_from_ragged_batch)

__all__ = ["RecBatcher", "RecEngine", "RecRequest",
           "requests_from_ragged_batch"]
