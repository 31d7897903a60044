from repro_torch.serving.engine import Batcher, DecodeEngine, Request
from repro_torch.serving.rec_engine import (InflightBatch, RecBatcher,
                                            RecEngine, RecRequest,
                                            requests_from_ragged_batch,
                                            tune_buckets)

__all__ = ["Batcher", "DecodeEngine", "InflightBatch", "RecBatcher",
           "RecEngine", "RecRequest", "Request",
           "requests_from_ragged_batch", "tune_buckets"]
