from repro_torch.core.embedding_source import SourceSpec
from repro_torch.serving.engine import Batcher, DecodeEngine, Request
from repro_torch.serving.rec_engine import (InflightBatch, RecBatcher,
                                            RecEngine, RecRequest,
                                            requests_from_ragged_batch,
                                            tune_buckets)
from repro_torch.serving.scheduler import (BatchPlan, ServiceEstimator,
                                           SlaPolicy, SlaScheduler,
                                           plan_batch)

__all__ = ["BatchPlan", "Batcher", "DecodeEngine", "InflightBatch",
           "Request", "RecBatcher", "RecEngine", "RecRequest",
           "ServiceEstimator", "SlaPolicy", "SlaScheduler", "SourceSpec",
           "plan_batch", "requests_from_ragged_batch", "tune_buckets"]
