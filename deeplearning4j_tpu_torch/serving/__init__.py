"""Model serving: registry, dynamic batcher, admission, HTTP server, and
generative decode over a paged KV cache."""
from deeplearning4j_tpu_torch.serving.admission import (AdmissionController,
                                                        DeadlineExceeded,
                                                        ShedError)
from deeplearning4j_tpu_torch.serving.batcher import ServingBatcher
from deeplearning4j_tpu_torch.serving.generative import (DecodeEngine,
                                                         TokenStream)
from deeplearning4j_tpu_torch.serving.kvcache import (KVBlockPool,
                                                      PoolExhausted,
                                                      pool_report)
from deeplearning4j_tpu_torch.serving.registry import (ModelRegistry,
                                                       ModelStatus,
                                                       ModelVersion)
from deeplearning4j_tpu_torch.serving.server import InferenceServer

__all__ = ["AdmissionController", "DeadlineExceeded", "DecodeEngine",
           "InferenceServer", "KVBlockPool", "ModelRegistry", "ModelStatus",
           "ModelVersion", "PoolExhausted", "ServingBatcher", "ShedError",
           "TokenStream", "pool_report"]
