"""Model serving: registry, dynamic batcher, admission, HTTP server,
generative decode over a paged KV cache, the multi-replica router, and
the request observatory (trace contexts through every hop,
:class:`SLOTracker` error-budget burn rates on ``GET /api/slo``, and the
:class:`RequestRecorder` flight recorder of completed requests)."""
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
from deeplearning4j_tpu_torch.serving.reqrec import RequestRecorder
from deeplearning4j_tpu_torch.serving.router import ServingRouter
from deeplearning4j_tpu_torch.serving.server import InferenceServer
from deeplearning4j_tpu_torch.serving.slo import SLOTracker

__all__ = ["AdmissionController", "DeadlineExceeded", "DecodeEngine",
           "InferenceServer", "KVBlockPool", "ModelRegistry", "ModelStatus",
           "ModelVersion", "PoolExhausted", "RequestRecorder",
           "SLOTracker", "ServingBatcher", "ServingRouter", "ShedError",
           "TokenStream", "pool_report"]
