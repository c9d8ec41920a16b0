"""Autodiff graph layer: SameDiff.

Counterpart of ``deeplearning4j_tpu/autodiff``: the graph builder and
executor (``samediff.py``), the op registry (``registry.py``), the op
namespaces (``opsets.py``), the GraphOptimizer passes (``passes.py``),
``TrainingConfig`` / ``History`` (``training.py``) and op validation
(``opvalidation.py``). The graph runs as an eager op walk on the graph's
device, differentiated by autograd; serialization keeps the JAX
package's zip (graph.json + arrays.npz + updater.npz).
"""
from deeplearning4j_tpu_torch.autodiff.registry import (OP_REGISTRY,
                                                        op_coverage)
from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff,
                                                        SDVariable,
                                                        VariableType)
from deeplearning4j_tpu_torch.autodiff.training import (History,
                                                        TrainingConfig)

__all__ = ["SameDiff", "SDVariable", "VariableType", "TrainingConfig",
           "History", "OP_REGISTRY", "op_coverage"]
