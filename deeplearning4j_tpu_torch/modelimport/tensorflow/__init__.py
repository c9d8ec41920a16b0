"""TF GraphDef import (counterpart of deeplearning4j_tpu/modelimport/
tensorflow)."""
from deeplearning4j_tpu_torch.modelimport.tensorflow.importer import (
    GraphDefImporter, TensorflowFrameworkImporter, TFGraphMapper)

__all__ = ["GraphDefImporter", "TensorflowFrameworkImporter",
           "TFGraphMapper"]
