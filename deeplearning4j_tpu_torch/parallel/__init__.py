"""Parallelism: meshes with named axes (:mod:`.mesh`), data-parallel
training (:mod:`.wrapper`, :mod:`.sharedtraining`, :mod:`.zero`,
:mod:`.encoding`), tensor (:mod:`.tensor`, :mod:`.speclayout`), expert
(:mod:`.expert`), pipeline (:mod:`.pipeline`) and sequence
(:mod:`.sequence`) parallelism. Exported here: the names the JAX
package's ``parallel/__init__.py`` exports from the mesh, sequence,
speclayout and pipeline modules, where the port has them."""
from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    MeshFactory, make_mesh,
                                                    stage_submesh)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    PIPE_AXIS, SCHEDULES, PipelineTrainer, StagePartition, bubble_fraction,
    build_schedule, peak_residency)
from deeplearning4j_tpu_torch.parallel.sequence import (
    blockwise_attention, flash_attention, ring_attention,
    ring_self_attention, ulysses_attention, ulysses_self_attention)
from deeplearning4j_tpu_torch.parallel.speclayout import (SpecLayout,
                                                          TpLeafSpec)

__all__ = [
    "DEFAULT_DATA_AXIS", "MeshFactory", "make_mesh",
    "blockwise_attention", "flash_attention", "ring_attention",
    "ring_self_attention", "ulysses_attention", "ulysses_self_attention",
    "SpecLayout", "TpLeafSpec",
    "PIPE_AXIS", "SCHEDULES", "PipelineTrainer", "StagePartition",
    "bubble_fraction", "build_schedule", "peak_residency", "stage_submesh",
]
