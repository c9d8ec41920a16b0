"""SpecLayout: which parameter leaves tensor parallelism splits over the
``model`` axis, and how.

Counterpart of ``deeplearning4j_tpu/parallel/speclayout.py``, its rules
bit for bit. The vocabulary is the megatron one of ``parallel/tensor.py``
(column ``P(None, model)``, row ``P(model, None)``, sharded bias
``P(model)``), inferred from shapes entry by entry (an MLN ``layer_i``, a
graph vertex):

- a 2-D weight is **column**-sharded when its output dimension divides
  by the tp degree (embeddings, projections, the head), else **row**-
  sharded when its input dimension does, else replicated. Column is
  tested first, so a square out-projection is column;
- a 1-D bias is sharded ``P(model)`` when a column-sharded weight of the
  same entry has its width; other biases and norm gains stay replicated.

Each leaf gets a :class:`TpLeafSpec`: ``compute``, how the step sees it
(model axis only), and ``resident``, how it lives between steps: the
same under the dense tail, and under the ZeRO tails (sharded, encoded,
fsdp) with one more dimension split over ``data``, so the leaf and its
updater state live at 1/(dp·tp) a replica.

The JAX package keeps every leaf at its full logical shape and lets
GSPMD place it. PyTorch runs eagerly, so here a replica holds only its
shard: ``parallel/zero.py`` cuts the shards (``tp_shard``), the training
step gathers a stage's tensor-parallel leaves once a step over ``model``
(and ``data`` under fsdp), and the gradient of a gathered leaf comes back
as the replica's own slice (``zero.tp_gather``). The ``pipe`` axis
partitions whole entries (``parallel/pipeline.py``) and never appears in
a spec: :meth:`SpecLayout.infer_stages` infers each stage's entries
against the stage's submesh, and each entry's specs equal a 2D run's.

Entries that are not flat ``{name: tensor}`` dicts get no specs. The
port stores a nested entry flat, its names joined with ``/``; such an
entry is nested in the JAX package and gets none either.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    DEFAULT_MODEL_AXIS)
from deeplearning4j_tpu_torch.parallel.mesh import PartitionSpec as P


class TpLeafSpec(NamedTuple):
    """Compute and resident ``PartitionSpec`` of one tensor-parallel
    leaf (see the module docstring)."""
    compute: P
    resident: P


def _is_flat_array_dict(entry) -> bool:
    return (isinstance(entry, dict) and bool(entry) and
            all(hasattr(a, "shape") and hasattr(a, "ndim") and "/" not in n
                for n, a in entry.items()))


def _nbytes(a) -> int:
    if hasattr(a, "element_size"):
        return int(a.numel()) * int(a.element_size())
    return int(np.prod(a.shape)) * int(np.dtype(a.dtype).itemsize)


class SpecLayout:
    """Per-entry tensor-parallel spec inference over a ``{entry: {name:
    tensor}}`` tree (or one flat entry, :meth:`infer_entry`), against a
    mesh's ``shape``."""

    def __init__(self, mesh, model_axis: str = DEFAULT_MODEL_AXIS,
                 data_axis: str = DEFAULT_DATA_AXIS,
                 stage_axis: str = "pipe"):
        self.mesh = mesh
        self.model_axis = model_axis
        self.data_axis = data_axis
        self.stage_axis = stage_axis
        shape = dict(mesh.shape)
        self.tp = int(shape.get(model_axis, 1))
        self.dp = int(shape.get(data_axis, 1))
        #: the pipeline-stage degree (1: no pipe axis)
        self.pp = int(shape.get(stage_axis, 1))

    # -- per-leaf rules ----------------------------------------------------
    def _resident(self, shape, compute: P, shard_over_data: bool) -> P:
        """The data axis added on a free dimension when the ZeRO layouts
        keep the leaf at 1/(dp·tp); 1-D leaves and dimensions that do not
        divide keep compute == resident."""
        if not shard_over_data or self.dp <= 1 or len(shape) != 2:
            return compute
        m, d = self.model_axis, self.data_axis
        if compute == P(None, m) and shape[0] % self.dp == 0:
            return P(d, m)
        if compute == P(m, None) and shape[1] % self.dp == 0:
            return P(m, d)
        return compute

    def infer_entry(self, entry, shard_over_data: bool = False
                    ) -> Dict[str, TpLeafSpec]:
        """``{name: TpLeafSpec}`` for one entry; replicated leaves are
        left out."""
        if self.tp <= 1 or not _is_flat_array_dict(entry):
            return {}
        m = self.model_axis
        specs: Dict[str, P] = {}
        col_widths = set()
        for name, a in entry.items():
            if a.ndim != 2:
                continue
            if a.shape[1] % self.tp == 0 and a.shape[1] >= self.tp:
                specs[name] = P(None, m)          # column (out-dim)
                col_widths.add(int(a.shape[1]))
            elif a.shape[0] % self.tp == 0 and a.shape[0] >= self.tp:
                specs[name] = P(m, None)          # row (in-dim)
        for name, a in entry.items():
            if (a.ndim == 1 and int(a.shape[0]) in col_widths
                    and a.shape[0] % self.tp == 0):
                specs[name] = P(m)                # column bias
        return {name: TpLeafSpec(sp, self._resident(
                    tuple(entry[name].shape), sp, shard_over_data))
                for name, sp in specs.items()}

    def infer(self, params, shard_over_data: bool = False
              ) -> Dict[str, Dict[str, TpLeafSpec]]:
        """``{entry: {name: TpLeafSpec}}``; entries with nothing to shard
        are left out."""
        out = {}
        for k, sub in (params or {}).items():
            specs = self.infer_entry(sub, shard_over_data)
            if specs:
                out[k] = specs
        return out

    def infer_stages(self, params, partition, shard_over_data: bool = False):
        """One ``{entry: {name: TpLeafSpec}}`` a stage of ``partition`` (a
        ``parallel.pipeline.StagePartition``), each inferred against its
        stage's submesh (``parallel.mesh.stage_submesh``); without a pipe
        axis the one stage is inferred against the whole mesh."""
        from deeplearning4j_tpu_torch.parallel.mesh import stage_submesh
        out = []
        for s in range(partition.n_stages):
            sub = (stage_submesh(self.mesh, s, self.stage_axis)
                   if self.pp > 1 else self.mesh)
            layout = SpecLayout(sub, model_axis=self.model_axis,
                                data_axis=self.data_axis,
                                stage_axis=self.stage_axis)
            stage_params = {k: params[k] for k in partition.stage_entries(s)
                            if k in (params or {})}
            out.append(layout.infer(stage_params, shard_over_data))
        return out


def tp_param_bytes(params, tp_specs) -> int:
    """The bytes of the tensor-parallel leaves at their full shapes (a
    replica holds 1/tp of them once placed)."""
    total = 0
    for k, names in (tp_specs or {}).items():
        sub = params.get(k, {})
        for name in names:
            a = sub.get(name) if isinstance(sub, dict) else None
            if hasattr(a, "shape"):
                total += _nbytes(a)
    return total
