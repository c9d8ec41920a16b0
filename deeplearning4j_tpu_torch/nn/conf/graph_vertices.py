"""Graph vertices: the DAG building blocks of ComputationGraph.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_vertices.py``, all
nine vertices: ``MergeVertex`` (concatenate the feature axis),
``ElementWiseVertex``, ``SubsetVertex`` (an inclusive feature range),
``ScaleVertex``, ``ShiftVertex``, ``StackVertex`` / ``UnstackVertex``
(along the batch axis), ``L2NormalizeVertex`` (per example, over every
axis but the batch) and ``PreprocessorVertex`` (an input preprocessor as
a vertex of its own). Each is a pure function of its inputs, with no
parameters.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType, InputTypeConvolutional, InputTypeRecurrent)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import InputPreProcessor


class GraphVertex:
    """forward(inputs: list[Tensor]) -> Tensor; single-output vertices."""

    def forward(self, inputs: list, *, training: bool = False):
        raise NotImplementedError

    def get_output_type(self, input_types: List[InputType]) -> InputType:
        raise NotImplementedError

    def to_map(self) -> dict:
        d = {"@class": type(self).__name__}
        for k, v in self.__dict__.items():
            d[k] = v.name if isinstance(v, enum.Enum) else v
        return d

    @staticmethod
    def from_map(d: dict) -> "GraphVertex":
        d = dict(d)
        cls_name = d.pop("@class")
        cls = VERTEX_REGISTRY.get(cls_name)
        if cls is None:
            raise NotImplementedError(
                f"vertex class {cls_name!r} is not ported yet (ported: "
                f"{sorted(VERTEX_REGISTRY)})")
        return cls(**d)


def _with_features(t: InputType, n: int) -> InputType:
    """``t`` with its feature (or channel) count set to ``n``."""
    if isinstance(t, InputTypeConvolutional):
        return InputType.convolutional(t.height, t.width, n)
    if isinstance(t, InputTypeRecurrent):
        return InputType.recurrent(n, t.timesteps)
    return InputType.feed_forward(n)


@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature/channel (last) axis (NHWC: the
    channels)."""

    def forward(self, inputs, *, training=False):
        return torch.cat(inputs, dim=-1)

    def get_output_type(self, input_types):
        return _with_features(input_types[0], sum(
            t.channels if isinstance(t, InputTypeConvolutional) else t.size
            for t in input_types))


@dataclass
class ElementWiseVertex(GraphVertex):
    class Op(enum.Enum):
        Add = "add"
        Subtract = "subtract"
        Product = "product"
        Average = "average"
        Max = "max"
        Min = "min"

    op: "ElementWiseVertex.Op" = None

    def __post_init__(self):
        if isinstance(self.op, str):
            self.op = ElementWiseVertex.Op[self.op]
        if self.op is None:
            self.op = ElementWiseVertex.Op.Add

    def forward(self, inputs, *, training=False):
        op = self.op
        if op is ElementWiseVertex.Op.Subtract:
            if len(inputs) != 2:
                raise ValueError(
                    f"Subtract needs exactly 2 inputs, got {len(inputs)}")
            return inputs[0] - inputs[1]
        if op is ElementWiseVertex.Op.Average:
            return sum(inputs) / len(inputs)
        fold = {ElementWiseVertex.Op.Add: torch.add,
                ElementWiseVertex.Op.Product: torch.mul,
                ElementWiseVertex.Op.Max: torch.maximum,
                ElementWiseVertex.Op.Min: torch.minimum}[op]
        out = inputs[0]
        for x in inputs[1:]:
            out = fold(out, x)
        return out

    def get_output_type(self, input_types):
        return input_types[0]


@dataclass
class SubsetVertex(GraphVertex):
    """The feature range ``[from_idx, to_idx]``, both ends included
    (reference: SubsetVertex)."""
    from_idx: int = 0
    to_idx: int = 0

    def forward(self, inputs, *, training=False):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def get_output_type(self, input_types):
        return _with_features(input_types[0],
                              self.to_idx - self.from_idx + 1)


@dataclass
class ScaleVertex(GraphVertex):
    scale_factor: float = 1.0

    def forward(self, inputs, *, training=False):
        return inputs[0] * self.scale_factor

    def get_output_type(self, input_types):
        return input_types[0]


@dataclass
class ShiftVertex(GraphVertex):
    shift_factor: float = 0.0

    def forward(self, inputs, *, training=False):
        return inputs[0] + self.shift_factor

    def get_output_type(self, input_types):
        return input_types[0]


@dataclass
class StackVertex(GraphVertex):
    """Concatenate the inputs along the batch axis (reference:
    StackVertex)."""

    def forward(self, inputs, *, training=False):
        return torch.cat(inputs, dim=0)

    def get_output_type(self, input_types):
        return input_types[0]


@dataclass
class UnstackVertex(GraphVertex):
    """Block ``from_idx`` of ``stack_size`` equal blocks of the batch axis
    (reference: UnstackVertex)."""
    from_idx: int = 0
    stack_size: int = 1

    def forward(self, inputs, *, training=False):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_idx * n:(self.from_idx + 1) * n]

    def get_output_type(self, input_types):
        return input_types[0]


@dataclass
class L2NormalizeVertex(GraphVertex):
    """``x / sqrt(sum(x²) + eps)`` per example, the sum over every axis
    but the batch."""
    eps: float = 1e-8

    def forward(self, inputs, *, training=False):
        x = inputs[0]
        axes = tuple(range(1, x.dim()))
        return x / torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True)
                              + self.eps)

    def get_output_type(self, input_types):
        return input_types[0]


@dataclass
class PreprocessorVertex(GraphVertex):
    preprocessor: Optional[InputPreProcessor] = None

    def __post_init__(self):
        if isinstance(self.preprocessor, dict):
            self.preprocessor = InputPreProcessor.from_map(self.preprocessor)

    def forward(self, inputs, *, training=False):
        return self.preprocessor.pre_process(inputs[0])

    def get_output_type(self, input_types):
        return self.preprocessor.get_output_type(input_types[0])

    def to_map(self):
        return {"@class": "PreprocessorVertex",
                "preprocessor": self.preprocessor.to_map()}


VERTEX_REGISTRY: dict = {c.__name__: c for c in (
    MergeVertex, ElementWiseVertex, SubsetVertex, ScaleVertex, ShiftVertex,
    StackVertex, UnstackVertex, L2NormalizeVertex, PreprocessorVertex)}
