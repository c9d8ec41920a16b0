"""Graph vertices: the DAG building blocks of ComputationGraph.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_vertices.py``, for
the vertices of the ported zoo models: ``ElementWiseVertex`` (ResNet-50's
residual add) and ``MergeVertex`` (SqueezeNet's fire-module concat).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType, InputTypeConvolutional, InputTypeRecurrent)


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


@dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature/channel (last) axis (NHWC: the
    channels)."""

    def forward(self, inputs, *, training=False):
        return torch.cat(inputs, dim=-1)

    def get_output_type(self, input_types):
        t0 = input_types[0]
        if isinstance(t0, InputTypeConvolutional):
            return InputType.convolutional(
                t0.height, t0.width, sum(t.channels for t in input_types))
        if isinstance(t0, InputTypeRecurrent):
            return InputType.recurrent(sum(t.size for t in input_types),
                                       t0.timesteps)
        return InputType.feed_forward(sum(t.size for t in input_types))


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


VERTEX_REGISTRY: dict = {c.__name__: c for c in (MergeVertex,
                                                  ElementWiseVertex)}
