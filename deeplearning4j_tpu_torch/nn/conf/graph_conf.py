"""ComputationGraphConfiguration + GraphBuilder.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_conf.py``: a
topo-sorted DAG of layer and vertex nodes with per-node input lists,
shape inference, and a JSON form that reads the JAX package's
``configuration.json`` verbatim and writes one it can read. A layer
vertex may carry an input preprocessor (given as ``add_layer``'s first
input, or inserted by shape inference as ``default_preprocessor``
decides), which the graph applies to the layer's input.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.nn.conf.builders import (
    BackpropType, GradientNormalization, apply_layer_defaults,
    default_preprocessor)
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.conf.preprocessors import InputPreProcessor
from deeplearning4j_tpu_torch.nn.weights import WeightInit


@dataclass
class VertexDef:
    """One node: a Layer or a GraphVertex plus its input vertex names
    (and, for a layer, the preprocessor of its input)."""
    name: str
    content: Union[Layer, GraphVertex]
    inputs: List[str]
    preprocessor: Optional[InputPreProcessor] = None

    @property
    def is_layer(self) -> bool:
        return isinstance(self.content, Layer)


@dataclass
class ComputationGraphConfiguration:
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    vertices: Dict[str, VertexDef] = field(default_factory=dict)
    input_types: List[InputType] = field(default_factory=list)
    seed: int = 12345
    updater: IUpdater = field(default_factory=lambda: Sgd(1e-3))
    weight_init: WeightInit = WeightInit.XAVIER
    l1: float = 0.0
    l2: float = 0.0
    gradient_normalization: GradientNormalization = \
        GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    dtype: str = "float32"
    compute_dtype: Optional[str] = None   # None = same as dtype
    remat_segments: int = 0

    def topo_order(self) -> List[str]:
        """Topologically sorted vertex names (inputs excluded)."""
        order: List[str] = []
        visited: Dict[str, int] = {}  # 0=visiting, 1=done

        def visit(name: str):
            if name in self.network_inputs:
                return
            st = visited.get(name)
            if st == 1:
                return
            if st == 0:
                raise ValueError(f"cycle at vertex {name!r}")
            visited[name] = 0
            for dep in self.vertices[name].inputs:
                visit(dep)
            visited[name] = 1
            order.append(name)

        for name in self.vertices:
            visit(name)
        return order

    def resolve_shapes(self) -> Dict[str, InputType]:
        """Infer each layer's ``n_in`` from the input types, inserting
        the default preprocessor where a layer vertex has none; returns
        every vertex's output type (empty without input types)."""
        if not self.input_types:
            return {}
        types: Dict[str, InputType] = dict(zip(self.network_inputs,
                                               self.input_types))
        for name in self.topo_order():
            v = self.vertices[name]
            in_types = [types[i] for i in v.inputs]
            if v.is_layer:
                cur = in_types[0]
                if v.preprocessor is None:
                    v.preprocessor = default_preprocessor(cur, v.content)
                if v.preprocessor is not None:
                    cur = v.preprocessor.get_output_type(cur)
                v.content.set_n_in(cur, override=False)
                types[name] = v.content.get_output_type(cur)
            else:
                types[name] = v.content.get_output_type(in_types)
        return types

    def to_json(self) -> str:
        d = {
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "vertices": [{
                "name": v.name,
                "kind": "layer" if v.is_layer else "vertex",
                "content": v.content.to_map(),
                "inputs": v.inputs,
                "preprocessor": v.preprocessor.to_map()
                                if v.preprocessor else None,
            } for v in self.vertices.values()],
            "input_types": [t.to_map() for t in self.input_types],
            "seed": self.seed,
            "updater": self.updater.to_map(),
            "weight_init": self.weight_init.name,
            "l1": self.l1, "l2": self.l2,
            "gradient_normalization": self.gradient_normalization.name,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "backprop_type": self.backprop_type.name,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "remat_segments": self.remat_segments,
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        conf = ComputationGraphConfiguration(
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            input_types=[InputType.from_map(t)
                         for t in d.get("input_types", [])],
            seed=d.get("seed", 12345),
            updater=IUpdater.from_map(d["updater"]),
            weight_init=WeightInit[d.get("weight_init", "XAVIER")],
            l1=d.get("l1", 0.0), l2=d.get("l2", 0.0),
            gradient_normalization=GradientNormalization[
                d.get("gradient_normalization", "NONE")],
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            backprop_type=BackpropType[d.get("backprop_type", "STANDARD")],
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            dtype=d.get("dtype", "float32"),
            compute_dtype=d.get("compute_dtype"),
            remat_segments=d.get("remat_segments", 0),
        )
        for vd in d["vertices"]:
            content = Layer.from_map(vd["content"]) \
                if vd["kind"] == "layer" \
                else GraphVertex.from_map(vd["content"])
            conf.vertices[vd["name"]] = VertexDef(
                vd["name"], content, list(vd["inputs"]),
                InputPreProcessor.from_map(vd["preprocessor"])
                if vd.get("preprocessor") else None)
        conf.resolve_shapes()
        return conf


class GraphBuilder:
    """Reference: NeuralNetConfiguration.Builder().graphBuilder()."""

    def __init__(self, base):
        self._base = base
        self._conf = ComputationGraphConfiguration()

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._conf.input_types = list(types)
        return self

    def add_layer(self, name: str, layer: Layer,
                  *inputs) -> "GraphBuilder":
        """``inputs`` are vertex names, optionally led by the
        preprocessor of the layer's input (the reference's overload)."""
        ins = list(inputs)
        pre = ins.pop(0) if ins and isinstance(ins[0],
                                               InputPreProcessor) else None
        self._conf.vertices[name] = VertexDef(name, layer, ins, pre)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._conf.vertices[name] = VertexDef(name, vertex, list(inputs))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs = list(names)
        return self

    def backprop_type(self, t: BackpropType) -> "GraphBuilder":
        self._conf.backprop_type = t
        return self

    def t_bptt_length(self, fwd: int,
                      back: Optional[int] = None) -> "GraphBuilder":
        self._conf.tbptt_fwd_length = fwd
        self._conf.tbptt_back_length = back if back is not None else fwd
        return self

    def remat_segments(self, n: int) -> "GraphBuilder":
        """Run the training walk in ``n`` checkpointed segments of the
        topo order (0: off). An explicit value here, 0 included,
        overrides the base builder's."""
        self._conf.remat_segments = int(n)
        self._remat_explicit = True
        return self

    def build(self) -> ComputationGraphConfiguration:
        b = self._base
        c = self._conf
        c.seed = b._seed
        c.updater = b._updater
        c.weight_init = b._weight_init
        c.l1, c.l2 = b._l1, b._l2
        c.gradient_normalization = b._grad_norm
        c.gradient_normalization_threshold = b._grad_norm_threshold
        c.dtype = b._dtype
        c.compute_dtype = b._compute_dtype
        if not getattr(self, "_remat_explicit", False):
            c.remat_segments = b._remat_segments
        for v in c.vertices.values():
            if v.is_layer:
                apply_layer_defaults(v.content, b)
        if not c.network_outputs:
            raise ValueError("setOutputs(...) not called")
        c.resolve_shapes()
        return c
