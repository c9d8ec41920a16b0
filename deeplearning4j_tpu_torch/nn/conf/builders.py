"""Network configuration builders.

Counterpart of ``deeplearning4j_tpu/nn/conf/builders.py``:
``NeuralNetConfiguration.Builder()`` with its global defaults,
``list()`` into a ``MultiLayerConfiguration`` (whose JSON is the JAX
package's, read and written verbatim, recurrent layers and truncated
BPTT included) and ``graph_builder()`` into a
``ComputationGraphConfiguration``. As in the JAX package, shape
inference inserts only the flat/NHWC adapters (``default_preprocessor``)
and no Rnn/FeedForward preprocessor by itself: a dense layer maps the
last axis of a ``[b, t, f]`` input, and ``RnnOutputLayer`` is
per-timestep.
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType, InputTypeConvolutional, InputTypeConvolutional3D,
    InputTypeConvolutionalFlat)
from deeplearning4j_tpu_torch.nn.conf import \
    layers_attention  # noqa: F401  registers the attention layers
from deeplearning4j_tpu_torch.nn.conf import \
    layers_recurrent  # noqa: F401  registers the recurrent layers
from deeplearning4j_tpu_torch.nn.conf.layers import (
    CnnLossLayer, ConvolutionLayer, DenseLayer, Layer, RnnOutputLayer,
    SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor,
    InputPreProcessor)
from deeplearning4j_tpu_torch.nn.weights import WeightInit


class GradientNormalization(enum.Enum):
    """Reference: org.deeplearning4j.nn.conf.GradientNormalization."""
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renorm_l2_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renorm_l2_param"
    CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "clip_elem"
    CLIP_L2_PER_LAYER = "clip_l2_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_param"


class BackpropType(enum.Enum):
    STANDARD = "standard"
    TRUNCATED_BPTT = "tbptt"


class WorkspaceMode(enum.Enum):
    """Kept for API parity (reference: WorkspaceMode); a no-op here:
    PyTorch's caching allocator owns device memory."""
    ENABLED = "enabled"
    NONE = "none"


def default_preprocessor(cur: InputType, layer: Layer
                         ) -> Optional[InputPreProcessor]:
    """The shape adapter the JAX package inserts before ``layer`` on a
    ``cur`` input, in a layer stack and before a graph's layer vertex
    alike: flat to NHWC before a convolution or pooling, NHWC to flat
    before a dense layer (output and loss layers included, the
    per-timestep ``RnnOutputLayer`` and the per-pixel ``CnnLossLayer``
    not)."""
    if isinstance(cur, InputTypeConvolutionalFlat) and \
            isinstance(layer, (ConvolutionLayer, SubsamplingLayer)):
        return FeedForwardToCnnPreProcessor(cur.height, cur.width,
                                            cur.channels)
    wants_ff = isinstance(layer, DenseLayer) and \
        not isinstance(layer, (RnnOutputLayer, CnnLossLayer))
    if isinstance(cur, InputTypeConvolutional) and wants_ff:
        return CnnToFeedForwardPreProcessor(cur.height, cur.width,
                                            cur.channels)
    if isinstance(cur, InputTypeConvolutional3D) and wants_ff:
        raise NotImplementedError(
            "Cnn3DToFeedForwardPreProcessor is not ported yet (ROADMAP.md, "
            "Queue A item 14)")
    return None


@dataclass
class MultiLayerConfiguration:
    layers: List[Layer] = field(default_factory=list)
    input_preprocessors: Dict[int, InputPreProcessor] = \
        field(default_factory=dict)
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
    input_type: Optional[InputType] = None

    def get_layer(self, i: int) -> Layer:
        return self.layers[i]

    def to_json(self) -> str:
        d = {
            "layers": [layer.to_map() for layer in self.layers],
            "input_preprocessors": {str(k): v.to_map() for k, v in
                                    self.input_preprocessors.items()},
            "seed": self.seed,
            "updater": self.updater.to_map(),
            "weight_init": self.weight_init.name,
            "l1": self.l1,
            "l2": self.l2,
            "gradient_normalization": self.gradient_normalization.name,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "backprop_type": self.backprop_type.name,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "remat_segments": self.remat_segments,
            "input_type": self.input_type.to_map() if self.input_type
                          else None,
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        conf = MultiLayerConfiguration(
            layers=[Layer.from_map(m) for m in d["layers"]],
            input_preprocessors={int(k): InputPreProcessor.from_map(v)
                                 for k, v in
                                 d.get("input_preprocessors", {}).items()},
            seed=d.get("seed", 12345),
            updater=IUpdater.from_map(d["updater"]),
            weight_init=WeightInit[d.get("weight_init", "XAVIER")],
            l1=d.get("l1", 0.0),
            l2=d.get("l2", 0.0),
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
            input_type=InputType.from_map(d["input_type"])
                       if d.get("input_type") else None,
        )
        conf.resolve_shapes()
        return conf

    def resolve_shapes(self) -> List[Optional[InputType]]:
        """Infer each layer's ``n_in`` and insert the default
        preprocessors, given ``input_type``; returns each layer's input
        type (after its preprocessor), or Nones without an input type."""
        if self.input_type is None:
            return [None] * len(self.layers)
        cur = self.input_type
        types = []
        for i, layer in enumerate(self.layers):
            if i in self.input_preprocessors:
                cur = self.input_preprocessors[i].get_output_type(cur)
            else:
                pre = default_preprocessor(cur, layer)
                if pre is not None:
                    self.input_preprocessors[i] = pre
                    cur = pre.get_output_type(cur)
            layer.set_n_in(cur, override=False)
            types.append(cur)
            cur = layer.get_output_type(cur)
        return types


class ListBuilder:
    """Reference: NeuralNetConfiguration.ListBuilder."""

    def __init__(self, base: "NeuralNetConfiguration.Builder"):
        self._base = base
        self._layers: List[Layer] = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, layer: Layer) -> "ListBuilder":
        self._layers.append(layer)
        return self

    def input_pre_processor(self, idx: int,
                            p: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[idx] = p
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._input_type = t
        return self

    def backprop_type(self, t: BackpropType) -> "ListBuilder":
        self._backprop_type = t
        return self

    def t_bptt_length(self, fwd: int,
                      back: Optional[int] = None) -> "ListBuilder":
        self._tbptt_fwd = fwd
        self._tbptt_back = back if back is not None else fwd
        return self

    def build(self) -> MultiLayerConfiguration:
        b = self._base
        conf = MultiLayerConfiguration(
            layers=list(self._layers),
            input_preprocessors=dict(self._preprocessors),
            seed=b._seed, updater=b._updater, weight_init=b._weight_init,
            l1=b._l1, l2=b._l2, gradient_normalization=b._grad_norm,
            gradient_normalization_threshold=b._grad_norm_threshold,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            dtype=b._dtype, compute_dtype=b._compute_dtype,
            remat_segments=b._remat_segments, input_type=self._input_type)
        for layer in conf.layers:
            apply_layer_defaults(layer, b)
        conf.resolve_shapes()
        return conf


def apply_layer_defaults(layer: Layer,
                         base: "NeuralNetConfiguration.Builder"):
    """Flow global builder defaults down to a layer that did not set
    them."""
    if layer.updater is None:
        layer.updater = base._updater
    if layer.weight_init is None:
        layer.weight_init = base._weight_init
    if layer.l1 is None:
        layer.l1 = base._l1
    if layer.l2 is None:
        layer.l2 = base._l2
    if layer.dropout is None and base._dropout is not None:
        layer.dropout = base._dropout
    if layer.weight_noise is None and base._weight_noise is not None:
        layer.weight_noise = base._weight_noise
    if layer.constrain_weights is None and base._constrain_weights:
        layer.constrain_weights = list(base._constrain_weights)
    if layer.constrain_bias is None and base._constrain_bias:
        layer.constrain_bias = list(base._constrain_bias)
    if layer.constrain_all is None and base._constrain_all:
        layer.constrain_all = list(base._constrain_all)


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.Builder()``."""

    class Builder:
        def __init__(self):
            self._seed = 12345
            self._updater: IUpdater = Sgd(1e-3)
            self._weight_init = WeightInit.XAVIER
            self._l1 = 0.0
            self._l2 = 0.0
            self._dropout: Optional[float] = None
            self._weight_noise = None
            self._grad_norm = GradientNormalization.NONE
            self._grad_norm_threshold = 1.0
            self._dtype = "float32"
            self._compute_dtype: Optional[str] = None
            self._remat_segments = 0
            self._activation = None
            self._constrain_weights: list = []
            self._constrain_bias: list = []
            self._constrain_all: list = []

        def seed(self, s: int):
            self._seed = int(s)
            return self

        def updater(self, u: IUpdater):
            self._updater = u
            return self

        def weight_init(self, w: WeightInit):
            self._weight_init = w
            return self

        def l1(self, v: float):
            self._l1 = float(v)
            return self

        def l2(self, v: float):
            self._l2 = float(v)
            return self

        def dropout(self, p: float):
            """The default input dropout (retain probability) of every
            layer that sets none."""
            self._dropout = float(p)
            return self

        def activation(self, a):
            """Stored for API parity; like the JAX package's, applied
            nowhere (each layer names its own activation)."""
            self._activation = a
            return self

        def constrain_weights(self, *constraints):
            """Post-update projections of every layer's weight params
            (reference: Builder.constrainWeights), for each layer that
            sets none."""
            self._constrain_weights = list(constraints)
            return self

        def constrain_bias(self, *constraints):
            self._constrain_bias = list(constraints)
            return self

        def constrain_all_parameters(self, *constraints):
            """Reference: Builder.constrainAllParameters."""
            self._constrain_all = list(constraints)
            return self

        def weight_noise(self, wn):
            """The default ``WeightNoise`` of every layer that sets
            none (the layers carry it into the JSON)."""
            self._weight_noise = wn
            return self

        def gradient_normalization(self, g: GradientNormalization):
            self._grad_norm = g
            return self

        def gradient_normalization_threshold(self, t: float):
            self._grad_norm_threshold = float(t)
            return self

        def data_type(self, dtype: str):
            self._dtype = dtype
            return self

        def compute_data_type(self, dtype: Optional[str]):
            """Mixed precision: run the forward math in this dtype
            ('bfloat16') while parameters stay in ``data_type``."""
            self._compute_dtype = dtype
            return self

        def remat_segments(self, n: int):
            """Run the training forward in ``n`` checkpointed segments of
            the stack (only segment-boundary activations are kept for
            the backward; 0 keeps everything)."""
            self._remat_segments = int(n)
            return self

        def list(self) -> ListBuilder:  # noqa: A003
            return ListBuilder(self)

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
                GraphBuilder
            return GraphBuilder(self)
