"""Layer configurations and their math.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers.py``, every layer
of it (the recurrent layers are in ``layers_recurrent.py``, the
attention layers in ``layers_attention.py``). Each config dataclass keeps the JAX package's fields, so ``configuration.json``
round-trips verbatim, and is also the runtime:

    init_params(generator, input_type)   -> {name: CPU tensor}
    init_state(input_type)               -> {name: CPU tensor}
    forward(params, x, training, state)  -> (y, state)
    get_output_type(input_type)          -> InputType

A layer that ``accepts_mask()`` (the recurrent layers, global pooling,
``LastTimeStepLayer``) also takes ``mask=``, the ``[b, t]`` features
mask; ``is_recurrent()`` layers carry a transient per-sequence state
(``zero_state``).

Layouts are the JAX package's at every public function (NHWC
activations, dense ``W`` as ``[n_in, n_out]``) except conv kernels,
which are OIHW, PyTorch's layout; ``utils/serializer.py`` converts at
the zip boundary. ``forward(training=True)`` is the training forward:
BatchNormalization normalizes with batch statistics and returns its
blended running stats, and a layer's ``dropout`` (a retain probability
or an ``IDropout`` of ``nn/conf/dropout.py``) is applied to its input
with masks drawn from ``rng``, the layer's ``RngKey`` (no key: no
dropout, as in the JAX package's ``output(train=True)``). A layer's
``weight_noise`` is applied by the network, which owns the keys.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.learning.updaters import IUpdater
from deeplearning4j_tpu_torch.lossfunctions import LossFunction
from deeplearning4j_tpu_torch.nn.conf.dropout import (IDropout, WeightNoise,
                                                      dropout_from)
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType, InputTypeConvolutional, InputTypeConvolutional3D,
    InputTypeFeedForward, InputTypeRecurrent)
from deeplearning4j_tpu_torch.nn.weights import WeightInit


class PoolingType(enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


class ConvolutionMode(enum.Enum):
    """Reference: Strict/Truncate/Same. Truncate == XLA VALID."""
    STRICT = "strict"
    TRUNCATE = "truncate"
    SAME = "same"


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the JAX package's dtype promotion: an f32 operand
    lifts a bf16 or f16 one to f32 (``jnp.matmul`` promotes; torch
    refuses mixed dtypes)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


@dataclass
class Layer:
    """Base layer config. Fields mirror BaseLayer/FeedForwardLayer."""

    n_in: int = 0
    n_out: int = 0
    activation: Activation = Activation.IDENTITY
    weight_init: Optional[WeightInit] = None      # None -> net default
    bias_init: float = 0.0
    updater: Optional[IUpdater] = None            # None -> net default
    l1: Optional[float] = None
    l2: Optional[float] = None
    #: a retain probability OR an IDropout variant (nn/conf/dropout.py)
    dropout: object = None
    #: a WeightNoise (or DropConnect) applied to the params in training
    weight_noise: object = None
    constrain_weights: object = None
    constrain_bias: object = None
    constrain_all: object = None
    constrain_params: object = None
    name: Optional[str] = None

    def __post_init__(self):
        for f in ("activation", "gate_activation"):
            v = getattr(self, f, None)
            if isinstance(v, str):
                setattr(self, f, Activation.from_name(v))
        if isinstance(self.weight_init, str):
            self.weight_init = WeightInit[self.weight_init.upper()]
        lf = getattr(self, "loss_function", None)
        if isinstance(lf, str):
            self.loss_function = LossFunction[lf.upper()]

    # -- runtime protocol ------------------------------------------------
    def has_params(self) -> bool:
        return True

    def has_state(self) -> bool:
        return False

    def is_recurrent(self) -> bool:
        """True for layers with a transient per-sequence state (h, c)."""
        return False

    def accepts_mask(self) -> bool:
        """True if ``forward`` takes a per-timestep ``mask``."""
        return self.is_recurrent()

    def zero_state(self, batch: int, dtype=torch.float32) -> dict:
        return {}

    def init_params(self, generator, input_type: InputType,
                    dtype=torch.float32) -> dict:
        return {}

    def init_state(self, input_type: InputType,
                   dtype=torch.float32) -> dict:
        return {}

    def forward(self, params, x, *, training: bool, rng=None, state=None):
        raise NotImplementedError

    def get_output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def set_n_in(self, input_type: InputType, override: bool):
        if isinstance(input_type, InputTypeFeedForward) and \
                (override or not self.n_in):
            self.n_in = input_type.size

    # -- input dropout (the reference applies it to the layer's input) --
    def _maybe_dropout(self, x, training: bool, rng):
        if self.dropout is None or not training or rng is None:
            return x
        return dropout_from(self.dropout).apply(x, rng)

    # -- serde -----------------------------------------------------------
    def to_map(self) -> dict:
        d = {"@class": type(self).__name__}
        for k, v in self.__dict__.items():
            if isinstance(v, enum.Enum):
                v = v.name
            elif isinstance(v, (IUpdater, IDropout, WeightNoise)):
                v = v.to_map()
            elif isinstance(v, tuple):
                v = list(v)
            d[k] = v
        return d

    @staticmethod
    def from_map(d: dict) -> "Layer":
        d = dict(d)
        cls_name = d.pop("@class")
        cls = LAYER_REGISTRY.get(cls_name)
        if cls is None:
            raise NotImplementedError(
                f"layer class {cls_name!r} is not ported yet (the layer "
                f"families left are ROADMAP.md, Queue A item 14), or is a "
                f"custom layer not registered with register_layer "
                f"(registered: {sorted(LAYER_REGISTRY)})")
        for k, v in list(d.items()):
            if k == "updater" and isinstance(v, dict):
                d[k] = IUpdater.from_map(v)
            elif k == "dropout" and isinstance(v, dict):
                d[k] = IDropout.from_map(v)
            elif k == "weight_noise" and isinstance(v, dict):
                d[k] = WeightNoise.from_map(v)
            elif k == "pooling_type" and isinstance(v, str):
                d[k] = PoolingType[v]
            elif k == "convolution_mode" and isinstance(v, str):
                d[k] = ConvolutionMode[v]
            elif k in ("kernel_size", "stride", "padding", "dilation") \
                    and isinstance(v, list):
                d[k] = tuple(v)
        return cls(**d)


# ---------------------------------------------------------------------------
@dataclass
class DenseLayer(Layer):
    """Fully connected layer; ``W`` is ``[n_in, n_out]``."""

    has_bias: bool = True
    activation: Activation = Activation.SIGMOID

    def init_params(self, generator, input_type, dtype=torch.float32):
        wi = self.weight_init or WeightInit.XAVIER
        p = {"W": wi.init(generator, (self.n_in, self.n_out),
                          self.n_in, self.n_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtype)
        return p

    def forward(self, params, x, *, training, rng=None, state=None):
        return self.activation(self._affine(params, x, training, rng)), \
            state

    def _affine(self, params, x, training, rng):
        x = self._maybe_dropout(x, training, rng)
        z = matmul(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return z

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)


@dataclass
class ConvolutionLayer(Layer):
    """2D convolution over NHWC activations, OIHW kernel; the conv and
    its bias/activation epilogue go through
    ``ops/conv_epilogue.conv_forward``."""

    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    has_bias: bool = True

    def __post_init__(self):
        super().__post_init__()
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)

    def _pad_cfg(self):
        if self.convolution_mode is ConvolutionMode.SAME:
            return "SAME"
        ph, pw = self.padding
        return [(ph, ph), (pw, pw)]

    def init_params(self, generator, input_type, dtype=torch.float32):
        kh, kw = self.kernel_size
        fan_in = kh * kw * self.n_in
        fan_out = kh * kw * self.n_out
        wi = self.weight_init or WeightInit.XAVIER
        p = {"W": wi.init(generator, (self.n_out, self.n_in, kh, kw),
                          fan_in, fan_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtype)
        return p

    def forward(self, params, x, *, training, rng=None, state=None):
        x = self._maybe_dropout(x, training, rng)
        from deeplearning4j_tpu_torch.ops.conv_epilogue import conv_forward
        z = conv_forward(x, params["W"], stride=self.stride,
                         padding=self._pad_cfg(), dilation=self.dilation,
                         bias=params["b"] if self.has_bias else None,
                         activation=self.activation)
        return z, state

    def set_n_in(self, input_type, override):
        if isinstance(input_type, InputTypeConvolutional) and \
                (override or not self.n_in):
            self.n_in = input_type.channels

    def get_output_type(self, input_type):
        if not isinstance(input_type, InputTypeConvolutional):
            raise ValueError(f"{type(self).__name__} needs a "
                             f"convolutional input, got {input_type}")
        h, w = input_type.height, input_type.width
        kh, kw = self.kernel_size
        sh, sw = self.stride
        dh, dw = self.dilation
        ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        if self.convolution_mode is ConvolutionMode.SAME:
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            ph, pw = self.padding
            oh = (h + 2 * ph - ekh) // sh + 1
            ow = (w + 2 * pw - ekw) // sw + 1
        return InputType.convolutional(oh, ow, self.n_out)


@dataclass
class SubsamplingLayer(Layer):
    """Pooling over NHWC activations. SAME pads as XLA does, with the
    odd pixel on the high side, and a max pool pads with -inf."""

    pooling_type: PoolingType = PoolingType.MAX
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: ConvolutionMode = ConvolutionMode.TRUNCATE
    pnorm: int = 2

    def __post_init__(self):
        super().__post_init__()
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def has_params(self) -> bool:
        return False

    def forward(self, params, x, *, training, rng=None, state=None):
        from deeplearning4j_tpu_torch.ops.conv_epilogue import same_padding
        kh, kw = self.kernel_size
        sh, sw = self.stride
        if self.convolution_mode is ConvolutionMode.SAME:
            (ht, hb) = same_padding(int(x.shape[1]), kh, sh)
            (wl, wr) = same_padding(int(x.shape[2]), kw, sw)
        else:
            ph, pw = self.padding
            ht = hb = ph
            wl = wr = pw
        pad = (wl, wr, ht, hb)
        xn = x.permute(0, 3, 1, 2)              # channels-last NCHW view
        pt = self.pooling_type
        if pt is PoolingType.MAX:
            z = F.max_pool2d(F.pad(xn, pad, value=float("-inf")),
                             (kh, kw), (sh, sw))
        else:
            def window_sum(t):
                return F.avg_pool2d(F.pad(t, pad), (kh, kw), (sh, sw)) \
                    * (kh * kw)
            if pt is PoolingType.SUM:
                z = window_sum(xn)
            elif pt is PoolingType.AVG:
                z = window_sum(xn) / window_sum(torch.ones_like(xn))
            else:
                p = float(self.pnorm)
                z = window_sum(torch.abs(xn) ** p) ** (1.0 / p)
        return z.permute(0, 2, 3, 1), state

    def get_output_type(self, input_type):
        if not isinstance(input_type, InputTypeConvolutional):
            raise ValueError(f"{type(self).__name__} needs a "
                             f"convolutional input, got {input_type}")
        h, w = input_type.height, input_type.width
        kh, kw = self.kernel_size
        sh, sw = self.stride
        if self.convolution_mode is ConvolutionMode.SAME:
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            ph, pw = self.padding
            oh = (h + 2 * ph - kh) // sh + 1
            ow = (w + 2 * pw - kw) // sw + 1
        return InputType.convolutional(oh, ow, input_type.channels)

    def set_n_in(self, input_type, override):
        pass


@dataclass
class BatchNormalization(Layer):
    """Batch norm. Inference folds the running stats into a per-channel
    scale and shift and applies them, with the activation, in one pass
    of the conv epilogue (``maybe_bn_inference_epilogue``). Training
    normalizes with batch statistics, through the fused-backward
    ``bn_train_normalize`` on the card (``ops/bn_train.py``), and blends
    the running stats by ``decay`` from the batch mean and the biased
    batch variance."""

    decay: float = 0.9
    eps: float = 1e-5
    gamma_init: float = 1.0
    beta_init: float = 0.0
    lock_gamma_beta: bool = False

    def has_state(self) -> bool:
        return True

    def _nf(self, input_type):
        if isinstance(input_type, InputTypeConvolutional):
            return input_type.channels
        return input_type.size

    def init_params(self, generator, input_type, dtype=torch.float32):
        nf = self._nf(input_type)
        return {"gamma": torch.full((nf,), float(self.gamma_init),
                                    dtype=dtype),
                "beta": torch.full((nf,), float(self.beta_init),
                                   dtype=dtype)}

    def init_state(self, input_type, dtype=torch.float32):
        nf = self._nf(input_type)
        return {"mean": torch.zeros((nf,), dtype=dtype),
                "var": torch.ones((nf,), dtype=dtype)}

    def forward(self, params, x, *, training, rng=None, state=None):
        if training:
            return self._forward_train(params, x, state)
        acc = torch.promote_types(x.dtype, torch.float32)
        mean = state["mean"].to(acc)
        var = state["var"].to(acc)
        # sqrt then divide, as the JAX package folds (not rsqrt)
        scale = params["gamma"].to(acc) / torch.sqrt(var + self.eps)
        shift = params["beta"].to(acc) - mean * scale
        from deeplearning4j_tpu_torch.ops.conv_epilogue import \
            maybe_bn_inference_epilogue
        out = maybe_bn_inference_epilogue(x, scale, shift, self.activation)
        if out is not None:
            return out, state
        out = x * scale.to(x.dtype) + shift.to(x.dtype)
        return self.activation(out), state

    def _forward_train(self, params, x, state):
        # the decisions in the JAX package's order: the fused backward
        # first; without it the epilogue family with the activation
        # streamed in; else the plain math under autograd
        from deeplearning4j_tpu_torch.ops.bn_train import (
            bn_forward_math, bn_train_normalize, fused_bn_bwd_enabled)
        from deeplearning4j_tpu_torch.ops.conv_epilogue import \
            maybe_fused_bn_train
        from deeplearning4j_tpu_torch.parallel.mesh import current_replica
        gamma, beta = params["gamma"], params["beta"]
        # a data-parallel step's statistics are the global batch's
        replica = current_replica()
        act_done = False
        if fused_bn_bwd_enabled(x.device):
            out, mean, var = bn_train_normalize(x, gamma, beta, self.eps,
                                                replica)
        else:
            fused = maybe_fused_bn_train(x, gamma, beta, self.eps,
                                         self.activation, replica)
            if fused is not None:
                out, mean, var = fused
                act_done = True
            else:
                out, mean, var, _ = bn_forward_math(x, gamma, beta,
                                                    self.eps, replica)
        d = self.decay
        with torch.no_grad():
            new_state = {
                k: (d * state[k] + (1 - d) * v.detach()).to(state[k].dtype)
                for k, v in (("mean", mean), ("var", var))}
        return (out if act_done else self.activation(out)), new_state

    def get_output_type(self, input_type):
        return input_type

    def set_n_in(self, input_type, override):
        self.n_in = self.n_out = self._nf(input_type)


@dataclass
class ActivationLayer(Layer):
    def has_params(self) -> bool:
        return False

    def forward(self, params, x, *, training, rng=None, state=None):
        return self.activation(x), state

    def get_output_type(self, input_type):
        return input_type

    def set_n_in(self, input_type, override):
        pass


@dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial (NHWC / NDHWC) or time axes; a
    ``[b, t]`` mask drops padded timesteps out of the pool."""

    pooling_type: PoolingType = PoolingType.MAX

    def has_params(self) -> bool:
        return False

    def accepts_mask(self) -> bool:
        return True

    def forward(self, params, x, *, training, rng=None, state=None,
                mask=None):
        axes = {5: (1, 2, 3), 4: (1, 2), 3: (1,)}.get(x.dim())
        if axes is None:
            return x, state
        pt = self.pooling_type
        if mask is not None and x.dim() in (3, 5):
            m = mask.to(x.dtype).reshape(
                tuple(mask.shape[:2]) + (1,) * (x.dim() - 2))
            spatial = 1
            for d in x.shape[2:-1]:
                spatial *= int(d)
            if pt is PoolingType.MAX:
                z = torch.amax(torch.where(m > 0, x, float("-inf")),
                               dim=axes)
            elif pt is PoolingType.SUM:
                z = torch.sum(x * m, dim=axes)
            elif pt is PoolingType.AVG:
                denom = torch.clamp(mask.to(x.dtype).sum(1), min=1.0)
                z = torch.sum(x * m, dim=axes) / (denom[:, None] * spatial)
            else:
                p = float(getattr(self, "pnorm", 2.0))
                z = torch.sum(torch.abs(x * m) ** p, dim=axes) ** (1.0 / p)
            return z, state
        if pt is PoolingType.MAX:
            z = torch.amax(x, dim=axes)
        elif pt is PoolingType.SUM:
            z = torch.sum(x, dim=axes)
        elif pt is PoolingType.AVG:
            z = torch.mean(x, dim=axes)
        else:
            p = float(getattr(self, "pnorm", 2.0))
            z = torch.sum(torch.abs(x) ** p, dim=axes) ** (1.0 / p)
        return z, state

    def get_output_type(self, input_type):
        if isinstance(input_type, (InputTypeConvolutional,
                                   InputTypeConvolutional3D)):
            return InputType.feed_forward(input_type.channels)
        if isinstance(input_type, InputTypeRecurrent):
            return InputType.feed_forward(input_type.size)
        return input_type

    def set_n_in(self, input_type, override):
        pass


@dataclass
class DropoutLayer(Layer):
    """Standalone dropout; ``dropout`` is the retain probability (or an
    IDropout), as in the JAX package; the identity at inference."""

    dropout: float = 0.5

    def has_params(self) -> bool:
        return False

    def forward(self, params, x, *, training, rng=None, state=None):
        return self._maybe_dropout(x, training, rng), state

    def get_output_type(self, input_type):
        return input_type

    def set_n_in(self, input_type, override):
        pass


@dataclass
class EmbeddingLayer(Layer):
    """Index -> vector lookup (reference: conf.layers.EmbeddingLayer):
    int ``[b]`` or ``[b, 1]`` -> ``[b, n_out]``; ``n_in`` is the
    vocabulary size."""

    has_bias: bool = False

    def init_params(self, generator, input_type, dtype=torch.float32):
        wi = self.weight_init or WeightInit.XAVIER
        p = {"W": wi.init(generator, (self.n_in, self.n_out), self.n_in,
                          self.n_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtype)
        return p

    def forward(self, params, x, *, training, rng=None, state=None):
        idx = x.long()
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        z = params["W"][idx]
        if self.has_bias:
            z = z + params["b"]
        return self.activation(z), state

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def set_n_in(self, input_type, override):
        pass  # n_in is the vocabulary size


# ---------------------------------------------------------------------------
@dataclass
class BaseOutputLayer(DenseLayer):
    """Dense projection plus a loss head."""

    loss_function: LossFunction = LossFunction.MCXENT
    activation: Activation = Activation.SOFTMAX

    def compute_loss(self, labels, preds_or_logits, *, from_logits: bool,
                     mask=None, average=True):
        lf = self.loss_function
        if from_logits and lf.supports_logits():
            return lf.score_from_logits(labels, preds_or_logits, mask=mask,
                                        average=average)
        return lf.score(labels, preds_or_logits, mask=mask, average=average)

    def wants_logits(self) -> bool:
        """Fold the final softmax/sigmoid into the loss, as the JAX
        package does (no clip + log in probability space)."""
        return (self.loss_function.supports_logits() and
                self.activation in (Activation.SOFTMAX, Activation.SIGMOID))

    def forward_logits(self, params, x, *, training, rng=None, state=None):
        return self._affine(params, x, training, rng), state


@dataclass
class OutputLayer(BaseOutputLayer):
    """Reference: conf.layers.OutputLayer."""


@dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep output head (reference: conf.layers.RnnOutputLayer):
    ``[b, t, f] -> [b, t, n_out]``, the affine map and the softmax (or
    its logits, folded into the loss) at every step."""

    def set_n_in(self, input_type, override):
        if isinstance(input_type, InputTypeRecurrent) and \
                (override or not self.n_in):
            self.n_in = input_type.size

    def get_output_type(self, input_type):
        t = input_type.timesteps if isinstance(input_type,
                                               InputTypeRecurrent) else -1
        return InputType.recurrent(self.n_out, t)


@dataclass
class LossLayer(BaseOutputLayer):
    """A loss head with no parameters (reference: conf.layers.LossLayer):
    the activation of its input, the loss against the labels."""

    def has_params(self) -> bool:
        return False

    def init_params(self, generator, input_type, dtype=torch.float32):
        return {}

    def forward(self, params, x, *, training, rng=None, state=None):
        return self.activation(x), state

    def forward_logits(self, params, x, *, training, rng=None, state=None):
        return x, state

    def get_output_type(self, input_type):
        return input_type

    def set_n_in(self, input_type, override):
        if isinstance(input_type, InputTypeFeedForward):
            self.n_in = self.n_out = input_type.size


@dataclass
class CnnLossLayer(LossLayer):
    """A per-pixel loss head on NHWC activations, no parameters and no
    flattening (reference: conf.layers.CnnLossLayer); its activation is
    applied before the loss, never folded into it."""

    activation: Activation = Activation.IDENTITY

    def wants_logits(self) -> bool:
        return False

    def set_n_in(self, input_type, override):
        pass


LAYER_REGISTRY: dict = {c.__name__: c for c in
                        (DenseLayer, ConvolutionLayer, SubsamplingLayer,
                         BatchNormalization, ActivationLayer, DropoutLayer,
                         EmbeddingLayer, GlobalPoolingLayer, OutputLayer,
                         RnnOutputLayer, LossLayer, CnnLossLayer)}


def register_layer(cls):
    """Register a layer class for the JSON round trip."""
    LAYER_REGISTRY[cls.__name__] = cls
    return cls
