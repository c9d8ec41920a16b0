"""Custom layers defined through the SameDiff graph builder.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers_samediff.py``
(reference: ``org.deeplearning4j.nn.conf.layers.samediff.{SameDiffLayer,
SameDiffOutputLayer, SameDiffVertex}``): subclass, declare the
parameters' shapes, and describe the forward pass as a SameDiff graph;
the layer then takes part in a ``MultiLayerNetwork`` or
``ComputationGraph`` like any built-in layer, and round-trips through
``configuration.json`` and ``ModelSerializer`` zips once its class is
registered (``register_layer`` / ``register_vertex``).

The user's graph is traced once per device into the layer's own
``SameDiff``; a forward is that graph's walk (``SameDiff._plan`` /
``_run``) with the network's parameter tensors as its variables, so
autograd reaches them and the flash kernels run wherever the graph has
an attention site. Random ops inside draw from the layer's key, the
network's ``fold_in`` of the layer's position (no key: ``RngKey(0)``, as
the JAX package takes ``PRNGKey(0)``). Parameters are initialised by
``initialize_parameters`` from the network's generator: the weight
init (XAVIER by default) for parameters of two or more axes, zeros for
the rest.

The port adds one thing to the JAX package's layer: ``define_layer(sd,
layer_input, params, mask)`` (the reference's signature) makes the layer
take the network's ``[b, t]`` features mask as a placeholder.

Usage::

    @register_layer
    @dataclass
    class MyLayer(SameDiffLayer):
        def define_parameters(self):
            return {"W": (self.n_in, self.n_out)}

        def define_layer(self, sd, layer_input, params):
            return sd.nn.relu(layer_input.mmul(params["W"]))
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Dict

import torch

from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (GraphVertex,
                                                              register_vertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseOutputLayer, Layer,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.weights import WeightInit

#: an instance attribute that is runtime state, never configuration
_CACHE = "_fn_cache"


def _build_layer_fn(define, n_inputs: int, param_shapes: Dict[str, tuple],
                    device, with_mask: bool = False):
    """Trace a ``define_layer``-style callable into a fresh ``SameDiff``
    on ``device``; returns ``fn(param_vals, inputs, rng, training,
    mask=None) -> output`` over the graph's walk."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    sd = SameDiff(device)
    inputs = [sd.placeholder(f"input{i}" if n_inputs > 1 else "input",
                             shape=None) for i in range(n_inputs)]
    pvars = {n: sd.var(n, shape=shape)
             for n, shape in param_shapes.items()}
    args = [sd, inputs[0] if n_inputs == 1 else inputs, pvars]
    mask = None
    if with_mask:
        mask = sd.placeholder("mask", shape=None)
        args.append(mask)
    out = define(*args)
    names = tuple(v.name for v in inputs) + ((mask.name,) if with_mask
                                              else ())
    plan = sd._plan((out.name,), names)

    def run(param_vals, input_arrays, rng, training, mask_array=None):
        ph = {v.name: a for v, a in zip(inputs, input_arrays)}
        if with_mask:
            if mask_array is None:
                # no features mask: every step is kept
                x = input_arrays[0]
                mask_array = torch.ones(x.shape[:2], dtype=x.dtype,
                                        device=x.device)
            ph[mask.name] = mask_array
        var_vals = {n: param_vals[n] for n in plan.variables}
        return sd._run(plan, var_vals, ph, (out.name,), training=training,
                       rng=rng if rng is not None else RngKey(0))[0]

    return run


def _cached_fn(obj, key, build):
    cache = obj.__dict__.setdefault(_CACHE, {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _without_cache(d: dict) -> dict:
    d.pop(_CACHE, None)
    return d


def _init_params(layer, generator, shapes: Dict[str, tuple], dtype):
    """The weight init for parameters of two or more axes (fan in the
    first axis, fan out the last), zeros for the rest."""
    wi = layer.weight_init or WeightInit.XAVIER
    out = {}
    for n, shape in shapes.items():
        shape = tuple(int(s) for s in shape)
        if len(shape) >= 2:
            out[n] = wi.init(generator, shape, shape[0], shape[-1], dtype)
        else:
            out[n] = torch.zeros(shape, dtype=dtype)
    return out


def _takes_mask(define) -> bool:
    return "mask" in inspect.signature(define).parameters


@register_layer
@dataclass
class SameDiffLayer(Layer):
    """Base class of user-defined SameDiff layers (reference:
    samediff.SameDiffLayer). Override ``define_parameters`` and
    ``define_layer`` (and ``initialize_parameters`` /
    ``get_output_type`` where the defaults do not fit)."""

    # -- user hooks ------------------------------------------------------
    def define_parameters(self) -> Dict[str, tuple]:
        """name -> shape of every trainable parameter."""
        return {}

    def initialize_parameters(self, generator, shapes: Dict[str, tuple],
                              dtype) -> Dict[str, torch.Tensor]:
        """The weight init (XAVIER by default) for parameters of two or
        more axes, zeros for the rest (reference: SDLayerParams' weight
        and bias split), drawn from the network's ``generator``."""
        return _init_params(self, generator, shapes, dtype)

    def define_layer(self, sd, layer_input, params):
        raise NotImplementedError

    # -- layer protocol --------------------------------------------------
    def has_params(self) -> bool:
        return bool(self.define_parameters())

    def accepts_mask(self) -> bool:
        return _takes_mask(self.define_layer)

    def init_params(self, generator, input_type, dtype=torch.float32):
        return self.initialize_parameters(generator,
                                          self.define_parameters(), dtype)

    def _fn(self, device):
        device = torch.device(device)
        return _cached_fn(self, device, lambda: _build_layer_fn(
            self.define_layer, 1, self.define_parameters(), device,
            self.accepts_mask()))

    def forward(self, params, x, *, training, rng=None, state=None,
                mask=None):
        return self._fn(x.device)(params, [x], rng, training, mask), state

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def to_map(self) -> dict:
        return _without_cache(super().to_map())


@register_layer
@dataclass
class SameDiffOutputLayer(BaseOutputLayer):
    """User-defined output layer (reference: samediff.
    SameDiffOutputLayer): ``define_layer`` gives the pre-activations,
    the configured activation and loss function apply to them."""

    def define_parameters(self) -> Dict[str, tuple]:
        return {}

    def initialize_parameters(self, generator, shapes, dtype):
        return _init_params(self, generator, shapes, dtype)

    def define_layer(self, sd, layer_input, params):
        raise NotImplementedError

    def has_params(self) -> bool:
        return bool(self.define_parameters())

    def init_params(self, generator, input_type, dtype=torch.float32):
        return self.initialize_parameters(generator,
                                          self.define_parameters(), dtype)

    def _fn(self, device):
        device = torch.device(device)
        return _cached_fn(self, device, lambda: _build_layer_fn(
            self.define_layer, 1, self.define_parameters(), device))

    def wants_logits(self) -> bool:
        return False

    def forward(self, params, x, *, training, rng=None, state=None):
        return self.activation(self.forward_logits(
            params, x, training=training, rng=rng)[0]), state

    def forward_logits(self, params, x, *, training, rng=None, state=None):
        return self._fn(x.device)(params, [x], rng, training), state

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def to_map(self) -> dict:
        return _without_cache(super().to_map())


@register_vertex
class SameDiffVertex(GraphVertex):
    """User-defined multi-input vertex of a ComputationGraph (reference:
    samediff.SameDiffVertex). Override ``define_vertex(sd, inputs)``
    (no parameters: a trainable custom vertex belongs in a
    SameDiffLayer) and ``get_output_type``."""

    def define_vertex(self, sd, inputs):
        raise NotImplementedError

    def _fn(self, n_inputs: int, device):
        device = torch.device(device)
        return _cached_fn(self, (n_inputs, device), lambda: _build_layer_fn(
            lambda sd, ins, params: self.define_vertex(
                sd, ins if isinstance(ins, list) else [ins]),
            n_inputs, {}, device))

    def forward(self, inputs, *, training=False):
        return self._fn(len(inputs), inputs[0].device)(
            {}, list(inputs), None, training)

    def get_output_type(self, input_types):
        return input_types[0]

    def to_map(self) -> dict:
        return _without_cache(super().to_map())
