"""MultiLayerNetwork: a sequential layer stack.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` on one device:
``init``, ``output``, ``fit`` (x, y | DataSet | iterator), ``score``,
listeners and per-layer updaters, on the training step shared with
ComputationGraph (``nn/trainer.py``). Parameters, states and updater
states are keyed ``"layer_<i>"``, as in the JAX package, so its zips
and trees carry across (``utils/serializer.py``). Each layer's input
passes its preprocessor first (``conf.input_preprocessors``, filled in
by shape inference: flat to NHWC before a convolution, NHWC to flat
before a dense layer).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.nn.conf.builders import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.graph import (
    as_device_tensor, cast_floats, check_activation_dtype, to_torch_dtype)
from deeplearning4j_tpu_torch.nn.trainer import Trainable


class MultiLayerNetwork(Trainable):
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.states: Dict[str, Dict[str, torch.Tensor]] = {}
        self._init_training()
        self.device: Optional[torch.device] = None
        self._dtype = to_torch_dtype(conf.dtype)
        self._initialized = False

    # ------------------------------------------------------------------
    def init(self, device: Union[None, str, torch.device] = None, *,
             generator: Optional[torch.Generator] = None
             ) -> "MultiLayerNetwork":
        """Initialise parameters and states on ``device`` (``None``: the
        card) from ``generator``, a CPU ``torch.Generator`` seeded from
        ``conf.seed`` when not given."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.conf.seed)
        types = self.conf.resolve_shapes()
        params, states = {}, {}
        for i, (layer, cur) in enumerate(zip(self.conf.layers, types)):
            k = f"layer_{i}"
            params[k] = layer.init_params(generator, cur, self._dtype) \
                if layer.has_params() else {}
            states[k] = layer.init_state(cur, self._dtype) \
                if layer.has_state() else {}
        return self.set_params(params, states, device)

    def set_params(self, params: dict, states: dict,
                   device: Union[None, str, torch.device] = None
                   ) -> "MultiLayerNetwork":
        """Install ``params``/``states`` (``{"layer_<i>": {name:
        tensor}}``) on ``device``; conv kernels stored channels-last."""
        dev = resolve_device(device)
        check_activation_dtype(self.conf, dev)
        keys = self._keys()
        missing = [k for k in keys if k not in params]
        if missing:
            raise ValueError(f"params missing layers {missing[:5]}")

        def place(t: torch.Tensor) -> torch.Tensor:
            t = t.to(dev)
            if t.dim() == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            return t

        self.params = {k: {n: place(t) for n, t in params[k].items()}
                       for k in keys}
        self.states = {k: {n: t.to(dev) for n, t in states.get(k, {})
                           .items()} for k in keys}
        self.device = dev
        self._initialized = True
        self._reset_updater_states()
        return self

    # -- Trainable protocol ----------------------------------------------
    def _keys(self):
        return [f"layer_{i}" for i in range(len(self.conf.layers))]

    def _layer(self, key):
        return self.conf.layers[int(key.split("_")[1])]

    @property
    def output_layer_conf(self) -> BaseOutputLayer:
        last = self.conf.layers[-1]
        if not isinstance(last, BaseOutputLayer):
            raise ValueError("last layer is not an output layer")
        return last

    def n_layers(self) -> int:
        return len(self.conf.layers)

    # ------------------------------------------------------------------
    def _forward(self, params, states, x: torch.Tensor, *,
                 training: bool = False, want_logits: bool = False):
        """Walk the stack; returns ``(out, new_states)``."""
        conf = self.conf
        if conf.compute_dtype:
            cd = to_torch_dtype(conf.compute_dtype)
            params = cast_floats(params, cd)
            if x.is_floating_point():
                x = x.to(cd)
        new_states = {}
        h = x
        n = len(conf.layers)
        for i, layer in enumerate(conf.layers):
            k = f"layer_{i}"
            if i in conf.input_preprocessors:
                h = conf.input_preprocessors[i].pre_process(h)
            if training and layer.weight_noise is not None:
                raise NotImplementedError(
                    f"{k}: weight noise is not ported yet")
            lp, ls = params.get(k, {}), states.get(k) or None
            if i == n - 1 and want_logits and \
                    isinstance(layer, BaseOutputLayer) and \
                    layer.wants_logits():
                h, ns = layer.forward_logits(lp, h, training=training,
                                             state=ls)
            else:
                h, ns = layer.forward(lp, h, training=training, state=ls)
            new_states[k] = ns or {}
        if conf.compute_dtype:
            h = h.to(self._dtype)
        return h, new_states

    def _as_input(self, x) -> torch.Tensor:
        return as_device_tensor(x, self._dtype, self.device)

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Inference forward on ``self.device``."""
        if train:
            raise NotImplementedError(
                "output(train=True) is not ported yet")
        if not self._initialized:
            self.init()
        with torch.inference_mode():
            out, _ = self._forward(self.params, self.states,
                                   self._as_input(x))
        return out

    # -- training --------------------------------------------------------
    def _split(self, data, labels):
        if labels is None:
            x, y = data.features, data.labels
            lmask = getattr(data, "labels_mask", None)
        else:
            x, y, lmask = data, labels, None
        return ([self._as_input(x)], [self._as_input(y)],
                [self._as_input(lmask)] if lmask is not None else None)

    def _loss(self, params, inputs, labels, lmasks, *, training: bool):
        out_layer = self.output_layer_conf
        want_logits = out_layer.wants_logits()
        out, new_states = self._forward(params, self.states, inputs[0],
                                        training=training,
                                        want_logits=True)
        data_loss = out_layer.compute_loss(
            labels[0], out, from_logits=want_logits,
            mask=lmasks[0] if lmasks is not None else None)
        return data_loss + self._regularization(params), new_states

    def num_params(self) -> int:
        return int(sum(t.numel() for sub in self.params.values()
                       for t in sub.values()))
