"""MultiLayerNetwork: a sequential layer stack.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py`` on one device:
``init``, ``output``, ``feed_forward``, ``predict``, ``fit`` (x, y |
DataSet | iterator), ``fit_steps``, ``score``, ``evaluate``, listeners
and per-layer updaters, ``param_table`` / ``get_param`` /
``set_params_from_table``, ``clone`` and ``summary``, on the training step shared with
ComputationGraph (``nn/trainer.py``). Parameters, states and updater
states are keyed ``"layer_<i>"``, as in the JAX package, so its zips
and trees carry across (``utils/serializer.py``). Each layer's input
passes its preprocessor first (``conf.input_preprocessors``, filled in
by shape inference: flat to NHWC before a convolution, NHWC to flat
before a dense layer).

Sequences (``[b, t, f]``): a DataSet's ``features_mask`` (``[b, t]``)
reaches every layer that accepts one, and its ``labels_mask`` the loss.
Recurrent layers' state is transient, as in the JAX package: each fit
batch starts from zero states in ``dtype`` and they are dropped after
it, so nothing of one batch leaks into the next or into ``output``
(which starts from zeros of the input's dtype). With
``backprop_type=TRUNCATED_BPTT`` a batch trains as segments of
``tbptt_fwd_length`` steps, one update and one iteration each, the
state carried from segment to segment and detached between them (the
truncation). ``rnn_time_step`` streams a sequence a step or a chunk at
a time, carrying the state across calls until
``rnn_clear_previous_state``.

Training draws from a per-step ``RngKey`` folded with each layer's
index (``nn/trainer.py``): a layer's input dropout, then its weight
noise, which perturbs the parameters the forward uses while the
gradients flow to the clean ones. With ``conf.remat_segments > 1`` the
training forward runs in that many segments of the layer stack
(``common/remat.py``), each but the last under
``torch.utils.checkpoint``: only a segment's input is kept for the
backward and its interior is recomputed, with the same keys, so the
recomputed dropout masks are the first forward's; the recomputed
forward's states are discarded (the first forward's are returned).
``output(train=True)`` and ``feed_forward(train=True)`` run the training
forward without a key, as the JAX package does: batch statistics, no
dropout.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.common import layerprof
from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.common.remat import segment_plan
from deeplearning4j_tpu_torch.nn.conf.builders import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.graph import (
    as_device_tensor, cast_floats, check_activation_dtype, clone_tree,
    to_torch_dtype)
from deeplearning4j_tpu_torch.nn.trainer import Trainable


class MultiLayerNetwork(Trainable):

    _FUNNEL = "MultiLayerNetwork"

    def _layer_types(self) -> dict:
        return {f"layer_{i}": type(layer).__name__
                for i, layer in enumerate(self.conf.layers)}

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
                 training: bool = False, rng=None, want_logits: bool = False,
                 mask: Optional[torch.Tensor] = None, start_at: int = 0,
                 stop_at: Optional[int] = None):
        """Walk the stack; ``mask`` is the ``[b, t]`` features mask, given
        to the layers that accept one; ``rng`` this step's key (None: no
        dropout and no weight noise). ``start_at`` / ``stop_at`` bound the
        walk to layers ``[start_at, stop_at)``, a pipeline stage's slice
        (``parallel/pipeline.py``): ``x`` is then the stage's incoming
        activation, and each layer's key stays folded on its absolute
        index, so a sliced walk draws what the whole one draws. Returns
        ``(out, new_states)``, both in ``dtype`` under
        ``compute_dtype``."""
        conf = self.conf
        if conf.compute_dtype:
            cd = to_torch_dtype(conf.compute_dtype)
            params = cast_floats(params, cd)
            if x.is_floating_point():
                x = x.to(cd)
        n = len(conf.layers)

        def run_layer(i, h):
            layer = conf.layers[i]
            k = f"layer_{i}"
            if i in conf.input_preprocessors:
                h = conf.input_preprocessors[i].pre_process(h)
            # the layer's key is fold_in(rng, i) whether or not the walk
            # is segmented, so remat does not change the stream
            lrng = rng.fold_in(i) if rng is not None else None
            lp, ls = params.get(k, {}), states.get(k) or None
            if training and layer.weight_noise is not None and \
                    lrng is not None and lp:
                lrng, wn_rng = lrng.split()
                lp = layer.weight_noise.apply(lp, wn_rng)
            if i == n - 1 and want_logits and \
                    isinstance(layer, BaseOutputLayer) and \
                    layer.wants_logits():
                h, ns = layer.forward_logits(lp, h, training=training,
                                             rng=lrng, state=ls)
            elif mask is not None and layer.accepts_mask():
                h, ns = layer.forward(lp, h, training=training, rng=lrng,
                                      state=ls, mask=mask)
            else:
                h, ns = layer.forward(lp, h, training=training, rng=lrng,
                                      state=ls)
            return h, ns or {}

        def run_segment(lo, hi, h):
            ns = {}
            for i in range(lo, hi):
                if training:
                    with layerprof.scope(f"layer_{i}"):
                        h, ns[f"layer_{i}"] = run_layer(i, h)
                else:
                    h, ns[f"layer_{i}"] = run_layer(i, h)
            return h, ns

        new_states = {}
        h = x
        sliced = start_at != 0 or stop_at is not None
        if training and conf.remat_segments > 1 and n > 1 and not sliced:
            for lo, hi, wrap in segment_plan(n, conf.remat_segments):
                if wrap:
                    h, ns = checkpoint(run_segment, lo, hi, h,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
                else:
                    h, ns = run_segment(lo, hi, h)
                new_states.update(ns)
        else:
            h, new_states = run_segment(
                start_at, n if stop_at is None else min(stop_at, n), h)
        if conf.compute_dtype:
            h = h.to(self._dtype)
            new_states = cast_floats(new_states, self._dtype)
        return h, new_states

    # ------------------------------------------------------------------
    def _as_input(self, x) -> torch.Tensor:
        return as_device_tensor(x, self._dtype, self.device)

    def _as_mask(self, m) -> Optional[torch.Tensor]:
        return self._as_input(m) if m is not None else None

    def output(self, x, train: bool = False, mask=None) -> torch.Tensor:
        """Forward on ``self.device``; ``mask`` is the ``[b, t]`` features
        mask of a sequence batch. ``train=True`` runs the training
        forward without a key (batch statistics, no dropout) and keeps
        no state."""
        if not self._initialized:
            self.init()
        with torch.inference_mode():
            out, _ = self._forward(self.dense_params(), self.states,
                                   self._as_input(x), training=train,
                                   mask=self._as_mask(mask))
        return out

    def feed_forward(self, x, train: bool = False) -> list:
        """Every layer's activation, the input first (reference:
        feedForward), in the compute dtype; ``train`` as in
        ``output``."""
        if not self._initialized:
            self.init()
        conf = self.conf
        h = self._as_input(x)
        params = self.dense_params()
        if conf.compute_dtype:
            cd = to_torch_dtype(conf.compute_dtype)
            params = cast_floats(params, cd)
            if h.is_floating_point():
                h = h.to(cd)
        acts = [h]
        with torch.inference_mode():
            for i, layer in enumerate(conf.layers):
                if i in conf.input_preprocessors:
                    h = conf.input_preprocessors[i].pre_process(h)
                h, _ = layer.forward(params.get(f"layer_{i}", {}), h,
                                     training=train,
                                     state=self.states.get(f"layer_{i}")
                                     or None)
                acts.append(h)
        return acts

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions (reference: predict)."""
        return self.output(x).argmax(-1).cpu().numpy()

    # -- training --------------------------------------------------------
    def _split(self, data, labels):
        if labels is None:
            x, y = data.features, data.labels
            lmask = getattr(data, "labels_mask", None)
            fmask = getattr(data, "features_mask", None)
        else:
            x, y, lmask, fmask = data, labels, None, None
        return ([self._as_input(x)], [self._as_input(y)],
                [self._as_mask(lmask)] if lmask is not None else None,
                self._as_mask(fmask))

    def _loss(self, params, states, inputs, labels, lmasks, fmask=None, *,
              training: bool, rng=None):
        out_layer = self.output_layer_conf
        want_logits = out_layer.wants_logits()
        out, new_states = self._forward(params, states, inputs[0],
                                        training=training, rng=rng,
                                        want_logits=True, mask=fmask)
        # the loss and the regularization belong to no layer: named
        with layerprof.scope("loss"):
            data_loss = out_layer.compute_loss(
                labels[0], out, from_logits=want_logits,
                mask=lmasks[0] if lmasks is not None else None)
            return data_loss + self._regularization(params), new_states

    # -- stateful streaming inference ------------------------------------
    def rnn_time_step(self, x) -> torch.Tensor:
        """Feed one step (``[b, f]``, answered as ``[b, n_out]``) or a
        chunk (``[b, t, f]``) of a sequence, carrying the recurrent state
        across calls (reference: rnnTimeStep)."""
        self._refuse_bidirectional("networks")
        if not self._initialized:
            self.init()
        x = self._as_input(x)
        single_step = x.dim() == 2
        if single_step:
            x = x[:, None, :]
        states = self._stream_states(int(x.shape[0]))
        with torch.inference_mode():
            out, new_states = self._forward(self.dense_params(), states, x)
        self._keep_stream(new_states)
        if single_step and out.dim() == 3:
            out = out[:, -1]
        return out

    def rnn_get_previous_state(self, layer_idx: int) -> Optional[dict]:
        if self._rnn_stream_states is None:
            return None
        return self._rnn_stream_states.get(f"layer_{layer_idx}")

    # -- evaluation ------------------------------------------------------
    def evaluate(self, iterator):
        """Classification evaluation (reference: evaluate(iterator)):
        outputs under each batch's features mask, counted under its
        labels mask."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation
        ev = Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            out = self.output(ds.features,
                              mask=getattr(ds, "features_mask", None))
            ev.eval(ds.labels, out, mask=getattr(ds, "labels_mask", None))
        return ev

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.evaluation import RegressionEvaluation
        ev = RegressionEvaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            out = self.output(ds.features)
            ev.eval(ds.labels, out, mask=getattr(ds, "labels_mask", None))
        return ev

    def num_params(self) -> int:
        return int(sum(t.numel() for sub in self.dense_params().values()
                       for t in sub.values()))

    def param_table(self) -> dict:
        """``{"<i>_<name>": tensor}``: each layer's parameters, then its
        states (the reference's paramTable naming). Conv kernels are
        OIHW, the port's layout."""
        out = {}
        params = self.dense_params()
        for i in range(self.n_layers()):
            for tree in (params, self.states):
                for name, t in (tree.get(f"layer_{i}") or {}).items():
                    out[f"{i}_{name}"] = t
        return out

    def get_param(self, key: str) -> torch.Tensor:
        i, name = key.split("_", 1)
        return self.dense_params()[f"layer_{i}"][name]

    def set_params_from_table(self, table: dict) -> None:
        """Copy each ``"<i>_<name>"`` entry into that layer's parameter or
        state of the name, in place; an entry naming neither is
        ignored."""
        with torch.no_grad():
            for key, value in table.items():
                i, name = key.split("_", 1)
                for tree in (self.params, self.states):
                    sub = tree.get(f"layer_{i}") or {}
                    if name in sub:
                        sub[name].copy_(torch.as_tensor(np.asarray(value))
                                        if not isinstance(value,
                                                          torch.Tensor)
                                        else value)
                        break

    def clone(self) -> "MultiLayerNetwork":
        """A network of a copy of the configuration with copies of the
        parameters, states and updater state (not the counters), on the
        same device."""
        net = MultiLayerNetwork(copy.deepcopy(self.conf))
        if self._initialized:
            net.set_params(clone_tree(self.dense_params()),
                           clone_tree(self.states),
                           self.device)
            net.updater_states = clone_tree(self.updater_states)
        return net

    def summary(self) -> str:
        lines = [f"{'idx':<4} {'type':<24} {'nIn->nOut':<14} {'params':<10}"]
        total = 0
        params = self.dense_params()
        for i, layer in enumerate(self.conf.layers):
            n = int(sum(t.numel() for t in
                        params.get(f"layer_{i}", {}).values()))
            total += n
            lines.append(f"{i:<4} {type(layer).__name__:<24} "
                         f"{layer.n_in}->{layer.n_out:<10} {n:<10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)
