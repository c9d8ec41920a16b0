"""ComputationGraph: a DAG model run vertex by vertex.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` on one device:
``init``, the topo-ordered walk of ``_forward`` (without tensor
parallelism; under fsdp it reads the parameters through
``parallel/zero.FsdpParamView``), ``output`` / ``outputs`` / ``predict``,
``evaluate`` / ``evaluate_regression``, ``rnn_time_step`` with
``rnn_{get,set,clear}_previous_state``, ``param_table``, ``summary``,
and training: ``fit(x, y)``, ``fit(DataSet)``, ``fit(iterator)``,
``fit_steps``, ``score()``, listeners, truncated BPTT, gradient
accumulation and the dense update tail (``nn/trainer.py``). PyTorch
runs eagerly, so there is no compiled step: each vertex's layer runs as
its own kernels, in order, on ``self.device``, and autograd walks back
through them.

A layer vertex's input passes its preprocessor first. The features mask
is the first network input's (a DataSet's ``features_mask``, a
MultiDataSet's ``features_masks[0]``, ``output(..., mask=)``): as in the
JAX package it is handed unchanged to every layer that accepts one, and
is not propagated (after a layer that changes the time axis, such as
``LearnedSelfAttentionLayer``, no mask-taking layer should follow).

Training draws from a per-step ``RngKey`` folded with each layer's
position among the layer vertices of the topo order (the JAX package's
derivation): the layer's input dropout, then its weight noise. With
``conf.remat_segments > 1`` the training walk runs in that many
contiguous segments of the topo order (``common/remat.py``), each but
the last under ``torch.utils.checkpoint``; only the activations live
at a segment boundary (consumed later, or a network output) cross it,
and a segment's interior is recomputed in the backward with the same
keys. The first forward's states are the ones kept.
``output(train=True)`` runs the training forward without a key.

``params`` and ``states`` are ``{vertex: {name: tensor}}``, as in the
JAX package. With ``compute_dtype`` set ('bfloat16', 'float16') the
forward casts the float parameters and the inputs to it, keeps the
BatchNormalization running stats in float32, and casts the outputs back
to ``dtype``. Float64 activations run on the CPU only: the epilogue
kernels do not stream them, and ``set_params`` refuses them on cuda.
``updater_states`` is ``{vertex: {slot: {name: tensor}}}``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.common import layerprof
from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.common.remat import segment_plan
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputTypeRecurrent
from deeplearning4j_tpu_torch.nn.conf.layers import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.trainer import Trainable
from deeplearning4j_tpu_torch.parallel.zero import FsdpParamView

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16}


def to_torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r} "
                         f"(one of {sorted(_DTYPES)})") from None


def cast_floats(tree: dict, dtype: torch.dtype) -> dict:
    """Cast every floating tensor of a ``{vertex: {name: tensor}}``
    tree to ``dtype`` (an fsdp view casts each group as it gathers
    it)."""
    if isinstance(tree, FsdpParamView):
        return tree.cast(dtype)
    return {k: {n: (t.to(dtype) if t.is_floating_point() else t)
                for n, t in sub.items()} for k, sub in tree.items()}


def check_activation_dtype(conf, dev: torch.device) -> None:
    """Refuse float64 activations on the card, where the epilogue
    kernels stream float32, bfloat16 and float16 only."""
    act_dtype = to_torch_dtype(conf.compute_dtype or conf.dtype)
    if dev.type == "cuda" and act_dtype == torch.float64:
        raise ValueError(
            "float64 activations do not run on cuda: the epilogue "
            "kernels stream float32, bfloat16 and float16 (set "
            "compute_dtype, or pass device='cpu')")


def as_device_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """An array or tensor on ``device``, floats cast to ``dtype``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def clone_tree(tree):
    """A copy of a nested dict / list / tuple of tensors, each tensor
    cloned."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def ds_features_mask(ds):
    """A DataSet's or MultiDataSet's features mask: the first input's."""
    ms = getattr(ds, "features_masks", None)
    if ms:
        return ms[0]
    return getattr(ds, "features_mask", None)


def ds_labels_masks(ds):
    """A DataSet's or MultiDataSet's labels masks, one per output, or
    None."""
    ms = getattr(ds, "labels_masks", None)
    if ms is not None:
        return ms
    lm = getattr(ds, "labels_mask", None)
    return [lm] if lm is not None else None


def _as_list(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v]


class ComputationGraph(Trainable):

    _FUNNEL = "ComputationGraph"

    def _layer_types(self) -> dict:
        return {layerprof.sanitize(n):
                type(self.conf.vertices[n].content).__name__
                for n in self._topo}

    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.states: Dict[str, Dict[str, torch.Tensor]] = {}
        self._init_training()
        self.device: Optional[torch.device] = None
        self._dtype = to_torch_dtype(conf.dtype)
        self._topo = conf.topo_order()
        #: each layer vertex's position among the layer vertices of the
        #: topo order: its key in a step is fold_in(rng, position)
        self._layer_pos = {n: i for i, n in enumerate(
            n for n in self._topo if conf.vertices[n].is_layer)}
        self._initialized = False

    # ------------------------------------------------------------------
    def init(self, device: Union[None, str, torch.device] = None, *,
             generator: Optional[torch.Generator] = None
             ) -> "ComputationGraph":
        """Initialise parameters and states on ``device`` (``None``: the
        card; see ``common.environment.resolve_device``). Values come
        from ``generator``, a CPU ``torch.Generator`` seeded from
        ``conf.seed`` when not given, so a seed gives the same weights
        on every device."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(self.conf.seed)
        types = self.conf.resolve_shapes()
        params, states = {}, {}
        for name in self._topo:
            v = self.conf.vertices[name]
            params[name], states[name] = {}, {}
            if not v.is_layer:
                continue
            in_type = types.get(v.inputs[0])
            if v.preprocessor is not None and in_type is not None:
                in_type = v.preprocessor.get_output_type(in_type)
            if v.content.has_params():
                params[name] = v.content.init_params(generator, in_type,
                                                     self._dtype)
            if v.content.has_state():
                states[name] = v.content.init_state(in_type, self._dtype)
        return self.set_params(params, states, dev)

    def set_params(self, params: dict, states: dict,
                   device: Union[None, str, torch.device] = None
                   ) -> "ComputationGraph":
        """Install ``params``/``states`` (``{vertex: {name: tensor}}``,
        every vertex of the graph present) on ``device``. Conv kernels
        are stored channels-last, the layout the NHWC activations
        convolve fastest against."""
        dev = resolve_device(device)
        check_activation_dtype(self.conf, dev)
        missing = [n for n in self._topo if n not in params]
        if missing:
            raise ValueError(f"params missing vertices {missing[:5]}")

        def place(t: torch.Tensor) -> torch.Tensor:
            t = t.to(dev)
            if t.dim() == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            return t

        self.params = {k: {n: place(t) for n, t in params[k].items()}
                       for k in self._topo}
        self.states = {k: {n: t.to(dev) for n, t in states.get(k, {})
                           .items()} for k in self._topo}
        self.device = dev
        self._initialized = True
        self._reset_updater_states()
        return self

    # -- Trainable protocol ----------------------------------------------
    def output_layer_confs(self) -> Dict[str, BaseOutputLayer]:
        """The output layers among the network's outputs, by vertex."""
        out = {}
        for name in self.conf.network_outputs:
            layer = self.conf.vertices[name].content
            if isinstance(layer, BaseOutputLayer):
                out[name] = layer
        return out

    def _keys(self):
        return self._topo

    def _layer(self, key):
        v = self.conf.vertices[key]
        return v.content if v.is_layer else None

    # ------------------------------------------------------------------
    def _forward(self, params, states, inputs: Sequence[torch.Tensor], *,
                 training: bool = False, rng=None,
                 want_logits: bool = False, fmask=None, start_acts=None,
                 topo_slice=None):
        """Walk in topo order; returns ``(acts, new_states)``: the
        activations by vertex name (network inputs included; an output
        layer that folds its softmax into the loss gives logits when
        ``want_logits``; the segmented walk keeps only those live at its
        end), and each stateful layer's new state (the blended
        BatchNormalization stats in training). ``rng`` is this step's
        key (None: no dropout and no weight noise); ``fmask`` the ``[b,
        t]`` features mask, given to every layer that accepts one.
        ``topo_slice=(lo, hi)`` walks only ``topo[lo:hi]``, a pipeline
        stage's slice (``parallel/pipeline.py``), with ``start_acts``
        (``{name: activation}``) the activations earlier stages hand
        over; each layer's key stays folded on its position in the whole
        topo order."""
        conf = self.conf
        if conf.compute_dtype:
            cd = to_torch_dtype(conf.compute_dtype)
            params = cast_floats(params, cd)
            inputs = [x.to(cd) if x.is_floating_point() else x
                      for x in inputs]
            if start_acts is not None:
                start_acts = {k: (a.to(cd) if a.is_floating_point() else a)
                              for k, a in start_acts.items()}
        layer_pos = self._layer_pos

        def run_vertex(name, acts):
            v = conf.vertices[name]
            xs = [acts[i] for i in v.inputs]
            if not v.is_layer:
                return v.content.forward(xs, training=training), None
            layer = v.content
            h = xs[0]
            if v.preprocessor is not None:
                h = v.preprocessor.pre_process(h)
            lrng = rng.fold_in(layer_pos[name]) if rng is not None \
                else None
            lp, ls = params.get(name, {}), states.get(name) or None
            if training and layer.weight_noise is not None and \
                    lrng is not None and lp:
                lrng, wn_rng = lrng.split()
                lp = layer.weight_noise.apply(lp, wn_rng)
            if want_logits and name in conf.network_outputs and \
                    isinstance(layer, BaseOutputLayer) and \
                    layer.wants_logits():
                h, ns = layer.forward_logits(lp, h, training=training,
                                             rng=lrng, state=ls)
            else:
                kw = {"mask": fmask} if fmask is not None and \
                    layer.accepts_mask() else {}
                h, ns = layer.forward(lp, h, training=training, rng=lrng,
                                      state=ls, **kw)
            return h, ns or {}

        def run_segment(names, in_acts, out_names):
            acts = dict(in_acts)
            ns = {}
            for name in names:
                if training:
                    with layerprof.scope(name):
                        acts[name], s_ = run_vertex(name, acts)
                else:
                    acts[name], s_ = run_vertex(name, acts)
                if s_ is not None:
                    ns[name] = s_
            return {k: acts[k] for k in out_names}, ns

        acts = dict(zip(conf.network_inputs, inputs))
        if start_acts is not None:
            acts.update(start_acts)
        topo = self._topo
        if topo_slice is not None:
            topo = topo[topo_slice[0]:topo_slice[1]]
            acts, new_states = run_segment(topo, acts, list(acts) + topo)
        elif training and conf.remat_segments > 1 and len(topo) > 1:
            new_states = {}
            for lo, hi, wrap, seg_in, seg_out in self._segments():
                seg = topo[lo:hi]
                args = (seg, {k: acts[k] for k in seg_in}, seg_out)
                outs, ns = (checkpoint(run_segment, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
                            if wrap else run_segment(*args))
                keep = self._live_after(hi)
                acts = {k: a for k, a in acts.items() if k in keep}
                acts.update(outs)
                new_states.update(ns)
        else:
            acts, new_states = run_segment(topo, acts,
                                           list(conf.network_inputs) + topo)
        if conf.compute_dtype:
            for out in conf.network_outputs:
                if out in acts:
                    acts[out] = acts[out].to(self._dtype)
        return acts, new_states

    def _live_after(self, end: int) -> set:
        """The activations a later vertex (at topo position >= ``end``)
        consumes, and the network outputs."""
        keep = set(self.conf.network_outputs)
        for name in self._topo[end:]:
            keep.update(self.conf.vertices[name].inputs)
        return keep

    def _segments(self):
        """``(lo, hi, wrap, seg_in, seg_out)`` for each segment of the
        remat plan: the activations a segment reads from before it, and
        those it produces that are live after it."""
        out = []
        for lo, hi, wrap in segment_plan(len(self._topo),
                                         self.conf.remat_segments):
            seg = self._topo[lo:hi]
            refs = {src for n in seg for src in self.conf.vertices[n].inputs}
            seg_in = sorted(refs - set(seg))
            seg_out = sorted(set(seg) & self._live_after(hi))
            out.append((lo, hi, wrap, seg_in, seg_out))
        return out

    def _as_input(self, x) -> torch.Tensor:
        return as_device_tensor(x, self._dtype, self.device)

    def _as_mask(self, m) -> Optional[torch.Tensor]:
        return self._as_input(m) if m is not None else None

    def output(self, *inputs, train: bool = False, mask=None):
        """Output activations on ``self.device`` (a tensor, or a list
        with one per network output). ``inputs`` are NHWC arrays or
        tensors, one per network input; ``mask`` the ``[b, t]``
        features mask. ``train=True`` runs the training forward without
        a key (batch statistics, no dropout) and keeps no state."""
        if not self._initialized:
            self.init()
        xs = [self._as_input(x) for x in inputs]
        with torch.inference_mode():
            acts, _ = self._forward(self.dense_params(), self.states, xs,
                                    training=train,
                                    fmask=self._as_mask(mask))
        outs = [acts[n] for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def outputs(self, *inputs, train: bool = False, mask=None) -> list:
        """``output`` as a list whatever the number of network outputs
        (reference: output returns INDArray[])."""
        out = self.output(*inputs, train=train, mask=mask)
        return out if isinstance(out, list) else [out]

    def predict(self, *inputs) -> np.ndarray:
        """Argmax class predictions of the first output."""
        return self.outputs(*inputs)[0].argmax(-1).cpu().numpy()

    # -- stateful streaming inference ------------------------------------
    def rnn_time_step(self, *inputs):
        """Feed one step (2-dim recurrent inputs, answered with each
        output's last step) or a chunk (3-dim) of a sequence through the
        graph, carrying every recurrent vertex's state across calls
        (reference: rnnTimeStep). Inputs declared feed-forward pass as
        they are."""
        self._refuse_bidirectional("graphs")
        if not self._initialized:
            self.init()
        xs = [self._as_input(x) for x in inputs]
        rec = [isinstance(t, InputTypeRecurrent)
               for t in self.conf.input_types] or [True] * len(xs)
        if len(rec) != len(xs):
            raise ValueError(f"rnnTimeStep got {len(xs)} inputs for "
                             f"{len(rec)} declared network inputs")
        single_step = all(x.dim() == 2 for x, r in zip(xs, rec) if r)
        xs = [x[:, None, :] if r and x.dim() == 2 else x
              for x, r in zip(xs, rec)]
        states = self._stream_states(int(xs[0].shape[0]))
        with torch.inference_mode():
            acts, new_states = self._forward(self.dense_params(), states, xs)
        self._keep_stream(new_states)
        outs = [acts[n] for n in self.conf.network_outputs]
        if single_step:
            outs = [o[:, -1] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_get_previous_state(self, vertex_name: str) -> Optional[dict]:
        if self._rnn_stream_states is None:
            return None
        return self._rnn_stream_states.get(vertex_name)

    def rnn_set_previous_state(self, vertex_name: str, state: dict) -> None:
        """Overwrite one recurrent vertex's streaming state (reference:
        rnnSetPreviousState); the batch size comes from the state."""
        if not self._initialized:
            self.init()
        if vertex_name not in self._recurrent_keys():
            raise ValueError(f"'{vertex_name}' is not a recurrent vertex "
                             f"(recurrent: {self._recurrent_keys()})")
        if not state:
            raise ValueError("cannot infer batch size from an empty state "
                             "dict")
        batch = int(next(iter(state.values())).shape[0])
        states = self._stream_states(batch, "rnnSetPreviousState")
        self._rnn_stream_states = {**states, vertex_name: {
            n: self._as_input(t) for n, t in state.items()}}

    # -- training --------------------------------------------------------
    def _split(self, data, labels):
        """(inputs, labels, labels masks, features mask) as tensors on
        the device, from ``(x, y)`` (arrays, tensors or lists of them) or
        a DataSet / MultiDataSet."""
        if labels is None:
            feats, labs = data.features, data.labels
            lmasks, fmask = ds_labels_masks(data), ds_features_mask(data)
        else:
            feats, labs, lmasks, fmask = data, labels, None, None
        inputs = [self._as_input(x) for x in _as_list(feats)]
        labels = [self._as_input(y) for y in _as_list(labs)]
        if lmasks is not None:
            lmasks = [self._as_mask(m) for m in lmasks]
        return inputs, labels, lmasks, self._as_mask(fmask)

    def _loss(self, params, states, inputs, labels, lmasks, fmask=None, *,
              training: bool, rng=None):
        acts, new_states = self._forward(params, states, inputs,
                                         training=training, rng=rng,
                                         want_logits=True, fmask=fmask)
        # the loss and the regularization belong to no layer: named
        with layerprof.scope("loss"):
            loss = self._regularization(params)
            for i, name in enumerate(self.conf.network_outputs):
                layer = self.conf.vertices[name].content
                if not isinstance(layer, BaseOutputLayer):
                    continue
                loss = loss + layer.compute_loss(
                    labels[i], acts[name],
                    from_logits=layer.wants_logits(),
                    mask=lmasks[i] if lmasks is not None else None)
        return loss, new_states

    # -- evaluation ------------------------------------------------------
    def _eval_batches(self, iterator):
        """``(labels, output, labels mask)`` of the first network output
        per batch, the output under the batch's features mask."""
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            out = self.outputs(*_as_list(ds.features),
                               mask=ds_features_mask(ds))[0]
            lmasks = ds_labels_masks(ds)
            yield (_as_list(ds.labels)[0], out,
                   lmasks[0] if lmasks else None)

    def evaluate(self, iterator):
        """Classification evaluation of the first output (reference:
        evaluate(iterator))."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation
        ev = Evaluation()
        for labels, out, lmask in self._eval_batches(iterator):
            ev.eval(labels, out, mask=lmask)
        return ev

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.evaluation import RegressionEvaluation
        ev = RegressionEvaluation()
        for labels, out, lmask in self._eval_batches(iterator):
            ev.eval(labels, out, mask=lmask)
        return ev

    # ------------------------------------------------------------------
    def num_params(self) -> int:
        return int(sum(t.numel() for sub in self.dense_params().values()
                       for t in sub.values()))

    def param_table(self) -> dict:
        """``{"<vertex>_<name>": tensor}`` in topo order (conv kernels
        OIHW, the port's layout)."""
        params = self.dense_params()
        return {f"{name}_{n}": t for name in self._topo
                for n, t in params.get(name, {}).items()}

    def summary(self) -> str:
        lines = [f"{'vertex':<28} {'type':<22} {'inputs':<28} "
                 f"{'params':<10}"]
        total = 0
        params = self.dense_params()
        for name in self._topo:
            v = self.conf.vertices[name]
            n = int(sum(t.numel() for t in params.get(name,
                                                           {}).values()))
            total += n
            lines.append(f"{name:<28} {type(v.content).__name__:<22} "
                         f"{','.join(v.inputs):<28} {n:<10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)
