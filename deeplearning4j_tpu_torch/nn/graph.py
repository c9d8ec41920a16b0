"""ComputationGraph: a DAG model run vertex by vertex.

Counterpart of ``deeplearning4j_tpu/nn/graph.py`` on one device:
``init``, the topo-ordered walk of ``_forward`` (without tensor
parallelism, fsdp or features masks, which ``fit``, ``score`` and
``evaluate`` refuse), ``output``, ``evaluate`` /
``evaluate_regression``, and training: ``fit(x, y)``,
``fit(DataSet)``, ``fit(iterator)``, ``score()``, listeners, gradient
accumulation and the dense update tail (``nn/trainer.py``). PyTorch
runs eagerly, so there is no compiled step: each vertex's layer runs as
its own kernels, in order, on ``self.device``, and autograd walks back
through them.

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

from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.common.remat import segment_plan
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import BaseOutputLayer
from deeplearning4j_tpu_torch.nn.trainer import Trainable

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
    tree to ``dtype``."""
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


def _refuse_features_mask(ds) -> None:
    masks = getattr(ds, "features_masks", None) or [
        getattr(ds, "features_mask", None)]
    if any(m is not None for m in masks):
        raise NotImplementedError(
            "features masks in a ComputationGraph are not ported yet "
            "(ROADMAP.md, Queue A item 15)")


class ComputationGraph(Trainable):
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
    def _keys(self):
        return self._topo

    def _layer(self, key):
        v = self.conf.vertices[key]
        return v.content if v.is_layer else None

    # ------------------------------------------------------------------
    def _forward(self, params, states, inputs: Sequence[torch.Tensor], *,
                 training: bool = False, rng=None,
                 want_logits: bool = False):
        """Walk in topo order; returns ``(acts, new_states)``: the
        activations by vertex name (network inputs included; an output
        layer that folds its softmax into the loss gives logits when
        ``want_logits``; the segmented walk keeps only those live at its
        end), and each stateful layer's new state (the blended
        BatchNormalization stats in training). ``rng`` is this step's
        key (None: no dropout and no weight noise)."""
        conf = self.conf
        if conf.compute_dtype:
            cd = to_torch_dtype(conf.compute_dtype)
            params = cast_floats(params, cd)
            inputs = [x.to(cd) if x.is_floating_point() else x
                      for x in inputs]
        layer_pos = self._layer_pos

        def run_vertex(name, acts):
            v = conf.vertices[name]
            xs = [acts[i] for i in v.inputs]
            if not v.is_layer:
                return v.content.forward(xs, training=training), None
            layer = v.content
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
                h, ns = layer.forward_logits(lp, xs[0], training=training,
                                             rng=lrng, state=ls)
            else:
                h, ns = layer.forward(lp, xs[0], training=training,
                                      rng=lrng, state=ls)
            return h, ns or {}

        def run_segment(names, in_acts, out_names):
            acts = dict(in_acts)
            ns = {}
            for name in names:
                acts[name], s_ = run_vertex(name, acts)
                if s_ is not None:
                    ns[name] = s_
            return {k: acts[k] for k in out_names}, ns

        acts = dict(zip(conf.network_inputs, inputs))
        topo = self._topo
        if training and conf.remat_segments > 1 and len(topo) > 1:
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

    def output(self, *inputs, train: bool = False):
        """Output activations on ``self.device`` (a tensor, or a list
        with one per network output). ``inputs`` are NHWC arrays or
        tensors, one per network input. ``train=True`` runs the
        training forward without a key (batch statistics, no dropout)
        and keeps no state."""
        if not self._initialized:
            self.init()
        xs = [self._as_input(x) for x in inputs]
        with torch.inference_mode():
            acts, _ = self._forward(self.params, self.states, xs,
                                    training=train)
        outs = [acts[n] for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    # -- training --------------------------------------------------------
    def _split(self, data, labels):
        """(inputs, labels, labels masks) as tensors on the device, from
        ``(x, y)`` (arrays, tensors or lists of them) or a DataSet /
        MultiDataSet. A features mask is refused: ``fit`` and ``score``
        would treat the padded steps as real data (ROADMAP item 15
        ports the masks)."""
        if labels is None:
            _refuse_features_mask(data)
            feats, labs = data.features, data.labels
            lmasks = getattr(data, "labels_masks", None)
            if lmasks is None and getattr(data, "labels_mask",
                                          None) is not None:
                lmasks = [data.labels_mask]
        else:
            feats, labs, lmasks = data, labels, None
        def as_list(v):
            return list(v) if isinstance(v, (list, tuple)) else [v]
        inputs = [self._as_input(x) for x in as_list(feats)]
        labels = [self._as_input(y) for y in as_list(labs)]
        if lmasks is not None:
            lmasks = [self._as_input(m) if m is not None else None
                      for m in lmasks]
        return inputs, labels, lmasks

    def _loss(self, params, states, inputs, labels, lmasks, fmask=None, *,
              training: bool, rng=None):
        # ``fmask`` is always None: ``_split`` refuses features masks
        acts, new_states = self._forward(params, states, inputs,
                                         training=training, rng=rng,
                                         want_logits=True)
        loss = self._regularization(params)
        for i, name in enumerate(self.conf.network_outputs):
            layer = self.conf.vertices[name].content
            if not isinstance(layer, BaseOutputLayer):
                continue
            loss = loss + layer.compute_loss(
                labels[i], acts[name], from_logits=layer.wants_logits(),
                mask=lmasks[i] if lmasks is not None else None)
        return loss, new_states

    # -- evaluation ------------------------------------------------------
    def _eval_batches(self, iterator):
        """``(labels, output)`` of the first network output per batch,
        with the labels mask."""
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            _refuse_features_mask(ds)
            feats = ds.features if isinstance(ds.features, list) \
                else [ds.features]
            out = self.output(*feats)
            if isinstance(out, list):
                out = out[0]
            labels = ds.labels[0] if isinstance(ds.labels, list) \
                else ds.labels
            lmasks = getattr(ds, "labels_masks", None)
            lmask = lmasks[0] if lmasks else getattr(ds, "labels_mask",
                                                     None)
            yield labels, out, lmask

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
        return int(sum(t.numel() for sub in self.params.values()
                       for t in sub.values()))
