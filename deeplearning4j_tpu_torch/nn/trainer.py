"""The training step shared by ComputationGraph and MultiLayerNetwork.

Counterpart of the dense rung of ``_build_train_step`` in
``deeplearning4j_tpu/nn/graph.py`` and ``nn/multilayer.py``: the loss
(data loss plus ``_regularization``, l1 and 0.5·l2·ΣW² on each layer's
``W`` only, inside the loss), its gradient with respect to every
parameter, and the per-layer update tail: gradient normalization, the
layer's updater (its own, or the network's), ``p − update``, then the
layer's constraints. PyTorch runs eagerly, so the step is this code run
once per batch rather than a compiled program; ``torch.autograd.grad``
takes the place of ``jax.value_and_grad``.

Parameters are updated in place (``p.sub_``) under ``no_grad``: the
stored tensors keep their storage and layout (conv kernels channels-last)
and no second copy of the weights is made. Updater state is replaced
slot by slot, as the JAX package returns it.

A subclass provides ``_keys()`` (its parameter groups in order),
``_layer(key)``, ``_loss(params, states, inputs, labels, lmasks,
fmask, training=, rng=)`` returning ``(loss, new_states)``, and
``_split(data)`` turning ``(x, y)`` or a DataSet into ``(inputs, labels,
lmasks, fmask)`` on the device. ``_train_step`` is one update from
given states. ``_fit_batch`` runs it from ``self.states`` with every
recurrent layer's state zeroed for the batch, then keeps each non-empty
new state (BatchNormalization's running stats) and drops the recurrent
ones, as the JAX package does: each batch is a fresh sequence, and
nothing of it leaks into the next batch or into ``output``. With
``backprop_type=TRUNCATED_BPTT`` a sequence batch (a 3-dim first input)
trains as segments of ``tbptt_fwd_length`` steps, one update and one
iteration each, every input, label and mask with a time axis cut, the
state carried from segment to segment and detached between them (the
truncation); the listeners fire once a batch. ``fit_steps`` is a plain
loop of ``_train_step`` on one batch, the recurrent state carried from
step to step, as the JAX package's compiled loop does.

``rnn_time_step`` (on each network kind) streams a sequence a step or a
chunk at a time; the state it carries across calls lives here until
``rnn_clear_previous_state``.

Random streams: each step takes a fresh key from ``self._rng`` (an
``RngKey`` seeded from ``conf.seed``; ``common/rng.py``), which the
network folds with each layer's index for its dropout and weight noise.

Gradient accumulation (``set_accumulation_steps(n)``, the reference's
GradientsAccumulator): each fit batch is a micro-batch whose gradients
are summed; the update tail runs once a window on their mean, with the
updater's iteration counting the updates applied (so Adam's bias
correction sees update indices). Per micro-batch, as in the JAX package,
the states are kept, the score is set, ``iteration_count`` advances and
the listeners fire. A partial window is applied at each epoch's end
and when the window size changes (``flush_accumulated``).

Learning-rate schedules see ``iteration`` (or, under accumulation, the
updates applied) and ``epoch_count``.

``fit(iterator)`` stages the batches through
``datasets/prefetch.maybe_device_prefetch``: a feeder thread runs the
ETL and copies each batch to the device ahead of the step, as the JAX
package's fit funnels do (``DL4J_TORCH_DEVICE_PREFETCH=0`` turns it
off; the trajectories are the same bits either way).

The training observatory (``common/telemetry.py``, ``stepstats.py``,
``diagnostics.py``, ``layerprof.py``) sees every step as the JAX
package's funnels show it, under the model name ``"MultiLayerNetwork"``
or ``"ComputationGraph"``: a ``step_span`` around each fit step
(``dl4j_train_step_seconds``, a ``train_step`` trace span) and then
``diagnostics.after_step`` (the step's phase breakdown closed, a
flight-recorder record, and the numerics watchdog on the loss and, while
it is armed, the global gradient norm); under accumulation the watchdog
checks each micro-batch's gradients before they join the window and
``record_step`` records; each tBPTT segment records with its
``tbptt_segment``; ``fit_steps`` is one span and one record over its
loop. Each layer or vertex of the training forward, the loss and the
update tail run in ``layerprof.scope``s, and ``layer_report`` charges
one step's work to them. A replica copy that a ParallelWrapper steps
beside the wrapped model records nothing (``_observe``): the wrapped
model's records are the global step's, as the JAX package's one
program's are. None of it changes what the step computes.

Data parallelism (``set_dp_mesh``, the JAX package's): the model is one
replica of a mesh (``parallel/mesh.py``) and trains on its shard of the
global batch. Its training forward runs with the replica current
(``replica_scope``), so BatchNormalization takes its statistics over the
global batch. Its loss is its own rows' mean loss plus the
regularization; the update exchange (``parallel/zero.py``) applies the
mean of the replicas' gradients, so the regularization counts once, and
the score is the replicas' mean loss. The dense exchange all-reduces the
gradients before the per-key update tail; the sharded one (ZeRO-1)
replaces that tail with the flat reduce-scatter / update / all-gather of
``zero.apply_update_sharded``, each replica holding 1/N of the updater
state; the encoded one compresses the mean-gradient slice under error
feedback before the updater (``zero.apply_update_encoded``, the residual
1/N a replica too); under fsdp (ZeRO-3) the parameters themselves are
the replica's slices of the flats: the loss reads them through
``zero.FsdpParamView`` (a group gathered at its first use, its gradient
reduce-scattered in the backward) and ``zero.apply_update_fsdp`` updates
the slices in place. Every path outside the training step reads
``dense_params()``, which under fsdp gathers the slices: a collective,
which every replica of the mesh calls. Under accumulation the exchange
runs once a window, on the mean gradient. An encoded run's
error-feedback state stays in the updater state between fits (in the
dense layout once unbound) and is dropped when the model steps under any
other exchange.

Tensor parallelism (``set_dp_mesh(..., tp_specs=)``, the specs of
``parallel/speclayout.py``): on a mesh with a ``model`` axis (or a
``pipe`` axis) the model's replica is its data group
(``parallel/mesh.AxisReplica``), so the update exchange, the mean loss
and BatchNormalization's statistics run over the data group only. Each
tensor-parallel leaf is held as the replica's shard (the flats of the
ZeRO tails never hold one); the loss reads it gathered whole through
``zero.pin_tp_entry`` (under fsdp through ``FsdpParamView``), whose
backward leaves the replica's own slice of the gradient; the tails
update the shards with ``zero.apply_update_tp`` (the dense tail with the
layer's own updater on the shards, gathering them only where gradient
normalization or a constraint needs the whole leaf). Unbinding gathers
the leaves and their state back to the dense layout.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.common import diagnostics, layerprof, telemetry
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.datasets.prefetch import maybe_device_prefetch
from deeplearning4j_tpu_torch.learning.updaters import (FSDP_KEY, TP_KEY,
                                                        is_encoded, is_fsdp,
                                                        tree_leaves, tree_map)
from deeplearning4j_tpu_torch.nn.conf.builders import BackpropType
from deeplearning4j_tpu_torch.nn.conf.constraints import apply_constraints
from deeplearning4j_tpu_torch.nn.gradient import \
    apply_gradient_normalization
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.encoding import resolve_encoding
from deeplearning4j_tpu_torch.parallel.mesh import (Replica,
                                                    canonical_device,
                                                    replica_scope)

_Tree = Dict[str, Dict[str, torch.Tensor]]


class Trainable:
    """fit / score / listeners / updater state over ``self.params``."""

    params: _Tree
    states: _Tree

    def _init_training(self) -> None:
        self.updater_states: Dict[str, dict] = {}
        self.listeners: List[TrainingListener] = []
        self.iteration_count = 0
        self.epoch_count = 0
        self.last_batch_size = 0
        self._score: Optional[torch.Tensor] = None
        self._rng = RngKey(self.conf.seed)
        self._accum_steps = 1
        self._accum_grads: Optional[_Tree] = None
        self._accum_count = 0
        self._updates_applied = 0
        self._replica: Optional[Replica] = None
        self._dp_mode: Optional[zero.UpdateExchange] = None
        self._dp_encoding = None
        self._fsdp_specs: dict = {}
        #: {entry: {name: TpLeafSpec}} while bound with tensor parallelism,
        #: and the replica of the whole mesh its collectives run through
        self._tp_specs: dict = {}
        self._tp_replica: Optional[Replica] = None
        self._rnn_stream_states: Optional[_Tree] = None
        self._rnn_stream_batch = 0
        self._observe = True
        self._last_gnorm: Optional[torch.Tensor] = None
        #: the last fit batch's input and label shapes (layer_report)
        self._layerprof_shapes = None

    def _next_key(self) -> RngKey:
        """This step's random key; the stream advances."""
        self._rng, key = self._rng.split()
        return key

    def _reset_updater_states(self) -> None:
        self.updater_states = {k: self._updater(k).init_state(
            self.params.get(k, {})) for k in self._keys()}

    def _updater(self, key: str):
        layer = self._layer(key)
        if layer is not None and layer.updater is not None:
            return layer.updater
        return self.conf.updater

    # ------------------------------------------------------------------
    def set_listeners(self, *listeners: TrainingListener):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners: TrainingListener):
        self.listeners.extend(listeners)
        return self

    def _regularization(self, params: _Tree):
        reg = 0.0
        for key in self._keys():
            layer = self._layer(key)
            if layer is None:
                continue
            l1, l2 = layer.l1 or 0.0, layer.l2 or 0.0
            W = params.get(key, {}).get("W")
            if W is None or (l1 == 0.0 and l2 == 0.0):
                continue
            if l1:
                reg = reg + l1 * torch.sum(torch.abs(W))
            if l2:
                reg = reg + 0.5 * l2 * torch.sum(W * W)
        return reg

    # ------------------------------------------------------------------
    def fit(self, data, labels=None, *, n_epochs: int = 1):
        """fit(x, y) | fit(DataSet) | fit(iterator): one step per batch."""
        if not self._initialized:
            self.init()
        if labels is not None or hasattr(data, "features"):
            for _ in range(n_epochs):
                self._fit_batch(*self._split(data, labels))
            return self
        data = maybe_device_prefetch(data, device=self.device,
                                     dtype=self._dtype)
        for _ in range(n_epochs):
            for lis in self.listeners:
                lis.on_epoch_start(self)
            if hasattr(data, "reset"):
                data.reset()
            for ds in data:
                self._fit_batch(*self._split(ds, None))
            # a partial accumulation window does not leak across epochs
            self.flush_accumulated()
            # epochs completed advance before the listeners fire, as in
            # the JAX package (an epoch-end checkpoint saves the count)
            self.epoch_count += 1
            for lis in self.listeners:
                lis.on_epoch_end(self)
        return self

    def _recurrent_keys(self) -> List[str]:
        return [k for k in self._keys() if self._layer(k) is not None
                and self._layer(k).is_recurrent()]

    def _with_zero_rnn_states(self, states: _Tree, batch: int) -> _Tree:
        """States for a fresh sequence: persistent entries (BN) kept,
        recurrent ones zeros of ``dtype`` for ``batch``."""
        out = dict(states)
        for k in self._recurrent_keys():
            out[k] = {n: t.to(self.device) for n, t in
                      self._layer(k).zero_state(batch, self._dtype).items()}
        return out

    def _keep_states(self, new_states: _Tree) -> None:
        """Keep each non-empty new state; drop the recurrent ones."""
        for k, st in new_states.items():
            if st:
                self.states[k] = st
        for k in self._recurrent_keys():
            self.states[k] = {}

    #: the model name the fit funnels record under
    _FUNNEL = "Trainable"

    def _fit_batch(self, inputs: List[torch.Tensor],
                   labels: List[torch.Tensor], lmasks, fmask=None) -> None:
        states = self._with_zero_rnn_states(self.states,
                                            int(inputs[0].shape[0]))
        self._layerprof_shapes = (
            [(tuple(x.shape), x.dtype) for x in inputs],
            [(tuple(y.shape), y.dtype) for y in labels])
        if self.conf.backprop_type is BackpropType.TRUNCATED_BPTT and \
                inputs[0].dim() == 3:
            new_states = self._fit_tbptt(states, inputs, labels, lmasks,
                                         fmask)
        elif self._accum_steps > 1:
            with telemetry.step_span(
                    self._FUNNEL, accumulating=self._accum_steps) as sp:
                new_states = self._accumulate_step(states, inputs, labels,
                                                   lmasks, fmask)
            if self._observe:
                diagnostics.record_step(
                    self, self._FUNNEL, self.iteration_count - 1,
                    self._score, sp, grad_norm=self._last_gnorm)
        else:
            with telemetry.step_span(self._FUNNEL) as sp:
                new_states = self._train_step(states, inputs, labels,
                                              lmasks, fmask)
            self._after_step(sp)
        self._keep_states(new_states)
        self._batch_done(inputs)

    def _after_step(self, span, **extra) -> None:
        """The funnel's record and watchdog for the step just taken
        (``iteration_count - 1``): the flight recorder, the step
        breakdown, and the numerics check, which scans the updated
        parameters for the first bad leaf on a trip."""
        if self._observe:
            diagnostics.after_step(
                self, self._FUNNEL, self.iteration_count - 1, self._score,
                span, grad_norm=self._last_gnorm, params=self.params,
                **extra)

    def _fit_tbptt(self, states: _Tree, inputs, labels, lmasks, fmask
                   ) -> _Tree:
        """Segments of ``tbptt_fwd_length`` steps (the last one may be
        shorter), one update each; the state carries across segments,
        detached by ``_train_step``, so no gradient crosses them."""
        L = self.conf.tbptt_fwd_length

        def seg(a, t0, ndim):
            return a[:, t0:t0 + L] if a is not None and a.dim() >= ndim \
                else a

        for t0 in range(0, int(inputs[0].shape[1]), L):
            states = self._train_step(
                states, [seg(x, t0, 3) for x in inputs],
                [seg(y, t0, 3) for y in labels],
                [seg(m, t0, 2) for m in lmasks] if lmasks is not None
                else None, seg(fmask, t0, 2))
            self._after_step(None, tbptt_segment=t0 // L)
        return states

    def fit_steps(self, ds, steps: int):
        """``steps`` updates on one batch, as a plain loop of
        ``_train_step``. As in the JAX package's compiled loop, the
        recurrent state starts at zero once and carries from step to
        step, listeners fire once with the last loss, and masked
        DataSets are refused."""
        if not self._initialized:
            self.init()
        if any(getattr(ds, a, None) is not None for a in (
                "features_mask", "labels_mask", "features_masks",
                "labels_masks")):
            raise ValueError(
                "fit_steps does not support masked DataSets: padded "
                "timesteps would train as real data; use fit()")
        inputs, labels, _, _ = self._split(ds, None)
        states = self._with_zero_rnn_states(self.states,
                                            int(inputs[0].shape[0]))
        # one span and one record over the loop: the last step's loss
        # and gradient norm stand for the group, as the JAX package's
        # compiled loop reports it
        with telemetry.step_span(self._FUNNEL, steps=steps) as sp:
            for _ in range(steps):
                states = self._train_step(states, inputs, labels, None)
        self._after_step(sp, steps=steps)
        self._keep_states(states)
        self._batch_done(inputs)
        return self

    # -- stateful streaming inference ------------------------------------
    def _refuse_bidirectional(self, what: str) -> None:
        from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import \
            Bidirectional
        if any(isinstance(self._layer(k), Bidirectional)
               for k in self._keys()):
            # the backward direction needs future timesteps
            raise ValueError(f"rnnTimeStep is not supported on {what} "
                             f"with Bidirectional layers")

    def _stream_states(self, batch: int, what: str = "rnnTimeStep"
                       ) -> _Tree:
        """The streaming states, zeroed for ``batch`` sequences on first
        use; a call with another batch size raises."""
        if self._rnn_stream_states is None:
            self._rnn_stream_states = self._with_zero_rnn_states(
                self.states, batch)
            self._rnn_stream_batch = batch
        elif batch != self._rnn_stream_batch:
            raise ValueError(
                f"{what} batch size {batch} != stored state batch size "
                f"{self._rnn_stream_batch}; call "
                f"rnn_clear_previous_state() first")
        return self._rnn_stream_states

    def _keep_stream(self, new_states: _Tree) -> None:
        """Keep the recurrent layers' new states; persistent ones (BN)
        stay as they are."""
        merged = dict(self._rnn_stream_states)
        for k in self._recurrent_keys():
            merged[k] = new_states[k]
        self._rnn_stream_states = merged

    def rnn_clear_previous_state(self) -> None:
        self._rnn_stream_states = None

    def _batch_done(self, inputs: List[torch.Tensor]) -> None:
        # the global batch: every replica of a mesh takes an equal shard
        self.last_batch_size = int(inputs[0].shape[0]) * (
            self._replica.size if self._replica is not None else 1)
        for lis in self.listeners:
            lis.iteration_done(self, self.iteration_count - 1,
                               self.epoch_count)

    def _grads(self, states: _Tree, inputs: List[torch.Tensor],
               labels: List[torch.Tensor], lmasks, fmask=None):
        """The loss and its gradient from ``states`` under this step's
        key: ``(loss, grads, new_states)``, the loss and the states
        detached (no gradient crosses two steps)."""
        # under fsdp an entry's leaves are its flat slices,
        # {FSDP_KEY: {dtype: slice}}, one level deeper than a dense one
        leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                           self.params)
        flat = tree_leaves(leaves)
        params = leaves
        if self._params_are_fsdp():
            params = zero.FsdpParamView(leaves, self._fsdp_specs,
                                        self._replica,
                                        tp_specs=self._tp_specs,
                                        tp_replica=self._tp_replica)
        elif self._tp_specs:
            params = self._tp_view(leaves)
        with replica_scope(self._replica), torch.enable_grad():
            loss, new_states = self._loss(params, states, inputs, labels,
                                          lmasks, fmask, training=True,
                                          rng=self._next_key())
            grads_flat = iter(torch.autograd.grad(loss, flat,
                                                  allow_unused=True))

        def grad_of(t):
            g = next(grads_flat)
            return g if g is not None else torch.zeros_like(t)
        grads = tree_map(grad_of, leaves)
        return loss.detach(), grads, {
            k: {n: t.detach() for n, t in st.items()}
            for k, st in new_states.items()}

    def _train_step(self, states: _Tree, inputs: List[torch.Tensor],
                    labels: List[torch.Tensor], lmasks, fmask=None
                    ) -> _Tree:
        """One loss, gradient and update from ``states``; returns the new
        states."""
        loss, grads, new_states = self._grads(states, inputs, labels,
                                              lmasks, fmask)
        with torch.no_grad():
            self._last_gnorm = self._grad_norm(grads)
            self._update_tail(grads, self.iteration_count)
        self._score = self._mean_loss(loss)
        self.iteration_count += 1
        return new_states

    def _tp_view(self, params: _Tree) -> _Tree:
        """``params`` with the tensor-parallel leaves gathered whole
        (their gradients come back as this replica's slices)."""
        return {k: (zero.pin_tp_entry(sub, self._tp_specs[k],
                                      self._tp_replica)
                    if k in self._tp_specs else sub)
                for k, sub in params.items()}

    def _grad_norm(self, grads: _Tree) -> Optional[torch.Tensor]:
        """The global gradient norm (f32, on the device) while the
        numerics watchdog is armed; None otherwise (no work)."""
        if not diagnostics.watchdog_enabled():
            return None
        sq = [torch.sum(torch.square(g.float()))
              for g in tree_leaves(grads)]
        return torch.sqrt(sum(sq)) if sq else None

    # -- gradient accumulation -------------------------------------------
    def set_accumulation_steps(self, n: int):
        """Apply the updater once every ``n`` fit() micro-batches, on the
        mean of their gradients; a changed ``n`` first applies the
        pending window."""
        n = max(int(n), 1)
        if n != self._accum_steps:
            self.flush_accumulated()
            self._accum_steps = n
        return self

    def flush_accumulated(self):
        """Apply a partial accumulation window now; a no-op when nothing
        is pending."""
        if self._accum_count:
            self._apply_accumulated()
        return self

    def _accumulate_step(self, states: _Tree, inputs: List[torch.Tensor],
                         labels: List[torch.Tensor], lmasks, fmask=None
                         ) -> _Tree:
        """One micro-batch: its gradients join the window's sum, and a
        full window is applied."""
        loss, grads, new_states = self._grads(states, inputs, labels,
                                              lmasks, fmask)
        score = self._mean_loss(loss)
        with torch.no_grad():
            self._last_gnorm = self._grad_norm(grads)
            if self._observe:
                # before the sum: a poisoned micro-batch is named here
                diagnostics.check_numerics(
                    self, self._FUNNEL, self.iteration_count, score,
                    grad_norm=self._last_gnorm, grads=grads)
            if self._accum_grads is None:
                self._accum_grads = grads
            else:
                tree_map(lambda a, g: a.add_(g), self._accum_grads, grads)
        self._accum_count += 1
        if self._accum_count >= self._accum_steps:
            self._apply_accumulated()
        self._score = score
        self.iteration_count += 1
        return new_states

    def _apply_accumulated(self) -> None:
        scale = 1.0 / self._accum_count
        with torch.no_grad():
            grads = tree_map(lambda g: g * scale, self._accum_grads)
            self._update_tail(grads, self._updates_applied)
        self._accum_grads = None
        self._accum_count = 0
        self._updates_applied += 1

    def _update_tail(self, grads: _Tree, iteration: int) -> None:
        with layerprof.scope("optimizer"):
            self._update_tail_scoped(grads, iteration)

    def _update_tail_scoped(self, grads: _Tree, iteration: int) -> None:
        if self._dp_mode is not zero.UpdateExchange.ENCODED and any(
                is_encoded(s) for s in self.updater_states.values()):
            # the residual belongs to the encoded exchange
            self.updater_states = zero.strip_encoded_states(
                self.updater_states)
        if self._dp_mode in zero.FLAT_MODES:
            return self._update_tail_flat(grads, iteration)
        if self._replica is not None:
            grads = self._mean_over_replicas(grads)
        conf = self.conf
        for key in self._keys():
            g = grads.get(key)
            if not g:
                continue
            specs = self._tp_specs.get(key)
            gn = conf.gradient_normalization
            if specs and getattr(gn, "name", "NONE") != "NONE":
                # the norms are the whole leaves'
                full = apply_gradient_normalization(
                    gn, conf.gradient_normalization_threshold,
                    zero.gather_tp_params({key: g}, self._tp_specs,
                                          self._tp_replica)[key])
                g = zero.place_tp_params({key: full}, self._tp_specs,
                                         self._tp_replica)[key]
            else:
                g = apply_gradient_normalization(
                    gn, conf.gradient_normalization_threshold, g)
            updates, us = self._updater(key).apply(
                g, self.updater_states[key], iteration, self.epoch_count)
            p = self.params[key]
            for n, u in updates.items():
                p[n].sub_(u)
            self._constrain(key)
            self.updater_states[key] = us

    def _constrain(self, key: str) -> None:
        layer = self._layer(key)
        if layer is None:
            return
        p = self.params[key]
        if key in self._tp_specs:
            # a constraint's norms are the whole leaves'
            full = zero.gather_tp_params({key: p}, self._tp_specs,
                                         self._tp_replica)[key]
            new = apply_constraints(layer, full)
            if all(new[n] is full[n] for n in full):
                return
            new = zero.place_tp_params({key: new}, self._tp_specs,
                                       self._tp_replica)[key]
            for n, t in new.items():
                p[n].copy_(t)
            return
        for n, t in apply_constraints(layer, p).items():
            if t is not p[n]:
                p[n].copy_(t)

    # -- data parallelism --------------------------------------------------
    def set_dp_mesh(self, mesh, axis: str = "data", mode=None,
                    encoding=None, *, model_axis: str = "model",
                    tp_specs=None):
        """Bind this model to a data-parallel replica, or unbind it with
        ``mesh=None``. ``mesh`` is a ``parallel.mesh.Replica``, or a mesh
        with one replica in this process (a ``ProcessGroupMesh``); on a
        mesh with another axis above 1 the exchange runs over the
        replica's ``axis`` group (``Replica.group``).
        ``mode`` None or ``"sharded"`` selects the ZeRO-1 tail (the
        updater state converts to this replica's 1/N of the flat
        layout), ``"dense"`` the all-reduce tail, ``"encoded"`` the
        compressed tail (``encoding``: an ``EncodingSpec`` or a scheme
        name, ``parallel.encoding.resolve_encoding``; the error-feedback
        state is injected where absent), ``"fsdp"`` the ZeRO-3 tail (the
        parameters convert to this replica's 1/N of their flats too);
        ``"auto"`` resolves as ``zero.resolve_update_exchange`` does.
        ``tp_specs`` (``{entry: {name: TpLeafSpec}}``, from
        ``parallel.speclayout.SpecLayout``) adds tensor parallelism over
        ``model_axis``: those leaves and their updater state are held as
        this replica's shards. Leaving a bound layout gathers the state
        (and the fsdp and tensor-parallel parameters) back to the dense
        layout, a collective every replica of the mesh takes part in."""
        replica = mesh
        if mesh is not None and not isinstance(mesh, Replica):
            local = mesh.local_replicas()
            if len(local) != 1:
                raise ValueError(
                    f"{type(mesh).__name__} holds {len(local)} replicas in "
                    f"this process: bind each replica's model to its own "
                    f"mesh.replica(rank)")
            replica = local[0]
        base = replica
        tp_specs = dict(tp_specs or {}) if replica is not None else {}
        if replica is not None:
            if tp_specs and replica.axis_size(model_axis) <= 1:
                raise ValueError(f"tp_specs need a {model_axis!r} mesh axis "
                                 f"above 1, mesh {replica.mesh.axes}")
            if replica.mesh.has_other_axes(axis):
                replica = base.group(axis)
            mode = zero.parse_update_exchange(mode or "sharded")
            if mode is zero.UpdateExchange.AUTO:
                mode = zero.resolve_update_exchange(base.mesh, axis,
                                                    mode, self)
            if canonical_device(replica.device) != \
                    canonical_device(self.device):
                raise ValueError(f"replica {replica} is on "
                                 f"{replica.device}, the model on "
                                 f"{self.device}")
        self.flush_accumulated()
        if self._replica is not None:
            self._gather_dp_layouts()
        self._replica = replica
        self._tp_replica = base if tp_specs else None
        self._tp_specs = tp_specs
        self._dp_mode = mode if replica is not None else None
        self._dp_encoding = None
        if replica is None:
            return self
        if self._dp_mode in zero.FLAT_MODES:
            n, rank = replica.size, replica.rank
            # the JAX package's sharded-state and fsdp-parameter
            # placements (parallel/zero.py), as collective spans
            with diagnostics.collective_span(
                    "state_placement", "data",
                    zero.dense_state_bytes(self.updater_states),
                    entries=len(self.updater_states)):
                if self._dp_mode is zero.UpdateExchange.ENCODED:
                    self._dp_encoding = resolve_encoding(encoding)
                    states = zero.ensure_encoded_states(
                        self.params, self.updater_states, n,
                        self._dp_encoding, tp_specs=tp_specs)
                else:
                    states = zero.states_to_sharded(
                        self.params, self.updater_states, n,
                        tp_specs=tp_specs)
                self.updater_states = zero.place_updater_states(
                    states, replica, tp_specs, base)
            if self._dp_mode is zero.UpdateExchange.FSDP:
                with diagnostics.collective_span(
                        "fsdp_param_placement", "data", 0,
                        entries=len(self.params)):
                    flat, self._fsdp_specs = zero.params_to_fsdp(
                        self.params, n, tp_specs=tp_specs)
                    self.params = zero.shard_params(flat, rank, n,
                                                    tp_specs, base)
                telemetry.gauge(
                    "dl4j_fsdp_param_shard_bytes",
                    "resident bytes of a replica's fsdp flat parameter "
                    "slices (1/N of the padded flat total)").set(
                        zero.fsdp_param_bytes(self.params))
                return self
        elif tp_specs:
            self.updater_states = zero.place_updater_states(
                self.updater_states, replica, tp_specs, base)
        if tp_specs:
            self.params = zero.place_tp_params(self.params, tp_specs, base)
        return self

    def _gather_dp_layouts(self) -> None:
        """Leave the bound layouts: the fsdp and tensor-parallel
        parameters and the flat (and tensor-parallel) updater state
        gathered back to the dense layout (collectives)."""
        specs, base = self._tp_specs, self._tp_replica
        if self._params_are_fsdp():
            self.params = zero.params_to_dense(self.params,
                                               self._fsdp_specs,
                                               self._replica, specs, base)
            self._fsdp_specs = {}
        elif specs:
            self.params = zero.gather_tp_params(self.params, specs, base)
        if self._dp_mode in zero.FLAT_MODES or specs:
            self.updater_states = zero.states_to_dense(
                self.params, zero.gather_updater_states(
                    self.updater_states, self._replica, specs, base))
        self._tp_specs, self._tp_replica = {}, None

    def _params_are_fsdp(self) -> bool:
        return any(is_fsdp(p) for p in self.params.values())

    def dense_params(self) -> _Tree:
        """The parameters in the dense per-layer layout whatever their
        residency: under fsdp a gather of every replica's slices (a
        collective: every replica of the mesh calls it), else
        ``params`` itself."""
        if self._params_are_fsdp():
            return zero.params_to_dense(self.params, self._fsdp_specs,
                                        self._replica, self._tp_specs,
                                        self._tp_replica)
        if self._tp_specs:
            return zero.gather_tp_params(self.params, self._tp_specs,
                                         self._tp_replica)
        return self.params

    def dense_updater_states(self) -> dict:
        """The updater state in the dense layout (a checkpoint's): while
        bound to a flat tail, every replica's slices gathered (a
        collective), else ``updater_states`` itself."""
        if self._dp_mode not in zero.FLAT_MODES and not self._tp_specs:
            return self.updater_states
        return zero.states_to_dense(
            self.dense_params(), zero.gather_updater_states(
                self.updater_states, self._replica, self._tp_specs,
                self._tp_replica))

    def _mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The replicas' mean loss (the loss itself without a mesh)."""
        if self._replica is None:
            return loss
        n = self._replica.size
        return self._replica.all_reduce_sum(loss.reshape(1))[0] / n

    def _mean_over_replicas(self, grads: _Tree) -> _Tree:
        """The dense exchange: the mean of the replicas' gradients, one
        all-reduce a dtype over the raveled tree."""
        from deeplearning4j_tpu_torch.learning.updaters import (dp_ravel,
                                                                dp_unravel)
        n = self._replica.size
        flats, spec = dp_ravel(grads, 1)
        return dp_unravel({k: self._replica.all_reduce_sum(f.contiguous())
                           / n for k, f in flats.items()}, spec)

    def _update_tail_flat(self, grads: _Tree, iteration: int) -> None:
        """The sharded, encoded and fsdp tails, a group at a time."""
        mode = self._dp_mode
        for key in self._keys():
            g = grads.get(key)
            if not g:
                continue
            up, st = self._updater(key), self.updater_states[key]
            p = self.params[key]
            specs = self._tp_specs.get(key)
            st, st_tp = zero.split_tp_state(st)
            us_tp = ()
            if mode is zero.UpdateExchange.FSDP:
                # no constraints here: the resolver refuses fsdp for them
                new_flat, us = zero.apply_update_fsdp(
                    up, g[FSDP_KEY], p[FSDP_KEY], st, iteration,
                    self._replica, epoch=self.epoch_count)
                for dt, t in new_flat.items():
                    p[FSDP_KEY][dt].copy_(t)
                if specs and TP_KEY in g:
                    new_tp, us_tp = zero.apply_update_tp(
                        up, g[TP_KEY], p[TP_KEY], st_tp, iteration,
                        self._replica, specs, gather_params=False,
                        grads_resident=True, epoch=self.epoch_count)
                    for n, t in new_tp.items():
                        p[TP_KEY][n].copy_(t)
            else:
                g_rest, g_tp = zero.split_tp_entry(g, specs or {})
                p_rest, p_tp = zero.split_tp_entry(p, specs or {})
                new_p = {}
                if g_rest:
                    if mode is zero.UpdateExchange.ENCODED:
                        new_p, us = zero.apply_update_encoded(
                            up, g_rest, p_rest, st, iteration, self._replica,
                            encoding=self._dp_encoding,
                            epoch=self.epoch_count)
                    else:
                        new_p, us = zero.apply_update_sharded(
                            up, g_rest, p_rest, st, iteration,
                            self._replica, epoch=self.epoch_count)
                else:
                    us = st
                if g_tp:
                    new_tp, us_tp = zero.apply_update_tp(
                        up, g_tp, p_tp, st_tp, iteration, self._replica,
                        specs, gather_params=True, epoch=self.epoch_count)
                    new_p.update(new_tp)
                for n, t in new_p.items():
                    p[n].copy_(t)
                self._constrain(key)
            self.updater_states[key] = zero.merge_tp_state(us, us_tp)

    # -- layer attribution -------------------------------------------------
    def layer_report(self, data=None, labels=None, **roofline_kw) -> dict:
        """Per-layer flops / bytes / roofline attribution of one train
        step at the given batch (or the last fitted batch's shapes, in
        zeros): ``common/layerprof.attribute_step`` runs the loss, its
        gradient and the updaters' update (not applied) with every aten
        op charged to the ``dl4j.<layer>`` scope that ran it; the report
        joins the kernel decisions each layer made and is published
        (``layerprof.last_report``, the ``dl4j_layer_*`` gauges). The
        model is left as it was (parameters, states, random stream).
        ``roofline_kw``: ``peak_tflops`` / ``peak_hbm_gbps`` (default:
        the H100's, for the model's compute dtype)."""
        if not self._initialized:
            self.init()
        if self._replica is not None:
            raise ValueError("layer_report attributes one replica's "
                             "step: unbind the data-parallel mesh "
                             "(set_dp_mesh(None)) first")
        if data is not None and hasattr(data, "features"):
            data, labels = data.features, data.labels
        if data is None:
            shapes = self._layerprof_shapes
            if shapes is None:
                raise ValueError(
                    "layer_report needs a batch: pass (data, labels) "
                    "or fit at least one batch first")
            data = [torch.zeros(s, dtype=d) for s, d in shapes[0]]
            labels = [torch.zeros(s, dtype=d) for s, d in shapes[1]]
            if self._FUNNEL == "MultiLayerNetwork":
                data, labels = data[0], labels[0]
        inputs, labs, lmasks, fmask = self._split(data, labels)
        states = self._with_zero_rnn_states(self.states,
                                            int(inputs[0].shape[0]))
        conf = self.conf

        def step():
            _, grads, _ = self._grads(states, inputs, labs, lmasks, fmask)
            with torch.no_grad(), layerprof.scope("optimizer"):
                for key in self._keys():
                    g = grads.get(key)
                    if not g:
                        continue
                    g = apply_gradient_normalization(
                        conf.gradient_normalization,
                        conf.gradient_normalization_threshold, g)
                    self._updater(key).apply(
                        g, self.updater_states[key], self.iteration_count,
                        self.epoch_count)

        dt = getattr(conf, "compute_dtype", None) or self._dtype
        roofline_kw.setdefault("peak_tflops",
                               diagnostics.peak_tflops_for(dt))
        roofline_kw.setdefault("peak_hbm_gbps", diagnostics.H100_HBM_GBPS)
        rng = self._rng
        try:
            return layerprof.attribute_step(
                step, model_name=type(self).__name__,
                layer_types=self._layer_types(), **roofline_kw)
        finally:
            self._rng = rng

    # ------------------------------------------------------------------
    def score(self, dataset=None) -> float:
        """The last step's loss, or the loss of ``dataset`` (inference
        mode, regularization included)."""
        if dataset is None:
            return float("nan") if self._score is None \
                else float(self._score)
        inputs, labels, lmasks, fmask = self._split(dataset, None)
        with torch.no_grad():
            loss, _ = self._loss(self.dense_params(), self.states, inputs,
                                 labels, lmasks, fmask, training=False,
                                 rng=None)
        return float(loss)
