"""ParallelWrapper: data-parallel training over the replicas of a mesh
in one process.

Counterpart of ``deeplearning4j_tpu/parallel/wrapper.py`` (reference:
``org.deeplearning4j.parallelism.ParallelWrapper``: N trainer threads,
each with a model replica on its device). The JAX package compiles one
global-view program over the mesh; PyTorch runs eagerly, so here the
replicas are real: rank 0 is the wrapped model, every other rank a copy
of it on its own device, each stepped on its own thread
(``parallel/mesh.ThreadMesh``). Each global batch is trimmed to a
multiple of the replica count and split in rank order; each replica
takes a step on its shard, and the update exchange
(``parallel/zero.py``: dense all-reduce, the ZeRO-1 sharded tail, fsdp
(ZeRO-3) or the encoded tail) leaves every replica with the same
parameters: the update of the mean gradient (its encoded form under
``encoded``), synchronous SGD on the global batch, as in the JAX
package. BatchNormalization's statistics are the global batch's
(``ops/bn_train.py``), so the step equals the one-replica step on the
same global batch.

Batches are staged through ``datasets/prefetch.maybe_device_prefetch``
with the trim-and-split as its ``place_fn``: the feeder thread copies
each replica's shard to its device ahead of the step
(``prefetch_buffer`` is the depth).

Each ``fit`` / ``fit_batch`` call binds the replicas to the mesh
(``set_dp_mesh``), copying the wrapped model's parameters, states and
updater state to the others, and unbinds them at its end: the flat
updater state (and the encoded residual) gathered back to the dense
layout, and under fsdp the parameters too; between calls the wrapped
model is an ordinary model, whose updater state carries the encoded
rung's error-feedback state (``ENCODED_KEY``) in the dense layout after
an encoded run, as in the JAX package.

Each global step runs in a ``collective.update_exchange`` span
(``diagnostics.collective_span``: ``dl4j_collective_seconds``, the
exchange's per-replica wire bytes) and observes
``dl4j_dp_step_seconds{workers}``; the wrapped model's funnel records
the step (the replicas' copies record nothing).

``averaging_frequency`` and ``training_mode`` are accepted and logged:
every step is an exact average. Not ported (``NotImplementedError``):
``tensor_parallel`` and ``pipeline_stages`` (what is left of ROADMAP item
12: ``speclayout.py``, the 1F1B ``PipelineTrainer`` and ``zero.py``'s
tensor-parallel branches) and ``remesh``, which
needs the elastic machinery of ``common/faults.py`` (item 14).
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.common import diagnostics, stepstats, telemetry
from deeplearning4j_tpu_torch.datasets.prefetch import maybe_device_prefetch
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.encoding import resolve_encoding
from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    ThreadMesh,
                                                    canonical_device,
                                                    make_mesh,
                                                    map_dataset_arrays)

log = logging.getLogger("deeplearning4j_tpu_torch")


#: what is left of ROADMAP item 12 under each Builder option
TP_FIT_PATH = ("tensor_parallel (its SpecLayout lowering, speclayout.py, "
               "and zero.py's tensor-parallel update exchange)")
PP_FIT_PATH = ("pipeline_stages (the 1F1B PipelineTrainer fit path of "
               "pipeline.py, with speclayout.py's per-stage specs)")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"Queue A item {item})")


def local_devices(model, workers: Optional[int] = None
                  ) -> List[torch.device]:
    """The devices of ``workers`` replicas of ``model`` (initialised on
    the card when it is not yet): the first ``workers`` cards (all of
    them by default) for a model on the card, ``workers`` CPU replicas
    (one by default) for a model on the CPU."""
    if not model._initialized:
        model.init()
    dev = canonical_device(model.device)
    if dev.type == "cpu":
        return [dev] * max(int(workers or 1), 1)
    n = torch.cuda.device_count()
    workers = n if workers in (None, -1) else int(workers)
    if workers > n:
        raise ValueError(f"{workers} workers need {workers} cards, have "
                         f"{n} (two replicas may not share a card)")
    first = dev.index
    return [torch.device("cuda", (first + i) % n) for i in range(workers)]


def _clone_replica(model, device: torch.device):
    """A copy of ``model``'s configuration with its parameters, states,
    updater state and counters, on ``device``."""
    def clone(tree):
        return {k: {n: t.detach().clone() for n, t in sub.items()}
                for k, sub in tree.items()}

    rep = type(model)(model.conf)
    rep.set_params(clone(model.params), clone(model.states), device)
    _copy_training_state(model, rep)
    # the wrapped model records the global step for the observatory
    rep._observe = False
    return rep


def _copy_training_state(src, dst) -> None:
    dev = dst.device
    with torch.no_grad():
        for k, sub in src.params.items():
            for n, t in sub.items():
                dst.params[k][n].copy_(t)
        for k, sub in src.states.items():
            dst.states[k] = {n: t.to(dev, copy=True) for n, t in sub.items()}

    def copy(tree):
        if isinstance(tree, dict):
            return {k: copy(v) for k, v in tree.items()}
        return tree.to(dev, copy=True)

    dst.updater_states = copy(src.updater_states)
    for attr in ("iteration_count", "epoch_count", "_updates_applied",
                 "_rng", "_accum_steps"):
        setattr(dst, attr, getattr(src, attr))


class ParallelWrapper:
    """Wrap a MultiLayerNetwork / ComputationGraph for data-parallel
    training over a mesh's replicas.

    Usage (the reference builder's shape)::

        pw = (ParallelWrapper.Builder(net)
              .workers(2)
              .prefetch_buffer(2)
              .build())
        pw.fit(train_iterator)
    """

    #: reference TrainingMode values (accepted; every step is an exact
    #: synchronous exchange)
    KNOWN_TRAINING_MODES = ("AVERAGING", "SHARED_GRADIENTS", "CUSTOM")

    def __init__(self, model, mesh: Optional[ThreadMesh] = None, *,
                 data_axis: str = DEFAULT_DATA_AXIS,
                 prefetch_buffer: int = 2,
                 averaging_frequency: int = 1,
                 report_score_after_averaging: bool = True,
                 accumulation_steps: int = 1,
                 update_exchange="auto", encoding=None):
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh(
            devices=local_devices(model))
        if data_axis != DEFAULT_DATA_AXIS:
            raise NotImplementedError(
                f"data_axis {data_axis!r}: only the data axis is ported")
        self.data_axis = data_axis
        self.prefetch_buffer = prefetch_buffer
        self.averaging_frequency = averaging_frequency
        self.report_score = report_score_after_averaging
        self.accumulation_steps = max(int(accumulation_steps), 1)
        #: the requested exchange; resolved at placement
        self.requested_exchange = zero.parse_update_exchange(
            update_exchange)
        self.update_exchange: Optional[zero.UpdateExchange] = None
        #: the codec asked for (``encoding=``) and, under the encoded
        #: exchange, the resolved ``EncodingSpec``
        self.requested_encoding = encoding
        self.encoding = None
        self._replicas: list = []
        self._placed = False
        #: per-replica wire bytes of one update exchange (at placement)
        self._exchange_bytes = 0
        if averaging_frequency != 1:
            log.info("averagingFrequency=%d ignored: every step is an "
                     "exact synchronous exchange", averaging_frequency)

    # -- Builder (the reference's API shape) -------------------------------
    class Builder:
        def __init__(self, model):
            self._model = model
            self._mesh = None
            self._prefetch = 2
            self._avg_freq = 1
            self._workers = None
            self._accum = 1
            self._exchange = "auto"
            self._encoding = None

        def workers(self, n: int) -> "ParallelWrapper.Builder":
            self._workers = n
            return self

        def mesh(self, mesh) -> "ParallelWrapper.Builder":
            self._mesh = mesh
            return self

        def prefetch_buffer(self, n: int) -> "ParallelWrapper.Builder":
            self._prefetch = n
            return self

        def averaging_frequency(self, n: int) -> "ParallelWrapper.Builder":
            self._avg_freq = n
            return self

        def accumulation_steps(self, n: int) -> "ParallelWrapper.Builder":
            """Apply the updater every ``n`` micro-batches on the mean
            gradient (reference: GradientsAccumulator)."""
            self._accum = n
            return self

        def update_exchange(self, mode) -> "ParallelWrapper.Builder":
            """'dense' | 'sharded' | 'fsdp' | 'encoded' | 'auto'
            (``zero.UpdateExchange``): 'fsdp' (ZeRO-3) keeps the
            parameters 1/N a replica too, 'encoded' compresses the
            gradient under error feedback (:meth:`encoding`); both are
            opt-in, 'auto' resolves to 'sharded'."""
            self._exchange = zero.parse_update_exchange(mode)
            return self

        def tensor_parallel(self, n: int) -> "ParallelWrapper.Builder":
            if int(n) > 1:
                raise not_ported(TP_FIT_PATH, "12")
            return self

        def pipeline_stages(self, n: int) -> "ParallelWrapper.Builder":
            if int(n) > 1:
                raise not_ported(PP_FIT_PATH, "12")
            return self

        def encoding(self, spec) -> "ParallelWrapper.Builder":
            """The codec of ``update_exchange('encoded')``: an
            ``EncodingSpec`` or a scheme name ('threshold', 'int8',
            '1bit'; ``parallel/encoding.py``). Ignored under every other
            exchange."""
            self._encoding = resolve_encoding(spec)
            return self

        def training_mode(self, mode) -> "ParallelWrapper.Builder":
            name = str(getattr(mode, "name", mode)).upper()
            if name not in ParallelWrapper.KNOWN_TRAINING_MODES:
                log.warning(
                    "unknown training_mode %r (known: %s); every known "
                    "mode is the same exact exchange", mode,
                    ", ".join(ParallelWrapper.KNOWN_TRAINING_MODES))
            return self

        def build(self) -> "ParallelWrapper":
            mesh = self._mesh
            if mesh is None:
                mesh = make_mesh(devices=local_devices(self._model,
                                                       self._workers))
            return ParallelWrapper(self._model, mesh,
                                   prefetch_buffer=self._prefetch,
                                   averaging_frequency=self._avg_freq,
                                   accumulation_steps=self._accum,
                                   update_exchange=self._exchange,
                                   encoding=self._encoding)

    # ------------------------------------------------------------------
    @property
    def n_workers(self) -> int:
        return self.mesh.size

    def _place_model(self):
        """Resolve the exchange and make the replicas (rank 0 is the
        wrapped model)."""
        m = self.model
        if not m._initialized:
            m.init(self.mesh.devices[0])
        if canonical_device(m.device) != self.mesh.devices[0]:
            raise ValueError(f"the model is on {m.device}, the mesh's "
                             f"rank 0 on {self.mesh.devices[0]}")
        mode = zero.resolve_update_exchange(self.mesh, self.data_axis,
                                            self.requested_exchange, m)
        self.update_exchange = mode
        self.encoding = (resolve_encoding(self.requested_encoding)
                         if mode is zero.UpdateExchange.ENCODED else None)
        m.set_accumulation_steps(self.accumulation_steps)
        self._replicas = [m] + [_clone_replica(m, d)
                                for d in self.mesh.devices[1:]]
        self._exchange_bytes = (
            zero.encoded_exchange_bytes(m.params, self.n_workers,
                                        self.encoding)
            if mode is zero.UpdateExchange.ENCODED else
            zero.update_exchange_bytes(m.params, self.n_workers, mode))
        self._placed = True

    def _bind(self):
        if not self._placed:
            self._place_model()
        else:
            self.model.set_accumulation_steps(self.accumulation_steps)
            for rep in self._replicas[1:]:
                _copy_training_state(self.model, rep)
        mode, enc = self.update_exchange, self.encoding
        self.mesh.run(lambda r: self._replicas[r].set_dp_mesh(
            self.mesh.replica(r), mode=mode, encoding=enc))

    def _unbind(self, ok: bool):
        if ok:
            self.mesh.run(lambda r: self._replicas[r].set_dp_mesh(None))
            return
        if self.update_exchange is zero.UpdateExchange.FSDP:
            # the parameters live only as the replicas' slices: gather
            # them even after a failed step, or the model has none
            try:
                self.mesh.run(lambda r: self._replicas[r].set_dp_mesh(None))
                return
            except Exception:   # noqa: BLE001 — the step's error is raised
                log.exception("gathering the fsdp parameters after a "
                              "failed step failed too")
        # after a failed step the replicas may disagree: drop the
        # bindings without a collective, and copy afresh next call
        for rep in self._replicas:
            rep._replica, rep._dp_mode = None, None

    def _shard_dataset(self, ds) -> list:
        """The batch trimmed to a multiple of the replica count, split
        in rank order: one DataSet a replica."""
        n = self.n_workers
        b = int((ds.features[0] if isinstance(ds.features, list)
                 else ds.features).shape[0])
        keep = (b // n) * n
        if keep == 0:
            raise ValueError(f"minibatch of {b} < {n} data-parallel "
                             f"replicas; increase the batch size")
        if keep != b:
            log.warning("trimming minibatch %d -> %d for %d-way DP", b,
                        keep, n)
        s = keep // n
        return [map_dataset_arrays(ds, lambda a, r=r: a[r * s:(r + 1) * s])
                for r in range(n)]

    def _step(self, shards: list) -> None:
        """One global step: every replica on its shard. The update
        exchange runs inside the replicas' steps, so its span wraps them
        (the step breakdown keeps only its excess over the wrapped step
        as ``collective``), with its per-replica wire bytes."""
        reps = self._replicas

        def run():
            self.mesh.run(lambda r: reps[r]._fit_batch(
                *reps[r]._split(shards[r], None)))

        if not telemetry.enabled():
            return run()
        mode = self.update_exchange.value
        t0 = time.perf_counter()
        with diagnostics.collective_span("update_exchange",
                                         self.data_axis,
                                         self._exchange_bytes, mode=mode):
            run()
        telemetry.histogram(
            "dl4j_dp_step_seconds",
            "data-parallel sharded step wall time incl. the fused "
            "in-step gradient all-reduce (seconds)").observe(
                time.perf_counter() - t0, workers=self.n_workers)
        telemetry.counter(
            "dl4j_dp_update_exchange_bytes_total",
            "estimated per-replica wire bytes moved by the in-step "
            "update exchange (ring collectives)").inc(
                self._exchange_bytes, mode=mode)

    # ------------------------------------------------------------------
    def fit(self, iterator, *, n_epochs: int = 1) -> "ParallelWrapper":
        """fit(DataSetIterator): the model's fit contract, each global
        batch split over the replicas."""
        return self.run_epochs(iterator, n_epochs, self._shard_dataset)

    def run_epochs(self, iterator, n_epochs: int, shard_fn):
        """The epoch / reset / listener loop, given how a batch becomes
        one DataSet a replica; staged through the prefetcher, which
        runs ``shard_fn`` and the copies on its feeder thread."""
        self._bind()
        ok = False
        # this process's breakdowns: worker 0 of 1, until the fit ends
        prev_label = stepstats.collector().worker_label()
        stepstats.collector().set_worker(0, 1)
        try:
            m = self.model
            staged = maybe_device_prefetch(
                iterator, device=self.mesh.devices, dtype=m._dtype,
                place_fn=shard_fn, depth=self.prefetch_buffer)
            place = (lambda ds: ds) if staged is not iterator else shard_fn
            for _ in range(n_epochs):
                if hasattr(staged, "reset"):
                    staged.reset()
                for lis in m.listeners:
                    lis.on_epoch_start(m)
                for ds in staged:
                    self._step(place(ds))
                # a partial accumulation window does not leak across
                # epochs
                self.mesh.run(
                    lambda r: self._replicas[r].flush_accumulated())
                for rep in self._replicas:
                    rep.epoch_count += 1
                for lis in m.listeners:
                    lis.on_epoch_end(m)
            ok = True
        finally:
            stepstats.collector().set_worker(**prev_label)
            self._unbind(ok)
        return self

    def fit_batch(self, ds) -> "ParallelWrapper":
        self._bind()
        ok = False
        try:
            self._step(self._shard_dataset(ds))
            ok = True
        finally:
            self._unbind(ok)
        return self

    def average_score(self) -> float:
        return self.model.score()

    def remesh(self, mesh=None, *, workers: Optional[int] = None):
        raise not_ported("remesh (elastic world-size changes need "
                          "common/faults.py)", "14")

    def shutdown(self):
        """Reference API: stop the trainers; the replicas are dropped."""
        self._placed = False
        self._replicas = []
