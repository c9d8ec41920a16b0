"""SharedTrainingMaster: data-parallel training across processes.

Counterpart of ``deeplearning4j_tpu/parallel/sharedtraining.py``
(reference: ``org.deeplearning4j.spark.parameterserver.training.
SharedTrainingMaster``: a Spark master, per-executor trainers and an
update exchange between them). The JAX package maps the cluster to
``jax.distributed`` and one global mesh; here:

- cluster membership -> ``torch.distributed.init_process_group``
  (``Builder.coordinator(address, num_processes, process_id)``; an
  address ``host:port`` means ``tcp://host:port``, a ``file://`` path
  works too), through ``parallel/mesh.ProcessGroupMesh``: NCCL for a
  model on the card, gloo on the CPU (``backend`` overrides; gloo with
  CUDA tensors stages them through the host), every collective with a
  timeout;
- one process is one replica; each process feeds its LOCAL shard of the
  data, and the global batch is the shards in rank order (the JAX
  package's ``_make_global_inner``), so every process must feed shards
  of one size;
- the update exchange is ``parallel/zero.py``'s (``auto``: ZeRO-1
  sharded whenever legal), installed with ``model.set_dp_mesh`` for the
  length of ``fit``; BatchNormalization takes the global batch's
  statistics.

Without a coordinator it degenerates to :class:`ParallelWrapper` over
``workers_per_node`` local replicas (all cards by default; one CPU
replica for a model on the CPU).

The reference's threshold and residual knobs configure the encoded
exchange: under ``update_exchange("encoded")`` they compose the
``EncodingSpec`` as the JAX package composes it (an explicit
``encoding(...)`` wins); under any other exchange they are inert, and
logged so. Not ported: tensor and pipeline parallelism (ROADMAP item
12) and ``checkpoint_dir`` (``utils/checkpoint.py``, item 14).

The scaling observatory's sidecar (``common/stepstats.py``) rides beside
the exchange: each process labels its step breakdowns with its rank and
ships them to rank 0, the leader, whose ``StepStatsAggregator`` listens
on ``DL4J_TORCH_OBSERVATORY_PORT`` (0: any free port; the leader
broadcasts the port it got over the process group). The leader merges
each step, gauges every worker's skew and trips straggler detection;
:meth:`SharedTrainingMaster.observatory_report` returns its view. Any
failure of the sidecar is logged and disables it: observability never
takes training down, and nothing on the compute path changes with it.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.common import stepstats
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.encoding import (EncodingSpec,
                                                        resolve_encoding)
from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    DEFAULT_TIMEOUT_S,
                                                    ProcessGroupMesh,
                                                    make_mesh)
from deeplearning4j_tpu_torch.parallel.wrapper import (PP_FIT_PATH,
                                                       TP_FIT_PATH,
                                                       ParallelWrapper,
                                                       not_ported,
                                                       local_devices)

log = logging.getLogger("deeplearning4j_tpu_torch")


@dataclass
class SharedTrainingConfiguration:
    """The reference SharedTrainingMaster.Builder's knobs that apply."""
    batch_size_per_worker: int = 32
    workers_per_node: int = -1          # -1: all local devices
    # the encoded exchange's codec; the reference's threshold and
    # residual knobs compose it when it is not given
    encoding: Optional[EncodingSpec] = None
    threshold_algorithm: object = None
    residual_post_processor: object = None
    update_exchange: str = "auto"
    accumulation_steps: int = 1
    # control plane (torch.distributed); None: one process
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    backend: Optional[str] = None       # None: nccl on the card, else gloo
    collective_timeout_s: float = DEFAULT_TIMEOUT_S


def _leader_host(address: Optional[str]) -> str:
    """The leader's host for the sidecar: the coordinator's, or the
    loopback for a ``file://`` rendezvous."""
    if not address or address.startswith("file://"):
        return "127.0.0.1"
    host = address.split("://")[-1].rsplit(":", 1)[0]
    return host or "127.0.0.1"


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


class SharedTrainingMaster:
    """Multi-process data-parallel trainer (one process a replica);
    one process alone is a :class:`ParallelWrapper` over local
    replicas."""

    def __init__(self, config: Optional[SharedTrainingConfiguration] = None):
        self.config = config or SharedTrainingConfiguration()
        self._mesh: Optional[ProcessGroupMesh] = None
        self._observatory: Optional[stepstats.StepStatsAggregator] = None
        self._obs_client: Optional[stepstats.StepStatsClient] = None
        self._last_observatory: Optional[dict] = None

    class Builder:
        def __init__(self, batch_size_per_worker: int = 32):
            self._c = SharedTrainingConfiguration(
                batch_size_per_worker=batch_size_per_worker)

        def workers_per_node(self, n: int):
            self._c.workers_per_node = n
            return self

        def threshold_algorithm(self, algo):
            self._c.threshold_algorithm = algo
            return self

        def residual_post_processor(self, rp):
            self._c.residual_post_processor = rp
            return self

        def update_exchange(self, mode):
            """'dense' | 'sharded' | 'fsdp' | 'encoded' | 'auto', checked
            here so a typo fails at build time."""
            self._c.update_exchange = zero.parse_update_exchange(mode).value
            return self

        def encoding(self, spec):
            """The codec of ``update_exchange('encoded')``: an
            ``EncodingSpec`` or a scheme name."""
            self._c.encoding = resolve_encoding(spec)
            return self

        def accumulation_steps(self, n: int):
            self._c.accumulation_steps = max(int(n), 1)
            return self

        def tensor_parallel(self, n: int):
            if int(n) > 1:
                raise not_ported(TP_FIT_PATH, "12")
            return self

        def pipeline_stages(self, n: int):
            if int(n) > 1:
                raise not_ported(PP_FIT_PATH, "12")
            return self

        def coordinator(self, address: str, num_processes: int,
                        process_id: int, backend: Optional[str] = None):
            self._c.coordinator_address = address
            self._c.num_processes = num_processes
            self._c.process_id = process_id
            self._c.backend = backend
            return self

        def collective_timeout(self, seconds: float):
            self._c.collective_timeout_s = float(seconds)
            return self

        def build(self) -> "SharedTrainingMaster":
            return SharedTrainingMaster(self._c)

    # ------------------------------------------------------------------
    def _process_mesh(self, model) -> ProcessGroupMesh:
        if self._mesh is None:
            c = self.config
            self._mesh = ProcessGroupMesh(
                _init_method(c.coordinator_address), c.num_processes,
                c.process_id, device=model.device, backend=c.backend,
                timeout_s=c.collective_timeout_s)
            log.info("torch.distributed up (%s): process %d/%d on %s",
                     self._mesh.backend, c.process_id, c.num_processes,
                     model.device)
        return self._mesh

    def _encoding(self, mode) -> Optional[EncodingSpec]:
        """The encoded exchange's codec, as the JAX master composes it:
        ``encoding`` when given, else the default spec with the
        reference's threshold algorithm and residual post-processor
        where they are set. None under any other exchange, where those
        knobs are inert."""
        c = self.config
        if mode is not zero.UpdateExchange.ENCODED:
            if c.threshold_algorithm is not None:
                log.info("threshold_algorithm configures the encoded "
                         "update exchange; update_exchange=%r keeps it "
                         "inert (dense all-reduce | ZeRO-1 sharded | "
                         "ZeRO-3 fsdp): pass update_exchange='encoded' "
                         "to compress the gradient exchange",
                         c.update_exchange)
            return None
        spec = resolve_encoding(c.encoding)
        if c.encoding is None and (c.threshold_algorithm is not None or
                                   c.residual_post_processor is not None):
            spec = EncodingSpec(
                scheme=spec.scheme,
                algorithm=c.threshold_algorithm or spec.algorithm,
                residual_post=(c.residual_post_processor
                               or spec.residual_post))
        log.info("encoded update exchange: scheme=%s algorithm=%s",
                 spec.scheme, type(spec.algorithm).__name__)
        return spec

    def fit(self, model, iterator, *, n_epochs: int = 1,
            checkpoint_dir=None, save_every_n_epochs: int = 1,
            keep_last: int = 3):
        """fit(model, DataSetIterator): each process iterates its local
        partition; the step is synchronous over every process."""
        if checkpoint_dir is not None:
            raise not_ported("checkpoint_dir (utils/checkpoint.py)", "14")
        c = self.config
        if not model._initialized:
            model.init()
        if not c.coordinator_address:
            mesh = make_mesh(devices=local_devices(
                model, c.workers_per_node if c.workers_per_node > 0
                else None), timeout_s=c.collective_timeout_s)
            mode = zero.resolve_update_exchange(mesh, DEFAULT_DATA_AXIS,
                                                c.update_exchange, model)
            ParallelWrapper(model, mesh, update_exchange=c.update_exchange,
                            accumulation_steps=c.accumulation_steps,
                            encoding=self._encoding(mode)
                            ).fit(iterator, n_epochs=n_epochs)
            return model
        mesh = self._process_mesh(model)
        mode = zero.resolve_update_exchange(mesh, DEFAULT_DATA_AXIS,
                                            c.update_exchange, model)
        model.set_accumulation_steps(c.accumulation_steps)
        model.set_dp_mesh(mesh, mode=mode, encoding=self._encoding(mode))
        self._setup_observatory(mesh, model.device)
        try:
            model.fit(iterator, n_epochs=n_epochs)
        except BaseException:
            # the processes may disagree now: no gathering collective
            model._replica, model._dp_mode = None, None
            self._teardown_observatory()
            raise
        self._teardown_observatory(mesh.local_replicas()[0], model.device)
        model.set_dp_mesh(None)
        return model

    # -- scaling observatory sidecar -----------------------------------
    def _setup_observatory(self, mesh: ProcessGroupMesh, device) -> None:
        """Label this process's breakdowns with its rank and ship them
        to the leader (rank 0) over a sidecar socket. The leader's port
        reaches the others by a broadcast (-1: the leader has none, and
        every process goes on without the sidecar)."""
        rank, n = mesh.rank, mesh.size
        replica = mesh.local_replicas()[0]
        self._prev_label = stepstats.collector().worker_label()
        stepstats.collector().set_worker(rank, n)
        leader = _leader_host(self.config.coordinator_address)
        port = -1
        if rank == 0:
            try:
                self._observatory = stepstats.StepStatsAggregator(
                    expected_workers=n,
                    port=Environment.get().observatory_port, host=leader)
                port = self._observatory.port
            except OSError as e:
                log.warning("scaling observatory sidecar disabled: %r", e)
        # the broadcast is a collective: every process takes part
        port = int(replica.broadcast(
            torch.tensor([port], dtype=torch.int64, device=device))[0])
        if port < 0:
            return
        try:
            self._obs_client = stepstats.StepStatsClient(leader, port,
                                                         worker=rank)
            stepstats.collector().add_sink(self._obs_client.ship)
        except OSError as e:
            log.warning("scaling observatory sidecar disabled: %r", e)

    def _teardown_observatory(self, replica=None, device=None) -> None:
        """Close the sidecar. After a fit that every process finished
        (``replica`` given), a barrier first lets every worker's last
        breakdown reach the leader before it reports. This process's
        breakdowns get back the label they had before the fit."""
        stepstats.collector().set_worker(**self._prev_label)
        if self._obs_client is not None:
            stepstats.collector().remove_sink(self._obs_client.ship)
            self._obs_client.close()
            self._obs_client = None
        if replica is not None:
            replica.all_reduce_sum(torch.zeros(1, device=device))
            if self._observatory is not None:
                self._observatory.wait_for_workers(timeout=10.0)
        if self._observatory is not None:
            self._last_observatory = self._observatory.report()
            self._observatory.close()
            self._observatory = None

    def observatory_report(self) -> Optional[dict]:
        """The leader's merged cross-worker view (skew, trips, clock
        offsets): live during fit, the final report afterwards; None on
        the other processes and in single-process runs."""
        if self._observatory is not None:
            return self._observatory.report()
        return self._last_observatory

    def shutdown(self) -> None:
        """Leave the process group."""
        if self._mesh is not None:
            self._mesh.shutdown()
            self._mesh = None


class ParameterAveragingTrainingMaster(SharedTrainingMaster):
    """Reference: ``ParameterAveragingTrainingMaster`` (Spark's
    broadcast-and-average every N rounds). A synchronous exchange every
    step is the averaging scheme at N = 1, so this is the same trainer
    with the reference's builder (``averaging_frequency`` accepted and
    logged)."""

    class Builder(SharedTrainingMaster.Builder):
        def __init__(self, rdd_data_set_num_examples: int = 32):
            super().__init__(
                batch_size_per_worker=rdd_data_set_num_examples)

        def averaging_frequency(self, n: int):
            log.info("averagingFrequency=%d accepted; every step "
                     "averages exactly", n)
            return self

        def batch_size_per_worker(self, n: int):
            self._c.batch_size_per_worker = n
            return self

        def build(self) -> "ParameterAveragingTrainingMaster":
            return ParameterAveragingTrainingMaster(self._c)
