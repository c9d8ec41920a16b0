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

The reference's threshold and residual knobs are accepted and logged as
inert: the encoded exchange they configure is not ported yet (ROADMAP
item 11), nor are tensor and pipeline parallelism (item 12) or
``checkpoint_dir`` (``utils/checkpoint.py``, item 14). The JAX
package's scaling observatory sidecar (``common/stepstats.py``, item
13) is left out.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from deeplearning4j_tpu_torch.parallel import zero
from deeplearning4j_tpu_torch.parallel.mesh import (DEFAULT_DATA_AXIS,
                                                    DEFAULT_TIMEOUT_S,
                                                    ProcessGroupMesh,
                                                    make_mesh)
from deeplearning4j_tpu_torch.parallel.wrapper import (ParallelWrapper,
                                                       not_ported,
                                                       local_devices)

log = logging.getLogger("deeplearning4j_tpu_torch")


@dataclass
class SharedTrainingConfiguration:
    """The reference SharedTrainingMaster.Builder's knobs that apply."""
    batch_size_per_worker: int = 32
    workers_per_node: int = -1          # -1: all local devices
    threshold_algorithm: object = None  # accepted, inert (item 11)
    residual_post_processor: object = None
    update_exchange: str = "auto"
    accumulation_steps: int = 1
    # control plane (torch.distributed); None: one process
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    backend: Optional[str] = None       # None: nccl on the card, else gloo
    collective_timeout_s: float = DEFAULT_TIMEOUT_S


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


class SharedTrainingMaster:
    """Multi-process data-parallel trainer (one process a replica);
    one process alone is a :class:`ParallelWrapper` over local
    replicas."""

    def __init__(self, config: Optional[SharedTrainingConfiguration] = None):
        self.config = config or SharedTrainingConfiguration()
        self._mesh: Optional[ProcessGroupMesh] = None

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
            """'dense' | 'sharded' | 'auto', checked here so a typo fails
            at build time."""
            self._c.update_exchange = zero.parse_update_exchange(mode).value
            return self

        def encoding(self, spec):
            raise not_ported("the encoded update exchange (encoding)",
                              "11")

        def accumulation_steps(self, n: int):
            self._c.accumulation_steps = max(int(n), 1)
            return self

        def tensor_parallel(self, n: int):
            if int(n) > 1:
                raise not_ported("tensor_parallel", "12")
            return self

        def pipeline_stages(self, n: int):
            if int(n) > 1:
                raise not_ported("pipeline_stages", "12")
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
        if c.threshold_algorithm is not None:
            log.info("threshold_algorithm configures the encoded update "
                     "exchange, which is not ported yet (ROADMAP item "
                     "11); update_exchange=%r keeps it inert",
                     c.update_exchange)
        if not c.coordinator_address:
            mesh = make_mesh(devices=local_devices(
                model, c.workers_per_node if c.workers_per_node > 0
                else None), timeout_s=c.collective_timeout_s)
            ParallelWrapper(model, mesh, update_exchange=c.update_exchange,
                            accumulation_steps=c.accumulation_steps
                            ).fit(iterator, n_epochs=n_epochs)
            return model
        mesh = self._process_mesh(model)
        mode = zero.resolve_update_exchange(mesh, DEFAULT_DATA_AXIS,
                                            c.update_exchange, model)
        model.set_accumulation_steps(c.accumulation_steps)
        model.set_dp_mesh(mesh, mode=mode)
        try:
            model.fit(iterator, n_epochs=n_epochs)
        except BaseException:
            # the processes may disagree now: no gathering collective
            model._replica, model._dp_mode = None, None
            raise
        model.set_dp_mesh(None)
        return model

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
