"""ParallelInference: request batching in front of one model.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py`` on one
device. :class:`InferenceMode` picks how ``submit`` runs a request:

- ``BATCHED`` (the default): a queue and a worker thread aggregate
  concurrent requests into one forward on the model's device. The worker
  flushes continuously, as the JAX package's serving batcher does by
  default: it blocks for one request, takes whatever else is queued (up
  to ``batch_limit``) and runs it at once, so arrivals during a forward
  form the next batch. ``flush_policy="window"`` instead holds the first
  request up to ``batch_window_ms`` collecting batch-mates (the JAX
  package's ``ParallelInference`` worker);
- ``INPLACE`` and ``SEQUENTIAL``: the request runs on the caller's thread
  at once, with no queue and no aggregation.

The JAX package's mesh (batch sharded over several chips) becomes the
single device the model lives on; data parallelism comes with its own
slice. The forward runs under ``torch.inference_mode()``, entered by
whichever thread runs it (the mode is thread-local, and the worker is a
thread of its own).
"""
from __future__ import annotations

import concurrent.futures
import queue as _queue
import threading
import time
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import telemetry

#: flush triggers of the BATCHED worker: continuous flushes whenever the
#: device frees and requests wait; window holds the first request up to
#: batch_window_ms hoping for batch-mates
FLUSH_POLICIES = ("continuous", "window")


class InferenceMode:
    #: run each request on the caller's thread, no queue
    INPLACE = "INPLACE"
    SEQUENTIAL = "SEQUENTIAL"
    #: aggregate concurrent requests into up-to-batch_limit forwards
    BATCHED = "BATCHED"


class ParallelInference:
    def __init__(self, model, *,
                 inference_mode: str = InferenceMode.BATCHED,
                 batch_limit: int = 32, queue_limit: int = 64,
                 flush_policy: str = "continuous",
                 batch_window_ms: float = 2.0):
        if inference_mode not in (InferenceMode.INPLACE,
                                  InferenceMode.SEQUENTIAL,
                                  InferenceMode.BATCHED):
            raise ValueError(f"unknown inference_mode {inference_mode!r}")
        if flush_policy not in FLUSH_POLICIES:
            raise ValueError(f"flush_policy must be one of "
                             f"{FLUSH_POLICIES}, got {flush_policy!r}")
        self.model = model
        self.inference_mode = inference_mode
        self.batch_limit = batch_limit
        self.queue_limit = queue_limit
        self.flush_policy = flush_policy
        self.batch_window_ms = float(batch_window_ms)
        #: forwards this instance ran (one a flushed chunk)
        self.forwards = 0
        self._forwards_lock = threading.Lock()
        self._worker = None
        self._requests = None
        self._shutdown = False
        self._lock = threading.Lock()

    class Builder:
        def __init__(self, model):
            self._model = model
            self._mode = InferenceMode.BATCHED
            self._batch_limit = 32
            self._queue_limit = 64

        def inference_mode(self, mode: str):
            self._mode = mode
            return self

        def batch_limit(self, n: int):
            self._batch_limit = n
            return self

        def queue_limit(self, n: int):
            self._queue_limit = n
            return self

        def build(self) -> "ParallelInference":
            return ParallelInference(
                self._model, inference_mode=self._mode,
                batch_limit=self._batch_limit,
                queue_limit=self._queue_limit)

    @property
    def n_workers(self) -> int:
        """Replicas serving requests: one, the model on its device."""
        return 1

    # ------------------------------------------------------------------
    def _ensure(self):
        if not self.model._initialized:
            self.model.init()

    def _forward_chunk(self, x: np.ndarray) -> np.ndarray:
        """One forward of a host batch on the model's device; the copy
        back to the host is the synchronisation point."""
        m = self.model
        if not x.flags.writeable:       # torch refuses read-only views
            x = np.array(x)
        self._count_forward()
        with torch.inference_mode():
            acts, _ = m._forward(m.params, m.states, [m._as_input(x)])
            return acts[m.conf.network_outputs[0]].cpu().numpy()

    def _count_forward(self) -> None:
        telemetry.counter(
            "dl4j_inference_forwards_total",
            "model forwards run by ParallelInference and its batchers"
        ).inc()
        # INPLACE and SEQUENTIAL run on the callers' threads; not the lock
        # submit holds over a full queue, which the worker must drain
        with self._forwards_lock:
            self.forwards += 1

    def output(self, x) -> np.ndarray:
        self._ensure()
        return self._forward_chunk(np.asarray(x))

    def output_batched(self, requests: List) -> List[np.ndarray]:
        """Aggregate ``requests`` into ``batch_limit``-row forwards and
        hand each request its rows."""
        if not requests:
            return []
        self._ensure()
        arrays = [np.asarray(r) for r in requests]
        sizes = [a.shape[0] for a in arrays]
        big = np.concatenate(arrays, axis=0)
        outs = [self._forward_chunk(big[i:i + self.batch_limit])
                for i in range(0, big.shape[0], self.batch_limit)]
        flat = np.concatenate(outs, axis=0)
        result, off = [], 0
        for s in sizes:
            result.append(flat[off:off + s])
            off += s
        return result

    # -- async serving ---------------------------------------------------
    def submit(self, x) -> "concurrent.futures.Future":
        """Submit one request; returns a Future of its result. BATCHED
        queues it for the worker; INPLACE and SEQUENTIAL run it here."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self.inference_mode != InferenceMode.BATCHED:
            telemetry.counter(
                "dl4j_inference_requests_total",
                "requests submitted to ParallelInference").inc(
                    mode=self.inference_mode)
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(self.output(x))
                except BaseException as e:       # noqa: BLE001
                    fut.set_exception(e)
            return fut
        self._enqueue(x, fut)
        return fut

    def _enqueue(self, x, fut) -> None:
        telemetry.counter(
            "dl4j_inference_requests_total",
            "requests submitted to ParallelInference").inc(
                mode=self.inference_mode)
        # the put happens under the lock shutdown() takes to enqueue its
        # sentinel, so no request lands behind the sentinel
        with self._lock:
            self._ensure_worker()
            self._requests.put((x, fut, time.monotonic()))

    def _ensure_worker(self):
        """Start the flush worker (caller holds ``self._lock``)."""
        if self._worker is not None:
            return
        self._requests = _queue.Queue(self.queue_limit)
        self._shutdown = False
        q = self._requests

        def loop():
            while True:
                try:
                    first = q.get(timeout=0.1)
                except _queue.Empty:
                    if self._shutdown:
                        return
                    continue
                if first is None:
                    return
                batch = [first]
                # window: wait up to batch_window_ms for batch-mates;
                # continuous: take only what is already queued
                window = self.flush_policy == "window"
                until = time.monotonic() + self.batch_window_ms / 1e3
                while len(batch) < self.batch_limit:
                    try:
                        if window:
                            nxt = q.get(timeout=max(
                                until - time.monotonic(), 0) or 1e-4)
                        else:
                            nxt = q.get_nowait()
                    except _queue.Empty:
                        break
                    if nxt is None:
                        self._flush(batch)
                        return
                    batch.append(nxt)
                self._flush(batch)

        self._worker = threading.Thread(target=loop, daemon=True,
                                        name="dl4j-torch-serving")
        self._worker.start()

    def _flush(self, batch):
        live = [(x, f, t) for x, f, t in batch
                if f.set_running_or_notify_cancel()]
        if not live:
            return
        try:
            with telemetry.span("inference.flush", requests=len(live)):
                outs = self.output_batched([x for x, _, _ in live])
        except BaseException as e:           # noqa: BLE001
            for _, f, _ in live:
                f.set_exception(e)
            return
        for (_, f, _), o in zip(live, outs):
            f.set_result(o)

    def shutdown(self):
        """Stop the worker after it flushes what is queued; futures
        still queued after it exits are cancelled."""
        with self._lock:
            worker, self._worker = self._worker, None
            if worker is None:
                return
            self._shutdown = True
            q = self._requests
            q.put(None)
        worker.join()
        while True:
            try:
                item = q.get_nowait()
            except _queue.Empty:
                break
            if item is not None:
                item[1].cancel()
