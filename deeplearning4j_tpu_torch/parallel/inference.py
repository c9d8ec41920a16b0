"""ParallelInference: request batching in front of one model.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py``'s
``BATCHED`` mode on one device: a queue and a worker thread aggregate
concurrent requests into one forward on the model's device. The worker
flushes continuously, as the JAX package's serving batcher does by
default: it blocks for one request, takes whatever else is queued (up
to ``batch_limit``) and runs it at once, so arrivals during a forward
form the next batch. The JAX package's mesh (batch sharded over several
chips) becomes the single device the model lives on; data parallelism
comes with its own slice.

The forward runs under ``torch.inference_mode()``, entered by whichever
thread runs it (the mode is thread-local, and the worker is a thread of
its own).
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


class ParallelInference:
    def __init__(self, model, *, batch_limit: int = 32,
                 queue_limit: int = 64):
        self.model = model
        self.batch_limit = batch_limit
        self.queue_limit = queue_limit
        self._worker = None
        self._requests = None
        self._shutdown = False
        self._lock = threading.Lock()

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
        telemetry.counter(
            "dl4j_inference_forwards_total",
            "model forwards run by ParallelInference and its batchers"
        ).inc()
        with torch.inference_mode():
            acts, _ = m._forward(m.params, m.states, [m._as_input(x)])
            return acts[m.conf.network_outputs[0]].cpu().numpy()

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
        """Enqueue one request; returns a Future of its result."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._enqueue(x, fut)
        return fut

    def _enqueue(self, x, fut) -> None:
        telemetry.counter(
            "dl4j_inference_requests_total",
            "requests submitted to ParallelInference").inc()
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
                while len(batch) < self.batch_limit:
                    try:
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
