"""Per-model dynamic batcher with shape-bucketed flushes.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py`` in dense mode:
a ``ParallelInference`` whose flushes are padded up to the nearest warm
bucket (a batch size run once at warmup), so steady-state requests only
ever meet shapes the device has seen. The default trigger is
ParallelInference's continuous one: the worker flushes the moment the
device is free and takes whatever is waiting; ``flush_policy="window"``
holds the first request up to ``batch_window_ms`` for batch-mates.
Realised fill lands in ``dl4j_serving_batch_occupancy`` (live rows over
padded rows) by model and policy. A per-version ``RetraceGuard`` counts
the padded shapes served; after warmup its count must not move.

A request may carry its
:class:`~deeplearning4j_tpu_torch.common.tracectx.TraceContext`
(``submit(..., ctx=)``): the flush worker, on its own thread, puts the
request's ``queue`` (submit to flush), ``batch_wait`` (flush
bookkeeping before the forward) and ``device`` (the forward, ending in
the copy to the host) phases on its timeline, with the batch size and
occupancy as notes.

Requests carry an optional ``time.monotonic()`` deadline: one that
expires while queued is cancelled with
:class:`~deeplearning4j_tpu_torch.serving.admission.DeadlineExceeded`,
never computed.

Model surfaces: a ComputationGraph runs its own ``_forward``; any other
model serves through its ``output(batch)`` (the generic path: the
registry's SameDiff adapter, a DecoderLM's logits). A model
with the ``prefill`` / ``decode_step`` contract (``DecoderLM``) also
gets a :class:`~deeplearning4j_tpu_torch.serving.generative.DecodeEngine`
over a paged KV pool on the model's device: ``generate=`` configures it
(``kv_blocks``, ``kv_block_size``, ``prompt_buckets``, ``decode_buckets``,
``max_seq_len``, ``rng_seed``, ``paged`` (``True``/``False`` forces the
paged or dense decode attention, ``None`` leaves it to the ladder), and
``kv_dtype``, the last defaulting from ``DL4J_TORCH_KV_DTYPE``). Dense
mode only: the JAX
package's residency modes and ``param_dtype`` are not ported.
"""
from __future__ import annotations

import concurrent.futures
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.compilecache import RetraceGuard
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.serving.admission import (
    DeadlineExceeded, deadline_shed_counter)

_LATENCY_HELP = ("serving request latency by stage: queue "
                 "(submit->flush), compute (flush forward, ending in the "
                 "device-to-host copy), total (submit->result), warmup "
                 "(per-bucket first run) (seconds)")

def _latency() -> telemetry.Histogram:
    return telemetry.histogram("dl4j_serving_latency_seconds",
                               _LATENCY_HELP)


class ServingBatcher(ParallelInference):
    """A ``ParallelInference`` whose flushes land on warm buckets."""

    mode = "dense"

    def __init__(self, model, buckets: Sequence[int] = (8, 32), *,
                 name: str = "model",
                 queue_limit: int = 256,
                 guard: Optional[RetraceGuard] = None,
                 flush_policy: str = "continuous",
                 batch_window_ms: float = 2.0,
                 generate: Optional[dict] = None):
        #: generic path: no graph ``_forward``, serve ``model.output``
        self._generic = None if hasattr(model, "_forward") \
            else model.output
        #: generative path: a DecodeEngine beside the predict path
        self._generative = (hasattr(model, "prefill")
                            and hasattr(model, "decode_step"))
        self.generate_config = dict(generate or {})
        self.engine = None
        if not buckets:
            raise ValueError("need at least one warmup bucket")
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        super().__init__(model, batch_limit=self.buckets[-1],
                         queue_limit=queue_limit, flush_policy=flush_policy,
                         batch_window_ms=batch_window_ms)
        self.name = name
        self.guard = guard if guard is not None else RetraceGuard(
            f"serving:{name}", threshold=len(self.buckets) + 1)
        self._warmed = False

    @property
    def params(self):
        """What this batcher holds resident: the model's parameters."""
        return getattr(self.model, "params", None)

    # ------------------------------------------------------------------
    def _ensure(self):
        if self._generic is None:
            super()._ensure()

    def _bucket_for(self, n: int) -> Optional[int]:
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def _pad_to_bucket(self, chunk: np.ndarray) -> np.ndarray:
        """Pad the batch dim up to the nearest warm bucket by repeating
        the last row (sliced off after the forward)."""
        n = chunk.shape[0]
        b = self._bucket_for(n)
        if b is None or b == n:
            return chunk
        reps = np.repeat(chunk[-1:], b - n, axis=0)
        return np.concatenate([chunk, reps], axis=0)

    def _record(self, padded: np.ndarray) -> None:
        """A new signature after warmup is a bucket miss: a shape the
        warm set did not cover reached the device."""
        hit = self.guard.record(padded)
        if self._warmed and not hit:
            telemetry.counter(
                "dl4j_serving_bucket_miss_total",
                "post-warmup flushes whose padded shape no warm bucket "
                "covered").inc(model=self.name)

    def _forward_padded(self, padded: np.ndarray, orig: int
                        ) -> np.ndarray:
        self._record(padded)
        if self._generic is None:
            return self._forward_chunk(padded)[:orig]
        self._count_forward()
        if not padded.flags.writeable:  # torch refuses read-only views
            padded = np.array(padded)
        out = self._generic(padded)
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        return np.asarray(out)[:orig]

    # ------------------------------------------------------------------
    def warmup(self, input_shape: Sequence[int],
               dtype=np.float32) -> float:
        """Run one forward per bucket (to completion) so the first real
        request meets a shape the device has seen. ``input_shape`` is
        one request's shape without the batch dim. Returns seconds."""
        self._ensure()
        lat = _latency()
        t_all = time.perf_counter()
        for b in self.buckets:
            x = np.zeros((b,) + tuple(input_shape), dtype)
            t0 = time.perf_counter()
            with telemetry.span("serving.warmup", model=self.name,
                                bucket=b):
                self._forward_padded(x, b)
            lat.observe(time.perf_counter() - t0, model=self.name,
                        stage="warmup")
        self._warmed = True
        return time.perf_counter() - t_all

    # -- generative path -----------------------------------------------
    @property
    def is_generative(self) -> bool:
        return self._generative

    def _ensure_generate(self):
        """Build the KV pool (on the model's device) and the DecodeEngine
        on first use."""
        if not self._generative:
            raise ValueError(f"model {self.name!r} has no "
                             f"prefill/decode_step surface")
        if self.engine is not None:
            return self.engine
        from deeplearning4j_tpu_torch.serving.generative import \
            DecodeEngine
        from deeplearning4j_tpu_torch.serving.kvcache import KVBlockPool
        cfg = self.generate_config
        m = self.model
        if getattr(m, "params", None) is None:
            m.init()
        c = m.conf
        kv_dtype = cfg.get("kv_dtype") or \
            os.environ.get("DL4J_TORCH_KV_DTYPE", "").strip() or "float32"
        pool = KVBlockPool(
            c.n_layers, int(cfg.get("kv_blocks", 64)),
            int(cfg.get("kv_block_size", 16)), c.n_heads, c.head_dim,
            dtype=kv_dtype, device=m.device, name=self.name)
        self.engine = DecodeEngine(
            m, m.params, pool, name=self.name,
            prompt_buckets=cfg.get("prompt_buckets", (16, 64)),
            decode_buckets=cfg.get("decode_buckets", (4, 8)),
            max_seq_len=cfg.get("max_seq_len"), paged=cfg.get("paged"),
            guard=self.guard, rng_seed=int(cfg.get("rng_seed", 0)))
        return self.engine

    def warmup_generate(self) -> float:
        """Run every prefill and decode bucket once before the first real
        generate request (the generative half of :meth:`warmup`).
        Returns seconds."""
        engine = self._ensure_generate()
        t0 = time.perf_counter()
        with telemetry.span("serving.warmup_generate", model=self.name):
            secs = engine.warmup()
        _latency().observe(secs, model=self.name, stage="warmup")
        self._warmed = True
        return time.perf_counter() - t0

    def generate_cost(self, prompt_len: int, max_tokens: int = 0) -> int:
        """Token cost of a generate admission (KV blocks)."""
        return self._ensure_generate().generate_cost(prompt_len,
                                                     max_tokens)

    def submit_generate(self, prompt, max_tokens: int, *,
                        temperature: float = 0.0, top_k: int = 0,
                        deadline: Optional[float] = None, ctx=None):
        """Enqueue a generate request; returns its
        :class:`~deeplearning4j_tpu_torch.serving.generative.TokenStream`.
        Raises ``PoolExhausted`` at once when the KV pool cannot hold the
        prompt (shed upstream as 429 + Retry-After). ``ctx``, the
        request's TraceContext, rides into the decode engine."""
        engine = self._ensure_generate()
        telemetry.counter(
            "dl4j_inference_requests_total",
            "requests submitted to ParallelInference").inc(mode="generate")
        return engine.submit(prompt, max_tokens, temperature=temperature,
                             top_k=top_k, deadline=deadline, ctx=ctx)

    def shutdown(self):
        if self.engine is not None:
            self.engine.shutdown()
        return super().shutdown()

    # ------------------------------------------------------------------
    def output_batched(self, requests: List) -> List[np.ndarray]:
        """Aggregate ``requests`` into bucket-padded flushes: rows are
        chunked by the largest bucket and each chunk padded up to its
        nearest bucket."""
        if not requests:
            return []
        self._ensure()
        arrays = [np.asarray(r) for r in requests]
        sizes = [a.shape[0] for a in arrays]
        big = np.concatenate(arrays, axis=0) if len(arrays) > 1 \
            else arrays[0]
        cap = self.buckets[-1]
        outs = []
        for i in range(0, big.shape[0], cap):
            chunk = big[i:i + cap]
            outs.append(self._forward_padded(self._pad_to_bucket(chunk),
                                             chunk.shape[0]))
        flat = np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
        result, off = [], 0
        for s in sizes:
            result.append(flat[off:off + s])
            off += s
        return result

    # ------------------------------------------------------------------
    def submit(self, x, deadline: Optional[float] = None, ctx=None
               ) -> "concurrent.futures.Future":
        """Enqueue one request; ``deadline`` is an absolute
        ``time.monotonic()`` instant past which it must not be computed;
        ``ctx`` is the request's TraceContext, carried on the Future to
        the flush worker."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if deadline is not None:
            fut._serving_deadline = float(deadline)
        if ctx is not None:
            fut._trace_ctx = ctx
        self._enqueue(x, fut)
        return fut

    def _padded_rows(self, rows: int) -> int:
        """Rows the device computes for ``rows`` live rows."""
        cap, total = self.buckets[-1], 0
        while rows > 0:
            take = min(rows, cap)
            total += self._bucket_for(take) or take
            rows -= take
        return total

    def _flush(self, batch):
        now = time.monotonic()
        live = []
        for x, f, t in batch:
            dl = getattr(f, "_serving_deadline", None)
            if dl is not None and now >= dl:
                deadline_shed_counter().inc(model=self.name, where="queue")
                if f.set_running_or_notify_cancel():
                    f.set_exception(DeadlineExceeded(
                        f"deadline passed {now - dl:.3f}s before flush"))
                continue
            if f.set_running_or_notify_cancel():
                live.append((x, f, t))
        if not live:
            return
        lat = _latency()
        rows = sum(int(np.asarray(x).shape[0]) for x, _, _ in live)
        occupancy = rows / max(1, self._padded_rows(rows))
        if telemetry.enabled():
            for _, _, t in live:
                lat.observe(now - t, model=self.name, stage="queue")
            telemetry.histogram(
                "dl4j_serving_batch_occupancy",
                "live rows / bucket-padded rows per serving flush, by "
                "model and flush policy (decode steps: policy=decode)",
                buckets=telemetry.RATIO_BUCKETS).observe(
                    occupancy, model=self.name, policy=self.flush_policy)
        t0 = time.perf_counter()
        t_dev0 = time.monotonic()
        try:
            with telemetry.span("serving.flush", model=self.name,
                                requests=len(live)):
                outs = self.output_batched([x for x, _, _ in live])
        except BaseException as e:           # noqa: BLE001
            for _, f, _ in live:
                f.set_exception(e)
            return
        t_dev1 = time.monotonic()
        lat.observe(time.perf_counter() - t0, model=self.name,
                    stage="compute")
        end = time.monotonic()
        for (_, f, t), o in zip(live, outs):
            lat.observe(end - t, model=self.name, stage="total")
            ctx = getattr(f, "_trace_ctx", None)
            if ctx is not None:
                ctx.phase_at("queue", t, now)
                ctx.phase_at("batch_wait", now, t_dev0)
                ctx.phase_at("device", t_dev0, t_dev1)
                ctx.note(batch=len(live), occupancy=round(occupancy, 3))
            f.set_result(o)
