"""Continuous-batching generative decode engine.

Counterpart of ``deeplearning4j_tpu/serving/generative.py``. Decode is
iteration-level work (Orca): the scheduling unit is one token step over
all live sequences, not one request. The engine owns that loop:

- **Prefill**: a new request's prompt, padded up to its prompt bucket,
  runs full causal attention (``DecoderLM.prefill``); its K/V are
  scattered into the request's blocks of the
  :class:`~deeplearning4j_tpu_torch.serving.kvcache.KVBlockPool` (padded
  positions into the scratch block 0) and its first token is sampled:
  the time-to-first-token span.
- **Decode**: every iteration runs ONE step over the live sequences,
  padded up to a decode bucket: each writes its new K/V into the pool in
  place, paged attention (kernel 10 on the card, the dense gather on the
  CPU; the ``paged_attention`` family of ``ops/kernel_select.py``),
  sample, append.
- **Retire**: a sequence leaves on EOS, ``max_tokens``, cancel or
  deadline, and its blocks return to the pool mid-batch: the others keep
  decoding, the freed blocks admit the next prefill.

Consumers read a :class:`TokenStream`, a queue the engine thread pushes
ids into as they decode (the producer of the server's chunked stream).

PyTorch runs eagerly and compiles nothing per shape, but the guard keeps
the JAX package's bookkeeping: every dispatch's padded signature is
recorded in the batcher's ``RetraceGuard``, and
``retraces_since_warmup() == 0`` says that steady state only met the
shapes warmup ran. ``decode_steps`` counts the decode steps run (warmup's
included): each launches kernel 10 once per layer on the card.
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.compilecache import RetraceGuard
from deeplearning4j_tpu_torch.ops.attention_kernels import \
    select_paged_backend
from deeplearning4j_tpu_torch.ops.sampling import sample_logits
from deeplearning4j_tpu_torch.serving.admission import DeadlineExceeded
from deeplearning4j_tpu_torch.serving.kvcache import (KVBlockPool,
                                                      PoolExhausted)

def _ttft_hist() -> telemetry.Histogram:
    return telemetry.histogram(
        "dl4j_generate_ttft_seconds",
        "time-to-first-token of generate requests: submit -> first "
        "sampled token (prefill queue + prefill compute), per model "
        "(seconds)")


def _intertoken_hist() -> telemetry.Histogram:
    return telemetry.histogram(
        "dl4j_generate_intertoken_seconds",
        "gap between consecutive streamed tokens of one sequence "
        "(seconds)")


def _tokens_counter() -> telemetry.Counter:
    return telemetry.counter(
        "dl4j_generate_tokens_total",
        "tokens decoded and streamed, per model")


def _requests_counter() -> telemetry.Counter:
    return telemetry.counter(
        "dl4j_generate_requests_total",
        "generate requests finished, by model and outcome (eos | "
        "max_tokens | cancelled | deadline | kv_pool | error)")


def _live_gauge() -> telemetry.Gauge:
    return telemetry.gauge(
        "dl4j_generate_live_sequences",
        "sequences currently in the continuous decode batch, per model")


def _disconnects_counter() -> telemetry.Counter:
    return telemetry.counter(
        "dl4j_generate_stream_disconnects_total",
        "generate streams cancelled mid-decode by client disconnect; "
        "their KV blocks return to the pool on the next iteration")


def _decode_step_hist() -> telemetry.Histogram:
    return telemetry.histogram(
        "dl4j_generate_decode_step_seconds",
        "wall time of one decode iteration over the live batch (K/V "
        "write + paged attention + sample, ending in the copy of the ids "
        "to the host), per model (seconds)")


class TokenStream:
    """Consumer handle of one generate request: iterate token ids as the
    engine decodes them; ``reason`` says how the sequence ended.
    ``cancel()`` (client disconnect) retires the sequence and frees its
    KV blocks on the engine's next iteration."""

    _DONE = object()

    def __init__(self, seq_id: int, prompt_len: int):
        self.seq_id = seq_id
        self.prompt_len = prompt_len
        self.reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False
        self._q: "_queue.Queue" = _queue.Queue()

    # engine side ---------------------------------------------------------
    def _put(self, token: int) -> None:
        self._q.put(int(token))

    def _close(self, reason: str,
               error: Optional[BaseException] = None) -> None:
        if self.reason is None:
            self.reason = reason
            self.error = error
            self._q.put(self._DONE)

    # consumer side -------------------------------------------------------
    def cancel(self) -> None:
        self.cancelled = True

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self.error is not None:
                    raise self.error
                return
            yield item

    def next(self, timeout: Optional[float] = None) -> Optional[int]:
        """The next id, or None once the stream has closed (see
        ``reason``). Raises the stream's error on a failed sequence,
        ``queue.Empty`` on timeout."""
        item = self._q.get(timeout=timeout)
        if item is self._DONE:
            if self.error is not None:
                raise self.error
            return None
        return item

    def tokens(self, timeout: Optional[float] = None) -> List[int]:
        """Drain the whole stream (blocking); raises the stream's error
        if the sequence failed."""
        out: List[int] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            item = self._q.get(timeout=left)
            if item is self._DONE:
                if self.error is not None:
                    raise self.error
                return out
            out.append(item)


class _Sequence:
    """Engine-internal live-sequence state."""

    __slots__ = ("seq_id", "stream", "next_token", "position", "generated",
                 "max_tokens", "temperature", "top_k", "deadline", "t_last",
                 "ctx")

    def __init__(self, seq_id, stream, next_token, position, max_tokens,
                 temperature, top_k, deadline, t_last, ctx=None):
        self.seq_id = seq_id
        self.stream = stream
        self.next_token = int(next_token)   # fed to the next step
        self.position = int(position)       # its index in the sequence
        self.generated = 1                  # the prefill-sampled token
        self.max_tokens = int(max_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.deadline = deadline
        self.t_last = t_last                # last token emit instant
        self.ctx = ctx                      # the request's TraceContext


class DecodeEngine:
    """The prefill/decode continuous-batching loop over one model.

    ``model`` exposes the :class:`~deeplearning4j_tpu_torch.models.decoder.
    DecoderLM` contract (``prefill``, ``decode_step``, ``conf``);
    ``params`` live on the pool's device. ``paged=None`` lets the
    ``paged_attention`` ladder pick the decode attention route at every
    step (kernel 10 on the card unless ``DL4J_TORCH_PAGED_ATTENTION=0``);
    ``True`` or ``False`` forces the paged or the dense route, recorded
    on the ladder's counter as forced or killed. ``warmup()`` runs every
    prompt bucket's prefill and
    every decode bucket's step once, so the guard's count freezes before
    the first real request."""

    def __init__(self, model, params, pool: KVBlockPool, *,
                 name: str = "model",
                 prompt_buckets: Sequence[int] = (16, 64),
                 decode_buckets: Sequence[int] = (4, 8),
                 max_seq_len: Optional[int] = None,
                 guard: Optional[RetraceGuard] = None,
                 rng_seed: int = 0, paged: Optional[bool] = None):
        self.model = model
        self.paged = paged
        self.params = params
        self.pool = pool
        self.device = pool.device
        self.name = name
        self.prompt_buckets = tuple(sorted({int(b) for b in prompt_buckets}))
        self.decode_buckets = tuple(sorted({int(b) for b in decode_buckets}))
        cap = pool.usable_blocks * pool.block_size
        self.max_seq_len = int(min(max_seq_len or model.conf.max_len,
                                   model.conf.max_len, cap))
        #: fixed block-table width, part of every decode signature
        self.max_blocks = pool.blocks_for(self.max_seq_len)
        self.guard = guard if guard is not None else RetraceGuard(
            f"generate:{name}",
            threshold=len(self.prompt_buckets) + len(self.decode_buckets)
            + 2)
        self._seq_ids = itertools.count(1)
        self._pending: "_queue.Queue" = _queue.Queue()
        self._live: Dict[int, _Sequence] = {}
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        #: the worker shutdown() swapped out, until it finishes its
        #: drain: _ensure_worker joins it, so two workers never touch
        #: _pending/_live at once
        self._draining: Optional[threading.Thread] = None
        self._work = threading.Event()
        self._shutdown = False
        self._warmed = False
        self.warm_signatures = 0
        #: decode steps run, warmup's included
        self.decode_steps = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            int(rng_seed))

    # -- the device work ---------------------------------------------------
    def _paged_now(self, batch: int) -> bool:
        override = None if self.paged is None else bool(self.paged)
        backend, _ = select_paged_backend(batch, self.max_blocks,
                                          device=self.device,
                                          override=override,
                                          use_env_override=override is None)
        return backend == "paged"

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill_commit(self, tokens: np.ndarray, length: np.ndarray,
                        slots: np.ndarray, temperature: float, top_k: int
                        ) -> int:
        """Prefill one bucket-padded prompt, write its K/V into the pool
        at ``slots`` (padded positions at scratch slot 0) and sample its
        first token."""
        with torch.inference_mode():
            last, k, v = self.model.prefill(self.params, self._tensor(tokens),
                                            self._tensor(length))
            pool = self.pool
            nl, nb, bs = pool.k.shape[:3]
            kf = pool.k.view(nl, nb * bs, *pool.k.shape[3:])
            vf = pool.v.view(nl, nb * bs, *pool.v.shape[3:])
            idx = self._tensor(slots).long()
            kf[:, idx] = k[:, 0].to(kf.dtype)
            vf[:, idx] = v[:, 0].to(vf.dtype)
            first = sample_logits(
                last, self._gen,
                torch.tensor([temperature], device=self.device),
                torch.tensor([top_k], device=self.device))
            return int(first.cpu()[0])

    def _decode(self, tokens, positions, tables, temps, topks
                ) -> np.ndarray:
        """One decode step over a bucket-padded batch; the sampled ids on
        the host."""
        with torch.inference_mode():
            logits, _, _ = self.model.decode_step(
                self.params, self._tensor(tokens), self._tensor(positions),
                self.pool.k, self.pool.v, self._tensor(tables),
                paged=self._paged_now(len(tokens)))
            ids = sample_logits(logits, self._gen, self._tensor(temps),
                                self._tensor(topks))
            self.decode_steps += 1
            return ids.cpu().numpy()

    # -- warmup ------------------------------------------------------------
    def warmup(self) -> float:
        """Run every prompt bucket's prefill (its writes to the scratch
        block) and every decode bucket's step once, on dummy data, to
        completion. The guard's count freezes here: a later new
        signature is a bucket miss."""
        t0 = time.perf_counter()
        for t in self.prompt_buckets:
            tokens = np.zeros((1, t), np.int32)
            length = np.asarray([1], np.int32)
            slots = np.zeros((t,), np.int64)
            self.guard.record(tokens, length)
            self.guard.record(slots)
            self._prefill_commit(tokens, length, slots, 0.0, 0)
        for b in self.decode_buckets:
            args = self._decode_args(b)
            self.guard.record(*args)
            self._decode(*args)
        self._warmed = True
        self.warm_signatures = self.guard.n_signatures
        return time.perf_counter() - t0

    def retraces_since_warmup(self) -> int:
        """Distinct signatures dispatched after warmup: 0 in steady state
        across any join/leave churn."""
        return self.guard.n_signatures - self.warm_signatures

    # -- request intake ----------------------------------------------------
    def generate_cost(self, prompt_len: int, max_tokens: int = 0) -> int:
        """Admission cost of a generate request: the KV blocks its prompt
        and completion occupy."""
        return self.pool.blocks_for(int(prompt_len) + int(max_tokens))

    def submit(self, prompt, max_tokens: int, *, temperature: float = 0.0,
               top_k: int = 0, deadline: Optional[float] = None,
               ctx=None) -> TokenStream:
        """Enqueue a generate request; returns its token stream. The
        prompt's KV blocks are allocated here, so
        :class:`~deeplearning4j_tpu_torch.serving.kvcache.PoolExhausted`
        (HTTP 429 upstream) raises before the caller streams anything.
        ``ctx``, the request's TraceContext, rides the pending entry: the
        engine thread puts the request's ``queue`` and ``device``
        (prefill) phases and a ``req.inter_token`` instant a decoded
        token on its timeline."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must carry at least one token")
        if prompt.size >= self.max_seq_len:
            raise ValueError(f"prompt of {prompt.size} tokens >= "
                             f"max_seq_len {self.max_seq_len}")
        if deadline is not None and time.monotonic() >= deadline:
            raise DeadlineExceeded(
                "deadline already expired at generate submit")
        max_tokens = int(min(max_tokens, self.max_seq_len - prompt.size))
        seq_id = next(self._seq_ids)
        self.pool.alloc(seq_id, int(prompt.size))
        stream = TokenStream(seq_id, int(prompt.size))
        with self._lock:
            self._ensure_worker()
            self._pending.put((seq_id, prompt, max_tokens,
                               float(temperature), int(top_k), deadline,
                               stream, time.monotonic(), ctx))
        self._work.set()
        return stream

    def _ensure_worker(self):
        """Start the engine thread (caller holds ``self._lock``)."""
        if self._worker is not None:
            return
        prev, self._draining = self._draining, None
        if prev is not None:
            # the old worker drains _pending/_live alone; it never takes
            # this lock, so waiting here cannot deadlock
            prev.join()
        self._shutdown = False
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=f"dl4j-generate-{self.name}")
        self._worker.start()

    def shutdown(self, timeout: float = 30.0):
        """Stop the engine thread after it drains every admitted and
        pending sequence (bounded by ``timeout``). A concurrent submit
        either reaches the old worker's drain or starts a fresh one."""
        with self._lock:
            self._shutdown = True
            w, self._worker = self._worker, None
            if w is not None:
                self._draining = w
        self._work.set()
        if w is not None:
            w.join(timeout)

    # -- the continuous loop -----------------------------------------------
    def _loop(self):
        me = threading.current_thread()
        while True:
            # clear before draining: a submit after the drain sets the
            # event again, so the wait below returns at once
            self._work.clear()
            admitted = self._admit_pending()
            stepped = self._decode_iteration()
            if admitted or stepped:
                continue
            # idle: every pending request admitted and every admitted
            # sequence retired, so leaving strands no stream
            if self._shutdown or self._worker is not me:
                return
            self._work.wait(0.05)

    def _admit_pending(self) -> bool:
        """Prefill every queued request, then join it to the decode
        batch."""
        admitted = False
        while True:
            try:
                item = self._pending.get_nowait()
            except _queue.Empty:
                return admitted
            admitted = True
            (seq_id, prompt, max_tokens, temperature, top_k, deadline,
             stream, t_submit, ctx) = item
            if stream.cancelled or (deadline is not None
                                    and time.monotonic() >= deadline):
                self.pool.free(seq_id)
                if ctx is not None:
                    ctx.phase_at("queue", t_submit, time.monotonic())
                self._finish(stream,
                             "cancelled" if stream.cancelled else "deadline")
                continue
            try:
                self._prefill_one(seq_id, prompt, max_tokens, temperature,
                                  top_k, deadline, stream, t_submit, ctx)
            except Exception as e:  # the stream carries it to its reader
                self.pool.free(seq_id)
                self._finish(stream, "error", e)

    def _prompt_bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return n                    # longer than every bucket: its own shape

    def _prefill_one(self, seq_id, prompt, max_tokens, temperature, top_k,
                     deadline, stream, t_submit, ctx=None):
        t_prefill = time.monotonic()
        if ctx is not None:
            # the engine-side queue phase: submit to prefill start
            ctx.phase_at("queue", t_submit, t_prefill)
        t = self._prompt_bucket(prompt.size)
        tokens = np.zeros((1, t), np.int32)
        tokens[0, :prompt.size] = prompt
        length = np.asarray([prompt.size], np.int32)
        # the prompt's K/V slots in its blocks; padded positions go to
        # the scratch block 0
        table = np.asarray(self.pool.table(seq_id), np.int64)
        bs = self.pool.block_size
        idx = np.arange(t)
        slots = np.where(idx < prompt.size,
                         table[np.minimum(idx // bs, len(table) - 1)] * bs
                         + idx % bs, 0)
        self._record(tokens, length)
        self._record(slots)
        with telemetry.span("generate.prefill", model=self.name,
                            tokens=int(prompt.size)):
            first = self._prefill_commit(tokens, length, slots,
                                         temperature, top_k)
        now = time.monotonic()
        _ttft_hist().observe(now - t_submit, model=self.name)
        if ctx is not None:
            # prefill, K/V commit and the first token's sample are this
            # request's device phase (decode steps are shared by the live
            # batch: instants a token instead)
            ctx.phase_at("device", t_prefill, now)
            ctx.note(kv_blocks=len(self.pool.table(seq_id)),
                     prompt_tokens=int(prompt.size))
        stream._put(first)
        _tokens_counter().inc(model=self.name)
        eos = self.model.conf.eos_id
        if first == eos or max_tokens <= 1:
            self.pool.free(seq_id)
            self._finish(stream, "eos" if first == eos else "max_tokens")
            return
        self._live[seq_id] = _Sequence(
            seq_id, stream, first, int(prompt.size), max_tokens,
            temperature, top_k, deadline, now, ctx)
        _live_gauge().set(len(self._live), model=self.name)

    def _decode_bucket(self, n: int) -> int:
        for b in self.decode_buckets:
            if n <= b:
                return b
        return self.decode_buckets[-1]

    def _decode_args(self, b: int):
        """Zeroed host arrays of a bucket-``b`` step: tokens, positions,
        tables, temperatures, top-k (an all-dead batch)."""
        return (np.zeros((b,), np.int32), np.zeros((b,), np.int32),
                np.zeros((b, self.max_blocks), np.int32),
                np.zeros((b,), np.float32), np.zeros((b,), np.int32))

    def _retire(self, seq: _Sequence, reason: str,
                error: Optional[BaseException] = None) -> None:
        self._live.pop(seq.seq_id, None)
        self.pool.free(seq.seq_id)
        self._finish(seq.stream, reason, error)
        _live_gauge().set(len(self._live), model=self.name)

    def _finish(self, stream: TokenStream, reason: str,
                error: Optional[BaseException] = None) -> None:
        stream._close(reason, error)
        if reason == "cancelled":
            _disconnects_counter().inc(model=self.name)
        _requests_counter().inc(model=self.name, outcome=reason)

    def _decode_iteration(self) -> bool:
        """ONE step over the live sequences; False when idle."""
        if not self._live:
            return False
        now = time.monotonic()
        # cancelled and expired sequences leave before the step
        for seq in list(self._live.values()):
            if seq.stream.cancelled:
                self._retire(seq, "cancelled")
            elif seq.deadline is not None and now >= seq.deadline:
                self._retire(seq, "deadline")
        # every sequence of this step grows by one token slot; a pool
        # with no free block sheds THAT sequence, the rest keep decoding.
        # (The JAX package extends every live sequence, also those past
        # the largest bucket that this step leaves out.)
        seqs = []
        for seq in list(self._live.values())[:self.decode_buckets[-1]]:
            try:
                self.pool.extend(seq.seq_id, 1)
                seqs.append(seq)
            except PoolExhausted as e:
                self._retire(seq, "kv_pool", e)
        if not seqs:
            return True
        b = self._decode_bucket(len(seqs))
        tokens, positions, tables, temps, topks = self._decode_args(b)
        for i, seq in enumerate(seqs):
            tokens[i] = seq.next_token
            positions[i] = seq.position
            tables[i] = self.pool.padded_table(seq.seq_id, self.max_blocks)
            temps[i] = seq.temperature
            topks[i] = seq.top_k
        self._record(tokens, positions, tables, temps, topks)
        t0 = time.perf_counter()
        with telemetry.span("generate.decode_step", model=self.name,
                            live=len(seqs), bucket=b):
            ids = self._decode(tokens, positions, tables, temps, topks)
        _decode_step_hist().observe(time.perf_counter() - t0,
                                    model=self.name)
        if telemetry.enabled():
            telemetry.histogram(
                "dl4j_serving_batch_occupancy",
                "live rows / bucket-padded rows per serving flush, by "
                "model and flush policy (decode steps: policy=decode)",
                buckets=telemetry.RATIO_BUCKETS).observe(
                    len(seqs) / max(1, b), model=self.name, policy="decode")
        now = time.monotonic()
        eos = self.model.conf.eos_id
        for i, seq in enumerate(seqs):
            tok = int(ids[i])
            seq.stream._put(tok)
            _tokens_counter().inc(model=self.name)
            if seq.ctx is not None:
                seq.ctx.instant("inter_token", index=seq.generated,
                                gap_ms=round((now - seq.t_last) * 1e3, 3))
            _intertoken_hist().observe(now - seq.t_last, model=self.name)
            seq.t_last = now
            seq.position += 1
            seq.next_token = tok
            seq.generated += 1
            if tok == eos:
                self._retire(seq, "eos")
            elif seq.generated >= seq.max_tokens:
                self._retire(seq, "max_tokens")
        return True

    def _record(self, *arrays) -> None:
        hit = self.guard.record(*arrays)
        if self._warmed and not hit:
            telemetry.counter(
                "dl4j_serving_bucket_miss_total",
                "post-warmup flushes whose padded shape no warm bucket "
                "covered").inc(model=self.name)
