"""The port's generative serving stack on the CPU: the paged KV pool,
the continuous-batching decode engine, token-cost admission and the
streaming ``:generate`` endpoint.

The cases of ``tests/test_kvcache.py`` and ``tests/test_generative.py``
that need no router and no residency mode, run on the port at
``DecoderConfig.tiny()``; greedy tokens are held to the port's dense
full re-forward (``reference_decode``), and the engine's greedy tokens to
the JAX package's ``DecodeEngine`` (``paged=True``, its Pallas kernel in
interpret mode) on the same parameters, carried by ``params_from_jax``.
"""
import http.client
import json
import queue as _queue
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.decoder import DecoderConfig as JaxConfig
from deeplearning4j_tpu.models.decoder import DecoderLM as JaxDecoder
from deeplearning4j_tpu.serving.generative import \
    DecodeEngine as JaxDecodeEngine
from deeplearning4j_tpu.serving.kvcache import KVBlockPool as JaxPool
from deeplearning4j_tpu_torch.common import telemetry
from deeplearning4j_tpu_torch.common.environment import Environment
from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
from deeplearning4j_tpu_torch.serving.admission import (AdmissionController,
                                                        ShedError)
from deeplearning4j_tpu_torch.serving.generative import DecodeEngine
from deeplearning4j_tpu_torch.serving.kvcache import (KVBlockPool,
                                                      PoolExhausted,
                                                      pool_report)
from deeplearning4j_tpu_torch.utils import serializer
from torch_parity import one_intraop_thread  # noqa: F401,E402


# ---------------------------------------------------------------------------
# the KV pool (tests/test_kvcache.py)
# ---------------------------------------------------------------------------
def _pool(num_blocks=8, block=4, **kw):
    kw.setdefault("device_arrays", False)
    return KVBlockPool(2, num_blocks, block, 2, 8, name="t", **kw)


class TestAllocator:
    def test_alloc_rounds_tokens_up_to_blocks(self):
        p = _pool()
        assert [p.blocks_for(n) for n in (1, 4, 5)] == [1, 1, 2]
        p.alloc("a", 5)
        assert p.live_blocks == 2 and len(p.table("a")) == 2
        assert p.length("a") == 5

    def test_block_zero_is_never_handed_out(self):
        p = _pool(num_blocks=4)
        ids = []
        for s in ("a", "b", "c"):
            p.alloc(s, 4)
            ids.extend(p.table(s))
        assert sorted(ids) == [1, 2, 3]

    def test_extend_chains_blocks_at_boundaries(self):
        p = _pool(block=4)
        p.alloc("a", 3)
        p.extend("a")                       # token 4: still block 1
        assert len(p.table("a")) == 1
        p.extend("a")                       # token 5: chains block 2
        assert len(p.table("a")) == 2 and p.length("a") == 5

    def test_free_returns_blocks_and_is_idempotent(self):
        p = _pool()
        p.alloc("a", 10)
        before = p.free_blocks
        assert p.free("a") == 3
        assert p.free_blocks == before + 3
        assert p.free("a") == 0
        assert p.live_sequences == 0

    def test_free_list_is_lifo(self):
        p = _pool()
        p.alloc("a", 8)
        first = p.table("a")
        p.free("a")
        p.alloc("b", 8)
        assert p.table("b") == first

    def test_exhaustion_sheds_not_partially_allocates(self):
        p = _pool(num_blocks=4)             # 3 usable
        p.alloc("a", 8)                     # 2 blocks
        free_before = p.free_blocks
        with pytest.raises(PoolExhausted) as ei:
            p.alloc("b", 8)
        assert ei.value.reason == "kv_pool"
        assert isinstance(ei.value, ShedError)
        assert p.free_blocks == free_before
        assert telemetry.counter("dl4j_kv_pool_shed_total").value(
            pool="t") >= 1

    def test_extend_exhaustion_raises_for_that_sequence(self):
        p = _pool(num_blocks=3, block=2)    # 2 usable
        p.alloc("a", 4)
        with pytest.raises(PoolExhausted):
            p.extend("a")
        assert p.length("a") == 4

    def test_padded_table_is_fixed_width_scratch_padded(self):
        p = _pool(block=4)
        p.alloc("a", 6)
        row = p.padded_table("a", 5)
        assert row.dtype == np.int32 and row.shape == (5,)
        assert list(row[2:]) == [0, 0, 0]
        with pytest.raises(ValueError):
            p.padded_table("a", 1)

    def test_occupancy_and_gauges_track_alloc_free(self):
        p = _pool(num_blocks=9)             # 8 usable
        p.alloc("a", 16)
        assert p.occupancy == pytest.approx(0.5)
        g = telemetry.gauge("dl4j_kv_pool_blocks")
        assert g.value(pool="t", state="live") == 4
        assert g.value(pool="t", state="free") == 4
        p.free("a")
        assert g.value(pool="t", state="live") == 0

    def test_needs_two_blocks_minimum(self):
        with pytest.raises(ValueError):
            _pool(num_blocks=1)


class TestPoolTensors:
    def test_layout_dtype_and_report(self):
        p = KVBlockPool(2, 4, 4, 2, 8, name="resident-t", device="cpu")
        assert p.k.shape == (2, 4, 4, 2, 8) and p.k.dtype == torch.float32
        assert p.pool_bytes == 2 * 4 * 4 * 2 * 8 * 4 * 2
        assert telemetry.gauge("dl4j_kv_pool_bytes").value(
            pool="resident-t") == p.pool_bytes
        mine = [r for r in pool_report() if r["pool"] == "resident-t"]
        assert len(mine) == 1 and mine[0]["bytes"] == p.pool_bytes
        assert mine[0]["layout"] == [2, 4, 4, 2, 8]

    def test_bf16_pool(self):
        p = KVBlockPool(1, 2, 2, 1, 4, dtype="bf16", device="cpu")
        assert p.k.dtype == torch.bfloat16
        assert p.pool_bytes == 2 * 2 * 2 * 1 * 4 * 2
        with pytest.raises(ValueError):
            KVBlockPool(1, 2, 2, 1, 4, dtype="int8", device="cpu")

    def test_batcher_pool_dtype_from_the_environment(self, monkeypatch):
        from deeplearning4j_tpu_torch.serving.batcher import ServingBatcher
        monkeypatch.setenv("DL4J_TORCH_KV_DTYPE", "bf16")
        model = DecoderLM(DecoderConfig.tiny())
        model.init("cpu")
        gen = {"kv_blocks": 4, "kv_block_size": 8, "prompt_buckets": (8,),
               "decode_buckets": (2,)}
        b = ServingBatcher(model, name="t-env", generate=gen)
        assert b._ensure_generate().pool.k.dtype == torch.bfloat16
        b2 = ServingBatcher(model, name="t-env2",
                            generate=dict(gen, kv_dtype="float32"))
        assert b2._ensure_generate().pool.k.dtype == torch.float32

    def test_pool_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KVBlockPool(1, 2, 2, 1, 4)

    def test_dropped_pool_leaves_the_report(self):
        import gc
        p = KVBlockPool(1, 2, 2, 1, 4, name="dropme", device_arrays=False)
        assert any(e["pool"] == "dropme" for e in pool_report())
        del p
        gc.collect()
        assert not any(e["pool"] == "dropme" for e in pool_report())


# ---------------------------------------------------------------------------
# token-cost admission
# ---------------------------------------------------------------------------
def test_admission_by_token_cost():
    ac = AdmissionController(max_queue=4)
    ac.admit("m", cost=3)
    with pytest.raises(ShedError):
        ac.admit("m", cost=2)              # 3 + 2 > 4
    ac.admit("m", cost=1)
    assert ac.inflight("m") == 4
    ac.release("m", cost=3)
    ac.release("m", cost=1)
    assert ac.inflight("m") == 0
    ac.admit("m", cost=10)                 # oversized, admitted when idle
    ac.release("m", cost=10)


def test_shed_retry_after_scales_with_cost():
    ac = AdmissionController(max_queue=1, retry_after_s=0.001,
                             rate_window_s=10.0)
    now = time.monotonic()
    for i in range(4):
        ac.observe_total("m", 0.01, now=now - 2.0 + i * 0.5)   # 2/s
    ac.admit("m")
    with pytest.raises(ShedError) as one:
        ac.admit("m", cost=1)
    with pytest.raises(ShedError) as eight:
        ac.admit("m", cost=8)
    assert eight.value.retry_after_s == pytest.approx(
        8 * one.value.retry_after_s, rel=0.05)


# ---------------------------------------------------------------------------
# the decode engine (tests/test_generative.py)
# ---------------------------------------------------------------------------
def _engine(conf=None, *, kv_blocks=64, block=8, prompt_buckets=(16,),
            decode_buckets=(4,), max_seq_len=64, **kw):
    conf = conf or DecoderConfig.tiny()
    model = DecoderLM(conf)
    params = model.init("cpu")
    pool = KVBlockPool(conf.n_layers, kv_blocks, block, conf.n_heads,
                       conf.head_dim, name="t-gen", device="cpu")
    eng = DecodeEngine(model, params, pool, name="t-gen",
                       prompt_buckets=prompt_buckets,
                       decode_buckets=decode_buckets,
                       max_seq_len=max_seq_len, **kw)
    eng.warmup()
    return model, pool, eng


class TestDecodeEngine:
    @pytest.mark.parametrize("gate", [None, "1"])
    def test_greedy_decode_matches_dense_reference(self, gate, monkeypatch):
        """Both routes of the ladder: the CPU's auto rung (the dense
        gather) and the forced kernel route (its plain version here)."""
        if gate is not None:
            monkeypatch.setitem(Environment.get().extra, "paged_attention",
                                gate)
        model, pool, eng = _engine()
        prompt = np.array([5, 9, 2, 7])
        got = list(eng.submit(prompt, 8))
        assert got == model.reference_decode(eng.params, prompt, 8)
        assert eng.retraces_since_warmup() == 0
        eng.shutdown()

    def test_multi_block_generation_chains_and_matches(self):
        model, pool, eng = _engine(block=4, max_seq_len=48)
        prompt = np.array([3, 11, 29])
        got = eng.submit(prompt, 24).tokens(timeout=60)
        assert got == model.reference_decode(eng.params, prompt, 24)
        assert pool.live_blocks == 0
        eng.shutdown()

    def test_eos_mid_batch_frees_blocks_while_others_decode(self):
        conf = DecoderConfig.tiny()
        probe = DecoderLM(conf)
        ref = probe.reference_decode(probe.init("cpu"),
                                     np.array([5, 9, 2, 7]), 8)
        eos = ref[3]                        # hit at step 4
        conf2 = DecoderConfig(**{**conf.__dict__, "eos_id": eos})
        model, pool, eng = _engine(conf2, decode_buckets=(4,))
        s1 = eng.submit(np.array([5, 9, 2, 7]), 8)
        s2 = eng.submit(np.array([8, 3]), 8)
        t1, t2 = list(s1), list(s2)
        assert s1.reason == "eos" and t1 == ref[:4]
        assert s2.reason == "max_tokens" and len(t2) == 8
        assert t2 == model.reference_decode(eng.params, np.array([8, 3]),
                                            8, eos_id=eos)
        assert pool.live_blocks == 0
        assert eng.retraces_since_warmup() == 0
        eng.shutdown()

    def test_cancel_frees_blocks_mid_generation(self):
        model, pool, eng = _engine(decode_buckets=(4,))
        stream = eng.submit(np.array([5, 9, 2, 7]), 2000)
        assert stream.next(timeout=10) is not None
        assert pool.live_blocks > 0
        stream.cancel()
        deadline = time.monotonic() + 10
        while pool.live_blocks and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.live_blocks == 0
        assert stream.reason == "cancelled"
        eng.shutdown()

    def test_max_tokens_capped_by_pool_capacity(self):
        model, pool, eng = _engine(max_seq_len=24, block=8)
        stream = eng.submit(np.array([1, 2, 3, 4]), 10_000)
        toks = list(stream)
        assert len(toks) <= 24 - 4
        assert stream.reason in ("max_tokens", "eos")
        assert toks == model.reference_decode(
            eng.params, np.array([1, 2, 3, 4]), 24 - 4)
        assert pool.live_blocks == 0
        eng.shutdown()

    def test_submit_sheds_synchronously_when_pool_full(self):
        model, pool, eng = _engine(kv_blocks=3, block=8)  # 2 usable
        s = eng.submit(np.arange(2, 12), 4)               # 2 blocks
        with pytest.raises(PoolExhausted):
            eng.submit(np.arange(2, 12), 4)
        list(s)
        eng.shutdown()

    def test_expired_deadline_and_bad_prompts_refused_at_submit(self):
        from deeplearning4j_tpu_torch.serving.admission import \
            DeadlineExceeded
        model, pool, eng = _engine(max_seq_len=24)
        with pytest.raises(DeadlineExceeded):
            eng.submit([1, 2], 4, deadline=time.monotonic() - 1)
        with pytest.raises(ValueError):
            eng.submit([], 4)
        with pytest.raises(ValueError):
            eng.submit(list(range(24)), 4)
        assert pool.live_blocks == 0
        eng.shutdown()

    def test_submit_after_shutdown_restarts_worker(self):
        model, pool, eng = _engine()
        prompt = np.array([5, 9, 2, 7])
        list(eng.submit(prompt, 4))
        eng.shutdown()
        stream = eng.submit(prompt, 8)
        got = []
        for _ in range(8):
            t = stream.next(timeout=10)
            if t is None:
                break
            got.append(t)
        assert got == model.reference_decode(eng.params, prompt, 8)
        assert pool.live_blocks == 0
        eng.shutdown()

    def test_shutdown_submit_race_never_strands_stream(self):
        model, pool, eng = _engine()
        prompt = np.array([5, 9, 2])
        streams, errs = [], []

        def submitter():
            for _ in range(6):
                try:
                    streams.append(eng.submit(prompt, 3))
                except PoolExhausted:
                    pass
                except Exception as e:       # noqa: BLE001
                    errs.append(e)

        threads = [threading.Thread(target=submitter) for _ in range(3)]
        for t in threads:
            t.start()
        for _ in range(8):
            eng.shutdown()
            time.sleep(0.005)
        for t in threads:
            t.join()
        assert not errs
        deadline = time.monotonic() + 30
        for s in streams:
            while s.reason is None:
                assert time.monotonic() < deadline, "stream stranded"
                try:
                    s.next(timeout=0.5)
                except _queue.Empty:
                    pass
        assert all(s.reason in ("max_tokens", "eos") for s in streams)
        eng.shutdown()
        assert pool.live_blocks == 0

    def test_decode_steps_count_every_step(self):
        model, pool, eng = _engine(decode_buckets=(2, 4))
        assert eng.decode_steps == 2                     # warmup's
        toks = list(eng.submit([5, 9], 5))
        assert len(toks) == 5
        assert eng.decode_steps == 2 + 4                 # first from prefill
        eng.shutdown()


def test_engine_greedy_tokens_equal_jax_engine(monkeypatch):
    """The same parameters (carried by params_from_jax) and prompts
    through the JAX package's DecodeEngine (paged=True: its Pallas kernel
    in interpret mode) and the port's (the kernel route forced: its plain
    version on the CPU) stream the same greedy tokens."""
    monkeypatch.setitem(Environment.get().extra, "paged_attention", "1")
    jconf = JaxConfig.tiny()
    jm = JaxDecoder(jconf)
    jp = jm.init()
    jpool = JaxPool(jconf.n_layers, 16, 8, jconf.n_heads, jconf.head_dim,
                    name="t-jax")
    jeng = JaxDecodeEngine(jm, jp, jpool, name="t-jax",
                           prompt_buckets=(8,), decode_buckets=(2,),
                           max_seq_len=32, paged=True)
    conf = DecoderConfig.tiny()
    params, _ = serializer.params_from_jax(
        {e: {n: np.asarray(a) for n, a in ls.items()}
         for e, ls in jp.items()}, {}, conf)
    pm = DecoderLM(conf)
    pm.set_params(params, "cpu")
    pool = KVBlockPool(conf.n_layers, 16, 8, conf.n_heads, conf.head_dim,
                       name="t-port", device="cpu")
    eng = DecodeEngine(pm, pm.params, pool, name="t-port",
                       prompt_buckets=(8,), decode_buckets=(2,),
                       max_seq_len=32)
    prompts = ([5, 9, 2, 7], [8, 3, 30])
    try:
        js = [jeng.submit(np.asarray(p), 6) for p in prompts]
        ps = [eng.submit(np.asarray(p), 6) for p in prompts]
        jt = [list(s) for s in js]
        pt = [list(s) for s in ps]
    finally:
        jeng.shutdown()
        eng.shutdown()
    assert pt == jt
    assert all(len(t) == 6 for t in pt)
    assert pool.live_blocks == 0


# ---------------------------------------------------------------------------
# the :generate endpoint
# ---------------------------------------------------------------------------
def _serve_generative(**generate_overrides):
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    gen = {"kv_blocks": 32, "kv_block_size": 8, "prompt_buckets": (16,),
           "decode_buckets": (4,), "max_seq_len": 64}
    gen.update(generate_overrides)
    model = DecoderLM(DecoderConfig.tiny())
    model.init("cpu")
    reg = ModelRegistry("cpu")
    ver = reg.register("lm", model, generate=gen)
    srv = InferenceServer(reg).start(0)
    return reg, ver, srv


def _gen_request(port, body, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/models/lm:generate",
                 body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    return conn, conn.getresponse()


class TestGenerateEndpoint:
    def test_streams_ndjson_tokens_then_done(self):
        reg, ver, srv = _serve_generative()
        try:
            conn, resp = _gen_request(
                srv.port, {"prompt": [5, 9, 2, 7], "max_tokens": 6})
            assert resp.status == 200
            assert resp.getheader("Transfer-Encoding") == "chunked"
            assert resp.getheader("X-Model-Version") == "1"
            lines = [json.loads(ln) for ln in
                     resp.read().decode().strip().splitlines()]
            toks = [r["token"] for r in lines if "token" in r]
            assert [r["index"] for r in lines[:-1]] == list(range(6))
            done = lines[-1]
            assert done["done"] and done["tokens"] == len(toks) == 6
            assert done["reason"] == "max_tokens"
            assert toks == ver.model.reference_decode(
                ver.batcher.engine.params, np.array([5, 9, 2, 7]), 6)
            assert ver.retraces_since_warmup() == 0
            desc = reg.describe()[0]["versions"][0]
            assert desc["generative"] is True
            conn.close()
        finally:
            srv.stop()
            reg.shutdown()

    def test_non_stream_mode_buffers_one_json(self):
        reg, ver, srv = _serve_generative()
        try:
            conn, resp = _gen_request(
                srv.port, {"prompt": [5, 9], "max_tokens": 4,
                           "stream": False})
            assert resp.status == 200
            doc = json.loads(resp.read())
            assert len(doc["tokens"]) == 4
            assert doc["reason"] == "max_tokens"
            assert doc["model"] == "lm" and doc["version"] == 1
            conn.close()
        finally:
            srv.stop()
            reg.shutdown()

    def test_pool_exhaustion_is_429_with_retry_after(self):
        reg, ver, srv = _serve_generative(kv_blocks=3)   # 2 usable
        pool = ver.batcher.engine.pool
        try:
            pool.alloc("hog", pool.usable_blocks * pool.block_size)
            conn, resp = _gen_request(
                srv.port, {"prompt": list(range(2, 12)), "max_tokens": 4})
            assert resp.status == 429
            retry = resp.getheader("Retry-After")
            assert retry is not None and int(retry) >= 1
            assert json.loads(resp.read())["reason"] == "kv_pool"
            conn.close()
            pool.free("hog")
            assert srv.admission.inflight("lm") == 0    # cost released
        finally:
            srv.stop()
            reg.shutdown()

    def test_expired_deadline_is_504(self):
        reg, ver, srv = _serve_generative()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=10)
            conn.request("POST", "/v1/models/lm:generate",
                         body=json.dumps({"prompt": [5, 9],
                                          "max_tokens": 4}).encode(),
                         headers={"X-Deadline-Ms": "-1"})
            resp = conn.getresponse()
            assert resp.status == 504
            resp.read()
            conn.close()
        finally:
            srv.stop()
            reg.shutdown()

    def test_client_disconnect_frees_blocks(self):
        reg, ver, srv = _serve_generative()
        pool = ver.batcher.engine.pool
        try:
            conn, resp = _gen_request(
                srv.port, {"prompt": [5, 9, 2, 7], "max_tokens": 2000})
            resp.fp.readline()
            conn.sock.close()
            deadline = time.monotonic() + 15
            while pool.live_blocks and time.monotonic() < deadline:
                time.sleep(0.02)
            assert pool.live_blocks == 0
        finally:
            srv.stop()
            reg.shutdown()

    def test_unknown_model_404_bad_body_400_and_non_generative_400(self):
        from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
        from deeplearning4j_tpu_torch.serving.server import InferenceServer

        class Dense:
            def output(self, x):
                return x

        model = DecoderLM(DecoderConfig.tiny())
        model.init("cpu")
        reg = ModelRegistry("cpu")
        reg.register("plain", Dense())
        reg.register("lm", model, generate={"prompt_buckets": (16,),
                                            "decode_buckets": (4,),
                                            "kv_block_size": 8})
        srv = InferenceServer(reg).start(0)
        try:
            for path, body, code in (
                    ("/v1/models/nope:generate", b'{"prompt": [1]}', 404),
                    ("/v1/models/plain:generate", b'{"prompt": [1]}', 400),
                    ("/v1/models/lm:generate", b'{"prompt": []}', 400),
                    ("/v1/models/lm:generate", b'{"max_tokens": 3}', 400),
                    ("/v1/models/lm:generate", b'not json', 400)):
                conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                                  timeout=10)
                conn.request("POST", path, body=body)
                resp = conn.getresponse()
                assert resp.status == code, (path, body)
                resp.read()
                conn.close()
            # the generic path serves a model without a graph forward
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=10)
            conn.request("POST", "/v1/models/plain:predict",
                         body=b'{"inputs": [[1.0, 2.0]]}')
            resp = conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read())["outputs"] == [[1.0, 2.0]]
            conn.close()
        finally:
            srv.stop()
            reg.shutdown()

    def test_decoder_predict_serves_full_logits(self):
        reg, ver, srv = _serve_generative()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=30)
            conn.request("POST", "/v1/models/lm:predict",
                         body=json.dumps({"inputs": [[5, 9, 2]]}).encode())
            resp = conn.getresponse()
            assert resp.status == 200
            out = np.asarray(json.loads(resp.read())["outputs"])
            want = ver.model.output(np.asarray([[5, 9, 2]])).numpy()
            np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
            conn.close()
        finally:
            srv.stop()
            reg.shutdown()


class TestChunkedHttpUtil:
    def _boom_server(self, n_good_chunks, explode=True):
        from deeplearning4j_tpu_torch.common.httputil import (
            QuietHandler, start_http_server)

        class H(QuietHandler):
            def do_GET(self):           # noqa: N802
                self.begin_chunks("text/plain")
                try:
                    for i in range(n_good_chunks):
                        self.send_chunk(f"c{i}\n".encode())
                    self.send_chunk(b"")        # no frame for no data
                    if explode:
                        raise RuntimeError("mid-stream failure")
                    self.end_chunks()
                except RuntimeError:
                    self.abort_chunks()

        return start_http_server(H, 0)

    def test_clean_stream_ends_with_terminal_chunk(self):
        httpd, _ = self._boom_server(3, explode=False)
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", httpd.server_address[1], timeout=10)
            conn.request("GET", "/")
            assert conn.getresponse().read() == b"c0\nc1\nc2\n"
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_mid_stream_exception_truncates_not_wedges(self):
        httpd, _ = self._boom_server(2, explode=True)
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", httpd.server_address[1], timeout=10)
            t0 = time.monotonic()
            conn.request("GET", "/")
            resp = conn.getresponse()
            with pytest.raises((http.client.IncompleteRead,
                                http.client.HTTPException, OSError)):
                resp.read()
            assert time.monotonic() - t0 < 8
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()


@pytest.mark.parametrize("paged,decision", [(True, "forced"),
                                            (False, "killed")])
def test_generate_config_paged_forces_the_decode_route(paged, decision):
    """``generate={"paged": ...}`` reaches the engine, as the reference's
    batcher passes it: the ladder records the route that was asked for
    at every decode step (forced: the paged route, here the kernel's
    plain version; killed: the dense gather), and the served greedy
    tokens equal the dense full re-forward either way."""
    from deeplearning4j_tpu_torch.ops import kernel_select
    before = kernel_select.decisions("paged_attention")
    reg, ver, srv = _serve_generative(paged=paged)
    try:
        conn, resp = _gen_request(
            srv.port, {"prompt": [5, 9, 2, 7], "max_tokens": 6})
        assert resp.status == 200
        toks = [r["token"] for r in (json.loads(ln) for ln in
                                     resp.read().decode().strip()
                                     .splitlines())
                if "token" in r]
        conn.close()
        engine = ver.batcher.engine
        assert engine.paged is paged
        assert toks == ver.model.reference_decode(
            engine.params, np.array([5, 9, 2, 7]), 6)
        after = kernel_select.decisions("paged_attention")
        grew = {d for d in after if after[d] != before.get(d, 0)}
        assert grew == {decision}
        assert after[decision] - before.get(decision, 0) == \
            engine.decode_steps
    finally:
        srv.stop()
        reg.shutdown()
