"""The port's ResNet-50 serving slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
weights cross through the port's serializer (``params_from_jax``).
Tolerance rtol 1e-4 / atol 1e-5 on softmax outputs: both sides compute
in float32, with convolutions summed in different orders (XLA's CPU
backend against oneDNN).
"""
import io
import json
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import ResNet50 as JaxResNet50
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.utils import ModelSerializer as JaxSerializer
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.zoo import ResNet50
from deeplearning4j_tpu_torch.serving import InferenceServer, ModelRegistry
from deeplearning4j_tpu_torch.utils import ModelSerializer
from deeplearning4j_tpu_torch.utils.serializer import params_from_jax
from torch_parity import one_intraop_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parent.parent
CIFAR_ZIP = ROOT / "deeplearning4j_tpu" / "models" / "pretrained" / \
    "resnet_cifar.zip"
RTOL, ATOL = 1e-4, 1e-5


def _np_tree(tree):
    return {k: {n: np.asarray(a) for n, a in sub.items()}
            for k, sub in tree.items()}


# 1 -------------------------------------------------------------------------
@pytest.mark.parametrize("size,stride", [(7, 1), (7, 2), (8, 1), (8, 2),
                                         (224, 2)])
def test_same_padding_and_max_pool_match_jax(size, stride):
    """SAME convs (7x7 and 3x3) and the 3x3 max pool at odd and even
    sizes: XLA pads asymmetrically at stride 2 (the stem: (2, 3) on
    224), and pads the max pool with -inf."""
    r = np.random.RandomState(size * 10 + stride)
    batch = 1 if size == 224 else 2
    x = r.randn(batch, size, size, 3).astype(np.float32) - 1.0
    for k in (7, 3):
        kw = dict(kernel_size=(k, k), stride=(stride, stride), n_in=3,
                  n_out=4, has_bias=False, activation="IDENTITY")
        jconv = jl.ConvolutionLayer(convolution_mode=jl.ConvolutionMode.SAME,
                                    **kw)
        tconv = tl.ConvolutionLayer(convolution_mode=tl.ConvolutionMode.SAME,
                                    **kw)
        w = (0.2 * r.randn(k, k, 3, 4)).astype(np.float32)
        want, _ = jconv.forward({"W": jnp.asarray(w)}, jnp.asarray(x),
                                training=False)
        got, _ = tconv.forward(
            {"W": torch.from_numpy(np.ascontiguousarray(
                w.transpose(3, 2, 0, 1)))}, torch.from_numpy(x),
            training=False)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    jpool = jl.SubsamplingLayer(pooling_type=jl.PoolingType.MAX,
                                kernel_size=(3, 3), stride=(stride, stride),
                                convolution_mode=jl.ConvolutionMode.SAME)
    tpool = tl.SubsamplingLayer(pooling_type=tl.PoolingType.MAX,
                                kernel_size=(3, 3), stride=(stride, stride),
                                convolution_mode=tl.ConvolutionMode.SAME)
    want, _ = jpool.forward({}, jnp.asarray(x), training=False)
    got, _ = tpool.forward({}, torch.from_numpy(x), training=False)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# 2 -------------------------------------------------------------------------
def test_bundled_resnet_cifar_zip_matches_jax():
    x = np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32)
    want = np.asarray(JaxSerializer.restore_model(str(CIFAR_ZIP)).output(x))
    net = ModelSerializer.restore_model(CIFAR_ZIP, device="cpu")
    assert net.iteration_count == 120 and net.epoch_count == 3
    got = net.output(x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_port_written_zip_restores_in_jax(tmp_path):
    net = ModelSerializer.restore_model(CIFAR_ZIP, device="cpu")
    path = tmp_path / "round.zip"
    ModelSerializer.write_model(net, path)
    x = np.random.RandomState(1).rand(4, 32, 32, 3).astype(np.float32)
    want = np.asarray(JaxSerializer.restore_model(str(path)).output(x))
    np.testing.assert_allclose(net.output(x).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    again = ModelSerializer.restore_model(path, device="cpu")
    assert json.loads(again.conf.to_json()) == json.loads(
        net.conf.to_json())


# 3 -------------------------------------------------------------------------
SMALL = dict(STAGES=((1, 8), (1, 16)), height=32, width=32, num_classes=10)


def test_small_resnet50_from_jax_matches():
    """The JAX-initialised ResNet50 builder, with numpy-seeded BN
    stats and affine params far from the identity, carried across by
    ``params_from_jax``; the port's own builder gives the same
    configuration JSON."""
    jnet = JaxResNet50(**SMALL).init()
    r = np.random.RandomState(7)
    params, states = _np_tree(jnet.params), _np_tree(jnet.states)
    for name, st in states.items():
        if "mean" in st:
            C = st["mean"].shape[0]
            st["mean"] = (0.3 * r.randn(C)).astype(np.float32)
            st["var"] = (0.5 + r.rand(C)).astype(np.float32)
            params[name]["gamma"] = (1 + 0.3 * r.randn(C)).astype(
                np.float32)
            params[name]["beta"] = (0.3 * r.randn(C)).astype(np.float32)
    jnet.params = {k: {n: jnp.asarray(a) for n, a in sub.items()}
                   for k, sub in params.items()}
    jnet.states = {k: {n: jnp.asarray(a) for n, a in sub.items()}
                   for k, sub in states.items()}
    x = r.randn(4, 32, 32, 3).astype(np.float32)
    want = np.asarray(jnet.output(x))

    conf = ResNet50(**SMALL).conf()
    assert json.loads(conf.to_json()) == json.loads(jnet.conf.to_json())
    p, s = params_from_jax(params, states, conf)
    assert p["stem_conv"]["W"].shape == (64, 3, 7, 7)       # OIHW
    net = ComputationGraph(conf).set_params(p, s, "cpu")
    got = net.output(x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the reverse direction reads the JAX JSON verbatim
    conf2 = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    assert json.loads(conf2.to_json()) == json.loads(jnet.conf.to_json())


def test_bf16_compute_dtype_tracks_f32():
    net = ResNet50(**SMALL).init("cpu")
    net16 = ComputationGraph(ResNet50(compute_dtype="bfloat16",
                                      **SMALL).conf()).set_params(
        net.params, net.states, "cpu")
    x = np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32)
    a, b = net.output(x), net16.output(x)
    assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
    # bf16 keeps 8 mantissa bits through ~20 layers
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-2)


# 4 -------------------------------------------------------------------------
def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_inference_server_answers_json_and_npy():
    net = ResNet50(**SMALL).init("cpu")
    reg = ModelRegistry("cpu", default_buckets=(4, 8))
    ver = reg.register("r50", net, warmup_shape=(32, 32, 3))
    server = InferenceServer(reg).start(port=0)
    try:
        url = f"{server.url}/v1/models/r50:predict"
        r = np.random.RandomState(5)
        x1 = r.randn(1, 32, 32, 3).astype(np.float32)
        code, body = _post(url, json.dumps({"inputs": x1.tolist()}).encode(),
                           "application/json")
        doc = json.loads(body)
        assert code == 200 and doc["batch"] == 1 and doc["version"] == 1
        np.testing.assert_allclose(np.asarray(doc["outputs"]),
                                   net.output(x1).numpy(), rtol=1e-5,
                                   atol=1e-6)
        x6 = r.randn(6, 32, 32, 3).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, x6)
        code, body = _post(url, buf.getvalue(), "application/octet-stream")
        got = np.load(io.BytesIO(body))
        assert code == 200 and got.shape == (6, 10)
        np.testing.assert_allclose(got, net.output(x6).numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert ver.retraces_since_warmup() == 0
        with urllib.request.urlopen(f"{server.url}/v1/models") as resp:
            models = json.loads(resp.read())["models"]
        assert models[0]["versions"][0]["warm_buckets"] == [4, 8]
        for path, text in (("/healthz", b"ok"), ("/readyz", b"ready"),
                           ("/metrics", b"dl4j_serving_requests_total")):
            with urllib.request.urlopen(server.url + path) as resp:
                assert text in resp.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{server.url}/v1/models/nope:predict", b"{}",
                  "application/json")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, b"{}", "application/json")
        assert e.value.code == 400
    finally:
        server.stop()
        reg.shutdown()


# 5 -------------------------------------------------------------------------
@pytest.mark.parametrize("entry", ["zoo", "graph", "serializer"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "zoo": lambda: ResNet50(**SMALL).init(),
        "graph": lambda: ComputationGraph(ResNet50(**SMALL).conf()).init(),
        "serializer": lambda: ModelSerializer.restore_model(CIFAR_ZIP),
    }
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        calls[entry]()


# serving mechanics ----------------------------------------------------------
def test_admission_sheds_fails_fast_and_drains():
    from deeplearning4j_tpu_torch.serving.admission import (
        AdmissionController, DeadlineExceeded, ShedError, deadline_after_ms)
    ac = AdmissionController(max_queue=2, latency_slo_ms=10.0)
    ac.admit("m")
    ac.admit("m")
    with pytest.raises(ShedError) as e:
        ac.admit("m")
    assert e.value.reason == "queue_full"
    with pytest.raises(DeadlineExceeded):
        ac.admit("m", deadline_after_ms(-1.0))
    ac.observe_total("m", 0.5)          # p95 500 ms > 10 ms SLO: shrink
    assert ac.budget("m") == 1
    assert int(ac.retry_after_header("m")) >= 1
    ac.release("m")
    ac.release("m")
    assert ac.drain(timeout=1.0)
    with pytest.raises(ShedError) as e:
        ac.admit("m")
    assert e.value.reason == "draining"


@pytest.mark.parametrize("rows", [(1,) * 7, (3, 1, 2, 1)])
def test_batcher_pads_to_warm_buckets(rows):
    """Requests of one or several rows come back with their own rows,
    and every flush is padded to a warm bucket."""
    from deeplearning4j_tpu_torch.common import telemetry
    from deeplearning4j_tpu_torch.serving.batcher import ServingBatcher
    net = ResNet50(**SMALL).init("cpu")
    name = f"pad-{len(rows)}"
    b = ServingBatcher(net, (2, 4), name=name)
    b.warmup((32, 32, 3))
    warm = b.guard.n_signatures
    x = np.random.RandomState(9).randn(7, 32, 32, 3).astype(np.float32)
    starts = np.cumsum((0,) + rows)
    futs = [b.submit(x[i:j]) for i, j in zip(starts[:-1], starts[1:])]
    outs = [f.result(timeout=60) for f in futs]
    b.shutdown()
    assert [o.shape[0] for o in outs] == list(rows)
    np.testing.assert_allclose(np.concatenate(outs), net.output(x).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert b.guard.n_signatures == warm == 2      # only shapes 2 and 4
    assert b._padded_rows(7) == 8 and b._padded_rows(9) == 10
    assert any(e["name"] == "serving.flush" and
               e["args"]["model"] == name
               for e in telemetry.trace_events())


def test_parallel_inference_batched_and_hot_swap():
    from deeplearning4j_tpu_torch.parallel.inference import \
        ParallelInference
    net = ResNet50(**SMALL).init("cpu")
    x = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    pi = ParallelInference(net, batch_limit=2)
    futs = [pi.submit(x[:2]), pi.submit(x[2:])]
    got = np.concatenate([f.result(timeout=60) for f in futs])
    pi.shutdown()
    np.testing.assert_allclose(got, net.output(x).numpy(), rtol=1e-5,
                               atol=1e-6)
    reg = ModelRegistry("cpu", default_buckets=(4,))
    v1 = reg.register("m", net)
    v2 = reg.register("m", ResNet50(seed=5, **SMALL).init("cpu"))
    assert reg.model("m") is v2 and v1.status == "RETIRED"
    assert [v["version"] for v in reg.describe()[0]["versions"]] == [1, 2]
    assert reg.retraces_since_warmup("m") == 0
    reg.shutdown()
