#!/usr/bin/env python3
"""Drive deeplearning4j_tpu_torch's main paths on one CUDA card: serving
ResNet-50, training ResNet-50 (ComputationGraph) and training LeNet-5
(MultiLayerNetwork).

Run from the root of a checkout, with no arguments, on a machine with
one NVIDIA H100 (it fails without a card, and without the package):

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1) when its check fails:

1. device: the card's name, count, and ``nvidia-smi`` name/power limit;
2. build: every ``csrc/*.cu`` with nvcc for sm_90a, all at once; prints
   the build times and ``-Xptxas -v``;
3. kernels: the epilogue (kernel 1) against its plain PyTorch version
   (f32, bf16 and f16, relu and identity, a ragged M, a C off the
   vector width, NaN inputs), bitwise, at every BatchNormalization site
   shape of the batch-8 and batch-32 serving buckets; then CUDA-graph
   timings of the kernel, the plain version and the one-call library
   yardstick over the 53 sites of a batch-32 forward, beside the bound;
4. training kernels: the epilogue backward (2), channel sums (3) and
   the BN backward passes (5, 6) against their plain versions at every
   (M, C) site shape of a batch-32 ResNet-50 step and LeNet-5's two
   conv shapes, f32/bf16/f16: elementwise outputs bitwise, sums within
   ``SUM_RTOL`` of sum|terms| per channel, sums bitwise equal across two
   launches; then their timings over the 53 sites of a batch-32 step;
5. serving: a full-width ResNet-50 (224x224x3, 1000 classes, seeded
   random weights, BatchNormalization stats set from the generator)
   registered and served over HTTP, kernel counts reset just before and
   read just after; answers against ``net.output`` at the bucket they
   were served at (bitwise) and the card against the CPU (TF32 off);
   one bf16 and one f16 forward;
6. train ResNet-50: 224x224x3, 1000 classes, batch 32, f32, the zoo's
   Nesterovs(0.1, 0.9) and l2 1e-4, seeded weights, 10 ``fit`` steps on
   one seeded batch (8 classes, each a fixed random image plus noise)
   with the counts reset before and read after (53 launches each of
   kernels 3, 1, 5 and 6 a step, none of 2); the last loss below the
   first (10 steps, not 5: from its initial loss of ~11 this
   configuration overshoots for its first three to five steps and
   settles below its first loss by step 10); step time, img/s and the
   device's busy/idle share; four steps with the fused BN backward
   killed (kernel 2, and kernel 1 twice a site); two in bf16; card
   against CPU (and a float64 CPU step) for one step at 64x64, TF32 off;
7. train LeNet-5: 28x28x1, batch 64, Adam(1e-3), 20 steps through
   ``fit(iterator)`` on the synthetic MNIST surrogate; the loss falls,
   kernels 1 and 2 launch twice a step;
8. weights across: the JAX package's bundled ``resnet_cifar.zip``
   restored on the card and on the CPU, outputs compared.

Then one JSON line of kernel records (each kernel's times from its own
timing phase, its launches from the path that carries it), the
``nvidia-smi`` line, and the last line ``{"ok": true, "device": {...}}``.

TF32: the served and trained paths run with PyTorch's defaults (cuDNN
convolutions in TF32, matmuls in full f32); each comparison states its
setting.
"""
from __future__ import annotations

import concurrent.futures
import io
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BATCH = 32
CIFAR_ZIP = ROOT / "deeplearning4j_tpu" / "models" / "pretrained" / \
    "resnet_cifar.zip"

class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[device] {name} count={count}")
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return {"kind": name, "count": count, "nvidia_smi": smi}


def phase_build() -> None:
    """One nvcc for each source, all started together."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    names = sorted(src.stem for src in cuda_build.CSRC_DIR.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.build, names))
    secs = time.perf_counter() - t0
    info = cuda_build.build_info
    print(f"[build] {len(info)} source(s) in {secs:.2f}s")
    for name, rec in info.items():
        print(f"[build] {name}: {rec['seconds']:.2f}s -> {rec['path']}")
        print(rec["log"])


def _time_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA
    graph and replayed back to back, so the host's launch overhead
    leaves no gaps between the kernels (``_time_ms`` keeps them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def bn_sites(conf, batch: int):
    """(M, C, act) of every BatchNormalization site of a forward."""
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    types = conf.resolve_shapes()
    sites = []
    for name in conf.topo_order():
        v = conf.vertices[name]
        if isinstance(v.content, BatchNormalization):
            t = types[name]
            sites.append((batch * t.height * t.width, t.channels,
                          v.content.activation.value))
    return sites


DTYPES = ("float32", "bfloat16", "float16")


def _compare(torch, ce, x, s, b, act: str, what: str) -> float:
    """Kernel against plain version on the same inputs, bitwise: both
    round the multiply, then the add, in f32, and round to x's dtype the
    same way; NaN in the same places. Returns max |kernel - plain|."""
    y = ce.scale_shift_act(x, s, b, act)
    r = ce.scale_shift_act_plain(x, s, b, act)
    torch.cuda.synchronize()
    same_nan = torch.equal(torch.isnan(y), torch.isnan(r))
    err = float((y.float() - r.float()).abs().nan_to_num(0.0).max())
    check(y.dtype == x.dtype and same_nan and err == 0.0,
          f"scale_shift_act {what}: max err {err}, NaN positions equal: "
          f"{same_nan}")
    return err


def phase_kernels(torch) -> dict:
    """Kernel against plain version, then timings at the slice's
    shapes. Tolerance: bitwise (max |kernel - plain| == 0)."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    g = torch.Generator(device="cuda").manual_seed(11)
    max_err = 0.0
    shapes = [(401408, 64), (100352, 256), (1568, 2048), (100353, 64),
              (12345, 6)]
    for M, C in shapes:
        for dt in DTYPES:
            for act in ("relu", "identity"):
                x = torch.randn(M, C, device="cuda", generator=g).to(
                    getattr(torch, dt))
                x.view(-1)[::9973] = float("nan")
                s = torch.randn(C, device="cuda", generator=g)
                b = torch.randn(C, device="cuda", generator=g)
                max_err = max(max_err, _compare(
                    torch, ce, x, s, b, act, f"[{M},{C}] {dt} {act}"))
    print(f"[kernels] scale_shift_act == plain (bitwise) at "
          f"{len(shapes)} shapes x {'/'.join(DTYPES)} x relu/identity, "
          f"NaN propagated; max_abs_err {max_err}")

    # every site shape of the batch-8 bucket (the batch-32 ones are
    # compared in the timing loop below, on the buffers it times)
    conf = ResNet50().conf()
    sites8 = sorted(set(bn_sites(conf, 8)))
    for M, C, act in sites8:
        for dt in DTYPES:
            x = torch.randn(M, C, device="cuda", generator=g).to(
                getattr(torch, dt))
            s = torch.rand(C, device="cuda", generator=g) + 0.5
            b = torch.randn(C, device="cuda", generator=g)
            max_err = max(max_err, _compare(
                torch, ce, x, s, b, act, f"batch-8 site [{M},{C}] {dt} "
                                         f"{act}"))
    print(f"[kernels] scale_shift_act == plain (bitwise) at the "
          f"{len(sites8)} (M, C, act) site shapes of a batch-8 forward, "
          f"{'/'.join(DTYPES)}")

    # timings over the 53 sites of a batch-32 forward, grouped by shape;
    # each shape cycles through enough buffers to exceed the 50 MB L2
    sites = bn_sites(conf, BATCH)
    check(len(sites) == 53, f"ResNet-50 has {len(sites)} BN sites, "
                            f"expected 53")
    groups: dict = {}
    for site in sites:
        groups[site] = groups.get(site, 0) + 1
    timing = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        esize = torch.tensor([], dtype=dt).element_size()
        tot = {"kernel": 0.0, "plain": 0.0, "library": 0.0,
               "kernel_eager": 0.0}
        bytes_moved = 0
        flops = 0
        per_shape = []
        for (M, C, act), n in sorted(groups.items()):
            n_buf = max(1, int(-(-100e6 // (M * C * esize))))
            xs = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                  for _ in range(n_buf)]
            s = torch.rand(C, device="cuda", generator=g) + 0.5
            b = torch.randn(C, device="cuda", generator=g)
            s_l, b_l = s.to(dt), b.to(dt)
            max_err = max(max_err, _compare(
                torch, ce, xs[0], s, b, act, f"batch-{BATCH} site "
                                             f"[{M},{C}] {dt} {act}"))
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % n_buf
                return xs[it["i"]]
            def kern():
                return ce.scale_shift_act(nxt(), s, b, act)

            def plain():
                return ce.scale_shift_act_plain(nxt(), s, b, act)

            def lib():
                return torch.addcmul(b_l, nxt(), s_l)
            k_ms, p_ms, l_ms = (_graph_ms(torch, f)
                                for f in (kern, plain, lib))
            host_ms = _time_ms(torch, kern)
            site_bytes = M * C * esize * 2 + 2 * C * 4
            tot["kernel"] += n * k_ms
            tot["plain"] += n * p_ms
            tot["library"] += n * l_ms
            tot["kernel_eager"] += n * host_ms
            bytes_moved += n * site_bytes
            flops += n * 2 * M * C
            bound = site_bytes / HBM_BYTES_PER_S * 1e3
            per_shape.append({"M": M, "C": C, "act": act, "sites": n,
                              "kernel_ms": k_ms, "plain_ms": p_ms,
                              "addcmul_ms": l_ms, "eager_ms": host_ms,
                              "bound_ms": bound,
                              "achieved_GBps": site_bytes / k_ms / 1e6})
            del xs
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                       flops / F32_FLOPS) * 1e3
        timing[str(dt).split(".")[-1]] = {
            "kernel_ms": tot["kernel"], "plain_ms": tot["plain"],
            "library_ms": tot["library"], "bound_ms": bound_ms,
            "kernel_eager_ms": tot["kernel_eager"],
            "bytes": bytes_moved, "flops": flops, "per_shape": per_shape}
        print(f"[kernels] {dt} batch-{BATCH} forward, 53 sites: kernel "
              f"{tot['kernel']:.4f} ms, plain {tot['plain']:.4f} ms, "
              f"addcmul {tot['library']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bytes_moved / 1e9:.3f} GB); device time (CUDA graph "
              f"replay); eager launches {tot['kernel_eager']:.4f} ms")
        for r in per_shape:
            print(f"[kernels]   [{r['M']},{r['C']}] {r['act']} x{r['sites']}"
                  f": kernel {r['kernel_ms']:.4f} plain {r['plain_ms']:.4f}"
                  f" addcmul {r['addcmul_ms']:.4f} eager "
                  f"{r['eager_ms']:.4f} bound "
                  f"{r['bound_ms']:.4f} ms, {r['achieved_GBps']:.0f} GB/s")
    print(f"[kernels] scale_shift_act == plain (bitwise) at the "
          f"{len(groups)} (M, C, act) site shapes of a batch-{BATCH} "
          f"forward, {'/'.join(DTYPES)}; max_abs_err over all {max_err}")
    return {"max_abs_err": max_err, "timing": timing}


# ---------------------------------------------------------------------------
def seeded_resnet(torch, device: str, seed: int = 7, **kw):
    """Full-width ResNet-50 with weights from a seeded generator, and
    BatchNormalization stats set from the same generator around the
    statistics of a calibration batch, so each site folds to a scale and
    shift far from the identity while activations stay O(1)."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    g = torch.Generator().manual_seed(seed)
    net = ResNet50(**kw).init(device, generator=g)
    x = torch.randn(8, net.conf.input_types[0].height,
                    net.conf.input_types[0].width, 3, generator=g)
    acts = {"input": x.to(device)}
    with torch.inference_mode():
        for name in net._topo:
            v = net.conf.vertices[name]
            xs = [acts[i] for i in v.inputs]
            if not v.is_layer:
                acts[name] = v.content.forward(xs)
                continue
            if isinstance(v.content, BatchNormalization):
                h = xs[0].float()
                dims = tuple(range(h.dim() - 1))
                mean, var = h.mean(dims).cpu(), h.var(dims).cpu()
                C = mean.numel()
                p, st = net.params[name], net.states[name]
                p["gamma"] = (1 + 0.2 * torch.randn(C, generator=g)
                              ).to(device)
                p["beta"] = (0.2 * torch.randn(C, generator=g)).to(device)
                st["mean"] = (mean + 0.1 * var.sqrt() * torch.randn(
                    C, generator=g)).to(device)
                st["var"] = (var * (0.5 + torch.rand(C, generator=g))
                             ).to(device)
            acts[name], _ = v.content.forward(
                net.params[name], xs[0], training=False,
                state=net.states[name] or None)
    return net


def _post(url: str, body: bytes, ctype: str):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        data = resp.read()
        code = resp.status
    return code, data, (time.perf_counter() - t0) * 1e3


def _npy(a) -> bytes:
    import numpy as np
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def phase_slice(torch, device: str = "cuda", image: int = 224,
                label: str = "cpu") -> dict:
    """``label`` names the card and its power limit on every timing."""
    import numpy as np

    from deeplearning4j_tpu_torch.common import telemetry
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.serving import (InferenceServer,
                                                  ModelRegistry)
    from deeplearning4j_tpu_torch.models.zoo import ResNet50

    kw = {} if image == 224 else {"height": image, "width": image}
    t0 = time.perf_counter()
    net = seeded_resnet(torch, device, **kw)
    print(f"[slice] ResNet-50 {image}x{image}x3 -> 1000, "
          f"{net.num_params()} params on {device}, built in "
          f"{time.perf_counter() - t0:.2f}s")
    rs = np.random.RandomState(3)
    x1 = rs.randn(1, image, image, 3).astype(np.float32)
    x8 = rs.randn(8, image, image, 3).astype(np.float32)
    x32 = rs.randn(32, image, image, 3).astype(np.float32)
    forwards = telemetry.counter("dl4j_inference_forwards_total")
    copies = telemetry.counter("dl4j_conv_layout_copies_total")

    # ---- the main path: counts to 0, register + serve, counts read ----
    fwd0, copies0 = forwards.value(), copies.value()
    for k in cuda_build.KERNELS.values():
        k.launches = 0
    registry = ModelRegistry(device, default_buckets=(8, 32))
    ver = registry.register("resnet50", net, warmup_shape=(image, image, 3))
    server = InferenceServer(registry).start(port=0)
    url = f"{server.url}/v1/models/resnet50:predict"
    lat = {}
    try:
        code, data, lat["json_1"] = _post(
            url, json.dumps({"inputs": x1.tolist()}).encode(),
            "application/json")
        check(code == 200, f"JSON predict returned {code}")
        out1 = np.asarray(json.loads(data)["outputs"], np.float32)
        code, data, lat["npy_8"] = _post(url, _npy(x8),
                                         "application/octet-stream")
        check(code == 200, f"npy predict returned {code}")
        out8 = np.load(io.BytesIO(data))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            futs = [pool.submit(_post, url, _npy(x32[i:i + 1]),
                                "application/octet-stream")
                    for i in range(32)]
            res = [f.result() for f in futs]
        wall32 = time.perf_counter() - t0
        check(all(r[0] == 200 for r in res), "a concurrent predict failed")
        out32 = np.concatenate([np.load(io.BytesIO(r[1])) for r in res])
        lat["concurrent_32_ms"] = [r[2] for r in res]
        try:
            _post(f"{server.url}/v1/models/nope:predict", b"{}",
                  "application/json")
            unknown = 200
        except urllib.error.HTTPError as e:
            unknown = e.code
        check(unknown == 404, f"unknown model returned {unknown}")
    finally:
        launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        n_fwd = forwards.value() - fwd0
        retraces = ver.retraces_since_warmup()
        with urllib.request.urlopen(f"{server.url}/metrics") as r:
            metrics_ok = b"dl4j_serving_requests_total" in r.read()
        server.stop()
        registry.shutdown()
    n_copies = copies.value() - copies0
    print(f"[slice] main path: {n_fwd} forwards, launches {launches}, "
          f"layout copies {n_copies}, retraces_since_warmup {retraces}")
    check(metrics_ok, "/metrics lacks dl4j_serving_requests_total")
    check(retraces == 0, f"retraces_since_warmup = {retraces}")
    if device == "cuda":
        # serving runs the inference forward: of the kernels, only the
        # epilogue is on its path
        check(launches["scale_shift_act"] == 53 * n_fwd,
              f"scale_shift_act launches {launches['scale_shift_act']} "
              f"!= 53 x {n_fwd} forwards")
    print(f"[slice] latency ms: json_1 {lat['json_1']:.2f}, npy_8 "
          f"{lat['npy_8']:.2f}, 32 concurrent p50 "
          f"{np.percentile(lat['concurrent_32_ms'], 50):.2f} max "
          f"{max(lat['concurrent_32_ms']):.2f}, 32-image wall "
          f"{wall32 * 1e3:.2f} ({32 / wall32:.1f} img/s over HTTP) "
          f"[{label}]")
    print(f"[slice] each concurrent request, ms: "
          f"{[round(v, 1) for v in lat['concurrent_32_ms']]}")

    # ---- answers against net.output, bitwise, at the served bucket ----
    # (same TF32 setting: the default). The batcher pads a flush to its
    # bucket by repeating the last row; a row's answer depends only on
    # the row and the batch shape, so each request is held to
    # net.output at the bucket it can have been served at.
    def ref(x):
        return net.output(x).float().cpu().numpy()

    def bitwise(got, want, what):
        err = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")
        check(got.shape == want.shape and np.isfinite(got).all()
              and np.array_equal(got, want),
              f"{what}: served answer differs from net.output by {err}")
    bitwise(out1, ref(np.repeat(x1, 8, axis=0))[:1], "json_1 (bucket 8)")
    bitwise(out8, ref(x8), "npy_8 (bucket 8)")
    ref32 = ref(x32)
    ref8 = np.concatenate([ref(x32[i:i + 8]) for i in range(0, 32, 8)])
    at8 = (out32 == ref8).all(-1)
    at32 = (out32 == ref32).all(-1)
    bad = [i for i in range(32) if not (at8[i] or at32[i])]
    check(not bad, f"concurrent_32: rows {bad} match net.output at "
                   f"neither bucket (max |d| vs bucket 32 "
                   f"{float(np.abs(out32 - ref32).max())})")
    # the rows differ from each other, so a row handed to the wrong
    # request would fail the bitwise check above
    pair = np.abs(ref32[:, None, :] - ref32[None, :, :]).max(-1)
    np.fill_diagonal(pair, np.inf)
    check(float(pair.min()) > 0.0,
          f"two of the 32 reference rows agree to {float(pair.min())}")
    print(f"[slice] served == net.output bitwise: json_1, npy_8, and all "
          f"32 burst rows ({int(at32.sum())} match bucket 32, "
          f"{int(at8.sum())} bucket 8); rows differ pairwise by >= "
          f"{float(pair.min()):.3e}, {len(set(ref32.argmax(-1)))} distinct "
          f"top-1 in 32")
    check(np.allclose(out32.sum(-1), 1.0, atol=1e-4),
          "softmax rows do not sum to 1")

    # ---- card against CPU, TF32 off ----
    result = {"latency_ms": lat, "forwards": n_fwd,
              "launches": launches, "layout_copies": n_copies,
              "http_img_per_s": 32 / wall32}
    if device == "cuda":
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            card = ref(x8[:4])
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        cpu_net = ComputationGraph(net.conf).set_params(
            {k: {n: t.cpu() for n, t in sub.items()}
             for k, sub in net.params.items()},
            {k: {n: t.cpu() for n, t in sub.items()}
             for k, sub in net.states.items()}, "cpu")
        cpu = cpu_net.output(x8[:4]).numpy()
        err = float(np.abs(card - cpu).max())
        check(np.allclose(card, cpu, rtol=1e-3, atol=1e-5),
              f"card vs CPU (TF32 off): max |d| {err}")
        print(f"[slice] card == CPU (f32, TF32 off), max |d| {err:.3e}, "
              f"top-1 {card.argmax(-1).tolist()}")
        result["card_vs_cpu_max_abs"] = err

        # device throughput at batch 32, input resident on the card
        xb = torch.from_numpy(x32).cuda()
        runs = sorted(_time_ms(torch, lambda: net.output(xb), reps=10)
                      for _ in range(3))
        ms = runs[1]
        result["fwd32_f32_ms"] = runs
        print(f"[slice] batch-32 f32 forward {ms:.3f} ms (median of "
              f"{[round(r, 3) for r in runs]}) = {32e3 / ms:.1f} img/s "
              f"(TF32 convs, device-resident input) [{label}]")
        # bf16 and f16: the same weights under compute_dtype
        p32 = net.output(xb).float()
        for cd, short in (("bfloat16", "bf16"), ("float16", "f16")):
            conf16 = ResNet50(compute_dtype=cd).conf()
            net16 = ComputationGraph(conf16).set_params(net.params,
                                                        net.states, device)
            n0 = cuda_build.KERNELS["scale_shift_act"].launches
            p16 = net16.output(xb).float()
            torch.cuda.synchronize()
            check(cuda_build.KERNELS["scale_shift_act"].launches - n0 == 53,
                  f"{short} forward did not run 53 epilogue launches")
            check(bool(torch.isfinite(p16).all()),
                  f"{short} output not finite")
            agree = float((p16.argmax(-1) == p32.argmax(-1)).float().mean())
            d16 = float((p16 - p32).abs().max())
            ms16 = _time_ms(torch, lambda: net16.output(xb), reps=10)
            result.update({f"fwd32_{short}_ms": ms16,
                           f"{short}_top1_agree": agree,
                           f"{short}_max_abs": d16})
            print(f"[slice] batch-32 {short} forward {ms16:.3f} ms = "
                  f"{32e3 / ms16:.1f} img/s; top-1 agreement with f32 "
                  f"{agree:.3f}, max |d prob| {d16:.3e} [{label}]")
            check(agree >= 0.75,
                  f"{short} top-1 agrees with f32 on {agree:.2f}")
        result["profile"] = profile_device(
            torch, lambda: net.output(xb), ms, "batch-32 f32 forward")
    return result


def profile_device(torch, fn, wall_ms: float, what: str) -> dict:
    """Device time by kernel over 3 calls of ``fn`` (profiler), and the
    idle share against the unprofiled wall time of one call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if dev_us and "CUDA" in str(getattr(e, "device_type", "")):
            rows.append((e.key, dev_us / 3e3, e.count // 3))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if not rows:
        print("[profile] device time: not measured (no CUDA events)")
        return {}
    idle = 1.0 - busy_ms / wall_ms
    print(f"[profile] per {what}: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms, idle share {idle:.3f}")
    for key, ms, n in rows[:12]:
        print(f"[profile]   {ms:8.3f} ms  x{n:<4d} {key[:90]}")
    return {"device_busy_ms": busy_ms, "idle_share": idle,
            "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                    for k, ms, n in rows[:20]]}


# ---------------------------------------------------------------------------
#: |kernel - plain| <= SUM_RTOL * sum|terms| per channel for the column
#: sums: both add the same f32 terms in different orders; at these
#: shapes the kernel's summation depth is under ~200 additions (worst
#: case 200 * 2^-24 = 1.2e-5 of sum|terms|), and torch's reduction adds
#: its own
SUM_RTOL = 2e-5
LENET_BATCH = 64
#: LeNet-5's two conv-epilogue sites at batch 64: 24x24x20 and 8x8x50
LENET_SITES = [(LENET_BATCH * 24 * 24, 20, "identity"),
               (LENET_BATCH * 8 * 8, 50, "identity")]
TRAIN_KERNELS = ("epilogue_backward", "channel_sums", "bn_bwd_sums",
                 "bn_bwd_dx")


def _sums_err(torch, got, want, terms, what) -> float:
    err = (got - want).abs()
    bound = SUM_RTOL * terms
    check(bool((err <= bound).all()),
          f"{what}: max err {float(err.max()):.3e} beyond "
          f"{SUM_RTOL} x sum|terms|")
    return float(err.max())


def _check_train_kernels(torch, M, C, act, dt, g, errs) -> None:
    """Kernels 2, 3, 5, 6 against their plain versions on one (M, C)."""
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    x = torch.randn(M, C, device="cuda", generator=g).to(dt)
    dy = torch.randn(M, C, device="cuda", generator=g).to(dt)
    s = torch.randn(C, device="cuda", generator=g)
    b = torch.randn(C, device="cuda", generator=g)
    what = f"[{M},{C}] {str(dt)[6:]} {act}"
    # kernel 2
    dx, ds, dsh = ce.epilogue_backward(x, dy, s, b, act)
    _, ds2, dsh2 = ce.epilogue_backward(x, dy, s, b, act)
    rdx, rds, rdsh = ce.epilogue_backward_plain(x, dy, s, b, act)
    check(torch.equal(dx, rdx), f"epilogue_backward dx {what} not bitwise")
    check(torch.equal(ds, ds2) and torch.equal(dsh, dsh2),
          f"epilogue_backward sums {what} differ across two launches")
    xf, ga = x.float(), dy.float().abs()
    if act == "relu":
        ga = torch.where(xf * s + b > 0, ga, 0.0)
    errs["epilogue_backward"] = max(
        errs["epilogue_backward"],
        _sums_err(torch, dsh, rdsh, ga.sum(0), f"dshift {what}"),
        _sums_err(torch, ds, rds, (ga * xf.abs()).sum(0), f"dscale {what}"))
    # kernel 3
    xs = x + 0.5
    got, again = ce.channel_sums(xs), ce.channel_sums(xs)
    check(torch.equal(got, again),
          f"channel_sums {what} differ across two launches")
    errs["channel_sums"] = max(errs["channel_sums"], _sums_err(
        torch, got, ce.channel_sums_plain(xs),
        ce.channel_sums_plain(xs.abs()), f"channel_sums {what}"))
    # kernels 5 and 6
    mean = 0.1 * torch.randn(C, device="cuda", generator=g)
    rstd = torch.rand(C, device="cuda", generator=g) + 0.5
    sdy, sdyx = bt.bn_bwd_sums(x, dy, mean, rstd)
    sdy2, sdyx2 = bt.bn_bwd_sums(x, dy, mean, rstd)
    check(torch.equal(sdy, sdy2) and torch.equal(sdyx, sdyx2),
          f"bn_bwd_sums {what} differ across two launches")
    rsdy, rsdyx = bt.bn_bwd_sums_plain(x, dy, mean, rstd)
    t_dy, t_dyx = bt.bn_bwd_sums_plain((xf - mean).abs(), dy.abs(),
                                       torch.zeros_like(mean), rstd)
    errs["bn_bwd_sums"] = max(
        errs["bn_bwd_sums"],
        _sums_err(torch, sdy, rsdy, t_dy, f"sum dy {what}"),
        _sums_err(torch, sdyx, rsdyx, t_dyx, f"sum dy*xhat {what}"))
    a, d, e = (torch.randn(C, device="cuda", generator=g) for _ in range(3))
    dx6 = bt.bn_bwd_dx(x, dy, a, d, e)
    check(torch.equal(dx6, bt.bn_bwd_dx_plain(x, dy, a, d, e)),
          f"bn_bwd_dx {what} not bitwise")
    torch.cuda.synchronize()


def _site_costs(name: str, M: int, C: int, esize: int, act: str):
    """(bytes, operations) the function must move and do at one site:
    each input read once, each output written once."""
    n = M * C
    if name == "channel_sums":
        return n * esize + 2 * C * 4, 3 * n
    if name == "epilogue_backward":
        return 3 * n * esize + 4 * C * 4, (7 if act == "relu" else 4) * n
    if name == "bn_bwd_sums":
        return 2 * n * esize + 4 * C * 4, 5 * n
    return 3 * n * esize + 3 * C * 4, 4 * n                 # bn_bwd_dx


def phase_train_kernels(torch) -> dict:
    """Kernels 2, 3, 5 and 6 against their plain versions at every site
    shape, then timings over the 53 sites of a batch-32 training step."""
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    from deeplearning4j_tpu_torch.ops import conv_epilogue as ce
    g = torch.Generator(device="cuda").manual_seed(13)
    sites = bn_sites(ResNet50().conf(), BATCH)
    check(len(sites) == 53, f"ResNet-50 has {len(sites)} BN sites")
    errs = {k: 0.0 for k in TRAIN_KERNELS}
    shapes = sorted(set(sites)) + LENET_SITES
    for M, C, act in shapes:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            _check_train_kernels(torch, M, C, act, dt, g, errs)
    print(f"[train-kernels] epilogue_backward/channel_sums/bn_bwd_sums/"
          f"bn_bwd_dx == plain at {len(shapes)} (M, C, act) shapes (the "
          f"batch-{BATCH} ResNet-50 step's and LeNet-5's), f32/bf16/f16: "
          f"dx bitwise, sums within {SUM_RTOL} x sum|terms|, sums bitwise "
          f"across two launches; max |kernel - plain| {errs}")

    groups: dict = {}
    for site in sites:
        groups[site] = groups.get(site, 0) + 1
    timing = {k: {} for k in TRAIN_KERNELS}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        esize = torch.tensor([], dtype=dt).element_size()
        short = str(dt).split(".")[-1]
        tot = {k: {"kernel": 0.0, "plain": 0.0, "library": 0.0,
                   "eager": 0.0, "bytes": 0, "ops": 0, "shapes": []}
               for k in TRAIN_KERNELS}
        for (M, C, act), n in sorted(groups.items()):
            n_buf = max(1, int(-(-100e6 // (M * C * esize))))
            xs = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                  for _ in range(n_buf)]
            dys = [torch.randn(M, C, device="cuda", generator=g).to(dt)
                   for _ in range(n_buf)]
            v = [torch.rand(C, device="cuda", generator=g) + 0.5
                 for _ in range(3)]
            it = {"i": 0}

            def nxt():
                it["i"] = (it["i"] + 1) % n_buf
                return xs[it["i"]], dys[it["i"]]

            def nbb():
                x, dy = nxt()
                return torch.ops.aten.native_batch_norm_backward(
                    dy, x, v[0], None, None, v[1], v[2], True, 1e-5,
                    [True, True, True])

            fns = {
                "channel_sums": (lambda: ce.channel_sums(nxt()[0]),
                                 lambda: ce.channel_sums_plain(nxt()[0]),
                                 lambda: torch.var_mean(nxt()[0], 0,
                                                        correction=0)),
                "epilogue_backward": (
                    lambda: ce.epilogue_backward(*nxt(), v[0], v[1], act),
                    lambda: ce.epilogue_backward_plain(*nxt(), v[0], v[1],
                                                       act),
                    None),
                "bn_bwd_sums": (
                    lambda: bt.bn_bwd_sums(*nxt(), v[1], v[2]),
                    lambda: bt.bn_bwd_sums_plain(*nxt(), v[1], v[2]),
                    nbb),
                "bn_bwd_dx": (
                    lambda: bt.bn_bwd_dx(*nxt(), *v),
                    lambda: bt.bn_bwd_dx_plain(*nxt(), *v),
                    nbb),
            }
            for name, (kern, plain, lib) in fns.items():
                t = tot[name]
                k_ms = _graph_ms(torch, kern)
                t["kernel"] += n * k_ms
                t["plain"] += n * _graph_ms(torch, plain)
                t["eager"] += n * _time_ms(torch, kern)
                if lib is not None and t["library"] is not None:
                    try:
                        t["library"] += n * _graph_ms(torch, lib)
                    except RuntimeError as exc:
                        print(f"[train-kernels] library call for {name} "
                              f"[{M},{C}] {short} failed: {exc}")
                        t["library"] = None
                b_, o_ = _site_costs(name, M, C, esize, act)
                t["bytes"] += n * b_
                t["ops"] += n * o_
                t["shapes"].append(f"[{M},{C}]x{n} {k_ms * 1e3:.1f}us "
                                   f"{b_ / k_ms / 1e6:.0f}GB/s")
            del xs, dys
        for name, t in tot.items():
            bound = max(t["bytes"] / HBM_BYTES_PER_S,
                        t["ops"] / F32_FLOPS) * 1e3
            lib = (t["library"] if name != "epilogue_backward" else None)
            timing[name][short] = {
                "kernel_ms": t["kernel"], "plain_ms": t["plain"],
                "library_ms": lib, "eager_ms": t["eager"],
                "bound_ms": bound, "bytes": t["bytes"],
                "bound_by": ("bytes" if t["bytes"] / HBM_BYTES_PER_S >=
                             t["ops"] / F32_FLOPS else "operations")}
            lib_s = f"{lib:.4f}" if lib is not None else "none"
            print(f"[train-kernels] {name} {short}, 53 sites of a "
                  f"batch-{BATCH} step: kernel {t['kernel']:.4f} ms, "
                  f"plain {t['plain']:.4f} ms, library {lib_s} ms, bound "
                  f"{bound:.4f} ms ({t['bytes'] / 1e9:.3f} GB), eager "
                  f"{t['eager']:.4f} ms")
            print(f"[train-kernels]   per site: {'; '.join(t['shapes'])}")
    return {"max_abs_err": errs, "timing": timing}


# ---------------------------------------------------------------------------
def _counts():
    from deeplearning4j_tpu_torch.ops import cuda_build
    return {k.name: k.launches for k in cuda_build.KERNELS.values()}


def _zero_counts():
    from deeplearning4j_tpu_torch.ops import cuda_build
    for k in cuda_build.KERNELS.values():
        k.launches = 0


def _sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _timed_steps(torch, net, x, y, n: int):
    """``n`` fit steps; returns (losses, wall ms of each step)."""
    losses, ms = [], []
    for _ in range(n):
        _sync(torch, x.device.type)
        t0 = time.perf_counter()
        net.fit(x, y)
        _sync(torch, x.device.type)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score())
    return losses, ms


def _copy_net(torch, net, conf, device):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    return ComputationGraph(conf).set_params(
        {k: {n: t.detach().clone().to(device) for n, t in sub.items()}
         for k, sub in net.params.items()},
        {k: {n: t.clone().to(device) for n, t in sub.items()}
         for k, sub in net.states.items()}, device)


def learnable_batch(torch, g, batch: int, image: int, classes: int = 8):
    """A seeded batch the net can learn: ``classes`` of the 1000 labels,
    each a fixed random NHWC image plus noise at half its scale."""
    templates = torch.randn(classes, image, image, 3, generator=g)
    cls = torch.arange(batch) % classes
    x = templates[cls] + 0.5 * torch.randn(batch, image, image, 3,
                                           generator=g)
    labels = torch.randperm(1000, generator=g)[:classes][cls]
    return x, torch.eye(1000)[labels]


def phase_train_resnet(torch, label: str, device: str = "cuda",
                       image: int = 224, batch: int = BATCH) -> dict:
    """``device="cpu"`` with a small ``image`` and ``batch`` rehearses
    the phase without a card (launch counts, profile and the card-CPU
    comparison are the card's)."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    kw = dict(seed=21, height=image, width=image)
    g = torch.Generator().manual_seed(21)
    t0 = time.perf_counter()
    net = ResNet50(**kw).init(device, generator=g)
    x, y = learnable_batch(torch, g, batch, image)
    x, y = x.to(device), y.to(device)
    stem0 = net.states["stem_bn"]["mean"].clone()
    on_card = device == "cuda"
    print(f"[train] ResNet-50 {image}x{image}x3 -> 1000, batch {batch} "
          f"f32 on {device}, "
          f"{net.num_params()} params, updater {net.conf.updater}, l2 "
          f"{net.conf.l2}; built in {time.perf_counter() - t0:.2f}s")

    # ---- the main path: counts to 0, ten fit steps, counts read ----
    steps = 10
    _zero_counts()
    losses, ms = _timed_steps(torch, net, x, y, steps)
    launches = _counts()
    print(f"[train] losses {losses}; step ms {[round(m, 3) for m in ms]}; "
          f"launches {launches}")
    check(all(np.isfinite(losses)), f"loss not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = {"channel_sums": 53, "scale_shift_act": 53, "bn_bwd_sums": 53,
            "bn_bwd_dx": 53, "epilogue_backward": 0}
    for k, per_step in want.items():
        check(launches[k] == per_step * steps * on_card,
              f"{k}: {launches[k]} launches in {steps} steps, expected "
              f"{per_step} a step")
    moved = float((net.states["stem_bn"]["mean"] - stem0).abs().max())
    check(moved > 0, "running stats did not move")
    step_ms = float(np.median(ms[1:]))
    print(f"[train] batch-{batch} f32 step {step_ms:.3f} ms (median of "
          f"steps 2-{steps}) = {batch * 1e3 / step_ms:.1f} img/s; running "
          f"mean moved by up to {moved:.3e} [{label}]")
    result = {"losses": losses, "step_ms": ms, "median_step_ms": step_ms,
              "img_per_s": batch * 1e3 / step_ms, "launches": launches}
    if on_card:
        result["profile"] = profile_device(
            torch, lambda: net.fit(x, y), step_ms,
            f"batch-{batch} f32 train step")

    # ---- the fused BN backward killed: kernel 2, kernel 1 twice ----
    off_steps = 4
    os.environ["DL4J_TORCH_FUSED_BN_BWD"] = "0"
    try:
        _zero_counts()
        l_off, ms_off = _timed_steps(torch, net, x, y, off_steps)
        off = _counts()
    finally:
        del os.environ["DL4J_TORCH_FUSED_BN_BWD"]
    per_step = {"channel_sums": 53, "scale_shift_act": 106,
                "epilogue_backward": 53, "bn_bwd_sums": 0, "bn_bwd_dx": 0}
    for k, n in per_step.items():
        check(off[k] == n * off_steps * on_card,
              f"fused_bn_bwd=0: {k} {off[k]} launches in {off_steps} "
              f"steps, expected {n} a step")
    check(all(np.isfinite(l_off)), f"fused_bn_bwd=0 loss {l_off}")
    off_ms = float(np.median(ms_off[1:]))
    print(f"[train] DL4J_TORCH_FUSED_BN_BWD=0: step {off_ms:.3f} ms "
          f"(median of steps 2-{off_steps} of "
          f"{[round(m, 3) for m in ms_off]}; fused backward "
          f"{step_ms:.3f}); launches {off} [{label}]")
    result.update(step_ms_bn_bwd_off=ms_off, launches_bn_bwd_off=off)

    # ---- one bf16 step on a copy ----
    net16 = _copy_net(torch, net, ResNet50(compute_dtype="bfloat16",
                                           **kw).conf(), device)
    l16, ms16 = _timed_steps(torch, net16, x, y, 2)
    check(all(np.isfinite(l16)), f"bf16 losses {l16}")
    print(f"[train] bf16 compute_dtype: losses {l16}, steps "
          f"{[round(m, 3) for m in ms16]} ms [{label}]")
    result.update(bf16_losses=l16, bf16_step_ms=ms16)
    del net16, net
    if on_card:
        torch.cuda.empty_cache()
        result["card_vs_cpu"] = train_card_vs_cpu(torch)
    return result


#: card against CPU after one step at 64x64 (TF32 off). One float32
#: step of this network is ill-conditioned: its BatchNormalization
#: gamma/beta gradients are sums that cancel, and rounding alone moves
#: a parameter's update by a few percent in norm against the float64
#: step. So the updates are held norm-wise against a float64 step on
#: the CPU: the card's distance from it may be at most UPDATE_FACTOR
#: times the CPU float32 step's own (plus UPDATE_FLOOR). The loss and the
#: running stats are forward quantities and are held directly.
LOSS_RTOL, STATE_RTOL = 1e-5, 1e-3
UPDATE_FACTOR, UPDATE_FLOOR = 2.0, 1e-3


def train_card_vs_cpu(torch, image: int = 64, batch: int = 8,
                      device: str = "cuda") -> dict:
    """One fit step on the card and on the CPU from the same weights,
    the CPU on the card's route (both kernel gates forced: the kernels'
    plain versions) in float32 and in float64. ``device="cpu"``
    rehearses it without a card."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    g = torch.Generator().manual_seed(23)
    base = ResNet50(height=image, width=image, seed=23).init(
        "cpu", generator=g)
    x, y = learnable_batch(torch, g, batch, image)
    p0 = {k: {n: t.double() for n, t in sub.items()}
          for k, sub in base.params.items()}
    card = _copy_net(torch, base, base.conf, device)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card.fit(x.to(device), y.to(device))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    conf64 = ResNet50(height=image, width=image, seed=23).conf()
    conf64.dtype = "float64"
    cpu64 = ComputationGraph(conf64).set_params(
        {k: {n: t.clone() for n, t in sub.items()} for k, sub in p0.items()},
        {k: {n: t.double() for n, t in sub.items()}
         for k, sub in base.states.items()}, "cpu")
    extra = Environment.get().extra
    saved = {k: extra.get(k) for k in ("fused_conv", "fused_bn_bwd")}
    extra.update(fused_conv="1", fused_bn_bwd="1")
    try:
        base.fit(x, y)
        cpu64.fit(x.double(), y.double())
    finally:
        for k, v in saved.items():
            if v is None:
                extra.pop(k, None)
            else:
                extra[k] = v
    check(abs(card.score() - base.score()) <= LOSS_RTOL * abs(base.score()),
          f"loss card {card.score()} vs cpu {base.score()}")

    def dist(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    e_card = e_cpu = e_pair = 0.0
    for k, sub in p0.items():
        for n, t0 in sub.items():
            d64 = cpu64.params[k][n] - t0
            dcard = card.params[k][n].detach().cpu().double() - t0
            dcpu = base.params[k][n].detach().double() - t0
            e_card = max(e_card, dist(dcard, d64))
            e_cpu = max(e_cpu, dist(dcpu, d64))
            e_pair = max(e_pair, dist(dcard, dcpu))
    check(e_card <= UPDATE_FACTOR * e_cpu + UPDATE_FLOOR,
          f"card updates {e_card:.3e} from the float64 step, the CPU "
          f"float32 step's {e_cpu:.3e}")
    e_state = 0.0
    for k, sub in base.states.items():
        for n, t in sub.items():
            e = dist(card.states[k][n].cpu().double(), t.double())
            e_state = max(e_state, e)
            check(e <= STATE_RTOL, f"running stat {k}/{n}: card vs cpu "
                                   f"{e:.3e} in norm")
    out = {"loss_card": card.score(), "loss_cpu": base.score(),
           "loss_cpu64": cpu64.score(), "update_card_vs_f64": e_card,
           "update_cpu32_vs_f64": e_cpu, "update_card_vs_cpu32": e_pair,
           "states_card_vs_cpu32": e_state}
    print(f"[train] card vs CPU, one step at {image}x{image}, batch {batch}"
          f" (TF32 off; CPU on the card's route): loss {card.score():.7f} "
          f"vs {base.score():.7f} (f64 {cpu64.score():.7f}); worst update "
          f"in norm: card vs f64 {e_card:.3e}, CPU f32 vs f64 {e_cpu:.3e},"
          f" card vs CPU f32 {e_pair:.3e}; running stats {e_state:.3e}")
    return out


def phase_train_lenet(torch, label: str, device: str = "cuda") -> dict:
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

    class Timed(TrainingListener):
        def __init__(self):
            self.scores, self.ms = [], []
            self.t = time.perf_counter()

        def iteration_done(self, model, iteration, epoch):
            self.scores.append(model.score())     # syncs on the loss
            now = time.perf_counter()
            self.ms.append((now - self.t) * 1e3)
            self.t = now

    steps = 20
    net = LeNet().init(device, generator=torch.Generator().manual_seed(5))
    it = MnistDataSetIterator(LENET_BATCH, num_examples=LENET_BATCH * steps)
    lis = Timed()
    net.set_listeners(lis)
    _zero_counts()
    lis.t = time.perf_counter()
    net.fit(it)
    _sync(torch, device)
    launches = _counts()
    s = lis.scores
    print(f"[lenet] {steps} steps of batch {LENET_BATCH}, Adam(1e-3), "
          f"synthetic MNIST: losses {[round(v, 4) for v in s]}; launches "
          f"{launches}")
    check(all(np.isfinite(s)), "LeNet loss not finite")
    check(np.mean(s[-5:]) < np.mean(s[:5]),
          f"LeNet loss did not fall: first five {s[:5]}, last five "
          f"{s[-5:]}")
    for k in ("scale_shift_act", "epilogue_backward"):
        check(launches[k] == 2 * steps * (device == "cuda"),
              f"LeNet {k}: {launches[k]} launches in {steps} steps, "
              f"expected 2 a step")
    step_ms = float(np.median(lis.ms[1:]))
    print(f"[lenet] step {step_ms:.3f} ms (median of steps 2-{steps}, "
          f"host batches through fit(iterator)) = "
          f"{LENET_BATCH * 1e3 / step_ms:.1f} img/s [{label}]")
    return {"losses": s, "step_ms": lis.ms, "median_step_ms": step_ms,
            "launches": launches}


def phase_weights_across(torch) -> dict:
    import numpy as np

    from deeplearning4j_tpu_torch.utils import ModelSerializer
    check(CIFAR_ZIP.exists(), f"{CIFAR_ZIP} missing")
    card = ModelSerializer.restore_model(CIFAR_ZIP, "cuda")
    cpu = ModelSerializer.restore_model(CIFAR_ZIP, "cpu")
    x = np.random.RandomState(5).rand(16, 32, 32, 3).astype(np.float32)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        a = card.output(x).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    b = cpu.output(x).numpy()
    err = float(np.abs(a - b).max())
    check(np.allclose(a, b, rtol=1e-4, atol=1e-5),
          f"resnet_cifar.zip card vs CPU: max |d| {err}")
    print(f"[weights] resnet_cifar.zip restored on cuda == cpu (TF32 off)"
          f", max |d| {err:.3e}, top-1 {a.argmax(-1)[:8].tolist()}")
    return {"max_abs": err}


# ---------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import deeplearning4j_tpu_torch  # noqa: F401  fails outside a checkout
    t_start = time.perf_counter()
    dev = phase_device(torch)
    phase_build()
    label = dev["nvidia_smi"]
    kern = phase_kernels(torch)
    tk = phase_train_kernels(torch)
    sl = phase_slice(torch, label=label)
    tr = phase_train_resnet(torch, label)
    ln = phase_train_lenet(torch, label)
    phase_weights_across(torch)

    from deeplearning4j_tpu_torch.ops import cuda_build
    f32 = kern["timing"]["float32"]
    # each kernel's launches come from the path that carries it
    paths = {"scale_shift_act": ("serving ResNet-50", sl["launches"]),
             "epilogue_backward": ("training LeNet-5, 20 steps",
                                   ln["launches"]),
             "channel_sums": ("training ResNet-50, 10 steps",
                              tr["launches"]),
             "bn_bwd_sums": ("training ResNet-50, 10 steps",
                             tr["launches"]),
             "bn_bwd_dx": ("training ResNet-50, 10 steps", tr["launches"])}
    records = []
    for k in cuda_build.KERNELS.values():
        path, launches = paths[k.name]
        if k.name == "scale_shift_act":
            t = {"kernel_ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
                 "bound_ms": f32["bound_ms"], "library_ms":
                 f32["library_ms"], "eager_ms": f32["kernel_eager_ms"],
                 "bound_by": "bytes"}
            err = kern["max_abs_err"]
            shapes = f"the 53 BatchNormalization sites of a batch-{BATCH} " \
                     f"f32 ResNet-50 forward"
            by_dtype = {d: v["kernel_ms"] for d, v in kern["timing"].items()}
        else:
            t = tk["timing"][k.name]["float32"]
            err = tk["max_abs_err"][k.name]
            shapes = f"the 53 BatchNormalization sites of a batch-{BATCH} " \
                     f"f32 ResNet-50 training step"
            by_dtype = {d: v["kernel_ms"]
                        for d, v in tk["timing"][k.name].items()}
        records.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "launches_path": path, "max_abs_err": err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "ms_by_dtype": by_dtype, "shapes": shapes})
    print(f"[done] ResNet-50 train step {tr['median_step_ms']:.3f} ms "
          f"({tr['img_per_s']:.1f} img/s), LeNet-5 step "
          f"{ln['median_step_ms']:.3f} ms [{label}]")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": records}))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
