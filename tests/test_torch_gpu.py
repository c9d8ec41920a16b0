"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked ``gpu`` and skips
without a card (decided inside the test). This file imports neither
jax nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
import pytest
import torch

from deeplearning4j_tpu_torch.ops import conv_epilogue as ce


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(401408, 64), (100352, 256),
                                   (1568, 2048), (1001, 64), (777, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_scale_shift_act_kernel_matches_plain(shape, dtype, act):
    """Bitwise: kernel and plain version both round the f32 multiply,
    then the add, and round to the output dtype the same way; NaN
    propagates through relu."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    M, C = shape
    x = torch.randn(M, C, device="cuda", generator=g).to(
        getattr(torch, dtype))
    x.view(-1)[::997] = float("nan")
    s = torch.randn(C, device="cuda", generator=g)
    b = torch.randn(C, device="cuda", generator=g)
    n0 = ce.EPILOGUE.launches
    y = ce.scale_shift_act(x, s, b, act)
    r = ce.scale_shift_act_plain(x, s, b, act)
    torch.cuda.synchronize()
    assert ce.EPILOGUE.launches == n0 + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(torch.isnan(y), torch.isnan(r))
    assert torch.equal(y.nan_to_num(0.0), r.nan_to_num(0.0))


@pytest.mark.gpu
def test_scale_shift_act_kernel_rejects_what_it_does_not_take():
    _need_card()
    x = torch.randn(64, 8, device="cuda")
    s = torch.ones(8, device="cuda")
    with pytest.raises(TypeError):
        ce.scale_shift_act(x.double(), s, s, "relu")
    with pytest.raises(ValueError):
        ce.scale_shift_act(x.t(), torch.ones(64, device="cuda"),
                           torch.ones(64, device="cuda"), "relu")
    with pytest.raises(ValueError):
        ce.scale_shift_act(x, s.cpu(), s, "relu")
    with pytest.raises(ValueError):
        ce.scale_shift_act(x, s, s, "tanh")


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16", "float16"])
def test_resnet50_forward_launches_53_epilogues_on_card(compute_dtype):
    _need_card()
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    net = ResNet50(height=64, width=64,
                   compute_dtype=compute_dtype).init("cuda")
    n0 = ce.EPILOGUE.launches
    out = net.output(torch.randn(2, 64, 64, 3))
    torch.cuda.synchronize()
    assert ce.EPILOGUE.launches - n0 == 53
    assert out.shape == (2, 1000) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# the training kernels: epilogue backward, channel sums, BN backward
# ---------------------------------------------------------------------------
#: |kernel - plain| <= SUM_RTOL * sum|terms| per channel: both sum the
#: same f32 terms in different orders; at these shapes the kernel's
#: summation depth is under ~200 additions (worst case 200 * 2^-24 =
#: 1.2e-5 relative to sum|terms|), torch's reduction adds its own,
#: bounded the same way
SUM_RTOL = 2e-5
TRAIN_SHAPES = [(401408, 64), (100352, 256), (1568, 2048), (100353, 64),
                (18432, 20), (2048, 50), (777, 3)]


def _rand(M, C, dtype, g):
    return torch.randn(M, C, device="cuda", generator=g).to(
        getattr(torch, dtype))


def _sums_close(got, want, terms_abs, what):
    err = (got - want).abs()
    assert bool((err <= SUM_RTOL * terms_abs + 1e-30).all()), (
        f"{what}: max err {float(err.max())}, bound "
        f"{float((SUM_RTOL * terms_abs).min())}")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_epilogue_backward_kernel_matches_plain(shape, dtype, act):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    M, C = shape
    x, dy = _rand(M, C, dtype, g), _rand(M, C, dtype, g)
    s = torch.randn(C, device="cuda", generator=g)
    b = torch.randn(C, device="cuda", generator=g)
    n0 = ce.EPILOGUE_BWD.launches
    dx, dscale, dshift = ce.epilogue_backward(x, dy, s, b, act)
    dx2, dscale2, dshift2 = ce.epilogue_backward(x, dy, s, b, act)
    rdx, rdscale, rdshift = ce.epilogue_backward_plain(x, dy, s, b, act)
    torch.cuda.synchronize()
    assert ce.EPILOGUE_BWD.launches == n0 + 2
    assert dx.dtype == x.dtype and torch.equal(dx, rdx)
    assert torch.equal(dscale, dscale2) and torch.equal(dshift, dshift2)
    xf, g_abs = x.float(), dy.float().abs()
    if act == "relu":
        g_abs = torch.where(xf * s + b > 0, g_abs, 0.0)
    _sums_close(dshift, rdshift, g_abs.sum(0), "dshift")
    _sums_close(dscale, rdscale, (g_abs * xf.abs()).sum(0), "dscale")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_channel_sums_kernel_matches_plain(shape, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    M, C = shape
    x = _rand(M, C, dtype, g) + 0.5
    n0 = ce.CHANNEL_SUMS.launches
    got, again = ce.channel_sums(x), ce.channel_sums(x)
    want = ce.channel_sums_plain(x)
    torch.cuda.synchronize()
    assert ce.CHANNEL_SUMS.launches == n0 + 2 and torch.equal(got, again)
    terms = ce.channel_sums_plain(x.abs())
    _sums_close(got, want, terms, "channel_sums")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bn_backward_kernels_match_plain(shape, dtype):
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    M, C = shape
    x, dy = _rand(M, C, dtype, g), _rand(M, C, dtype, g)
    mean = 0.1 * torch.randn(C, device="cuda", generator=g)
    rstd = torch.rand(C, device="cuda", generator=g) + 0.5
    n0, n1 = bt.BN_BWD_SUMS.launches, bt.BN_BWD_DX.launches
    sdy, sdyx = bt.bn_bwd_sums(x, dy, mean, rstd)
    sdy2, sdyx2 = bt.bn_bwd_sums(x, dy, mean, rstd)
    rsdy, rsdyx = bt.bn_bwd_sums_plain(x, dy, mean, rstd)
    a, d, e = (torch.randn(C, device="cuda", generator=g) for _ in range(3))
    dx = bt.bn_bwd_dx(x, dy, a, d, e)
    torch.cuda.synchronize()
    assert bt.BN_BWD_SUMS.launches == n0 + 2
    assert bt.BN_BWD_DX.launches == n1 + 1
    assert torch.equal(sdy, sdy2) and torch.equal(sdyx, sdyx2)
    t_dy, t_dyx = bt.bn_bwd_sums_plain((x.float() - mean).abs(),
                                       dy.abs(), torch.zeros_like(mean),
                                       rstd)
    _sums_close(sdy, rsdy, t_dy, "sum dy")
    _sums_close(sdyx, rsdyx, t_dyx, "sum dy*xhat")
    want = bt.bn_bwd_dx_plain(x, dy, a, d, e)
    assert dx.dtype == x.dtype and torch.equal(dx, want)


#: (M, C, view, expected body) for kernel 6: the scalar body at C = 3
#: and on a misaligned view ("tail": x[1:] of a flat buffer one element
#: longer), a second grid dimension of channel tiles at C = 2048 in f32
#: and C = 4096 in every dtype, M = 1
BN_DX_BODY_CASES = [
    (777, 3, None, "scalar"),
    (1568, 2048, None, "16-byte vectors"),
    (3, 4096, None, "16-byte vectors"),
    (1, 64, None, "16-byte vectors"),
    (1, 2048, None, "16-byte vectors"),
    (1000, 64, "tail", "scalar"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BN_DX_BODY_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}"
                                       + (f"-{c[2]}" if c[2] else ""))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bn_bwd_dx_each_body_bitwise_equal_to_plain(case, dtype):
    """Kernel 6's bodies (16-byte vectors or scalar, one or more channel
    tiles of at most 256 channel groups) bitwise equal to the plain
    version, and equal across two launches."""
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(7)
    M, C, view, prefix = case
    x, dy = _rand(M, C, dtype, g), _rand(M, C, dtype, g)
    if view == "tail":
        buf = torch.empty(M * C + 1, device="cuda", dtype=x.dtype)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(M, C)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    a, d, e = (torch.randn(C, device="cuda", generator=g) for _ in range(3))
    body = bt.bn_bwd_dx_body(x, dy)
    assert body.startswith(prefix), body
    groups = C // (16 // x.element_size()) if prefix != "scalar" else C
    tiles = -(-groups // min(groups, 256))
    assert f"x{tiles}," in body, body
    n0 = bt.BN_BWD_DX.launches
    dx = bt.bn_bwd_dx(x, dy, a, d, e)
    dx2 = bt.bn_bwd_dx(x, dy, a, d, e)
    want = bt.bn_bwd_dx_plain(x, dy, a, d, e)
    torch.cuda.synchronize()
    assert bt.BN_BWD_DX.launches == n0 + 2
    assert dx.dtype == x.dtype and torch.equal(dx, want)
    assert torch.equal(dx, dx2)


#: (M, C, view) for the one-launch sums of kernels 5 and 3: the 9 (M, C)
#: site shapes of a batch-32 ResNet-50 step, C % 8 != 0 (scalar body), a
#: pointer off 16 bytes ("tail": x[1:] of a flat buffer one element
#: longer), and M below one chunk (one chunk, one ticket group)
BN_SUMS_CASES = [
    (1568, 512, None), (1568, 2048, None), (6272, 256, None),
    (6272, 1024, None), (25088, 128, None), (25088, 512, None),
    (100352, 64, None), (100352, 256, None), (401408, 64, None),
    (777, 3, None), (3000, 20, None), (1000, 64, "tail"), (40, 64, None),
    (1, 512, None),
]
#: the kernels on column_reduce_sm90.cuh: kernel 5 (bn_bwd_sums, x and
#: dy) and kernel 3 (channel_sums, x alone)
SUMS_KERNELS = ["bn_bwd_sums", "channel_sums"]


def _bn_sums_inputs(M, C, view, dtype, g):
    x, dy = _rand(M, C, dtype, g), _rand(M, C, dtype, g)
    if view == "tail":
        buf = torch.empty(M * C + 1, device="cuda", dtype=x.dtype)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(M, C)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    mean = 0.1 * torch.randn(C, device="cuda", generator=g)
    rstd = torch.rand(C, device="cuda", generator=g) + 0.5
    return x, dy, mean, rstd


def _bn_sums_close(x, dy, mean, rstd, sdy, sdyx):
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    rsdy, rsdyx = bt.bn_bwd_sums_plain(x, dy, mean, rstd)
    t_dy, t_dyx = bt.bn_bwd_sums_plain((x.float() - mean).abs(),
                                       dy.abs(), torch.zeros_like(mean),
                                       rstd)
    _sums_close(sdy, rsdy, t_dy, "sum dy")
    _sums_close(sdyx, rsdyx, t_dyx, "sum dy*xhat")


def _one_launch_sums(kernel, ins):
    """Kernel 5 or 3 on the inputs of ``_bn_sums_inputs``: (a call giving
    its two sums, the body it names, its Kernel, a check of two sums
    against the plain version)."""
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    x, dy, mean, rstd = ins
    if kernel == "bn_bwd_sums":
        return (lambda: bt.bn_bwd_sums(x, dy, mean, rstd),
                bt.bn_bwd_sums_body(x, dy), bt.BN_BWD_SUMS,
                lambda got: _bn_sums_close(x, dy, mean, rstd, *got))

    def close(got):
        want, terms = ce.channel_sums_plain(x), ce.channel_sums_plain(x.abs())
        _sums_close(got[0], want[0], terms[0], "sum x")
        _sums_close(got[1], want[1], terms[1], "sum x*x")

    return (lambda: tuple(ce.channel_sums(x)), ce.channel_sums_body(x),
            ce.CHANNEL_SUMS, close)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", SUMS_KERNELS)
@pytest.mark.parametrize("case", BN_SUMS_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}"
                                       + (f"-{c[2]}" if c[2] else ""))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bn_bwd_sums_one_launch_matches_plain(case, dtype, kernel):
    """Kernels 5 and 3 within SUM_RTOL x sum|terms| of their plain
    versions, bitwise across two launches and across a CUDA-graph
    replay, one launch a call; the body each names is the one its shape
    asks for."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(17)
    M, C, view = case
    ins = _bn_sums_inputs(M, C, view, dtype, g)
    call, body, counter, close = _one_launch_sums(kernel, ins)
    vec = C % (16 // ins[0].element_size()) == 0 and view is None
    assert body.startswith("one launch, " + ("16-byte vectors" if vec
                                             else "scalar")), body
    if M <= 64:
        assert "grid 1x" in body, body
    n0 = counter.launches
    s0, s1 = call()
    s0b, s1b = call()
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert torch.equal(s0, s0b) and torch.equal(s1, s1b)
    close((s0, s1))
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        g0, g1 = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g0, s0) and torch.equal(g1, s1)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", SUMS_KERNELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_bwd_sums_two_streams_at_once(dtype, kernel):
    """Launches of kernel 5 or 3 in flight at once on two streams (and a
    graph replay on a third) each give their own inputs' bits: their
    tickets are their own."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(18)
    shapes = [(100352, 64), (25088, 512)]
    calls = [_one_launch_sums(kernel,
                              _bn_sums_inputs(M, C, None, dtype, g))[0]
             for M, C in shapes for _ in range(2)]
    want = [call() for call in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gout = calls[0]()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for _ in range(10):
        outs = []
        for i, call in enumerate(calls):
            with torch.cuda.stream(streams[i % 2]):
                outs.append(call())
        graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert torch.equal(got[0], w[0]) and torch.equal(got[1], w[1])
        assert torch.equal(gout[0], want[0][0])
        assert torch.equal(gout[1], want[0][1])


@pytest.mark.gpu
def test_training_kernels_reject_what_they_do_not_take():
    from deeplearning4j_tpu_torch.ops import bn_train as bt
    _need_card()
    x = torch.randn(64, 8, device="cuda")
    v = torch.ones(8, device="cuda")
    with pytest.raises(TypeError):
        ce.channel_sums(x.double())
    with pytest.raises(ValueError):
        ce.epilogue_backward(x, x.half(), v, v, "relu")
    with pytest.raises(ValueError):
        bt.bn_bwd_sums(x, x, v.cpu(), v)
    with pytest.raises(ValueError):
        bt.bn_bwd_dx(x, x.t().contiguous().t(), v, v, v)


def _counts():
    from deeplearning4j_tpu_torch.ops import cuda_build
    return {k: v.launches for k, v in cuda_build.KERNELS.items()}


def _delta(before):
    return {k: n - before[k] for k, n in _counts().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("gates,want", [
    ({}, {"channel_sums": 53, "scale_shift_act": 53, "bn_bwd_sums": 53,
          "bn_bwd_dx": 53, "epilogue_backward": 0}),
    ({"DL4J_TORCH_FUSED_BN_BWD": "0"},
     {"channel_sums": 53, "scale_shift_act": 106, "bn_bwd_sums": 0,
      "bn_bwd_dx": 0, "epilogue_backward": 53}),
    ({"DL4J_TORCH_FUSED_BN_BWD": "0", "DL4J_TORCH_FUSED_CONV": "0"},
     {"channel_sums": 0, "scale_shift_act": 0, "bn_bwd_sums": 0,
      "bn_bwd_dx": 0, "epilogue_backward": 0}),
])
def test_resnet50_train_step_launches_on_card(gates, want, monkeypatch):
    """One training step of ResNet-50 at 64x64 on the card: the fused
    backward path launches kernels 3, 1, 5 and 6 at each of the 53
    BatchNormalization sites; with it killed, kernel 2 and kernel 1
    twice; the plain math only with both gates killed. No other kernel
    of the port (the flash kernels) launches."""
    _need_card()
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    for k, v in gates.items():
        monkeypatch.setenv(k, v)
    net = ResNet50(height=64, width=64, num_classes=10).init("cuda")
    x = torch.randn(2, 64, 64, 3, device="cuda")
    y = torch.eye(10, device="cuda")[:2]
    before = _counts()
    net.fit(x, y)
    torch.cuda.synchronize()
    assert _delta(before) == {k: want.get(k, 0) for k in before}
    assert torch.isfinite(torch.tensor(net.score()))


@pytest.mark.gpu
def test_lenet_train_step_launches_kernels_1_and_2_twice():
    _need_card()
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    net = LeNet().init("cuda")
    x = torch.rand(8, 784, device="cuda")
    y = torch.eye(10, device="cuda")[:8]
    before = _counts()
    net.fit(x, y)
    torch.cuda.synchronize()
    d = _delta(before)
    assert d["scale_shift_act"] == 2 and d["epilogue_backward"] == 2


# ---------------------------------------------------------------------------
# the flash-attention kernels: forward (7), dq (8), dk/dv (9)
# ---------------------------------------------------------------------------
#: the reference's own bars (tests/test_attention_pallas.py:38,75): f32
#: forward rtol/atol 2e-5, gradients rtol 2e-4 / atol 2e-5; bf16 2e-2
FLASH_TOL = {"float32": ((2e-5, 2e-5), (2e-4, 2e-5)),
             "bfloat16": ((2e-2, 2e-2), (2e-2, 2e-2)),
             "float16": ((2e-2, 2e-2), (2e-2, 2e-2)),
             # f64 sums against the plain version's f64 chain
             "float64": ((1e-10, 1e-12), (1e-10, 1e-12))}
FLASH_SHAPES = [  # b, h, tq, tk, d, causal: every padded width 32..256
    (2, 3, 37, 37, 24, False), (2, 2, 70, 45, 32, False),
    (2, 2, 64, 64, 64, True), (2, 2, 50, 77, 128, True),
    (2, 2, 33, 33, 200, False), (4, 12, 128, 128, 64, False),
    # several tiles each way at d = 128 (the f32 dk/dv kernel's single-
    # buffered width), and widths off the 16-byte chunk (d = 60 in 16
    # bit, d = 30 in every dtype), which stage element by element
    (2, 2, 130, 200, 128, False), (2, 2, 150, 100, 60, True),
    (2, 3, 70, 70, 30, False),
    # several query and key tiles with tq > tk, and d = 96 (padded to
    # 128 inside the kernels), both causal
    (2, 2, 200, 130, 64, True), (2, 2, 190, 190, 96, True),
    # past 256, the wide bodies: an unprojected attention layer's 768
    # and a width off the 128-column output chunk, causal
    (2, 1, 40, 70, 768, False), (2, 2, 70, 45, 300, True)]


def _flash_inputs(b, h, tq, tk, d, dtype, g):
    q, k, v, do = (torch.randn(b, h, t, d, device="cuda", generator=g)
                   .to(getattr(torch, dtype)) for t in (tq, tk, tk, tq))
    mask = (torch.rand(b, tk, device="cuda", generator=g) > 0.3).float()
    mask[0] = 0.0                                 # a fully masked sequence
    mask[-1] = 1.0
    return q, k, v, do, mask


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
def test_flash_kernels_match_plain(shape, dtype):
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    _need_card()
    b, h, tq, tk, d, causal = shape
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do, mask = _flash_inputs(b, h, tq, tk, d, dtype, g)
    n = (sq.FLASH_FWD.launches, sq.FLASH_BWD_DQ.launches,
         sq.FLASH_BWD_DKV.launches)
    out, lse = sq.flash_forward(q, k, v, mask, causal)
    out2, lse2 = sq.flash_forward(q, k, v, mask, causal)
    r_out, r_lse = sq.flash_forward_plain(q, k, v, mask, causal)
    delta = sq.flash_delta(out, do)
    dq = sq.flash_bwd_dq(q, k, v, do, lse, delta, mask, causal)
    dk, dv = sq.flash_bwd_dkv(q, k, v, do, lse, delta, mask, causal)
    dq2 = sq.flash_bwd_dq(q, k, v, do, lse, delta, mask, causal)
    dk2, dv2 = sq.flash_bwd_dkv(q, k, v, do, lse, delta, mask, causal)
    r_dq = sq.flash_dq_plain(q, k, v, do, lse, delta, mask, causal)
    r_dk, r_dv = sq.flash_dkv_plain(q, k, v, do, lse, delta, mask, causal)
    torch.cuda.synchronize()
    assert (sq.FLASH_FWD.launches, sq.FLASH_BWD_DQ.launches,
            sq.FLASH_BWD_DKV.launches) == (n[0] + 2, n[1] + 2, n[2] + 2)
    for a, b2 in ((out, out2), (lse, lse2), (dq, dq2), (dk, dk2),
                  (dv, dv2)):
        assert torch.equal(a, b2)                 # repeatable bits
    (f_rtol, f_atol), (g_rtol, g_atol) = FLASH_TOL[dtype]
    acc = torch.promote_types(q.dtype, torch.float32)
    torch.testing.assert_close(out.to(acc), r_out.to(acc), rtol=f_rtol,
                               atol=f_atol)
    valid = mask.bool().any(-1)
    assert lse.dtype == acc
    torch.testing.assert_close(lse[valid], r_lse[valid].to(acc),
                               rtol=f_rtol, atol=f_atol)
    for got, want in ((dq, r_dq), (dk, r_dk), (dv, r_dv)):
        assert got.dtype == q.dtype
        torch.testing.assert_close(got.to(acc), want.to(acc), rtol=g_rtol,
                                   atol=g_atol)
    # the fully masked sequence: exact zeros, no NaN anywhere
    for t in (out, dq, dk, dv):
        assert not bool(torch.isnan(t).any())
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(dq[0], torch.zeros_like(dq[0]))


@pytest.mark.gpu
def test_flash_kernels_reject_what_they_do_not_take():
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    _need_card()
    q = torch.randn(1, 2, 8, 16, device="cuda")
    with pytest.raises(TypeError):
        sq.flash_forward(q.int(), q.int(), q.int())
    empty = torch.randn(1, 2, 0, 16, device="cuda")
    with pytest.raises(ValueError, match="empty operand"):
        sq.flash_forward(empty, q, q)
    with pytest.raises(ValueError):
        sq.flash_forward(q, q.half(), q)
    with pytest.raises(ValueError):
        sq.flash_forward(q, q, q, torch.ones(1, 8))   # mask on the CPU


@pytest.mark.gpu
def test_bert_launches_flash_kernels_once_a_layer():
    """A 2-layer BERT: 2 forward launches per forward and none of the
    backward kernels; 2 of each per training step (attention dropout
    off)."""
    import numpy as np

    from deeplearning4j_tpu_torch.models.bert import Bert, BertConfig
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    _need_card()
    conf = BertConfig.tiny(attention_probs_dropout_prob=0.0,
                           max_predictions_per_seq=4)
    bert = Bert(conf).init("cuda")
    rs = np.random.RandomState(0)
    ids = rs.randint(5, 1000, (4, 32))
    am = np.ones((4, 32), np.float32)
    am[1, 20:] = 0.0

    def counts():
        return (sq.FLASH_FWD.launches, sq.FLASH_BWD_DQ.launches,
                sq.FLASH_BWD_DKV.launches)

    n0 = counts()
    seq, pooled = bert.output(ids, attention_mask=am)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), n0)) == (2, 0, 0)
    assert bool(torch.isfinite(seq).all())
    batch = {"input_ids": ids, "attention_mask": am,
             "mlm_labels": np.where(rs.rand(4, 32) < 0.2, ids, -1),
             "nsp_labels": rs.randint(0, 2, 4)}
    n0 = counts()
    loss = bert.fit_batch(batch)
    assert tuple(a - b for a, b in zip(counts(), n0)) == (2, 2, 2)
    assert np.isfinite(loss)


#: (b, tq, tk): LearnedSelfAttentionLayer's one query and a few queries
#: against a sequence's keys, RecurrentAttentionLayer's one query a step
FEW_QUERY_SHAPES = [(32, 1, 128), (32, 4, 128), (5, 1, 77), (5, 4, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FEW_QUERY_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_kernels_at_few_queries_match_plain(shape, dtype):
    """t_q of 1 or 4 pads the query tile; ragged key masks (a prefix of
    each sequence, one sequence fully masked)."""
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    _need_card()
    b, tq, tk = shape
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do, _ = _flash_inputs(b, 12, tq, tk, 64, dtype, g)
    lengths = torch.randint(1, tk + 1, (b,), device="cuda", generator=g)
    lengths[0], lengths[1] = 0, tk
    mask = (torch.arange(tk, device="cuda")[None] < lengths[:, None]).float()
    out, lse = sq.flash_forward(q, k, v, mask)
    delta = sq.flash_delta(out, do)
    dq = sq.flash_bwd_dq(q, k, v, do, lse, delta, mask)
    dk, dv = sq.flash_bwd_dkv(q, k, v, do, lse, delta, mask)
    r_out, _ = sq.flash_forward_plain(q, k, v, mask)
    r_dq = sq.flash_dq_plain(q, k, v, do, lse, delta, mask)
    r_dk, r_dv = sq.flash_dkv_plain(q, k, v, do, lse, delta, mask)
    (f_rtol, f_atol), (g_rtol, g_atol) = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), r_out.float(), rtol=f_rtol,
                               atol=f_atol)
    for got, want in ((dq, r_dq), (dk, r_dk), (dv, r_dv)):
        torch.testing.assert_close(got.float(), want.float(), rtol=g_rtol,
                                   atol=g_atol)
    for t in (out, dq, dk, dv):
        assert not bool(torch.isnan(t).any())
        assert not bool(t[0].any())               # the fully masked one


@pytest.mark.gpu
def test_wide_heads_and_float64_sites_launch_the_kernels():
    """Head dim 768 and float64 through the attention entry point: one
    launch of kernel 7 each, equal to the dense answer; an unprojected
    SelfAttentionLayer over 768 features launches it too."""
    from deeplearning4j_tpu_torch.nn.conf.layers_attention import \
        SelfAttentionLayer
    from deeplearning4j_tpu_torch.ops import attention as att
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    wide = torch.randn(2, 1, 16, 768, device="cuda", generator=g)
    mask = torch.ones(2, 1, 1, 16, device="cuda")
    mask[1, ..., 9:] = 0.0
    for q, tol in ((wide, dict(rtol=2e-5, atol=2e-6)),
                   (wide[..., :64].double(), dict(rtol=1e-12, atol=1e-13))):
        n0 = sq.FLASH_FWD.launches
        got = att.dot_product_attention(q, q, q, mask)
        assert sq.FLASH_FWD.launches == n0 + 1 and got.dtype == q.dtype
        s = (q @ q.transpose(-1, -2)) / q.shape[-1] ** 0.5
        w = torch.softmax(s.masked_fill(mask == 0, -1e9), -1)
        torch.testing.assert_close(got, w @ q, **tol)
    n0 = sq.FLASH_FWD.launches
    layer = SelfAttentionLayer(n_in=768, n_out=768, project_input=False)
    y, _ = layer.forward({}, wide[:, 0], training=False, mask=mask[:, 0, 0])
    assert y.shape == (2, 16, 768) and bool(torch.isfinite(y).all())
    assert sq.FLASH_FWD.launches == n0 + 1


@pytest.mark.gpu
def test_attention_layers_launch_the_flash_kernels():
    """A small masked attention graph: 3 launches of each kernel a step
    (two self-attentions and the learned-query pooling); a
    RecurrentAttentionLayer one launch of kernel 7 a sequence step
    forward, and one of each a step in training."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_attention import \
        RecurrentAttentionLayer
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    import chip_smoke
    _need_card()

    def counts():
        return (sq.FLASH_FWD.launches, sq.FLASH_BWD_DQ.launches,
                sq.FLASH_BWD_DKV.launches)

    rs = np.random.RandomState(0)
    ids = rs.randint(0, 50, (4, 24))
    mask = np.ones((4, 24), np.float32)
    mask[1, 5:] = 0.0
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 4)]
    net = ComputationGraph(chip_smoke.attention_classifier_conf(
        50, 32, 4, 24, Adam(1e-3))).init("cuda")
    n0 = counts()
    net.fit(DataSet(ids, y, features_mask=mask))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), n0)) == (3, 3, 3)
    conf = (NeuralNetConfiguration.Builder().graph_builder()
            .add_inputs("x").set_input_types(InputType.recurrent(8, 24))
            .add_layer("ratt", RecurrentAttentionLayer(n_out=16, n_heads=2),
                       "x")
            .add_layer("out", RnnOutputLayer(n_out=3), "ratt")
            .set_outputs("out").build())
    rnet = ComputationGraph(conf).init("cuda")
    x = rs.randn(4, 24, 8).astype(np.float32)
    n0 = counts()
    out = rnet.output(x, mask=mask)
    assert tuple(a - b for a, b in zip(counts(), n0)) == (24, 0, 0)
    assert bool(torch.isfinite(out).all())
    n0 = counts()
    rnet.fit(DataSet(x, np.eye(3, dtype=np.float32)[rs.randint(0, 3, (4, 24))],
                     features_mask=mask, labels_mask=mask))
    assert tuple(a - b for a, b in zip(counts(), n0)) == (24, 24, 24)


# ---------------------------------------------------------------------------
# paged decode attention (kernel 10)
# ---------------------------------------------------------------------------
#: (b, h, d, block, max_blocks): every lane width 1, 2, 4, 8 and odd ones
PAGED_SHAPES = [(5, 3, 16, 8, 6), (8, 12, 64, 16, 64), (4, 5, 80, 8, 7),
                (3, 2, 128, 4, 9), (3, 2, 256, 16, 3), (2, 4, 32, 1, 20)]


def _paged_inputs(b, h, d, block, max_blocks, pool_dtype, g):
    nb = b * max_blocks + 1
    q = torch.randn(b, h, d, device="cuda", generator=g)
    k = torch.randn(nb, block, h, d, device="cuda", generator=g).to(
        pool_dtype)
    v = torch.randn(nb, block, h, d, device="cuda", generator=g).to(
        pool_dtype)
    perm = torch.randperm(nb - 1, device="cuda", generator=g) + 1
    tables = perm[:b * max_blocks].reshape(b, max_blocks).to(torch.int32)
    cap = block * max_blocks
    lengths = torch.randint(1, cap + 1, (b,), device="cuda", generator=g,
                            dtype=torch.int32)
    tables[0] = 0                        # a dead slot: scratch, length 1
    lengths[0] = 1
    if b > 2:
        lengths[1] = cap + 5             # past the table: clamped
        lengths[2] = block               # a block boundary
    return q, k, v, tables, lengths


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "float16"])
def test_paged_decode_kernel_matches_plain(shape, pool_dtype):
    """Within 2e-5 of the plain version (both compute in f32 from the
    same pool values), bitwise across two launches, finite."""
    _need_card()
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    g = torch.Generator(device="cuda").manual_seed(10)
    args = _paged_inputs(*shape, getattr(torch, pool_dtype), g)
    n0 = ak.PAGED_DECODE.launches
    out = ak.paged_decode_attention(*args)
    out2 = ak.paged_decode_attention(*args)
    ref = ak.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert ak.PAGED_DECODE.launches == n0 + 2
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    assert torch.equal(out, out2)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, rtol=0.0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float16"])
def test_paged_decode_kernel_low_precision_q(q_dtype):
    """q (and the output) in a 16-bit type: one rounding of the output
    apart from the plain version."""
    _need_card()
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, tables, lengths = _paged_inputs(8, 12, 64, 16, 8,
                                             torch.bfloat16, g)
    q = q.to(getattr(torch, q_dtype))
    out = ak.paged_decode_attention(q, k, v, tables, lengths)
    ref = ak.paged_attention_reference(q, k, v, tables, lengths)
    assert out.dtype == q.dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.gpu
def test_paged_decode_kernel_rejects_what_it_does_not_take():
    _need_card()
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, tables, lengths = _paged_inputs(3, 2, 64, 8, 4,
                                             torch.float32, g)
    with pytest.raises(TypeError):
        ak.paged_decode_attention(q.double(), k, v, tables, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        ak.paged_decode_attention(q, k.transpose(0, 1), v.transpose(0, 1),
                                  tables, lengths)
    with pytest.raises(ValueError):
        ak.paged_decode_attention(q, k, v, tables.cpu(), lengths)
    with pytest.raises(ValueError):
        ak.paged_decode_attention(q, k, v, tables[:2], lengths)
    wide = torch.zeros(3, 2, 300, device="cuda")
    with pytest.raises(ValueError):
        ak.paged_decode_attention(wide, torch.zeros(4, 8, 2, 300,
                                                    device="cuda"),
                                  torch.zeros(4, 8, 2, 300, device="cuda"),
                                  tables, lengths)


def _paged_case_inputs(b, h, d, block, max_blocks, lengths, pool_dtype,
                       q_dtype, g):
    """q, pools with every sequence's blocks at random places (block 0
    the scratch), tables padded with 0; a length of -1 is a dead slot
    (an all-zero table, length 1)."""
    nb = b * max_blocks + 1
    q = torch.randn(b, h, d, device="cuda", generator=g).to(q_dtype)
    k, v = (torch.randn(nb, block, h, d, device="cuda", generator=g
                        ).to(pool_dtype) for _ in range(2))
    perm = torch.randperm(nb - 1, device="cuda", generator=g) + 1
    tables = torch.zeros(b, max_blocks, dtype=torch.int32, device="cuda")
    lens = []
    for i, n in enumerate(lengths):
        if n < 0:
            lens.append(1)
            continue
        used = min(max_blocks, -(-n // block))
        tables[i, :used] = perm[i * max_blocks:i * max_blocks + used]
        lens.append(n)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, tables, lens


#: table blocks a rank of kernel 10's cluster split (kBlocksPerRank in
#: csrc/paged_attention.cu): P = ceil(max_blocks / 32) ranks, at most 8
PAGED_BLOCKS_PER_RANK = 32


def _ranks(max_blocks):
    return max(1, min(8, -(-max_blocks // PAGED_BLOCKS_PER_RANK)))


def _edges(block, max_blocks):
    """Lengths one either side of each partition edge of the staged
    body's cluster split at a full table, and of 1..3 valid blocks."""
    ranks = _ranks(max_blocks)
    out = []
    for r in range(1, ranks):
        tok = (r * max_blocks // ranks) * block
        out += [tok - 1, tok, tok + 1]
    return out + [1, 15, 16, 17, 2 * block + 1, 3 * block]


#: (h, d, block, max_blocks, lengths), a sequence a length: the
#: GPT-2-small site (P = 2 ranks at 64-block tables) with lengths 1, 15,
#: 16, 17, each partition edge of the full table +-1 and a sequence of
#: one block a rank +-1, a sequence of fewer valid blocks than ranks (a
#: rank with no valid token), a length past the table and dead slots;
#: P = 3 at a 70-block table (not divisible by P), P = 8 at 256 blocks;
#: d = 32, 64, 80, 128, 256
PAGED_BODY_CASES = [
    (12, 64, 16, 64, _edges(16, 64)
     + [31, 32, 33, 64 * 16, 64 * 16 + 6, 480, -1, -1]),
    (4, 64, 16, 70, _edges(16, 70) + [70 * 16, -1]),
    (2, 64, 4, 256, _edges(4, 256) + [256 * 4, 5, -1]),
    (4, 32, 16, 40, _edges(16, 40) + [-1]),
    (4, 80, 16, 40, _edges(16, 40) + [-1]),
    (4, 128, 16, 40, _edges(16, 40) + [-1]),
    (2, 256, 16, 40, _edges(16, 40) + [-1]),
]


def _paged_staged(d, esize):
    g = d * esize // 16
    return d <= 128 and d * esize % 16 == 0 and g & (g - 1) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_BODY_CASES,
                         ids=lambda c: f"h{c[0]}d{c[1]}mb{c[3]}")
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16", "float16"])
def test_paged_decode_each_body_matches_plain(case, pool_dtype, q_dtype):
    """Kernel 10's staged and general bodies against the plain version:
    within 2e-5 for an f32 q (and one rounding of the output for a 16-bit
    q), bitwise across two launches and across a CUDA-graph replay,
    finite, one launch a call."""
    _need_card()
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    h, d, block, mb, lengths = case
    b = len(lengths)
    g = torch.Generator(device="cuda").manual_seed(19)
    args = _paged_case_inputs(b, h, d, block, mb, lengths,
                              getattr(torch, pool_dtype),
                              getattr(torch, q_dtype), g)
    body = ak.paged_decode_body(*args[:4])
    esize = args[1].element_size()
    want_body = "staged" if _paged_staged(d, esize) else "general"
    assert body.startswith(want_body), body
    if want_body == "staged":
        assert f"{_ranks(mb)} ranks" in body, body
    n0 = ak.PAGED_DECODE.launches
    out = ak.paged_decode_attention(*args)
    out2 = ak.paged_decode_attention(*args)
    ref = ak.paged_attention_reference(*args)
    torch.cuda.synchronize()
    assert ak.PAGED_DECODE.launches == n0 + 2
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert torch.equal(out, out2)
    assert bool(torch.isfinite(out).all())
    rtol = {"float32": 0.0, "bfloat16": 2 ** -7, "float16": 2 ** -10}
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=rtol[q_dtype], atol=2e-5)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gout = ak.paged_decode_attention(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(gout, out)


@pytest.mark.gpu
def test_decode_engine_launches_kernel_10_once_a_layer_a_step():
    _need_card()
    import numpy as np

    from deeplearning4j_tpu_torch.models import DecoderConfig, DecoderLM
    from deeplearning4j_tpu_torch.ops import attention_kernels as ak
    from deeplearning4j_tpu_torch.serving.generative import DecodeEngine
    from deeplearning4j_tpu_torch.serving.kvcache import KVBlockPool
    conf = DecoderConfig(vocab_size=128, n_layers=12, n_heads=2,
                         d_model=64, d_ff=128, max_len=128)
    model = DecoderLM(conf)
    params = model.init("cuda")
    pool = KVBlockPool(12, 32, 16, 2, 32, name="gpu-test", device="cuda")
    eng = DecodeEngine(model, params, pool, name="gpu-test",
                       prompt_buckets=(16,), decode_buckets=(2, 4),
                       max_seq_len=128)
    n0 = ak.PAGED_DECODE.launches
    eng.warmup()
    prompts = ([5, 9, 2, 7], [8, 3, 30, 31, 32, 33])
    streams = [eng.submit(np.asarray(p), 10) for p in prompts]
    toks = [list(s) for s in streams]
    eng.shutdown()
    assert ak.PAGED_DECODE.launches - n0 == 12 * eng.decode_steps
    assert eng.decode_steps >= 2 + 9
    for p, t in zip(prompts, toks):
        assert t == model.reference_decode(params, p, 10)
    assert eng.retraces_since_warmup() == 0
    assert pool.live_blocks == 0


# ---------------------------------------------------------------------------
# kernel 4: the pointwise-conv matmul with bias and activation
# ---------------------------------------------------------------------------
#: (M, K, N): SqueezeNet's site shapes at batch 32 (squeeze, expand, the
#: 1000-class head), then a ragged M, an N off the tile and K = 16
MBA_SHAPES = [(100352, 64, 16), (100352, 16, 64), (100352, 128, 32),
              (25088, 384, 48), (25088, 48, 192), (25088, 64, 256),
              (6272, 512, 1000), (1001, 40, 37), (777, 16, 16),
              (129, 7, 3)]


def _mba_bar(x, w, b, ref32, dtype):
    """Per-element bar: ``2e-5 · (Σ_k |x_k·w_k| + |b|)`` (f32 sums in
    another order), plus one ulp of the output dtype at the plain f32
    result for bf16 and f16 (the kernel rounds its own f32 sum)."""
    bar = 2e-5 * (x.float().abs() @ w.float().abs().t() + b.abs())
    if dtype != torch.float32:
        _, e = torch.frexp(ref32.abs().nan_to_num(0.0))
        bar = bar + torch.ldexp(torch.full_like(ref32, torch.finfo(
            dtype).eps), e - 1)
    return bar


def _mba_inputs(M, K, N, dtype, g):
    x = torch.randn(M, K, device="cuda", generator=g).to(dtype)
    w = (torch.randn(N, K, device="cuda", generator=g) / K ** 0.5).to(dtype)
    b = 0.1 * torch.randn(N, device="cuda", generator=g)
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MBA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_matmul_bias_act_kernel_matches_plain(shape, dtype, act,
                                              monkeypatch):
    """Within the bar of every element, NaN in the same places (a NaN in
    x makes its row NaN), bitwise equal across two launches."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device="cuda").manual_seed(4)
    dt = getattr(torch, dtype)
    M, K, N = shape
    x, w, b = _mba_inputs(M, K, N, dt, g)
    x[::97, K // 2] = float("nan")
    n0 = ce.MATMUL.launches
    y = ce.matmul_bias_act(x, w, b, act)
    y2 = ce.matmul_bias_act(x, w, b, act)
    ref = ce.matmul_bias_act_plain(x.float(), w.float(), b, act)
    torch.cuda.synchronize()
    assert ce.MATMUL.launches == n0 + 2
    assert y.dtype == dt and y.shape == (M, N)
    assert torch.equal(y.view(torch.int16 if dt != torch.float32
                              else torch.int32),
                       y2.view(torch.int16 if dt != torch.float32
                               else torch.int32))
    assert torch.equal(torch.isnan(y), torch.isnan(ref))
    err = (y.float() - ref).abs().nan_to_num(0.0)
    assert bool((err <= _mba_bar(x, w, b, ref, dt).nan_to_num(0.0)).all())


@pytest.mark.gpu
def test_matmul_bias_act_kernel_rejects_what_it_does_not_take():
    _need_card()
    x = torch.randn(64, 32, device="cuda")
    w = torch.randn(16, 32, device="cuda")
    b = torch.zeros(16, device="cuda")
    with pytest.raises(TypeError):
        ce.matmul_bias_act(x.double(), w.double(), b, "relu")
    with pytest.raises(ValueError):
        ce.matmul_bias_act(torch.randn(32, 64, device="cuda").t(), w, b,
                           "relu")
    with pytest.raises(ValueError):
        ce.matmul_bias_act(x, torch.randn(16, 31, device="cuda"), b, "relu")
    with pytest.raises(ValueError):
        ce.matmul_bias_act(x, w.half(), b, "relu")
    with pytest.raises(ValueError):
        ce.matmul_bias_act(x, w, b.half(), "relu")
    with pytest.raises(ValueError):
        ce.matmul_bias_act(x, w, b.cpu(), "relu")
    with pytest.raises(ValueError):
        ce.matmul_bias_act(x, w, b, "tanh")


#: (M, K, N, view, the 16-bit body, the f32 body): shapes that select
#: each body of kernel 4 (the body's name as
#: ``matmul_bias_act_body`` begins). "tail" is x[1:] of a flat buffer
#: one element longer: a base 2 or 4 bytes off 16-byte alignment.
MBA_BODY_CASES = [
    (6272, 512, 1000, None, "wgmma", "f32 SIMT, cp.async"),  # classifier
    (25088, 48, 192, None, "wgmma", "f32 SIMT, cp.async"),
    (25088, 384, 48, None, "wgmma", "f32 SIMT, cp.async"),
    (6272, 512, 64, None, "wgmma", "f32 SIMT, cp.async"),  # 98 tiles
    (100352, 128, 16, None, "wgmma", "f32 SIMT, cp.async"),
    (1, 64, 64, None, "wgmma", "f32 SIMT, cp.async"),      # M = 1
    (1, 7, 3, None, "mma.sync, element", "f32 SIMT, element"),
    (300, 36, 64, None, "mma.sync, element", "f32 SIMT, cp.async"),
    (1001, 40, 37, None, "mma.sync, cp.async", "f32 SIMT, cp.async"),
    (1000, 64, 64, "tail", "mma.sync, element", "f32 SIMT, element"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MBA_BODY_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}"
                                       + (f"-{c[3]}" if c[3] else ""))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_matmul_bias_act_each_body_matches_plain(case, dtype, act,
                                                 monkeypatch):
    """Every body of kernel 4 at shapes that select it: the plan names
    the expected body, the result is within ``_mba_bar`` of every
    element, NaN rows propagate, two launches are bitwise equal."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device="cuda").manual_seed(6)
    dt = getattr(torch, dtype)
    M, K, N, view, body16, body32 = case
    x, w, b = _mba_inputs(M, K, N, dt, g)
    if view == "tail":
        buf = torch.empty(M * K + 1, device="cuda", dtype=dt)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(M, K)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    x[::97, K // 2] = float("nan")
    body = ce.matmul_bias_act_body(x, w)
    assert body.startswith(body32 if dt == torch.float32 else body16), body
    n0 = ce.MATMUL.launches
    y = ce.matmul_bias_act(x, w, b, act)
    y2 = ce.matmul_bias_act(x, w, b, act)
    ref = ce.matmul_bias_act_plain(x.float(), w.float(), b, act)
    torch.cuda.synchronize()
    assert ce.MATMUL.launches == n0 + 2
    assert y.dtype == dt and y.shape == (M, N)
    bits = torch.int16 if dt != torch.float32 else torch.int32
    assert torch.equal(y.view(bits), y2.view(bits))
    assert torch.equal(torch.isnan(y), torch.isnan(ref))
    err = (y.float() - ref).abs().nan_to_num(0.0)
    assert bool((err <= _mba_bar(x, w, b, ref, dt).nan_to_num(0.0)).all())


def _mba_plain_backward(x, w, y, dy, act):
    """The JAX package's ``_mba_bwd``: the relu mask from the output,
    f32 products cast back."""
    g = torch.where(y > 0, dy, 0.0) if act == "relu" else dy
    g = g.float()
    return ((g @ w.float()).to(x.dtype), (g.t() @ x.float()).to(w.dtype),
            g.sum(0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_matmul_bias_act_backward_matches_plain(dtype, act, monkeypatch):
    """Inputs on a grid of 1/32 so every sum is exact in f32: the
    kernel's forward then equals the plain one bitwise, and the
    Function's gradients equal the plain backward's."""
    _need_card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    M, K, N = 3000, 96, 48
    x = (torch.randint(-8, 9, (M, K), device="cuda", generator=g) / 4
         ).to(dt).requires_grad_()
    w = (torch.randint(-4, 5, (N, K), device="cuda", generator=g) / 8
         ).to(dt).requires_grad_()
    b = (torch.randint(-8, 9, (N,), device="cuda", generator=g) / 8
         ).requires_grad_()
    dy = torch.randn(M, N, device="cuda", generator=g).to(dt)
    y = ce.matmul_bias_act(x, w, b, act)
    ref = ce.matmul_bias_act_plain(x.detach(), w.detach(), b.detach(), act)
    assert torch.equal(y.detach(), ref)
    got = torch.autograd.grad(y, (x, w, b), dy)
    want = _mba_plain_backward(x.detach(), w.detach(), ref, dy, act)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16", "float16"])
def test_squeezenet_forward_launches_kernels_4_and_1(compute_dtype):
    """17 pointwise sites on kernel 4, the stem and the 8 expand-3x3 on
    kernel 1, nothing else."""
    _need_card()
    from deeplearning4j_tpu_torch.models import SqueezeNet
    from deeplearning4j_tpu_torch.ops import cuda_build
    net = SqueezeNet(height=64, width=64,
                     compute_dtype=compute_dtype).init("cuda")
    before = {k: v.launches for k, v in cuda_build.KERNELS.items()}
    out = net.output(torch.randn(2, 64, 64, 3))
    torch.cuda.synchronize()
    delta = {k: v.launches - before[k]
             for k, v in cuda_build.KERNELS.items()}
    assert delta == {k: {"matmul_bias_act": 17, "scale_shift_act": 9}
                     .get(k, 0) for k in delta}
    assert out.shape == (2, 1000) and bool(torch.isfinite(out).all())


@pytest.mark.gpu
def test_graves_lstm_char_rnn_step_and_stream_on_the_card(monkeypatch):
    """A 2 x GravesLSTM(64) char-RNN: one f32 fit step on the card
    against the same step on the CPU (matmul TF32 off; the updated
    weights within 1e-4 in norm), no ported kernel launched, and
    ``rnn_time_step`` fed one step at a time against ``output`` (1e-5)."""
    _need_card()
    from deeplearning4j_tpu_torch.activations import Activation
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.lossfunctions import LossFunction
    from deeplearning4j_tpu_torch.nn.conf.builders import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import GravesLSTM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import cuda_build
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    V, T, B = 30, 24, 8
    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(5e-3))
            .list()
            .layer(GravesLSTM(n_out=64, activation=Activation.TANH))
            .layer(GravesLSTM(n_out=64, activation=Activation.TANH))
            .layer(RnnOutputLayer(n_out=V, loss_function=LossFunction.MCXENT,
                                  activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(V, T)).build())
    cpu = MultiLayerNetwork(conf).init(
        "cpu", generator=torch.Generator().manual_seed(3))
    card = MultiLayerNetwork(conf).set_params(
        {k: {n: t.clone() for n, t in sub.items()}
         for k, sub in cpu.params.items()}, {}, "cuda")
    g = torch.Generator().manual_seed(4)
    eye = torch.eye(V)
    x = eye[torch.randint(0, V, (B, T), generator=g)]
    y = eye[torch.randint(0, V, (B, T), generator=g)]
    before = {k: v.launches for k, v in cuda_build.KERNELS.items()}
    card.fit(x.cuda(), y.cuda())
    cpu.fit(x, y)
    torch.cuda.synchronize()
    assert all(v.launches == before[k]
               for k, v in cuda_build.KERNELS.items())
    assert abs(card.score() - cpu.score()) <= 1e-5 * abs(cpu.score())
    for k, sub in cpu.params.items():
        for n, t in sub.items():
            d = float((card.params[k][n].cpu() - t).norm() / t.norm())
            assert d <= 1e-4, (k, n, d)
    xc = x.cuda()
    stream = torch.stack([card.rnn_time_step(xc[:, t]) for t in range(T)],
                         1)
    assert float((stream - card.output(xc)).abs().max()) <= 1e-5
    assert card.rnn_get_previous_state(1)["c"].device.type == "cuda"


@pytest.mark.gpu
def test_imported_bert_sdpa_sites_launch_the_flash_kernels():
    """A toy BERT GraphDef (the TF-free writer's) imported onto the card:
    each fused ``sdpa_core`` launches kernel 7 once a forward, and the
    output equals the ``optimize=False`` import's dense op-by-op chain
    (TF32 off) within rtol 1e-4 / atol 1e-5; one MLM training step
    launches kernels 8 and 9 once a site."""
    _need_card()
    import numpy as np

    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.modelimport.tensorflow import \
        TensorflowFrameworkImporter
    from deeplearning4j_tpu_torch.modelimport.tensorflow.bert_graph import (
        build_frozen_bert, import_and_attach_mlm)
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    b, t, layers = 2, 64, 2
    dims = dict(vocab=97, hidden=64, heads=2, layers=layers)
    gd = build_frozen_bert(t, b, **dims)
    shapes = {n: (b, t) for n in ("ids", "seg", "mask")}
    rs = np.random.RandomState(0)
    mask = np.ones((b, t), np.int32)
    mask[1, t // 2:] = 0
    feeds = {"ids": rs.randint(0, 97, (b, t)).astype(np.int32),
             "seg": np.zeros((b, t), np.int32), "mask": mask}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        opt = TensorflowFrameworkImporter.run_import(gd, shapes,
                                                     device="cuda")
        raw = TensorflowFrameworkImporter.run_import(gd, shapes,
                                                     optimize=False,
                                                     device="cuda")
        assert opt.graphopt_counts["attention_fuse"] == layers
        n0 = sq.FLASH_FWD.launches
        got = opt.output(feeds, ["Identity"])["Identity"]
        torch.cuda.synchronize()
        assert sq.FLASH_FWD.launches - n0 == layers
        n0 = sq.FLASH_FWD.launches
        want = raw.output(feeds, ["Identity"])["Identity"]
        torch.cuda.synchronize()
        assert sq.FLASH_FWD.launches == n0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    sd, _ = import_and_attach_mlm(gd, b, t, vocab=97, hidden=64,
                                  updater=Adam(1e-3), max_predictions=4,
                                  device="cuda")
    feeds.update(mlm_positions=np.tile(np.arange(4, dtype=np.int32),
                                       (b, 1)),
                 mlm_labels=rs.randint(0, 97, (b, 4)).astype(np.int32))
    c0 = (sq.FLASH_FWD.launches, sq.FLASH_BWD_DQ.launches,
          sq.FLASH_BWD_DKV.launches)
    loss = sd.fit_steps(feeds, 1)
    torch.cuda.synchronize()
    c1 = (sq.FLASH_FWD.launches, sq.FLASH_BWD_DQ.launches,
          sq.FLASH_BWD_DKV.launches)
    assert [x - y for x, y in zip(c1, c0)] == [layers] * 3
    assert np.isfinite(loss)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.5, 0.9])
def test_dropout_masks_on_the_card_keep_p_and_scale(p):
    """Masks drawn on the card by its generator: the kept share within
    4 sigma of p, kept entries scaled by 1/p exactly; SpatialDropout
    decides once per (example, channel) of an NHWC tensor."""
    _need_card()
    from deeplearning4j_tpu_torch.common.rng import RngKey
    from deeplearning4j_tpu_torch.nn.conf.dropout import (Dropout,
                                                          SpatialDropout)
    x = torch.rand(32, 13, 13, 512, device="cuda") + 0.5
    mask = Dropout(p).noise(x, RngKey(1))
    assert mask.is_cuda and mask.shape == x.shape
    n = mask.numel()
    keep = float(mask.float().mean())
    assert abs(keep - p) <= 4 * (p * (1 - p) / n) ** 0.5
    y = Dropout(p).apply(x, RngKey(1))
    assert torch.equal(y, torch.where(mask, x / p, 0.0))
    assert torch.equal(y, Dropout(p).apply(x, RngKey(1)))
    ys = SpatialDropout(p).apply(x, RngKey(2))
    kept = (ys != 0).reshape(32, 169, 512)
    assert torch.equal(kept.all(1), kept.any(1))        # whole channels
    share = float(kept.all(1).float().mean())
    assert abs(share - p) <= 4 * (p * (1 - p) / (32 * 512)) ** 0.5
    assert torch.equal(ys[ys != 0], (x / p)[ys != 0])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [True, "dots"])
def test_bert_tiny_remat_with_dropout_equals_no_remat_on_the_card(mode):
    """Hidden dropout 0.1 through the flash kernels: the recomputed
    layers redraw the first forward's masks from their keys, so two
    steps equal remat=False's bit for bit; kernel 7 launches once more
    a layer a step (its forward is recomputed), 8 and 9 once."""
    _need_card()
    import dataclasses

    import numpy as np

    from deeplearning4j_tpu_torch.common.rng import RngKey
    from deeplearning4j_tpu_torch.models import Bert, BertConfig
    from deeplearning4j_tpu_torch.models.bert import (_device_batch,
                                                      flatten_tree)
    from deeplearning4j_tpu_torch.parallel import sequence as sq
    conf = BertConfig.tiny(hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.0,
                           use_flash_attention=True)
    rs = np.random.RandomState(0)
    ids = rs.randint(5, 1000, (4, 64))
    batch = _device_batch({"input_ids": ids,
                           "attention_mask": np.ones((4, 64), np.float32),
                           "mlm_labels": np.where(rs.rand(4, 64) < 0.2,
                                                  ids, -1)}, "cuda")
    runs = {}
    for remat in (False, mode):
        bert = Bert(dataclasses.replace(conf, remat=remat)).init("cuda")
        bert._ensure_state()
        n0 = (sq.FLASH_FWD.launches, sq.FLASH_BWD_DQ.launches,
              sq.FLASH_BWD_DKV.launches)
        losses = [float(bert._step(batch, RngKey(3).fold_in(i)))
                  for i in range(2)]
        torch.cuda.synchronize()
        launches = (sq.FLASH_FWD.launches - n0[0],
                    sq.FLASH_BWD_DQ.launches - n0[1],
                    sq.FLASH_BWD_DKV.launches - n0[2])
        runs[remat] = (losses, launches, flatten_tree(bert.params))
    L = conf.num_hidden_layers
    assert runs[False][1] == (2 * L, 2 * L, 2 * L)
    assert runs[mode][1] == (4 * L, 2 * L, 2 * L)
    assert runs[mode][0] == runs[False][0]
    for k, t in runs[False][2].items():
        assert torch.equal(runs[mode][2][k], t), k


@pytest.mark.gpu
def test_two_accumulated_halves_equal_one_full_batch_on_the_card():
    """SqueezeNet at 64x64 with its dropout at retain 1.0 (no
    BatchNormalization, so the mean of the halves' gradients is the
    whole batch's) under Sgd (an update linear in the gradient): one
    accumulated update of two batch-8 halves equals one batch-16 step,
    norm-wise over all parameters within 1e-5 (TF32 off)."""
    _need_card()
    import numpy as np

    from deeplearning4j_tpu_torch.learning.updaters import Sgd
    from deeplearning4j_tpu_torch.models import SqueezeNet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def make():
        conf = SqueezeNet(num_classes=10, height=64, width=64).conf()
        conf.vertices["drop"].content.dropout = 1.0
        for v in conf.vertices.values():
            if v.is_layer:
                v.content.updater = Sgd(0.01)
        return ComputationGraph(conf).init(
            "cuda", generator=torch.Generator().manual_seed(4))
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(16, 64, 64, 3).astype(np.float32)).cuda()
    y = torch.eye(10)[torch.from_numpy(rs.randint(0, 10, 16))].cuda()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        full, acc = make(), make()
        p0 = {k: {n: t.clone() for n, t in sub.items()}
              for k, sub in full.params.items()}
        full.fit(x, y)
        acc.set_accumulation_steps(2)
        acc.fit(x[:8], y[:8])
        acc.fit(x[8:], y[8:])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    d_full = torch.cat([(full.params[k][n] - t).flatten()
                        for k, sub in p0.items() for n, t in sub.items()])
    d_acc = torch.cat([(acc.params[k][n] - t).flatten()
                       for k, sub in p0.items() for n, t in sub.items()])
    assert float(d_full.norm()) > 0
    assert float((d_acc - d_full).norm() / d_full.norm()) <= 1e-5


@pytest.mark.gpu
def test_staged_and_data_parallel_fits_equal_plain_fit_on_the_card(
        monkeypatch):
    """A small ResNet-50 (two stages, 32x32): ``fit(iterator)`` with the
    device prefetcher on and off, and ``ParallelWrapper`` with one
    worker, give the same bits on the card, each running kernels 3, 1, 5
    and 6 at every BatchNormalization a step."""
    _need_card()
    import numpy as np

    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    from deeplearning4j_tpu_torch.ops import bn_train
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    kw = dict(STAGES=((1, 8), (1, 16)), height=32, width=32,
              num_classes=10)
    # cuDNN's own algorithm choice must not add run-to-run noise
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    r = np.random.RandomState(0)
    data = [DataSet(r.randn(8, 32, 32, 3).astype(np.float32),
                    np.eye(10, dtype=np.float32)[r.randint(0, 10, 8)])
            for _ in range(3)]
    nets = []
    for how in ("staged", "unstaged", "wrapper"):
        monkeypatch.setenv("DL4J_TORCH_DEVICE_PREFETCH",
                           "0" if how == "unstaged" else "1")
        Environment.reset()
        net = ResNet50(**kw).init("cuda")
        n0 = bn_train.BN_BWD_DX.launches
        if how == "wrapper":
            ParallelWrapper.Builder(net).workers(1).build().fit(
                ListDataSetIterator(data))
        else:
            net.fit(ListDataSetIterator(data))
        torch.cuda.synchronize()
        sites = sum(isinstance(v.content, BatchNormalization)
                    for v in net.conf.vertices.values())
        assert bn_train.BN_BWD_DX.launches - n0 == 3 * sites
        nets.append(net)
    Environment.reset()
    for other in nets[1:]:
        for k, sub in nets[0].params.items():
            for n, t in sub.items():
                assert torch.equal(t, other.params[k][n]), f"{k}/{n}"
        for k, sub in nets[0].states.items():
            for n, t in sub.items():
                assert torch.equal(t, other.states[k][n]), f"{k}/{n}"


@pytest.mark.gpu
def test_ticket_pool_gets_captured_ranges_back():
    """Kernels 3 and 5 captured into more CUDA graphs than their ticket
    pool holds (1.5 x its 2^20 tickets, reckoned at the site with the
    most tickets a launch), each graph destroyed after it: every capture
    takes its range, and afterwards the kernels still launch eagerly and
    under a new graph to the first launch's bits, within SUM_RTOL of
    their plain versions (``chip_smoke.ticket_pool_check``)."""
    _need_card()
    import chip_smoke
    out = chip_smoke.ticket_pool_check(torch)
    for name in SUMS_KERNELS:
        assert out[name]["tickets_captured"] > chip_smoke.TICKET_POOL
