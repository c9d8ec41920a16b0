"""The registry's recurrent domain in the port (``lstm_cell``,
``gru_cell``, ``sru_cell``, ``lstm_layer``, ``rnn_layer``, ``gru_layer``,
``sru``) and ``sd.rnn`` against the JAX package's, on the CPU.

Each op at two sizes (the registry test's toy one and the LSTM graph's
test widths, b=2, t=5, f=11, H=16), from seeded numpy inputs: forward
within rtol 2e-5 / atol 1e-6, and the gradient of ``sum(out *
cotangent)`` for every floating input within rtol 2e-4 / atol 2e-5.
``sd.rnn``'s cell builders give the JAX package's outputs and gradients
through a graph; ``lstm_layer`` equals a chain of ``lstm_cell`` ops (its
input product is hoisted out of the loop, so within 2e-6, not bitwise);
and the control-flow ops report their output shapes on ``meta`` tensors,
which the importer's shape propagation reads.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.registry import get_op as jax_get_op
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.autodiff.registry import get_op
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _inputs(name, b, t, f, h):
    """Seeded inputs of each recurrent op (SRU needs f == H)."""
    rs = np.random.RandomState(zlib.crc32(f"{name}{h}".encode()))

    def n(*shape, s=1.0):
        return (rs.randn(*shape) * s).astype(np.float32)

    w = 1.0 / np.sqrt(f)
    return {
        "lstm_cell": [n(b, f), n(b, h), n(b, h), n(f, 4 * h, s=w),
                      n(h, 4 * h, s=0.5), n(4 * h, s=0.1)],
        "gru_cell": [n(b, f), n(b, h), n(f, 3 * h, s=w), n(h, 3 * h, s=0.5),
                     n(3 * h, s=0.1)],
        "sru_cell": [n(b, h), n(b, h), n(h, 3 * h, s=0.5), n(3 * h, s=0.1)],
        "lstm_layer": [n(b, t, f), n(b, h), n(b, h), n(f, 4 * h, s=w),
                       n(h, 4 * h, s=0.5), n(4 * h, s=0.1)],
        "rnn_layer": [n(b, t, f), n(b, h), n(f, h, s=w), n(h, h, s=0.5),
                      n(h, s=0.1)],
        "gru_layer": [n(b, t, f), n(b, h), n(f, 3 * h, s=w),
                      n(h, 3 * h, s=0.5), n(3 * h, s=0.1), n(3 * h, s=0.1)],
        "sru": [n(b, t, h), n(b, h), n(h, 3 * h, s=0.5), n(3 * h, s=0.1)],
    }[name]


_OPS = ["lstm_cell", "gru_cell", "sru_cell", "lstm_layer", "rnn_layer",
        "gru_layer", "sru"]
_SIZES = {"toy": (2, 4, 3, 4), "lstm_graph": (2, 5, 11, 16)}


def _outs(o):
    return list(o) if isinstance(o, (list, tuple)) else [o]


@pytest.mark.parametrize("size", sorted(_SIZES))
@pytest.mark.parametrize("name", _OPS)
def test_recurrent_op_matches_jax(name, size):
    ins = _inputs(name, *_SIZES[size])
    variants = ([{"linear_before_reset": False},
                 {"linear_before_reset": True}]
                if name == "gru_layer" else [{}])
    for attrs in variants:
        jo = [np.asarray(o) for o in _outs(jax_get_op(name)(
            [jnp.asarray(a) for a in ins], dict(attrs)))]
        rs = np.random.RandomState(7)
        cts = [rs.randn(*o.shape).astype(np.float32) for o in jo]

        def jloss(*xs):
            return sum(jnp.sum(o * c) for o, c in zip(
                _outs(jax_get_op(name)(list(xs), dict(attrs))), cts))

        jg = jax.grad(jloss, argnums=tuple(range(len(ins))))(
            *[jnp.asarray(a) for a in ins])
        ts = [torch.tensor(a, requires_grad=True) for a in ins]
        po = _outs(get_op(name)(ts, dict(attrs)))
        assert len(po) == len(jo)
        for p, j in zip(po, jo):
            assert tuple(p.shape) == j.shape
            np.testing.assert_allclose(p.detach().numpy(), j, **FWD)
        total = sum((p * torch.from_numpy(c)).sum() for p, c in zip(po, cts))
        pg = torch.autograd.grad(total, ts)
        for k, (p, j) in enumerate(zip(pg, jg)):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), **GRAD,
                                       err_msg=f"{name} input {k}")


@pytest.mark.parametrize("cell", ["lstm_cell", "gru_cell", "sru_cell"])
def test_sd_rnn_cells_match_jax(cell):
    ins = _inputs(cell, 2, 1, 3, 4)
    n_out = 1 if cell == "gru_cell" else 2
    res = []
    for sd in (JSameDiff(), SameDiff(device="cpu")):
        vs = [sd.var(f"in{k}", array=a) for k, a in enumerate(ins)]
        outs = _outs(getattr(sd.rnn, cell)(*vs))
        assert len(outs) == n_out
        sd.math.reduce_sum(sd.math.tanh(outs[0]), name="loss")
        sd.set_loss_variables(["loss"])
        names = [f"in{k}" for k in range(len(ins))]
        got = sd.output({}, [o.name for o in outs])
        grads = sd.calculate_gradients({}, names)
        res.append(([np.asarray(got[o.name].detach() if isinstance(
            got[o.name], torch.Tensor) else got[o.name]) for o in outs],
            [np.asarray(grads[n].detach() if isinstance(
                grads[n], torch.Tensor) else grads[n]) for n in names]))
    (jo, jg), (po, pg) = res
    for p, j in zip(po, jo):
        np.testing.assert_allclose(p, j, **FWD)
    for p, j in zip(pg, jg):
        np.testing.assert_allclose(p, j, **GRAD)


def test_lstm_layer_is_a_chain_of_cells():
    x, h, c, w, rw, b = [torch.from_numpy(a) for a in
                         _inputs("lstm_layer", 2, 5, 11, 16)]
    seq, h_last, c_last = get_op("lstm_layer")([x, h, c, w, rw, b], {})
    hs = []
    for t in range(x.shape[1]):
        h, c = get_op("lstm_cell")([x[:, t], h, c, w, rw, b], {})
        hs.append(h)
    torch.testing.assert_close(seq, torch.stack(hs, 1), rtol=2e-6,
                               atol=2e-6)
    torch.testing.assert_close(h_last, h, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(c_last, c, rtol=2e-6, atol=2e-6)


def test_control_flow_ops_report_shapes_on_meta():
    """A bounded and an unbounded loop, a cond and a scan, run on meta
    tensors (one trip: shapes only, no host read)."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    body = {"_cond_call": lambda v, w: [v.sum() < 3.0],
            "_body_call": lambda v, w: [v * w, w], "n_loop": 2}
    for mi in (None, 8):
        out = get_op("while_loop")([meta(4, 3), meta(3)],
                                   {**body, "max_iterations": mi})
        assert [tuple(o.shape) for o in out] == [(4, 3), (3,)]
        assert all(o.device.type == "meta" for o in out)
    out = get_op("cond")([meta(dtype=torch.bool), meta(2, 5)],
                         {"_true_call": lambda v: [v * 2.0, v.sum(0)],
                          "_false_call": lambda v: [v, v.sum(0)],
                          "n_operands": 1})
    assert [tuple(o.shape) for o in out] == [(2, 5), (5,)]
    out = get_op("scan")([meta(3), meta(7, 3)],
                         {"_body_call": lambda c, x: [c + x, c * x,
                                                      x.sum()],
                          "n_carry": 1})
    assert [tuple(o.shape) for o in out] == [(3,), (7, 3), (7,)]
