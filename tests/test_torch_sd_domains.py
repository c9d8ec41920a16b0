"""The seven op domains of slice 18 beyond the op-by-op cases of
``tests/test_torch_sd_registry.py``, on the CPU.

- Namespaces: ``chip_smoke.namespace_graph`` calls every method of
  ``sd.cnn``, ``sd.image``, ``sd.bitwise``, ``sd.linalg`` and
  ``sd.random`` in both packages: the same op lists and attrs, and the
  same outputs (rtol 2e-5 / atol 1e-5) but for the random draws, which
  are held to their shapes and dtypes, and ``qr`` / ``svd``, whose factor
  signs XLA's jitted program and LAPACK choose apart: by their absolute
  values and by the product of the factors.
- Random keys: an op's key is ``fold_in(call key, op index)``; the
  graph's key (``RngKey(0)``) splits once for each ``output`` call and
  each ``fit`` batch, ``fit_steps`` folds the step into its call's key,
  ``calculate_gradients`` uses ``RngKey(0)``; dropout is the identity
  unless training; a checkpointed segment redraws what its forward drew
  (``remat_segments``); the draws' moments over 10^6 values within 5
  sigma.
- 64-bit cyclic shifts, which the JAX package (32-bit by default)
  cannot hold, against Python's integers.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.autodiff.registry import get_op
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.learning.updaters import Sgd
from torch_parity import one_intraop_thread  # noqa: F401,E402


def test_namespaces_build_the_jax_graph():
    j, p = JSameDiff(), SameDiff("cpu")
    jn, pn = chip_smoke.namespace_graph(j), chip_smoke.namespace_graph(p)
    assert jn == pn and len(pn) == 31
    assert [(o.op_name, o.attrs) for o in p.ops] == \
        [(o.op_name, o.attrs) for o in j.ops]
    flat = [n for v in pn.values() for n in v]
    jo, po = j.output({}, flat), p.output({}, flat)
    for method, names in pn.items():
        for n in names:
            got, want = po[n].numpy(), np.asarray(jo[n])
            assert got.shape == want.shape and got.dtype == want.dtype, \
                method
            if method in ("linalg.qr", "linalg.svd"):
                # factor signs are each LAPACK path's own choice
                got, want = np.abs(got), np.abs(want)
            if not method.startswith("random."):
                np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5,
                                           err_msg=method)
    def factored(method):
        return p._arrays[p.ops[p._producer[pn[method][0]]].inputs[0]]

    q, r = (po[n] for n in pn["linalg.qr"])
    u, s, vh = (po[n] for n in pn["linalg.svd"])
    for got, method in ((q @ r, "linalg.qr"), ((u * s) @ vh, "linalg.svd")):
        np.testing.assert_allclose(got.numpy(), factored(method).numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=method)


# -- random keys ------------------------------------------------------------
P_DROP = 0.4


def _dropout_graph(remat=0):
    """loss = sum(dropout(x * w1) * w2) + sum(random_normal): each
    weight's gradient shows the mask its step drew."""
    sd = SameDiff("cpu")
    x = sd.placeholder("x", shape=(4, 6))
    w1 = sd.var("w1", array=np.ones((4, 6), np.float32))
    w2 = sd.var("w2", array=np.full((4, 6), 2.0, np.float32))
    h = sd.nn.dropout(x * w1, P_DROP, name="drop")
    noise = sd.random.normal(0.0, 1.0, (3,), name="noise")
    loss = sd.math.reduce_sum(h * w2) + sd.math.reduce_sum(noise)
    loss.rename("loss")
    sd.set_loss_variables(["loss"])
    sd.set_training_config(TrainingConfig.Builder().updater(Sgd(1.0))
                           .build())
    if remat:
        sd.set_remat_segments(remat)
    return sd


def _x():
    return np.random.RandomState(0).rand(4, 6).astype(np.float32) + 0.5


def _mask(key: RngKey, idx: int, shape=(4, 6)) -> torch.Tensor:
    """The keep mask dropout at op ``idx`` draws under ``key``."""
    u = torch.rand(shape, generator=key.fold_in(idx).generator("cpu"))
    return u < 1.0 - P_DROP


def test_output_draws_from_a_new_key_each_call():
    sd = _dropout_graph()
    drop = sd._producer["drop"]
    a = sd.output({"x": _x()}, ["drop"], training=True)["drop"]
    b = sd.output({"x": _x()}, ["drop"], training=True)["drop"]
    k = RngKey(0)
    for got in (a, b):
        k, call = k.split(2)
        want = torch.where(_mask(call, drop), torch.from_numpy(_x())
                           / (1.0 - P_DROP), torch.zeros(4, 6))
        assert torch.equal(got, want)
    assert not torch.equal(a, b)
    # the same construction draws the same values
    c = _dropout_graph().output({"x": _x()}, ["drop"], training=True)
    assert torch.equal(c["drop"], a)
    # not training (output's default): the identity
    d = sd.output({"x": _x()}, ["drop"])["drop"]
    assert torch.equal(d, torch.from_numpy(_x()))


def test_ops_at_two_positions_draw_apart():
    sd = SameDiff("cpu")
    a = sd.random.uniform(0.0, 1.0, (64,), name="a")
    b = sd.random.uniform(0.0, 1.0, (64,), name="b")
    out = sd.output({}, [a.name, b.name])
    assert not torch.equal(out["a"], out["b"])
    k = RngKey(0).split(2)[1]
    for name in ("a", "b"):
        want = torch.rand((64,), generator=k.fold_in(
            sd._producer[name]).generator("cpu"))
        assert torch.equal(out[name], want)


def _steps(keys, drop):
    """w1 and w2 after one Sgd(1) step under each key: w2's gradient is
    the kept ``x * w1 / (1 - p)``, w1's the kept ``x * w2 / (1 - p)``,
    so the weights show every step's mask."""
    x = torch.from_numpy(_x())
    w1, w2 = torch.ones(4, 6), torch.full((4, 6), 2.0)
    zero = torch.zeros(4, 6)
    for key in keys:
        keep = _mask(key, drop)
        w1, w2 = (w1 - torch.where(keep, x * w2 / (1.0 - P_DROP), zero),
                  w2 - torch.where(keep, x * w1 / (1.0 - P_DROP), zero))
    return w1, w2


def _weights_are(sd, want):
    for n, w in zip(("w1", "w2"), want):
        assert torch.allclose(sd._arrays[n], w, rtol=1e-6, atol=1e-6), n


def test_fit_steps_folds_the_step_into_one_call_key():
    """Step i of a ``fit_steps`` call draws under ``fold_in(call key,
    i)``; a second call takes a new call key."""
    sd = _dropout_graph()
    k, keys = RngKey(0), []
    for n_steps in (3, 2):
        k, call = k.split(2)
        keys += [call.fold_in(i) for i in range(n_steps)]
        sd.fit_steps({"x": _x()}, n_steps)
    _weights_are(sd, _steps(keys, sd._producer["drop"]))


def test_fit_takes_a_key_a_batch_and_gradients_key_zero():
    sd = _dropout_graph()
    drop = sd._producer["drop"]
    g = sd.calculate_gradients({"x": _x()}, ["w2"])["w2"]
    want = torch.where(_mask(RngKey(0), drop),
                       torch.from_numpy(_x()) / (1.0 - P_DROP),
                       torch.zeros(4, 6))
    assert torch.allclose(g, want)
    assert torch.equal(sd.calculate_gradients({"x": _x()}, ["w2"])["w2"], g)
    sd.fit([{"x": _x()}] * 3, placeholders_fn=lambda b: b)
    k, keys = RngKey(0), []
    for _ in range(3):
        k, batch = k.split(2)
        keys.append(batch)
    _weights_are(sd, _steps(keys, drop))


def test_remat_segments_redraw_the_same_masks():
    """A step with the walk cut into checkpointed segments (dropout and
    the noise inside them) gives the bits of the step without."""
    plain, remat = _dropout_graph(), _dropout_graph(remat=3)
    for sd in (plain, remat):
        sd.fit_steps({"x": _x()}, 2)
    for n in ("w1", "w2"):
        assert torch.equal(plain._arrays[n], remat._arrays[n]), n


@pytest.mark.parametrize("name,attrs", [
    ("random_normal", {"mean": 1.0, "stddev": 2.0, "shape": (3, 4)}),
    ("random_uniform", {"min": -2.0, "max": 3.0, "shape": (5,)}),
    ("random_bernoulli", {"prob": 0.3, "shape": (2, 3)}),
    ("dropout", {"rate": 0.3}),
])
def test_draws_have_their_moments(name, attrs):
    """One key draws the same bits twice and the next key others; the
    mean and standard deviation of 10^6 draws (dropout: the keep share
    and the kept values) within 5 sigma (``chip_smoke._random_on_card``,
    which phase 22 runs on the card)."""
    ins = [np.ones((4, 5), np.float32)] if name == "dropout" else []
    out = chip_smoke._random_on_card(torch, name, attrs, ins, "cpu", name)
    assert set(out) == {"mean", "std"}


# -- 64-bit cyclic shifts ---------------------------------------------------
def _rot64(v: int, s: int, left: bool) -> int:
    u, s = v & (2 ** 64 - 1), s % 64
    r = ((u << s) | (u >> (64 - s))) if left else \
        ((u >> s) | (u << (64 - s)))
    r &= 2 ** 64 - 1
    return r - 2 ** 64 if r >= 2 ** 63 else r


@pytest.mark.parametrize("left", [True, False])
def test_int64_cyclic_shifts(left):
    vals = [-(2 ** 63), -1, 1, 2 ** 63 - 1, 0x0123456789ABCDEF, -12345]
    shifts = [0, 63, 64, 67, 1, -1]
    x = torch.tensor(vals, dtype=torch.int64)
    s = torch.tensor(shifts, dtype=torch.int64)
    name = "cyclic_shift_left" if left else "cyclic_shift_right"
    got = get_op(name)([x, s], {})
    assert got.dtype == torch.int64
    assert got.tolist() == [_rot64(v, k, left) for v, k in zip(vals,
                                                                shifts)]
