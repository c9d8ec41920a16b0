"""The port's BERT (``models/bert.py``) against the JAX package's, on the
CPU, at ``BertConfig.tiny`` (2 layers, hidden 128, 4 heads).

The port starts from the JAX package's initial weights, carried across
by ``utils.serializer.params_from_jax``, and both take the same numpy
batches. Bars: forward rtol 1e-4 / atol 1e-5 (f32 on both sides, summed
in other orders through 2 layers and a LayerNorm each); 3-step
trajectories rtol 2e-4 / atol 1e-5 on the loss, with the parameters at
atol 1e-4 (a tenth of one Adam step at lr 1e-3: Adam divides by the root
of the second moment, so a gradient entry at the level of summation
noise still moves by ~lr) and Adam's moments at rtol 1e-3, as the port's
other Adam trajectories are held. The JAX package's flash route runs
its Pallas kernels in interpret mode (seconds a call), so it is driven
once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning.updaters import Adam as JAdam
from deeplearning4j_tpu.learning.updaters import Sgd as JSgd
from deeplearning4j_tpu.models.bert import Bert as JBert
from deeplearning4j_tpu.models.bert import BertConfig as JConfig
from deeplearning4j_tpu.models.bert import \
    BertForSequenceClassification as JClassifier
from deeplearning4j_tpu.nlp.bert_iterator import BertIterator as JIterator
from deeplearning4j_tpu.nlp.tokenization import \
    BertWordPieceTokenizer as JTokenizer
from deeplearning4j_tpu_torch.learning.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.models import (Bert, BertConfig,
                                             BertForSequenceClassification)
from deeplearning4j_tpu_torch.models.bert import flatten_tree
from deeplearning4j_tpu_torch.nlp import BertIterator, BertWordPieceTokenizer
from deeplearning4j_tpu_torch.parallel import sequence as sq
from deeplearning4j_tpu_torch.utils.serializer import (
    params_from_jax, params_to_jax, updater_state_from_jax,
    updater_state_to_jax)
from torch_parity import one_intraop_thread  # noqa: F401,E402

FWD = dict(rtol=1e-4, atol=1e-5)
RTOL, ATOL, ADAM_ATOL = 2e-4, 1e-5, 1e-4
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_jax(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_jax(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_of(jmodel, conf, updater=None):
    params, states = params_from_jax(_np(jmodel.params), {}, conf)
    assert states == {}
    return Bert(conf, updater).set_params(params, "cpu")


def _batch(n=4, t=24, vocab=1000, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, vocab, (n, t)).astype(np.int32)
    am = np.ones((n, t), np.float32)
    am[0, 17:] = 0.0
    am[2, 9:] = 0.0
    return {"input_ids": ids,
            "token_type_ids": (np.arange(t)[None] >= t // 2).astype(
                np.int32).repeat(n, 0),
            "attention_mask": am,
            "mlm_labels": np.where(rs.rand(n, t) < 0.25, ids, -1
                                   ).astype(np.int32),
            "nsp_labels": rs.randint(0, 2, n).astype(np.int32)}


@pytest.fixture(scope="module")
def models():
    jconf = JConfig.tiny(**NO_DROP)
    jb = JBert(jconf, JAdam(1e-3)).init()
    conf = BertConfig.tiny(**NO_DROP)
    return jb, conf


@pytest.fixture(scope="module")
def jax_encodings(models):
    """JAX sequence and pooled outputs on both of its routes."""
    jb, _ = models
    b = _batch()
    args = (b["input_ids"], b["token_type_ids"], b["attention_mask"])
    dense = jb.output(*args)
    jf = JBert(dataclasses.replace(jb.conf, use_flash_attention=True))
    jf.params = jb.params
    flash = jf.output(*args)
    return {"dense": [np.asarray(a) for a in dense],
            "flash": [np.asarray(a) for a in flash]}


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_encode_matches_jax_on_both_routes(route, models, jax_encodings):
    jb, conf = models
    if route == "flash":
        conf = dataclasses.replace(conf, use_flash_attention=True)
    b = _batch()
    seq, pooled = _port_of(jb, conf).output(
        b["input_ids"], b["token_type_ids"], b["attention_mask"])
    want_seq, want_pooled = jax_encodings[route]
    assert seq.dtype == torch.float32 and seq.shape == want_seq.shape
    np.testing.assert_allclose(seq.numpy(), want_seq, **FWD)
    np.testing.assert_allclose(pooled.numpy(), want_pooled, **FWD)


def test_forced_flash_route_matches_the_jax_dense_route(models,
                                                        jax_encodings):
    """The ladder's route: ``DL4J_TORCH_FLASH_ATTENTION=1`` sends every
    site of the default config through ``flash_sdpa``."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    jb, conf = models
    b = _batch()
    extra = Environment.get().extra
    extra["flash_attention"] = "1"
    try:
        seq, _ = _port_of(jb, conf).output(
            b["input_ids"], b["token_type_ids"], b["attention_mask"])
    finally:
        extra.pop("flash_attention")
    np.testing.assert_allclose(seq.numpy(), jax_encodings["dense"][0],
                               **FWD)


@pytest.mark.parametrize("kw", [{}, {"max_predictions_per_seq": 5},
                                {"fused_qkv": True},
                                {"max_predictions_per_seq": 40}],
                         ids=["full", "gathered", "fused_qkv", "k_over_t"])
@pytest.mark.parametrize("nsp", [True, False])
def test_pretrain_loss_matches_jax(kw, nsp, models):
    jb, conf = models
    jm = JBert(dataclasses.replace(jb.conf, **kw))
    jm.params = jb.params
    b = _batch()
    if not nsp:
        del b["nsp_labels"]
    want = float(jm.pretrain_loss(jm.params, {k: jnp.asarray(v) for k, v
                                              in b.items()},
                                  training=False))
    port = _port_of(jb, dataclasses.replace(conf, **kw))
    from deeplearning4j_tpu_torch.models.bert import _device_batch
    got = float(port.pretrain_loss(port.params, _device_batch(b, "cpu"),
                                   training=False))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_gathered_head_keeps_the_first_k_masked_positions_in_order():
    """The stable sort: rows with more than k masked positions train on
    the first k of them, so a label past them changes nothing."""
    conf = BertConfig.tiny(max_predictions_per_seq=3, **NO_DROP)
    port = Bert(conf).init("cpu")
    b = _batch()
    b["mlm_labels"][:] = -1
    b["mlm_labels"][:, [2, 5, 7]] = 11
    from deeplearning4j_tpu_torch.models.bert import _device_batch
    base = float(port.pretrain_loss(port.params, _device_batch(b, "cpu"),
                                    training=False))
    b["mlm_labels"][:, 20] = 12                  # a fourth position
    assert float(port.pretrain_loss(port.params, _device_batch(b, "cpu"),
                                    training=False)) == base


def _assert_params(jmodel, port, conf, atol=ADAM_ATOL):
    want = _flat_jax(jmodel.params)
    got = params_to_jax(port.params, conf)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("port_flash", [False, True],
                         ids=["dense", "port_flash_route"])
def test_three_step_adam_trajectory_matches_jax(port_flash, models):
    """JAX's dense route against the port's dense route and its flash
    route (the kernels' plain versions on the CPU, with their autograd
    Function's backward)."""
    jb, conf = models
    jm = JBert(dataclasses.replace(jb.conf, max_predictions_per_seq=6),
               JAdam(1e-3))
    jm.params = jax.tree_util.tree_map(jnp.array, jb.params)
    conf = dataclasses.replace(conf, max_predictions_per_seq=6,
                        use_flash_attention=port_flash)
    port = _port_of(jm, conf, Adam(1e-3))
    b = _batch(seed=1)
    for step in range(3):
        want, got = jm.fit_batch(b), port.fit_batch(b)
        assert abs(got - want) <= RTOL * abs(want) + ATOL, (step, got, want)
    _assert_params(jm, port, conf)
    want_state = _flat_jax(jm._opt_state)
    got_state = updater_state_to_jax(port._opt_state, conf)
    assert got_state.keys() == want_state.keys()
    for k in want_state:
        np.testing.assert_allclose(got_state[k], want_state[k], rtol=1e-3,
                                   atol=1e-6, err_msg=k)


def test_fit_steps_equals_fit_batch_steps(models):
    jb, conf = models
    a = _port_of(jb, conf, Adam(1e-3))
    b = _port_of(jb, conf, Adam(1e-3))
    batch = _batch(seed=2)
    losses = [a.fit_batch(batch) for _ in range(3)]
    assert b.fit_steps(batch, 3) == losses[-1]
    for k, t in flatten_tree(a.params).items():
        assert torch.equal(t, flatten_tree(b.params)[k]), k


def test_updater_reassignment_evicts_the_state(models):
    jb, conf = models
    port = _port_of(jb, conf, Adam(1e-3))
    batch = _batch()
    port.fit_batch(batch)
    assert port._iteration == 1
    port.updater = Sgd(0.0)
    before = {k: t.clone() for k, t in flatten_tree(port.params).items()}
    port.fit_batch(batch)
    assert port._iteration == 1 and set(port._opt_state) == set()
    for k, t in flatten_tree(port.params).items():
        assert torch.equal(t, before[k]), k
    # the JAX package does the same
    jm = JBert(jb.conf, JAdam(1e-3))
    jm.params = jax.tree_util.tree_map(jnp.array, jb.params)
    jm.fit_batch(batch)
    jm.updater = JSgd(0.0)
    jm.fit_batch(batch)
    assert jm._iteration == 1


def test_bf16_compute_dtype_near_jax(models):
    """bf16 activations round at other places in the two frameworks
    (XLA's fused bf16 ops against PyTorch's f32 opmath in each op), so
    the bar is bf16's: max |d| <= 0.1 on O(1) LayerNorm outputs, and
    pooled outputs within 0.05."""
    jb, conf = models
    jm = JBert(dataclasses.replace(jb.conf, compute_dtype="bfloat16"))
    jm.params = jb.params
    b = _batch()
    args = (b["input_ids"], b["token_type_ids"], b["attention_mask"])
    want_seq, want_pooled = (np.asarray(a) for a in jm.output(*args))
    seq, pooled = _port_of(jb, dataclasses.replace(conf, compute_dtype="bfloat16")
                           ).output(*args)
    assert seq.dtype == torch.float32
    assert float(np.abs(seq.numpy() - want_seq).max()) <= 0.1
    assert float(np.abs(pooled.numpy() - want_pooled).max()) <= 0.05


#: bf16 losses: one bf16 rounding of the loss (2^-9). The two frameworks
#: round bf16 activations at other places (see
#: test_bf16_compute_dtype_near_jax), but the loss averages over every
#: prediction; the largest gap measured over these 3 steps is 1.2e-4
BF16_LOSS_RTOL = 2.0 ** -9


@pytest.mark.parametrize("port_flash", [False, True],
                         ids=["dense", "port_flash_route"])
def test_bf16_pretraining_trajectory_near_jax(port_flash, models):
    """Three Adam steps at ``compute_dtype="bfloat16"``: JAX's dense route
    against the port's dense route and its flash route (on the CPU the
    kernels' plain versions, whose dq rounds dS to k's bf16)."""
    jb, conf = models
    jm = JBert(dataclasses.replace(jb.conf, max_predictions_per_seq=6,
                                   compute_dtype="bfloat16"), JAdam(1e-3))
    jm.params = jax.tree_util.tree_map(jnp.array, jb.params)
    conf = dataclasses.replace(conf, max_predictions_per_seq=6,
                               use_flash_attention=port_flash,
                               compute_dtype="bfloat16")
    port = _port_of(jm, conf, Adam(1e-3))
    b = _batch(seed=1)
    losses = []
    for step in range(3):
        want, got = jm.fit_batch(b), port.fit_batch(b)
        assert np.isfinite(got)
        assert abs(got - want) <= BF16_LOSS_RTOL * abs(want), (step, got,
                                                               want)
        losses.append(got)
    assert losses[-1] < losses[0]


def test_classifier_predict_and_fine_tune_match_jax(models):
    jb, conf = models
    jbert = JBert(jb.conf)
    jbert.params = jax.tree_util.tree_map(jnp.array, jb.params)
    jc = JClassifier(jbert, 2, JAdam(1e-3))
    bert = _port_of(jbert, conf)
    cls = BertForSequenceClassification(bert, 2, Adam(1e-3))
    params, _ = params_from_jax(_np(jc.params), {}, conf)
    cls.params = params
    b = _batch(seed=3)
    args = (b["input_ids"], b["token_type_ids"], b["attention_mask"])
    np.testing.assert_array_equal(cls.predict(*args), jc.predict(*args))
    batch = {"input_ids": b["input_ids"], "attention_mask":
             b["attention_mask"], "labels": np.array([0, 1, 1, 0])}
    for step in range(3):
        want, got = jc.fit_batch(batch), cls.fit_batch(batch)
        assert abs(got - want) <= RTOL * abs(want) + ATOL, (step, got, want)
    _assert_params(jc, cls, conf)
    # the encoder object follows the fine-tuned weights, as in JAX
    assert bert.params is cls.params["bert"]
    np.testing.assert_array_equal(cls.predict(*args), jc.predict(*args))


def test_serializer_round_trip_is_bit_exact(models):
    jb, conf = models
    flat = _flat_jax(jb.params)
    params, _ = params_from_jax(flat, {}, conf)
    back = params_to_jax(params, conf)
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])
    state = _flat_jax(JAdam(1e-3).init_state(jb.params))
    state["m/encoder/Wq"] = np.random.RandomState(0).randn(
        *state["m/encoder/Wq"].shape).astype(np.float32)
    port_state = updater_state_from_jax(state, conf)
    assert set(port_state) == {"m", "v"}
    back = updater_state_to_jax(port_state, conf)
    assert back.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])


def test_serializer_rejects_a_foreign_tree(models):
    jb, conf = models
    flat = _flat_jax(jb.params)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(flat, {}, dataclasses.replace(conf, hidden_size=64))
    with pytest.raises(ValueError, match="names no leaf"):
        params_from_jax({**flat, "encoder/extra": np.zeros(1)}, {}, conf)


def test_remat_and_overlong_sequences_raise():
    """remat is ported (tests/test_torch_remat.py): True gives the
    remat=False forward; a remat value the JAX package refuses raises
    here too, as does an overlong sequence."""
    ids = np.zeros((1, 8), np.int64)
    plain = Bert(BertConfig.tiny()).init("cpu").output(ids)
    got = Bert(BertConfig.tiny(remat=True)).init("cpu").output(ids)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    bert = Bert(BertConfig.tiny(remat="everything")).init("cpu")
    with pytest.raises(ValueError, match="remat="):
        bert.output(ids)
    bert = Bert(BertConfig.tiny()).init("cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        bert.output(np.zeros((1, 129), np.int64))


def test_training_with_dropout_is_seeded_and_takes_the_dense_path():
    """Attention-probability dropout needs the weights, so training with
    it runs the dense path: the flash forward is not called."""
    conf = BertConfig.tiny(use_flash_attention=True)
    bert = Bert(conf).init("cpu")
    calls = []
    orig = sq.flash_forward

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    sq.flash_forward, saved = spy, sq.flash_forward
    try:
        np.random.seed(0)
        loss = bert.fit_batch(_batch())
        assert not calls and np.isfinite(loss)
        bert.output(_batch()["input_ids"])
        assert calls                      # inference: no dropout, flash
    finally:
        sq.flash_forward = saved


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Bert(BertConfig.tiny()).init()


# ---------------------------------------------------------------------------
# the input pipeline: the same batches as the JAX package's
# ---------------------------------------------------------------------------
CORPUS = ["the quick brown fox jumps over the lazy dog",
          "a stitch in time saves nine, they say.",
          "Deep learning on the card: tokens, masks and labels!",
          "unaffable wordpieces split into ##pieces"] * 3


@pytest.mark.parametrize("task", ["UNSUPERVISED", "SEQ_CLASSIFICATION"])
def test_bert_iterator_matches_jax(task):
    vocab = BertWordPieceTokenizer.build_vocab(CORPUS, size=120)
    assert vocab == JTokenizer.build_vocab(CORPUS, size=120)
    tk, jtk = BertWordPieceTokenizer(vocab), JTokenizer(vocab)
    assert tk.tokenize(CORPUS[3]) == jtk.tokenize(CORPUS[3])
    sents = [(a, b) for a, b in zip(CORPUS, CORPUS[1:])] + CORPUS
    labels = [i % 3 for i in range(len(sents))]
    kw = dict(max_length=16, batch_size=5, task=task, seed=4,
              labels=labels if task == "SEQ_CLASSIFICATION" else None)
    got = list(BertIterator(tk, sents, **kw))
    want = list(JIterator(jtk, sents, **kw))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
