"""BERT: the encoder with its MLM/NSP pretraining heads, and a sequence
classifier over it.

Counterpart of ``deeplearning4j_tpu/models/bert.py``. The parameter
tree keeps the JAX package's names, shapes and ``[in, out]`` dense
layout (``x @ W``), so weights and updater state carry across 1:1
(``utils/serializer.py``):

  embeddings: word / position / token_type ``[., H]``, ln_g / ln_b
  encoder:    every leaf stacked over the layers, ``[L, ...]``
  pooler:     W, b
  mlm:        W, b, ln_g, ln_b, out_b (the decoder is tied to the word
              embeddings: ``h @ word.T + out_b``)
  nsp:        W, b

The encoder loops over the L layers with views into the stacked leaves
(the JAX package scans them). Attention goes through
``ops/attention.py:dot_product_attention``, whose ladder sends every
dropout-free site to the flash kernels on the card, or straight to
``parallel/sequence.py:flash_attention`` with ``use_flash_attention``.
Training with ``attention_probs_dropout_prob > 0`` takes the dense path
(the kernels do not materialise the weights to drop); set it to 0.0 to
train through the kernels.

Numerics as the JAX package's: GELU is the tanh approximation
(``jax.nn.gelu``'s default), LayerNorm uses the biased variance and eps
1e-12, parameters stay f32 while the encoder runs in ``compute_dtype``
(embeddings summed and normalised in f32 first, the pooler and heads in
f32). Token ids outside the vocabulary (or type vocabulary) raise in
PyTorch, where the JAX gather clamps them; a sequence longer than
``max_position_embeddings`` raises in both.

Training is eager: each step runs autograd over the flattened leaves
(``"embeddings/word"``, ...), applies the updater to that flat tree and
writes ``(p - u)`` back in p's dtype. ``fit_steps`` is a Python loop
with an ``RngKey`` per step (``common/rng.py``); as in the JAX package,
layer ``i`` draws its dropout masks from ``fold_in(key, i)`` and the
embeddings from a split of the key, each mask from a generator made
from its own key on the activations' device.

``remat``: False keeps every activation for the backward. True (or
"full") runs each encoder layer under ``torch.utils.checkpoint``, which
keeps only the layer's input and recomputes the rest in the backward
(``jax.checkpoint`` of the layer body); "dots" saves the outputs of the
matrix products (``aten.mm`` / ``addmm`` / ``bmm`` / ``baddbmm``) and
recomputes everything else, the flash forward included (JAX's
``dots_saveable`` policy). The recompute draws the same masks, since
they come from the layer's key.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deeplearning4j_tpu_torch.common import layerprof
from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.common.rng import RngKey
from deeplearning4j_tpu_torch.learning.updaters import Adam, IUpdater
from deeplearning4j_tpu_torch.ops.attention import (dot_product_attention,
                                                    merge_heads,
                                                    split_heads)
from deeplearning4j_tpu_torch.parallel.sequence import flash_attention

_Device = Union[None, str, torch.device]


def flatten_tree(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested ``{key: {...: tensor}}`` tree as ``{"key/.../name":
    tensor}``, in the tree's key order."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def unflatten_tree(flat: Dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flatten_tree`."""
    tree: dict = {}
    for path, v in flat.items():
        *groups, name = path.split("/")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[name] = v
    return tree


def _device_batch(batch: dict, device: torch.device) -> dict:
    """numpy or tensor values on ``device``: integer arrays as int64 (for
    indexing and gathers), floating ones as float32; None values
    dropped."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v)
        t = t.long() if not t.is_floating_point() else t.float()
        out[k] = t.to(device)
    return out


class _Trainable:
    """fit_batch / fit_steps / score over one eager train step."""

    updater: IUpdater
    params: dict
    device: torch.device

    def _loss_fn(self, params, batch, rng):
        raise NotImplementedError

    def _ensure_state(self) -> None:
        if self._state_updater is not None \
                and self._state_updater is not self.updater:
            # updater reassigned: its state belongs to the old rule
            self._opt_state = None
        if self._opt_state is None:
            self._state_updater = self.updater
            self._opt_state = self.updater.init_state(
                flatten_tree(self.params))
            self._iteration = 0

    def _step(self, batch: dict, rng: RngKey) -> torch.Tensor:
        """One update: autograd over the flat leaves, the updater on the
        flat tree, ``(p - u)`` in p's dtype. Returns the loss before the
        update (a 0-dim tensor on the device)."""
        flat = flatten_tree(self.params)
        leaves = {n: t.detach().requires_grad_(True)
                  for n, t in flat.items()}
        loss = self._loss_fn(unflatten_tree(leaves), batch, rng)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {n: g if g is not None else torch.zeros_like(leaves[n])
                 for n, g in zip(leaves, grads)}
        with layerprof.scope("optimizer"):
            updates, self._opt_state = self.updater.apply(
                grads, self._opt_state, self._iteration)
            new = {n: (leaves[n].detach() - updates[n]).to(flat[n].dtype)
                   for n in leaves}
        self.params = unflatten_tree(new)
        self._iteration += 1
        return loss.detach()

    def fit_batch(self, batch: dict) -> float:
        self._ensure_state()
        batch = _device_batch(batch, self.device)
        rng = RngKey(int(np.random.randint(0, 2 ** 31)))
        self.score_value = float(self._step(batch, rng))
        return self.score_value

    def fit_steps(self, batch: dict, n_steps: int) -> float:
        """``n_steps`` updates on one batch, step ``i`` under
        ``fold_in(key, i)``, syncing on the last loss only."""
        self._ensure_state()
        batch = _device_batch(batch, self.device)
        key = RngKey(int(np.random.randint(0, 2 ** 31)))
        loss = None
        for i in range(n_steps):
            loss = self._step(batch, key.fold_in(i))
        self.score_value = float(loss) if loss is not None \
            else float("nan")
        return self.score_value

    def score(self) -> float:
        return self.score_value


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    #: "float32", "bfloat16" or "float16": the encoder's activations and
    #: per-call cast of its leaves; parameters stay f32
    compute_dtype: str = "float32"
    #: False: keep every activation; True / "full": checkpoint each
    #: encoder layer (keep its input only); "dots": keep the matrix
    #: products' outputs, recompute the rest
    remat: object = False
    #: call the flash kernels directly rather than through the ladder;
    #: attention-probability dropout in training still takes the dense
    #: path
    use_flash_attention: bool = False
    #: q/k/v as one [H, 3H] product over the concatenated leaves (the
    #: parameter layout is unchanged)
    fused_qkv: bool = False
    #: MLM head on at most this many gathered positions per sequence;
    #: 0 = decode every position
    max_predictions_per_seq: int = 0

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny(**kw):
        """Test-scale config (layers=2, hidden=128)."""
        d = dict(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=256,
                 max_position_embeddings=128)
        d.update(kw)
        return BertConfig(**d)


def _norm(x, g, b, eps: float):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _dropout(x, rate: float, rng: Optional[RngKey], training: bool):
    if not training or rng is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng.generator(x.device),
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


#: the products "dots" saves: jax.checkpoint_policies.dots_saveable
#: saves every dot_general output
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_layer(fn, remat):
    """``fn`` (one encoder layer) under the ``remat`` policy: False as
    it is, True / "full" under ``checkpoint``, "dots" under a selective
    checkpoint that keeps the matrix products."""
    if not remat:
        return fn
    if remat in (True, "full"):
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat={remat!r}: use False, True, 'full', or "
                     f"'dots'")


def _trunc_normal(shape, sd: float, gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, sd, -2.0 * sd, 2.0 * sd,
                                       generator=gen)


class Bert(_Trainable):
    """BERT encoder with MLM/NSP pretraining heads."""

    def __init__(self, config: BertConfig,
                 updater: Optional[IUpdater] = None, seed: int = 0):
        self.conf = config
        self.updater = updater or Adam(1e-4)
        self.seed = seed
        self.params: Optional[dict] = None
        self.device = torch.device("cpu")
        self._opt_state = None
        self._state_updater = None
        self._iteration = 0
        self.score_value = float("nan")

    # -- init ------------------------------------------------------------
    def init(self, device: _Device = None,
             generator: Optional[torch.Generator] = None) -> "Bert":
        """Weights from ``generator`` (default: seeded with ``seed``),
        truncated normal at ``initializer_range``, onto ``device``
        (``None``: the card)."""
        device = resolve_device(device)
        c = self.conf
        g = generator or torch.Generator().manual_seed(self.seed)
        sd = c.initializer_range
        H, L, I = c.hidden_size, c.num_hidden_layers, c.intermediate_size

        def tn(*shape):
            return _trunc_normal(shape, sd, g)

        zeros, ones = torch.zeros, torch.ones
        params = {
            "embeddings": {
                "word": tn(c.vocab_size, H),
                "position": tn(c.max_position_embeddings, H),
                "token_type": tn(c.type_vocab_size, H),
                "ln_g": ones(H), "ln_b": zeros(H),
            },
            "encoder": {
                "Wq": tn(L, H, H), "bq": zeros(L, H),
                "Wk": tn(L, H, H), "bk": zeros(L, H),
                "Wv": tn(L, H, H), "bv": zeros(L, H),
                "Wo": tn(L, H, H), "bo": zeros(L, H),
                "attn_ln_g": ones(L, H), "attn_ln_b": zeros(L, H),
                "Wi": tn(L, H, I), "bi": zeros(L, I),
                "Wout": tn(L, I, H), "bout": zeros(L, H),
                "out_ln_g": ones(L, H), "out_ln_b": zeros(L, H),
            },
            "pooler": {"W": tn(H, H), "b": zeros(H)},
            "mlm": {"W": tn(H, H), "b": zeros(H), "ln_g": ones(H),
                    "ln_b": zeros(H), "out_b": zeros(c.vocab_size)},
            "nsp": {"W": tn(H, 2), "b": zeros(2)},
        }
        return self.set_params(params, device)

    def set_params(self, params: dict, device: _Device = None) -> "Bert":
        """Adopt a parameter tree (e.g. ``utils.serializer.params_from_jax``
        of the JAX package's, f32) on ``device``, in its own dtype; resets
        the updater state."""
        self.device = resolve_device(device)
        self.params = unflatten_tree({
            n: t.detach().to(self.device)
            for n, t in flatten_tree(params).items()})
        self._opt_state = None
        return self

    def num_params(self) -> int:
        return sum(t.numel() for t in flatten_tree(self.params).values())

    # -- encoder ---------------------------------------------------------
    def _attention(self, lp, x, key_mask, rng, training):
        c = self.conf
        h = c.num_attention_heads
        r_attn, r_out = rng.split() if rng is not None else (None, None)
        if c.fused_qkv:
            w = torch.cat([lp["Wq"], lp["Wk"], lp["Wv"]], 1)
            bias = torch.cat([lp["bq"], lp["bk"], lp["bv"]])
            q, k, v = (split_heads(t, h)
                       for t in torch.chunk(x @ w + bias, 3, dim=-1))
        else:
            q = split_heads(x @ lp["Wq"] + lp["bq"], h)
            k = split_heads(x @ lp["Wk"] + lp["bk"], h)
            v = split_heads(x @ lp["Wv"] + lp["bv"], h)
        attn_drop = (c.attention_probs_dropout_prob
                     if training and r_attn is not None else 0.0)
        if c.use_flash_attention and attn_drop == 0.0:
            o = flash_attention(q, k, v, False, key_mask)
        else:
            m = key_mask[:, None, None, :] if key_mask is not None else None
            gen = r_attn.generator(x.device) if attn_drop > 0.0 else None
            o = dot_product_attention(q, k, v, m, dropout_generator=gen,
                                      dropout_rate=attn_drop)
        o = merge_heads(o) @ lp["Wo"] + lp["bo"]
        return _dropout(o, c.hidden_dropout_prob, r_out, training)

    def _layer(self, lp, x, key_mask, rng, training):
        c = self.conf
        r1, r2 = rng.split() if rng is not None else (None, None)
        with layerprof.scope("encoder.attention"):
            a = self._attention(lp, x, key_mask, r1, training)
            x = _norm(x + a, lp["attn_ln_g"], lp["attn_ln_b"],
                      c.layer_norm_eps)
        with layerprof.scope("encoder.ffn"):
            i = _gelu(x @ lp["Wi"] + lp["bi"])
            o = _dropout(i @ lp["Wout"] + lp["bout"],
                         c.hidden_dropout_prob, r2, training)
            return _norm(x + o, lp["out_ln_g"], lp["out_ln_b"],
                         c.layer_norm_eps)

    def encode(self, params, input_ids, token_type_ids=None,
               attention_mask=None, *, training: bool = False,
               rng: Optional[RngKey] = None):
        """input_ids ``[b, t]`` -> (sequence_output ``[b, t, H]``,
        pooled_output ``[b, H]``), both f32 (f64 for a float64 model).
        ``rng``: the step's key (training dropout)."""
        c = self.conf
        r_emb = None
        if rng is not None:
            rng, r_emb = rng.split()
        dt = getattr(torch, c.compute_dtype)
        b, t = input_ids.shape
        if t > c.max_position_embeddings:
            raise ValueError(
                f"sequence length {t} exceeds max_position_embeddings "
                f"{c.max_position_embeddings}")
        with layerprof.scope("embeddings"):
            e = params["embeddings"]
            x = e["word"][input_ids]
            x = x + e["position"][:t][None]
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + e["token_type"][token_type_ids]
            x = _norm(x, e["ln_g"], e["ln_b"], c.layer_norm_eps)
            x = _dropout(x, c.hidden_dropout_prob, r_emb, training)
            x = x.to(dt)
        key_mask = None
        if attention_mask is not None:
            key_mask = attention_mask.to(dt)
        enc = {n: a.to(dt) for n, a in params["encoder"].items()}

        def body(x, i):
            r = rng.fold_in(i) if rng is not None else None
            return self._layer({n: a[i] for n, a in enc.items()}, x,
                               key_mask, r, training)

        layer_fn = remat_layer(body, c.remat)
        if not torch.is_grad_enabled():
            layer_fn = body          # nothing is kept for a backward
        for i in range(c.num_hidden_layers):
            x = layer_fn(x, i)
        # the pooler and heads run in f32 (f64 for a float64 model)
        x = x.to(torch.promote_types(dt, torch.float32))
        with layerprof.scope("pooler"):
            p = params["pooler"]
            pooled = torch.tanh(x[:, 0] @ p["W"] + p["b"])
        return x, pooled

    # -- heads -----------------------------------------------------------
    def mlm_logits(self, params, sequence_output):
        with layerprof.scope("mlm_head"):
            m = params["mlm"]
            h = _gelu(sequence_output @ m["W"] + m["b"])
            h = _norm(h, m["ln_g"], m["ln_b"], self.conf.layer_norm_eps)
            return h @ params["embeddings"]["word"].T + m["out_b"]

    def nsp_logits(self, params, pooled_output):
        with layerprof.scope("nsp_head"):
            n = params["nsp"]
            return pooled_output @ n["W"] + n["b"]

    def pretrain_loss(self, params, batch, rng=None, training=True):
        """Masked-LM plus next-sentence loss. batch: input_ids,
        token_type_ids, attention_mask, mlm_labels (``[b, t]``, -1 =
        ignore), nsp_labels (``[b]``, optional)."""
        seq, pooled = self.encode(
            params, batch["input_ids"], batch.get("token_type_ids"),
            batch.get("attention_mask"), training=training, rng=rng)
        labels = batch["mlm_labels"]
        k = self.conf.max_predictions_per_seq
        if k and k < labels.shape[1]:
            # the (at most k) masked positions per sequence, in order: a
            # stable sort of "not masked" puts them first
            masked = labels >= 0
            pos = torch.argsort((~masked).to(torch.int8), dim=1,
                                stable=True)[:, :k]
            labels = torch.gather(labels, 1, pos)
            seq = torch.gather(seq, 1,
                               pos[..., None].expand(-1, -1, seq.shape[-1]))
        logits = self.mlm_logits(params, seq)
        with layerprof.scope("loss"):
            w = (labels >= 0).to(torch.float32)
            safe = torch.clamp(labels, min=0)
            logp = torch.log_softmax(logits, -1)
            nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
            loss = torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)
        if batch.get("nsp_labels") is not None:
            nlogits = self.nsp_logits(params, pooled)
            with layerprof.scope("loss"):
                nlogp = torch.log_softmax(nlogits, -1)
                loss = loss - torch.mean(torch.gather(
                    nlogp, -1, batch["nsp_labels"][:, None])[:, 0])
        return loss

    def _loss_fn(self, params, batch, rng):
        return self.pretrain_loss(params, batch, rng)

    def output(self, input_ids, token_type_ids=None, attention_mask=None):
        """Inference forward: (sequence_output, pooled_output) on the
        model's device."""
        batch = _device_batch({"input_ids": input_ids,
                               "token_type_ids": token_type_ids,
                               "attention_mask": attention_mask},
                              self.device)
        with torch.inference_mode():
            return self.encode(self.params, batch["input_ids"],
                               batch.get("token_type_ids"),
                               batch.get("attention_mask"))


class BertForSequenceClassification(_Trainable):
    """A classification head over a (pretrained) encoder: logits =
    ``pooled @ W + b``. Holds a copy of the encoder's parameters;
    ``fit_batch`` writes the fine-tuned ones back into ``bert.params``."""

    def __init__(self, bert: Bert, num_labels: int,
                 updater: Optional[IUpdater] = None, seed: int = 1):
        self.bert = bert
        self.num_labels = num_labels
        self.updater = updater or Adam(2e-5)
        self.device = bert.device
        H = bert.conf.hidden_size
        g = torch.Generator().manual_seed(seed)
        self.params = {
            "bert": unflatten_tree({n: t.clone() for n, t in
                                    flatten_tree(bert.params).items()}),
            "cls": {"W": _trunc_normal((H, num_labels),
                                       bert.conf.initializer_range,
                                       g).to(self.device),
                    "b": torch.zeros(num_labels, device=self.device)},
        }
        self._opt_state = None
        self._state_updater = None
        self._iteration = 0
        self.score_value = float("nan")

    def logits(self, params, input_ids, token_type_ids=None,
               attention_mask=None, training=False, rng=None):
        _, pooled = self.bert.encode(params["bert"], input_ids,
                                     token_type_ids, attention_mask,
                                     training=training, rng=rng)
        return pooled @ params["cls"]["W"] + params["cls"]["b"]

    def _loss_fn(self, params, batch, rng):
        lg = self.logits(params, batch["input_ids"],
                         batch.get("token_type_ids"),
                         batch.get("attention_mask"), training=True,
                         rng=rng)
        logp = torch.log_softmax(lg, -1)
        return -torch.mean(torch.gather(logp, -1,
                                        batch["labels"][:, None])[:, 0])

    def fit_batch(self, batch: dict) -> float:
        loss = super().fit_batch(batch)
        self.bert.params = self.params["bert"]
        return loss

    def predict(self, input_ids, token_type_ids=None, attention_mask=None):
        """Predicted labels ``[b]`` as a numpy array."""
        batch = _device_batch({"input_ids": input_ids,
                               "token_type_ids": token_type_ids,
                               "attention_mask": attention_mask},
                              self.device)
        with torch.inference_mode():
            lg = self.logits(self.params, batch["input_ids"],
                             batch.get("token_type_ids"),
                             batch.get("attention_mask"))
        return lg.argmax(-1).cpu().numpy()
