"""Decoder-only transformer LM with a paged-decode serving contract.

Counterpart of ``deeplearning4j_tpu/models/decoder.py``: a pre-LN
decoder with learned position embeddings, a tanh-GELU MLP, LayerNorm eps
1e-5, a final LayerNorm and an untied head. The serving engine uses the
prefill/decode split:

- :meth:`DecoderLM.prefill`: full causal attention over the (padded)
  prompt through ``ops/attention.py:dot_product_attention``, returning
  the last valid position's logits and every layer's K/V for the pool.
  Its ``[b, 1, t, t]`` causal-times-length mask varies per query, so
  the flash ladder demotes the site to the dense path, as in the JAX
  package.
- :meth:`DecoderLM.decode_step`: one token per live sequence: project
  q/k/v for the new token, write its K/V into the paged pool at the
  block-table slot, then paged attention over the pool (kernel 10,
  ``ops/attention_kernels.py:paged_decode_attention``, or the dense
  gather, as ``paged`` says).

Parameters are the JAX package's two-level dict ``{entry: {leaf:
tensor}}`` with entries ``embed`` (``tok``, ``pos``), ``layer_<i>``
(``ln1_g``, ``ln1_b``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2_g``,
``ln2_b``, ``w1``, ``b1``, ``w2``, ``b2``) and ``head`` (``ln_g``,
``ln_b``, ``w``), dense weights ``[in, out]`` (``x @ w``), so
``utils/serializer.py`` carries them across as they are.

Causality makes the two paths agree: token *t*'s activations depend only
on tokens ``<= t``, so a decode step over cached K/V gives the logits of
a full forward's last position up to float association;
:meth:`reference_decode` is the full re-forward greedy decode that paged
decode is held to token for token.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
from deeplearning4j_tpu_torch.ops.attention_kernels import (
    paged_attention_reference, paged_decode_attention)

_Device = Union[None, str, torch.device]


@dataclass
class DecoderConfig:
    """Hyperparameters; ``tiny()`` is the test size."""

    vocab_size: int = 64
    n_layers: int = 2
    n_heads: int = 2
    d_model: int = 32
    d_ff: int = 64
    max_len: int = 256
    eos_id: int = 1
    seed: int = 0

    @staticmethod
    def tiny(**kw) -> "DecoderConfig":
        return DecoderConfig(**kw)

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def _ln(x, g, b, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _as_long(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=torch.long)


class DecoderLM:
    """Pre-LN decoder-only transformer over token ids."""

    def __init__(self, conf: Optional[DecoderConfig] = None, **kw):
        self.conf = conf if conf is not None else DecoderConfig(**kw)
        self.params: Optional[dict] = None
        self.device = torch.device("cpu")

    # -- init ------------------------------------------------------------
    def init(self, device: _Device = None, seed: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> dict:
        """Weights N(0, 0.02²) (LayerNorms 1/0, biases 0) drawn on
        ``device`` (``None``: the card) from ``generator``, by default
        one on that device seeded with ``seed`` (default ``conf.seed``).
        Returns the tree, also kept as ``self.params``."""
        device = resolve_device(device)
        c = self.conf
        g = generator or torch.Generator(device=device).manual_seed(
            c.seed if seed is None else int(seed))
        d, f, v = c.d_model, c.d_ff, c.vocab_size

        def dense(*shape):
            return torch.randn(shape, generator=g, device=g.device) * 0.02

        params = {"embed": {"tok": dense(v, d), "pos": dense(c.max_len, d)}}
        ones, zeros = torch.ones, torch.zeros
        for i in range(c.n_layers):
            params[f"layer_{i}"] = {
                "ln1_g": ones(d), "ln1_b": zeros(d),
                "wq": dense(d, d), "wk": dense(d, d),
                "wv": dense(d, d), "wo": dense(d, d),
                "ln2_g": ones(d), "ln2_b": zeros(d),
                "w1": dense(d, f), "b1": zeros(f),
                "w2": dense(f, d), "b2": zeros(d),
            }
        params["head"] = {"ln_g": ones(d), "ln_b": zeros(d),
                          "w": dense(d, v)}
        return self.set_params(params, device)

    def set_params(self, params: dict, device: _Device = None) -> dict:
        """Adopt a parameter tree (e.g. ``utils.serializer.params_from_jax``
        of the JAX package's) on ``device`` (``None``: the card)."""
        self.device = resolve_device(device)
        self.params = {e: {n: t.detach().to(self.device)
                           for n, t in leaves.items()}
                       for e, leaves in params.items()}
        return self.params

    def num_params(self) -> int:
        return sum(t.numel() for leaves in self.params.values()
                   for t in leaves.values())

    # -- shared blocks ---------------------------------------------------
    def _attn_qkv(self, p, h, heads_first: bool):
        c = self.conf
        shp = h.shape[:-1] + (c.n_heads, c.head_dim)
        q = (h @ p["wq"]).reshape(shp)
        k = (h @ p["wk"]).reshape(shp)
        v = (h @ p["wv"]).reshape(shp)
        if heads_first:              # [b, t, h, dh] -> [b, h, t, dh]
            q, k, v = (a.transpose(-3, -2) for a in (q, k, v))
        return q, k, v

    def _mlp(self, p, x):
        h = _ln(x, p["ln2_g"], p["ln2_b"])
        return x + F.gelu(h @ p["w1"] + p["b1"],
                          approximate="tanh") @ p["w2"] + p["b2"]

    # -- full causal forward (prefill / reference decode) ----------------
    def forward_with_kv(self, params, tokens, length=None):
        """Logits ``[b, t, vocab]`` and the stacked per-layer K/V
        ``[n_layers, b, t, heads, head_dim]`` (token-major, the pool's
        block layout). ``length`` ``[b]`` masks right-padding; padded
        positions still produce K/V (callers route them to the scratch
        block)."""
        c = self.conf
        dev = params["embed"]["tok"].device
        tokens = _as_long(tokens, dev)
        b, t = tokens.shape
        pos = torch.arange(t, device=dev)
        x = params["embed"]["tok"][tokens] + params["embed"]["pos"][pos]
        mask = torch.tril(torch.ones(t, t, device=dev))[None, None]
        if length is not None:
            valid = (pos[None, :] < _as_long(length, dev)[:, None]).float()
            mask = mask * valid[:, None, None, :]          # [b, 1, t, t]
        ks, vs = [], []
        for i in range(c.n_layers):
            p = params[f"layer_{i}"]
            h = _ln(x, p["ln1_g"], p["ln1_b"])
            q, k, v = self._attn_qkv(p, h, heads_first=True)
            a = dot_product_attention(q, k, v, mask=mask)
            x = x + a.transpose(1, 2).reshape(b, t, c.d_model) @ p["wo"]
            x = self._mlp(p, x)
            ks.append(k.transpose(1, 2))                    # [b, t, h, dh]
            vs.append(v.transpose(1, 2))
        hp = params["head"]
        logits = _ln(x, hp["ln_g"], hp["ln_b"]) @ hp["w"]
        return logits, torch.stack(ks), torch.stack(vs)

    def output(self, tokens) -> torch.Tensor:
        """Full-sequence logits on the model's device (the generic
        serving surface)."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            logits, _, _ = self.forward_with_kv(self.params, tokens)
        return logits

    def prefill(self, params, tokens, length):
        """Prompt pass: ``(last_logits [b, vocab], k, v)``, the logits of
        position ``length - 1`` and the stacked caches of
        :meth:`forward_with_kv`."""
        logits, k, v = self.forward_with_kv(params, tokens, length)
        length = _as_long(length, logits.device)
        last = logits[torch.arange(logits.shape[0], device=logits.device),
                      length - 1]
        return last, k, v

    # -- one decode step over the paged pool -----------------------------
    def decode_step(self, params, tokens, positions, k_pool, v_pool,
                    block_tables, *, paged: bool = False):
        """One token for every sequence of the decode batch.

        ``tokens`` / ``positions`` ``[b]`` (position = this token's
        index; the valid KV length becomes ``positions + 1``);
        ``k_pool`` / ``v_pool`` ``[n_layers, num_blocks, block, heads,
        head_dim]``; ``block_tables`` ``[b, max_blocks]`` int32 padded
        with the scratch block 0 (a dead batch slot passes position 0 and
        an all-zero table, so its write lands in scratch). ``paged``
        picks kernel 10 over the dense gather.

        The new token's K/V are written into the pools **in place**
        (the JAX package returns new pools): a functional update would
        hold a second pool, 1.2 GB at GPT-2-small width, every step.
        Returns ``(logits [b, vocab], k_pool, v_pool)``, the pools being
        the tensors passed in, so callers compare like with like."""
        c = self.conf
        dev = params["embed"]["tok"].device
        tokens = _as_long(tokens, dev)
        positions = _as_long(positions, dev)
        tables = torch.as_tensor(block_tables).to(device=dev,
                                                  dtype=torch.int32)
        b = tokens.shape[0]
        nl, nb, bs = k_pool.shape[:3]
        x = params["embed"]["tok"][tokens] + params["embed"]["pos"][positions]
        rows = torch.arange(b, device=dev)
        slot = tables[rows, positions // bs].long() * bs + positions % bs
        lengths = (positions + 1).to(torch.int32)
        kf = k_pool.view(nl, nb * bs, c.n_heads, c.head_dim)
        vf = v_pool.view(nl, nb * bs, c.n_heads, c.head_dim)
        attend = paged_decode_attention if paged \
            else paged_attention_reference
        for i in range(c.n_layers):
            p = params[f"layer_{i}"]
            h = _ln(x, p["ln1_g"], p["ln1_b"])
            q, k_new, v_new = self._attn_qkv(p, h, heads_first=False)
            # a low-precision pool takes the write in its own dtype; the
            # attention re-promotes through q
            kf[i, slot] = k_new.to(kf.dtype)
            vf[i, slot] = v_new.to(vf.dtype)
            a = attend(q, k_pool[i], v_pool[i], tables, lengths)
            x = x + a.reshape(b, c.d_model) @ p["wo"]
            x = self._mlp(p, x)
        hp = params["head"]
        logits = _ln(x, hp["ln_g"], hp["ln_b"]) @ hp["w"]
        return logits, k_pool, v_pool

    # -- reference decode (conformance) ----------------------------------
    def reference_decode(self, params, prompt, max_tokens: int,
                         eos_id: Optional[int] = None):
        """Greedy decode by a full re-forward each step: the dense
        reference paged decode must match token for token. ``prompt`` is
        a 1-D id list; returns the generated ids."""
        eos = self.conf.eos_id if eos_id is None else eos_id
        dev = params["embed"]["tok"].device
        ids = [int(t) for t in np.asarray(prompt).reshape(-1)]
        out = []
        with torch.inference_mode():
            for _ in range(max_tokens):
                tok = torch.tensor([ids], dtype=torch.long, device=dev)
                logits, _, _ = self.forward_with_kv(params, tok)
                nxt = int(torch.argmax(logits[0, -1]))
                out.append(nxt)
                ids.append(nxt)
                if nxt == eos:
                    break
        return out
