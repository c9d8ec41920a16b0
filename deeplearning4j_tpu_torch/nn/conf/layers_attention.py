"""Attention layers: SelfAttentionLayer, LearnedSelfAttentionLayer and
RecurrentAttentionLayer.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers_attention.py``, the
same fields and math, registered for both network kinds' JSON.
Activations are ``[batch, time, features]``; a mask is the ``[b, t]``
features mask, used as the key mask of every attention (a masked step is
neither attended to nor, in ``SelfAttentionLayer``, kept: its output is
zeroed). The attention itself is ``ops/attention.py``'s
``multi_head_attention`` / ``dot_product_attention``, so on the card a
site goes to the flash kernels (7, 8, 9) when ``ops/attention_kernels.py``'s
ladder takes it, and to the dense chain otherwise.

Mixed dtypes promote as in the JAX package's products: under
``compute_dtype`` a float32 input (a masked ``SelfAttentionLayer``'s
output is ``y * mask`` with a float32 mask, as in the JAX package) meets
16-bit weights, and the attention runs in float32.

``RecurrentAttentionLayer`` is a Python loop over ``t`` with one
attention call a step (the JAX package's ``lax.scan``): the input
projection ``x W + b`` and the keys and values of the whole sequence are
computed once before the loop, the query is the previous ``h``, and a
masked step holds ``h``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (InputType,
                                                     InputTypeRecurrent)
from deeplearning4j_tpu_torch.nn.conf.layers import (Layer, matmul,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.conf.layers_recurrent import _timesteps
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.ops.attention import (dot_product_attention,
                                                    merge_heads,
                                                    multi_head_attention,
                                                    split_heads)


def _promoted(params: dict, x: torch.Tensor):
    """``params`` and ``x`` in their common dtype (a float32 ``x`` lifts
    16-bit weights, as ``jnp.matmul`` promotes)."""
    dt = x.dtype
    for t in params.values():
        dt = torch.promote_types(dt, t.dtype)
    return {n: t.to(dt) for n, t in params.items()}, x.to(dt)


@dataclass
class BaseAttentionLayer(Layer):
    """Shared config: a projection width of ``n_heads * head_size``."""

    n_heads: int = 1
    head_size: int = 0          # 0 -> n_out // n_heads
    #: learn projection biases (the Keras MultiHeadAttention
    #: ``use_bias=True`` form; the reference layer has none)
    has_bias: bool = False

    def _head_size(self) -> int:
        return self.head_size or max(self.n_out // self.n_heads, 1)

    def accepts_mask(self) -> bool:
        return True

    def set_n_in(self, input_type, override):
        if isinstance(input_type, InputTypeRecurrent) and \
                (override or not self.n_in):
            self.n_in = input_type.size
            if not self.n_out:
                self.n_out = self.n_in

    def _proj_params(self, generator, q_dim: int, kv_dim: int, dtype):
        wi = self.weight_init or WeightInit.XAVIER
        hs = self._head_size() * self.n_heads
        p = {"Wq": wi.init(generator, (q_dim, hs), q_dim, hs, dtype),
             "Wk": wi.init(generator, (kv_dim, hs), kv_dim, hs, dtype),
             "Wv": wi.init(generator, (kv_dim, hs), kv_dim, hs, dtype),
             "Wo": wi.init(generator, (hs, self.n_out), hs, self.n_out,
                           dtype)}
        if self.has_bias:
            for n, size in (("bq", hs), ("bk", hs), ("bv", hs),
                            ("bo", self.n_out)):
                p[n] = torch.zeros((size,), dtype=dtype)
        return p


@register_layer
@dataclass
class SelfAttentionLayer(BaseAttentionLayer):
    """Self-attention over the input sequence (reference:
    conf.layers.SelfAttentionLayer). ``project_input=False`` needs a
    single head and applies unprojected dot-product attention."""

    project_input: bool = True

    def init_params(self, generator, input_type, dtype=torch.float32):
        if not self.project_input:
            if self.n_heads != 1:
                raise ValueError(
                    "SelfAttentionLayer(project_input=False) requires "
                    f"n_heads=1, got {self.n_heads} (reference rejects "
                    "projectInput=false with nHeads!=1)")
            return {}
        return self._proj_params(generator, self.n_in, self.n_in, dtype)

    def has_params(self) -> bool:
        return self.project_input

    def forward(self, params, x, *, training, rng=None, state=None,
                mask=None):
        x = self._maybe_dropout(x, training, rng)
        if not self.project_input:
            m = mask[:, None, :] if mask is not None else None
            y = dot_product_attention(x, x, x, m)
        else:
            p, x = _promoted(params, x)
            y = multi_head_attention(p, x, x, self.n_heads, key_mask=mask)
        if mask is not None:
            y = y * mask[:, :, None]
        return self.activation(y), state

    def get_output_type(self, input_type):
        n = self.n_out if self.project_input else self.n_in
        return InputType.recurrent(n, _timesteps(input_type))


@register_layer
@dataclass
class LearnedSelfAttentionLayer(BaseAttentionLayer):
    """Attention with ``n_queries`` learned query vectors (reference:
    conf.layers.LearnedSelfAttentionLayer): the output has ``n_queries``
    timesteps whatever the input's length."""

    n_queries: int = 1

    def init_params(self, generator, input_type, dtype=torch.float32):
        wi = self.weight_init or WeightInit.XAVIER
        p = self._proj_params(generator, self.n_in, self.n_in, dtype)
        p["Q"] = wi.init(generator, (self.n_queries, self.n_in), self.n_in,
                         self.n_in, dtype)
        return p

    def forward(self, params, x, *, training, rng=None, state=None,
                mask=None):
        x = self._maybe_dropout(x, training, rng)
        p, x = _promoted(params, x)
        q = p["Q"].expand(int(x.shape[0]), *p["Q"].shape)
        y = multi_head_attention(p, q, x, self.n_heads, key_mask=mask)
        return self.activation(y), state

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, self.n_queries)


@register_layer
@dataclass
class RecurrentAttentionLayer(BaseAttentionLayer):
    """A recurrent cell whose step input is joined by an attention
    readout over the whole sequence, queried by the previous hidden state
    (reference: conf.layers.RecurrentAttentionLayer):

        a_t = MHA(q = h_{t-1}, kv = x)
        h_t = act(x_t W + h_{t-1} R + a_t + b)
    """

    activation: Activation = Activation.TANH
    has_bias: bool = True

    def is_recurrent(self) -> bool:
        return True

    def zero_state(self, batch: int, dtype=torch.float32) -> dict:
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype)}

    def init_params(self, generator, input_type, dtype=torch.float32):
        wi = self.weight_init or WeightInit.XAVIER
        p = {"W": wi.init(generator, (self.n_in, self.n_out), self.n_in,
                          self.n_out, dtype),
             "R": wi.init(generator, (self.n_out, self.n_out), self.n_out,
                          self.n_out, dtype)}
        p.update(self._proj_params(generator, self.n_out, self.n_in, dtype))
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtype)
        return p

    def forward(self, params, x, *, training, rng=None, state=None,
                mask=None):
        x = self._maybe_dropout(x, training, rng)
        b, t = int(x.shape[0]), int(x.shape[1])
        if not state:
            state = {"h": self.zero_state(b, x.dtype)["h"].to(x.device)}
        h = state["h"]

        def proj(a, w, bias):
            y = matmul(a, params[w])
            return y + params[bias] if bias in params else y

        # hoisted out of the time loop: the input projection of every
        # step, and the keys and values of the whole sequence
        xw = proj(x, "W", "b").unbind(1)
        step_dtype = torch.promote_types(h.dtype, params["Wq"].dtype)
        k, v = (split_heads(proj(x, w, bias), self.n_heads)
                .to(step_dtype).contiguous()
                for w, bias in (("Wk", "bk"), ("Wv", "bv")))
        m = mask[:, None, None, :] if mask is not None else None
        ys = []
        for i in range(t):
            q = split_heads(proj(h[:, None, :], "Wq", "bq"), self.n_heads)
            a = proj(merge_heads(dot_product_attention(q, k, v, m)), "Wo",
                     "bo")[:, 0]
            h_new = self.activation(xw[i] + matmul(h, params["R"]) + a)
            if mask is not None:
                h_new = torch.where(mask[:, i, None] > 0, h_new, h)
            h = h_new
            ys.append(h)
        return torch.stack(ys, 1), {"h": h}

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, _timesteps(input_type))
