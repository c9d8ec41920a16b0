"""Recurrent layers: SimpleRnn, LSTM, GravesLSTM, GRU, Bidirectional,
EmbeddingSequenceLayer and LastTimeStepLayer.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers_recurrent.py``, the
same fields and math. Activations are ``[batch, time, features]``. The
input projection ``x @ W + b`` of every timestep is one ``[b·t, 4H]``
product hoisted out of the time loop; the loop itself is a Python loop
over ``t`` on tensors that computes only ``h @ RW`` and the gates, so
autograd records each step and the backward runs through time.

- Gate order is **[i, f, o, g]** in the fused ``[·, 4H]`` ``W``, ``RW``
  and ``b``; the forget-gate slice ``b[H:2H]`` starts at
  ``forget_gate_bias_init``. ``torch.nn.LSTM`` (cuDNN) orders its gates
  [i, f, g, o] and has no peepholes, so it is not used.
- GravesLSTM's peepholes: ``pI`` and ``pF`` multiply ``c_{t-1}``, ``pO``
  the new ``c_t``.
- A ``[b, t]`` mask holds a masked step's previous ``h`` (and ``c``),
  and its output is that held ``h``.
- The recurrent state is ``{"h": [b, H](, "c": [b, H])}``; a layer
  given none starts from zeros of the input's dtype. Mixed dtypes
  promote as in the JAX package (``nn/conf/layers.matmul``): a float32
  state meeting bfloat16 weights runs the step in float32.

Parameters are ``{name: tensor}`` per layer. ``Bidirectional`` keeps its
two directions' parameters and states in the same flat dict under
``fwd/`` and ``bwd/`` prefixes, the JAX package's nested tree flattened
the way its zips store it. ``ConvLSTM2D`` is not ported (it needs
``InputType.convolutional_3d``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import torch

from deeplearning4j_tpu_torch.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (InputType,
                                                     InputTypeRecurrent)
from deeplearning4j_tpu_torch.nn.conf.layers import (LAYER_REGISTRY, Layer,
                                                     matmul, register_layer)
from deeplearning4j_tpu_torch.nn.weights import WeightInit


def _timesteps(input_type) -> int:
    return input_type.timesteps if isinstance(input_type,
                                              InputTypeRecurrent) else -1


@dataclass
class BaseRecurrentLayer(Layer):
    activation: Activation = Activation.TANH

    def is_recurrent(self) -> bool:
        return True

    def zero_state(self, batch: int, dtype=torch.float32) -> dict:
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype)}

    def set_n_in(self, input_type, override):
        if isinstance(input_type, InputTypeRecurrent) and \
                (override or not self.n_in):
            self.n_in = input_type.size

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, _timesteps(input_type))

    def forward(self, params, x, *, training, rng=None, state=None,
                mask=None):
        x = self._maybe_dropout(x, training, rng)
        if not state:
            state = self.zero_state(int(x.shape[0]), x.dtype)
            state = {n: t.to(x.device) for n, t in state.items()}
        return self._scan(params, x, state, mask)

    def _input_projection(self, params, x):
        """``x @ W (+ b)`` for every timestep at once: one ``[b·t, ·]``
        product, split into the loop's ``[b, ·]`` steps."""
        b, t = int(x.shape[0]), int(x.shape[1])
        xw = matmul(x.reshape(b * t, -1), params["W"])
        if self.has_bias:
            xw = xw + params["b"]
        return xw.reshape(b, t, -1).unbind(1)

    @staticmethod
    def _hold(mask, t, new, prev):
        """A masked step keeps the previous value."""
        if mask is None:
            return new
        return torch.where(mask[:, t, None] > 0, new, prev)


@dataclass
class SimpleRnn(BaseRecurrentLayer):
    """h_t = act(x W + h_{t-1} R + b) (reference: recurrent.SimpleRnn)."""

    has_bias: bool = True

    def init_params(self, generator, input_type, dtype=torch.float32):
        wi = self.weight_init or WeightInit.XAVIER
        p = {"W": wi.init(generator, (self.n_in, self.n_out), self.n_in,
                          self.n_out, dtype),
             "RW": wi.init(generator, (self.n_out, self.n_out), self.n_out,
                           self.n_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init),
                                dtype=dtype)
        return p

    def _scan(self, params, x, state, mask):
        h, ys = state["h"], []
        for t, xw_t in enumerate(self._input_projection(params, x)):
            h = self._hold(mask, t,
                           self.activation(xw_t + matmul(h, params["RW"])),
                           h)
            ys.append(h)
        return torch.stack(ys, 1), {"h": h}


@dataclass
class LSTM(BaseRecurrentLayer):
    """Standard LSTM, gate order [i, f, o, g] (reference:
    conf.layers.LSTM)."""

    forget_gate_bias_init: float = 1.0
    gate_activation: Activation = Activation.SIGMOID
    has_bias: bool = True

    def zero_state(self, batch: int, dtype=torch.float32) -> dict:
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype),
                "c": torch.zeros((batch, self.n_out), dtype=dtype)}

    def init_params(self, generator, input_type, dtype=torch.float32):
        wi = self.weight_init or WeightInit.XAVIER
        H = self.n_out
        p = {"W": wi.init(generator, (self.n_in, 4 * H), self.n_in, H,
                          dtype),
             "RW": wi.init(generator, (H, 4 * H), H, H, dtype)}
        if self.has_bias:
            b = torch.full((4 * H,), float(self.bias_init), dtype=dtype)
            b[H:2 * H] = float(self.forget_gate_bias_init)
            p["b"] = b
        return p

    def _gates(self, z, c_prev, params):
        H = self.n_out
        gate, act = self.gate_activation, self.activation
        i = gate(z[:, :H])
        f = gate(z[:, H:2 * H])
        o = gate(z[:, 2 * H:3 * H])
        g = act(z[:, 3 * H:])
        c = f * c_prev + i * g
        return o * act(c), c

    def _scan(self, params, x, state, mask):
        h, c, ys = state["h"], state["c"], []
        for t, xw_t in enumerate(self._input_projection(params, x)):
            h_new, c_new = self._gates(xw_t + matmul(h, params["RW"]), c,
                                       params)
            h = self._hold(mask, t, h_new, h)
            c = self._hold(mask, t, c_new, c)
            ys.append(h)
        return torch.stack(ys, 1), {"h": h, "c": c}


@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013; reference:
    conf.layers.GravesLSTM, the BASELINE config #3 layer): ``c_{t-1}``
    enters the input and forget gates, ``c_t`` the output gate."""

    def init_params(self, generator, input_type, dtype=torch.float32):
        p = super().init_params(generator, input_type, dtype)
        H = self.n_out
        wi = self.weight_init or WeightInit.XAVIER
        for name in ("pI", "pF", "pO"):
            p[name] = wi.init(generator, (H,), H, H, dtype)
        return p

    def _gates(self, z, c_prev, params):
        H = self.n_out
        gate, act = self.gate_activation, self.activation
        i = gate(z[:, :H] + c_prev * params["pI"])
        f = gate(z[:, H:2 * H] + c_prev * params["pF"])
        g = act(z[:, 3 * H:])
        c = f * c_prev + i * g
        o = gate(z[:, 2 * H:3 * H] + c * params["pO"])
        return o * act(c), c


@dataclass
class GRU(BaseRecurrentLayer):
    """GRU (reference: conf.layers.GRU), gate order [r, z, n];
    ``recurrent_bias`` adds the Keras ``reset_after`` candidate bias."""

    gate_activation: Activation = Activation.SIGMOID
    has_bias: bool = True
    recurrent_bias: bool = False

    def init_params(self, generator, input_type, dtype=torch.float32):
        wi = self.weight_init or WeightInit.XAVIER
        H = self.n_out
        p = {"W": wi.init(generator, (self.n_in, 3 * H), self.n_in, H,
                          dtype),
             "RW": wi.init(generator, (H, 3 * H), H, H, dtype)}
        if self.has_bias:
            p["b"] = torch.full((3 * H,), float(self.bias_init),
                                dtype=dtype)
        if self.recurrent_bias:
            p["rb"] = torch.zeros((H,), dtype=dtype)
        return p

    def _scan(self, params, x, state, mask):
        H = self.n_out
        gate, act = self.gate_activation, self.activation
        rb = params.get("rb")
        h, ys = state["h"], []
        for t, xw_t in enumerate(self._input_projection(params, x)):
            hr = matmul(h, params["RW"])
            r = gate(xw_t[:, :H] + hr[:, :H])
            zt = gate(xw_t[:, H:2 * H] + hr[:, H:2 * H])
            hr_n = hr[:, 2 * H:] if rb is None else hr[:, 2 * H:] + rb
            n = act(xw_t[:, 2 * H:] + r * hr_n)
            h = self._hold(mask, t, (1 - zt) * n + zt * h, h)
            ys.append(h)
        return torch.stack(ys, 1), {"h": h}


class BidirectionalMode(enum.Enum):
    CONCAT = "concat"
    ADD = "add"
    MUL = "mul"
    AVERAGE = "average"


def _prefixed(tree: dict, prefix: str) -> dict:
    return {n[len(prefix):]: t for n, t in tree.items()
            if n.startswith(prefix)}


@dataclass
class Bidirectional(BaseRecurrentLayer):
    """A recurrent layer run forward and backward over time, with its
    own parameters each way (reference: recurrent.Bidirectional(mode,
    layer)); the two outputs concatenate, add, multiply or average."""

    fwd: Optional[BaseRecurrentLayer] = None
    mode: BidirectionalMode = BidirectionalMode.CONCAT

    def __post_init__(self):
        super().__post_init__()
        if isinstance(self.mode, str):
            self.mode = BidirectionalMode[self.mode.upper()]
        if self.fwd is not None:
            self.n_out = self.fwd.n_out

    def zero_state(self, batch: int, dtype=torch.float32) -> dict:
        one = self.fwd.zero_state(batch, dtype)
        return {f"{d}/{n}": t.clone() for d in ("fwd", "bwd")
                for n, t in one.items()}

    def set_n_in(self, input_type, override):
        super().set_n_in(input_type, override)
        self.fwd.set_n_in(input_type, override)

    def init_params(self, generator, input_type, dtype=torch.float32):
        return {f"{d}/{n}": t for d in ("fwd", "bwd")
                for n, t in self.fwd.init_params(generator, input_type,
                                                 dtype).items()}

    def forward(self, params, x, *, training, rng=None, state=None,
                mask=None):
        if not state:
            state = {n: t.to(x.device) for n, t in
                     self.zero_state(int(x.shape[0]), x.dtype).items()}
        # independent input-dropout masks per direction
        rng_f, rng_b = rng.split() if rng is not None else (None, None)
        y_f, s_f = self.fwd.forward(_prefixed(params, "fwd/"), x,
                                    training=training, rng=rng_f,
                                    state=_prefixed(state, "fwd/"),
                                    mask=mask)
        m_rev = torch.flip(mask, (1,)) if mask is not None else None
        y_b, s_b = self.fwd.forward(_prefixed(params, "bwd/"),
                                    torch.flip(x, (1,)), training=training,
                                    rng=rng_b,
                                    state=_prefixed(state, "bwd/"),
                                    mask=m_rev)
        y_b = torch.flip(y_b, (1,))
        if self.mode is BidirectionalMode.CONCAT:
            y = torch.cat([y_f, y_b], dim=-1)
        elif self.mode is BidirectionalMode.ADD:
            y = y_f + y_b
        elif self.mode is BidirectionalMode.MUL:
            y = y_f * y_b
        else:
            y = 0.5 * (y_f + y_b)
        new_state = {f"fwd/{n}": t for n, t in s_f.items()}
        new_state.update({f"bwd/{n}": t for n, t in s_b.items()})
        return y, new_state

    def get_output_type(self, input_type):
        n = self.fwd.n_out * (2 if self.mode is BidirectionalMode.CONCAT
                              else 1)
        return InputType.recurrent(n, _timesteps(input_type))

    def to_map(self):
        return {"@class": "Bidirectional", "mode": self.mode.name,
                "fwd": self.fwd.to_map()}


@dataclass
class EmbeddingSequenceLayer(Layer):
    """[b, t] int tokens -> [b, t, n_out] (reference:
    conf.layers.EmbeddingSequenceLayer)."""

    has_bias: bool = False

    def init_params(self, generator, input_type, dtype=torch.float32):
        wi = self.weight_init or WeightInit.XAVIER
        return {"W": wi.init(generator, (self.n_in, self.n_out), self.n_in,
                             self.n_out, dtype)}

    def forward(self, params, x, *, training, rng=None, state=None):
        idx = x.long()
        if idx.dim() == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        return params["W"][idx], state

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out, _timesteps(input_type))

    def set_n_in(self, input_type, override):
        pass  # n_in is the vocabulary size


@dataclass
class LastTimeStepLayer(Layer):
    """[b, t, f] -> [b, f], the last unmasked step (reference:
    recurrent.LastTimeStep)."""

    def has_params(self) -> bool:
        return False

    def accepts_mask(self) -> bool:
        return True

    def forward(self, params, x, *, training, rng=None, state=None,
                mask=None):
        if mask is not None:
            idx = torch.clamp((mask > 0).sum(1) - 1, min=0)
            return x[torch.arange(x.shape[0], device=x.device),
                     idx.long()], state
        return x[:, -1], state

    def get_output_type(self, input_type):
        return InputType.feed_forward(input_type.size)

    def set_n_in(self, input_type, override):
        if isinstance(input_type, InputTypeRecurrent):
            self.n_in = self.n_out = input_type.size


for _cls in (SimpleRnn, LSTM, GravesLSTM, GRU, EmbeddingSequenceLayer,
             LastTimeStepLayer):
    register_layer(_cls)

LAYER_REGISTRY["Bidirectional"] = lambda **d: Bidirectional(
    fwd=Layer.from_map(d["fwd"]), mode=BidirectionalMode[d["mode"]])
