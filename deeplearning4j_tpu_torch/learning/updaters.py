"""Updaters (optimizers): configuration and update math.

Counterpart of ``deeplearning4j_tpu/learning/updaters.py``. An updater
is its class name and hyperparameters, and round-trips through
``configuration.json`` exactly as the JAX package writes it
(``{"@class": "Nesterovs", "learning_rate": 0.1, "momentum": 0.9}``,
every field present, in the JAX package's field order).

The math is the JAX package's, over one layer's ``{name: tensor}``
gradients: ``init_state(params)`` gives the slots (``{"v": {name:
zeros}}`` for Nesterovs, ``{"m": ..., "v": ...}`` for Adam, ``{}`` for
Sgd and NoOp), and ``apply(grads, state, iteration)`` returns
``(updates, new_state)`` with the updates to be **subtracted** from the
parameters. Adam-family bias corrections use ``t = iteration + 1``.
``learning_rate`` may be a number or an ``ISchedule``
(``learning/schedules.py``), written into the JSON as its map and read
back from it; ``lr_at(iteration, epoch)`` gives the rate a step uses.

The ZeRO-1 flat layout (``dp_ravel`` / ``dp_unravel``, the JAX
package's): a tree of tensors ravels into one padded 1-D vector per
dtype, its length a multiple of the replica count, so the optimizer
state and the weight update split evenly over a data-parallel mesh
(``parallel/zero.py``). Leaves go in the JAX package's tree order
(dict keys sorted), so the flats match its layout.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from deeplearning4j_tpu_torch.learning.schedules import ISchedule

_Tree = Dict[str, torch.Tensor]

#: reserved key marking an updater-state dict as the dp-sharded flat
#: layout: ``{DP_SHARDED_KEY: {slot: {dtype key: flat}}}``
DP_SHARDED_KEY = "__dp_sharded__"


def is_dp_sharded(state) -> bool:
    return isinstance(state, dict) and DP_SHARDED_KEY in state


#: reserved key marking a parameter entry as the fsdp (ZeRO-3) flat
#: layout: ``{FSDP_KEY: {dtype key: flat}}``, a replica holding its 1/N
#: slice of each padded flat (``parallel/zero.py`` owns the conversions)
FSDP_KEY = "__fsdp__"


def is_fsdp(tree) -> bool:
    return isinstance(tree, dict) and FSDP_KEY in tree


#: reserved key marking the tensor-parallel split of a parameter or
#: updater-state entry: ``{TP_KEY: {param name: tensor}}``. Its leaves
#: are a replica's shards of the leaves ``parallel/speclayout.py`` splits
#: over the ``model`` axis (and, under the ZeRO layouts, over ``data``
#: too); they never ravel into the data-parallel flats, so the flats'
#: exchange never crosses ``model``. The key string is the JAX package's.
TP_KEY = "__tp__"


def has_tp(tree) -> bool:
    return isinstance(tree, dict) and TP_KEY in tree


#: reserved key marking the encoded exchange's error-feedback state in an
#: updater-state entry: ``{ENCODED_KEY: {"residual": {dtype key: flat},
#: "tau": f32, "step": int32, "sparsity": f32}}``; in the dense
#: (checkpoint) layout the residual is ``{name: tensor}``, the
#: parameters' tree, so a zip restores on any replica count. The key
#: strings are the JAX package's: they reach the zips.
ENCODED_KEY = "__encoded__"


def is_encoded(state) -> bool:
    return isinstance(state, dict) and ENCODED_KEY in state


def _dtype_key(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict in the JAX package's tree order
    (keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts of one structure, in
    insertion order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts in insertion order (the order
    :func:`tree_map` visits them)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


class DpFlatSpec:
    """How a tree ravels into per-dtype padded flat vectors: ``infos``
    per leaf (dtype key, offset into its dtype vector, shape); ``sizes``
    dtype key -> (original length, padded length), the padded length a
    multiple of ``n_shards``."""

    def __init__(self, structure, infos, sizes, n_shards: int,
                 axis: str = "data"):
        self.structure = structure
        self.infos: List[Tuple[str, int, tuple]] = infos
        self.sizes: Dict[str, Tuple[int, int]] = sizes
        self.n_shards = n_shards
        self.axis = axis


def dp_flatten_spec(tree, n_shards: int, axis: str = "data") -> DpFlatSpec:
    infos, offsets = [], {}
    for leaf in _leaves(tree):
        dt = _dtype_key(leaf)
        off = offsets.get(dt, 0)
        infos.append((dt, off, tuple(leaf.shape)))
        offsets[dt] = off + leaf.numel()
    sizes = {dt: (orig, -(-orig // n_shards) * n_shards)
             for dt, orig in offsets.items()}
    return DpFlatSpec(tree, infos, sizes, n_shards, axis)


def dp_ravel(tree, n_shards: int, spec: DpFlatSpec = None):
    """Ravel ``tree`` to ``{dtype key: flat padded vector}``, zero padded
    (a zero gradient and zero state leave a pad slot at zero under every
    updater here; :func:`dp_unravel` drops the pads). Returns ``(flats,
    spec)``."""
    if spec is None:
        spec = dp_flatten_spec(tree, n_shards)
    parts: Dict[str, list] = {}
    for leaf, (dt, _, _) in zip(_leaves(tree), spec.infos):
        parts.setdefault(dt, []).append(leaf.reshape(-1))
    flats = {}
    for dt, chunks in parts.items():
        orig, padded = spec.sizes[dt]
        if padded != orig:
            chunks.append(chunks[0].new_zeros(padded - orig))
        flats[dt] = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
    return flats, spec


def dp_unravel(flats: Dict[str, torch.Tensor], spec: DpFlatSpec):
    """Inverse of :func:`dp_ravel` (padding dropped). Only offsets and
    shapes are read, so vectors padded for another shard count unravel
    too."""
    leaves = [flats[dt][off:off + math.prod(shape)].reshape(shape)
              for dt, off, shape in spec.infos]
    return _unflatten(spec.structure, iter(leaves))

_ADAM_LIKE = {"learning_rate": 1e-3, "beta1": 0.9, "beta2": 0.999,
              "epsilon": 1e-8}
#: class name -> hyperparameters with their defaults, in field order
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "NoOp": {},
    "Sgd": {"learning_rate": 1e-3},
    "Nesterovs": {"learning_rate": 0.1, "momentum": 0.9},
    "Adam": dict(_ADAM_LIKE),
    "AdaMax": dict(_ADAM_LIKE),
    "Nadam": dict(_ADAM_LIKE),
    "AMSGrad": dict(_ADAM_LIKE),
    "AdaGrad": {"learning_rate": 1e-1, "epsilon": 1e-6},
    "AdaDelta": {"rho": 0.95, "epsilon": 1e-6, "learning_rate": 1.0},
    "RmsProp": {"learning_rate": 1e-3, "rms_decay": 0.95, "epsilon": 1e-8},
}
#: class name -> its state slots
SLOTS = {"NoOp": (), "Sgd": (), "Nesterovs": ("v",), "Adam": ("m", "v"),
         "AdaMax": ("m", "u"), "Nadam": ("m", "v"),
         "AMSGrad": ("m", "v", "vmax"), "AdaGrad": ("G",),
         "AdaDelta": ("Eg", "Edx"), "RmsProp": ("Eg",)}


class IUpdater:
    """An updater: ``kind`` (the ``@class`` name) and its
    hyperparameters, defaults filled in."""

    def __init__(self, kind: str, **hyper: Any):
        if kind not in DEFAULTS:
            raise ValueError(f"unknown updater {kind!r} (one of "
                             f"{sorted(DEFAULTS)})")
        unknown = set(hyper) - set(DEFAULTS[kind])
        if unknown:
            raise TypeError(f"{kind} has no hyperparameters "
                            f"{sorted(unknown)}")
        self.kind = kind
        # a schedule may come as its JSON map
        self.hyper: Dict[str, Any] = {**DEFAULTS[kind], **{
            k: ISchedule.from_map(v) if isinstance(v, dict) else v
            for k, v in hyper.items()}}

    def to_map(self) -> dict:
        return {"@class": self.kind,
                **{k: v.to_map() if isinstance(v, ISchedule) else v
                   for k, v in self.hyper.items()}}

    @staticmethod
    def from_map(d: dict) -> "IUpdater":
        d = dict(d)
        return IUpdater(d.pop("@class"), **d)

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in self.hyper.items())
        return f"{self.kind}({args})"

    # -- math ------------------------------------------------------------
    def lr_at(self, iteration: int, epoch: int = 0) -> float:
        """The learning rate at ``iteration`` / ``epoch``: the number,
        or the schedule's value there."""
        lr = self.hyper.get("learning_rate")
        if isinstance(lr, ISchedule):
            return lr.value_at(iteration, epoch)
        return float(lr)

    def init_state(self, params: _Tree) -> Dict[str, _Tree]:
        return {slot: {n: torch.zeros_like(p) for n, p in params.items()}
                for slot in SLOTS[self.kind]}

    def apply(self, grads: _Tree, state: Dict[str, _Tree], iteration: int,
              epoch: int = 0) -> Tuple[_Tree, Dict[str, _Tree]]:
        """``(updates_to_subtract, new_state)`` for one layer."""
        lr = self.lr_at(iteration, epoch) if "learning_rate" in self.hyper \
            else None
        return _MATH[self.kind](self, grads, state, iteration, lr)


def _tmap(fn: Callable, *trees: _Tree) -> _Tree:
    return {n: fn(*(t[n] for t in trees)) for n in trees[0]}


def _noop(u, grads, state, it, lr):
    return _tmap(torch.zeros_like, grads), state


def _sgd(u, grads, state, it, lr):
    return _tmap(lambda g: lr * g, grads), state


def _nesterovs(u, grads, state, it, lr):
    # v' = mu*v - lr*g; update = lr*g - mu*v' (the reference's
    # params += mu*v' - lr*g, as a quantity to subtract)
    mu = u.hyper["momentum"]
    v = _tmap(lambda v_, g: mu * v_ - lr * g, state["v"], grads)
    return _tmap(lambda vn, g: lr * g - mu * vn, v, grads), {"v": v}


def _bias_corrections(u, it):
    t = float(it) + 1.0
    return 1.0 - u.hyper["beta1"] ** t, 1.0 - u.hyper["beta2"] ** t


def _moments(u, grads, state):
    b1, b2 = u.hyper["beta1"], u.hyper["beta2"]
    m = _tmap(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = _tmap(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
    return m, v


def _adam(u, grads, state, it, lr):
    eps = u.hyper["epsilon"]
    m, v = _moments(u, grads, state)
    bc1, bc2 = _bias_corrections(u, it)
    upd = _tmap(lambda m_, v_: lr * (m_ / bc1) /
                (torch.sqrt(v_ / bc2) + eps), m, v)
    return upd, {"m": m, "v": v}


def _adamax(u, grads, state, it, lr):
    eps = u.hyper["epsilon"]
    b1, b2 = u.hyper["beta1"], u.hyper["beta2"]
    m = _tmap(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    uu = _tmap(lambda u_, g: torch.maximum(b2 * u_, torch.abs(g)),
               state["u"], grads)
    bc1, _ = _bias_corrections(u, it)
    upd = _tmap(lambda m_, u_: lr * m_ / (bc1 * (u_ + eps)), m, uu)
    return upd, {"m": m, "u": uu}


def _nadam(u, grads, state, it, lr):
    eps, b1 = u.hyper["epsilon"], u.hyper["beta1"]
    m, v = _moments(u, grads, state)
    bc1, bc2 = _bias_corrections(u, it)
    upd = _tmap(lambda m_, v_, g: lr / (torch.sqrt(v_ / bc2) + eps) *
                (b1 * m_ / bc1 + (1 - b1) * g / bc1), m, v, grads)
    return upd, {"m": m, "v": v}


def _amsgrad(u, grads, state, it, lr):
    eps = u.hyper["epsilon"]
    m, v = _moments(u, grads, state)
    vmax = _tmap(torch.maximum, state["vmax"], v)
    bc1, bc2 = _bias_corrections(u, it)
    # reference AMSGradUpdater: alpha_t = lr*sqrt(1-b2^t)/(1-b1^t)
    alpha_t = lr * math.sqrt(bc2) / bc1
    upd = _tmap(lambda m_, vm: alpha_t * m_ / (torch.sqrt(vm) + eps),
                m, vmax)
    return upd, {"m": m, "v": v, "vmax": vmax}


def _adagrad(u, grads, state, it, lr):
    eps = u.hyper["epsilon"]
    G = _tmap(lambda G_, g: G_ + g * g, state["G"], grads)
    upd = _tmap(lambda G_, g: lr * g / (torch.sqrt(G_) + eps), G, grads)
    return upd, {"G": G}


def _adadelta(u, grads, state, it, lr):
    rho, eps = u.hyper["rho"], u.hyper["epsilon"]
    Eg = _tmap(lambda e, g: rho * e + (1 - rho) * g * g, state["Eg"], grads)
    dx = _tmap(lambda e, edx, g: torch.sqrt(edx + eps) /
               torch.sqrt(e + eps) * g, Eg, state["Edx"], grads)
    Edx = _tmap(lambda edx, d: rho * edx + (1 - rho) * d * d,
                state["Edx"], dx)
    return dx, {"Eg": Eg, "Edx": Edx}


def _rmsprop(u, grads, state, it, lr):
    rho, eps = u.hyper["rms_decay"], u.hyper["epsilon"]
    Eg = _tmap(lambda e, g: rho * e + (1 - rho) * g * g, state["Eg"], grads)
    upd = _tmap(lambda e, g: lr * g / (torch.sqrt(e) + eps), Eg, grads)
    return upd, {"Eg": Eg}


_MATH = {"NoOp": _noop, "Sgd": _sgd, "Nesterovs": _nesterovs,
         "Adam": _adam, "AdaMax": _adamax, "Nadam": _nadam,
         "AMSGrad": _amsgrad, "AdaGrad": _adagrad, "AdaDelta": _adadelta,
         "RmsProp": _rmsprop}


def _factory(kind: str):
    names = tuple(DEFAULTS[kind])

    def make(*args, **kw) -> IUpdater:
        if len(args) > len(names):
            raise TypeError(f"{kind} takes at most {len(names)} "
                            f"positional arguments")
        return IUpdater(kind, **dict(zip(names, args)), **kw)
    make.__name__ = kind
    make.__doc__ = (f"The JAX package's {kind}; positional arguments in "
                    f"the order {names}.")
    return make


NoOp = _factory("NoOp")
Sgd = _factory("Sgd")
Nesterovs = _factory("Nesterovs")
Adam = _factory("Adam")
AdaMax = _factory("AdaMax")
Nadam = _factory("Nadam")
AMSGrad = _factory("AMSGrad")
AdaGrad = _factory("AdaGrad")
AdaDelta = _factory("AdaDelta")
RmsProp = _factory("RmsProp")
