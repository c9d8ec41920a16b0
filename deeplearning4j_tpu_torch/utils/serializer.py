"""Model checkpoint serialization, compatible with the JAX package's zips.

Counterpart of ``deeplearning4j_tpu/utils/serializer.py``: the same zip
entries (``configuration.json``, ``coefficients.npz``,
``updaterState.npz``, ``modelState.npz``, ``meta.json``) with the same
flat ``"<vertex>/<name>"`` npz keys, so a zip either package writes
restores in the other.

Weights cross at this boundary: the JAX package keeps conv kernels HWIO
and the port OIHW (:func:`params_from_jax` / :func:`params_to_jax`, for
a ComputationGraph's vertices or a MultiLayerNetwork's ``layer_<i>``);
dense ``W`` stays ``[n_in, n_out]``, and the recurrent leaves (``W``,
``RW``, ``b``, ``pI``, ``pF``, ``pO``) cross with no layout change; a
Bidirectional layer's nested ``fwd``/``bwd`` trees become the port's
``"fwd/W"``-style names. BatchNormalization ``mean``/``var``
come from ``modelState.npz``. Updater state crosses the same way
(:func:`updater_state_from_jax` / :func:`updater_state_to_jax`: each
slot of a conv kernel moves between HWIO and OIHW). BERT's trees
(``conf`` a ``BertConfig``: ``embeddings``, ``encoder`` stacked
``[L, ...]``, ``pooler``, ``mlm``, ``nsp``, or ``bert``/``cls`` for the
classifier) cross as they are: both packages compute ``x @ W`` with
``[in, out]`` weights, so no layout converts; their updater state is
``{slot: {"group/name": tensor}}`` in the port and ``{slot: tree}`` in
the JAX package. ``DecoderLM``'s two-level tree (``conf`` a
``DecoderConfig``: ``embed``, ``layer_<i>``, ``head``) crosses the same
way, leaf names and shapes checked. The distributed Transformer LM's
global tree (:func:`transformer_params_from_jax`, with its updater state)
crosses as it is too.

The encoded exchange's error-feedback state (``ENCODED_KEY``: the
residual in the parameters' layout, with tau, step and sparsity) crosses
beside the updater's slots under the JAX package's keys
(``"<key>/__encoded__/residual/<name>"``). ``write_model`` writes the
dense layout whatever the model's residency (``dense_params``,
``dense_updater_states``).

``restore_model`` restores ComputationGraph and MultiLayerNetwork zips,
every leaf's name and shape checked against the configuration's, and
reads ``updaterState.npz`` back when present, so training resumes where
it stopped; ``write_model`` writes it. A SameDiff zip (one with a
``graph.json``) restores through ``SameDiff.load``.
"""
from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.learning.updaters import ENCODED_KEY
from deeplearning4j_tpu_torch.models.bert import (BertConfig, flatten_tree,
                                                 unflatten_tree)
from deeplearning4j_tpu_torch.models.decoder import DecoderConfig
from deeplearning4j_tpu_torch.nn.conf.builders import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import ConvolutionLayer

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.npz"
UPDATER_ENTRY = "updaterState.npz"
STATE_ENTRY = "modelState.npz"
META_ENTRY = "meta.json"

_Tree = Dict[str, Dict[str, torch.Tensor]]
_Conf = Union[ComputationGraphConfiguration, MultiLayerConfiguration,
              BertConfig, DecoderConfig]


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested ``{key: {...: array}}`` tree, or an already-flat
    ``{"a/b": array}`` dict, as flat ``{"a/b": ndarray}``; empty
    containers (a stateless updater's ``()``) hold nothing."""
    if isinstance(tree, dict):
        flat = {}
        for k in tree:
            flat.update(_flatten(tree[k], f"{prefix}{k}/"))
        return flat
    if isinstance(tree, (list, tuple)):
        return {}
    return {prefix[:-1]: np.asarray(tree)}


def _keys(conf: _Conf):
    if isinstance(conf, MultiLayerConfiguration):
        return [f"layer_{i}" for i in range(len(conf.layers))]
    return list(conf.vertices)


def _is_conv_kernel(conf: _Conf, key: str, name: str) -> bool:
    if name != "W":
        return False
    if isinstance(conf, MultiLayerConfiguration):
        layer = conf.layers[int(key.split("_")[1])]
    else:
        layer = conf.vertices[key].content
    return isinstance(layer, ConvolutionLayer)


def _split_key(conf: _Conf, flat: Dict[str, np.ndarray]):
    """Yield ``(key, path, name, array)`` for each flat entry
    ``"key/path.../name"``, checking that ``key`` is the configuration's."""
    keys = set(_keys(conf))
    for full, a in flat.items():
        key, *path, name = full.split("/")
        if key not in keys:
            raise ValueError(f"checkpoint entry {full!r} names no vertex "
                             f"or layer of the configuration")
        yield key, path, name, a


def _to_port(conf, key, name, a) -> torch.Tensor:
    if _is_conv_kernel(conf, key, name):
        a = np.transpose(a, (3, 2, 0, 1))             # HWIO -> OIHW
    return torch.from_numpy(np.array(a))


def _to_jax(conf, key, name, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if _is_conv_kernel(conf, key, name):
        a = np.transpose(a, (2, 3, 1, 0))             # OIHW -> HWIO
    return np.ascontiguousarray(a)


def bert_param_shapes(conf: BertConfig) -> Dict[str, tuple]:
    """``{"group/name": shape}`` of a BERT pretraining model's tree."""
    c = conf
    H, L, I, V = (c.hidden_size, c.num_hidden_layers, c.intermediate_size,
                  c.vocab_size)
    shapes = {"embeddings/word": (V, H),
              "embeddings/position": (c.max_position_embeddings, H),
              "embeddings/token_type": (c.type_vocab_size, H),
              "embeddings/ln_g": (H,), "embeddings/ln_b": (H,),
              "pooler/W": (H, H), "pooler/b": (H,),
              "mlm/W": (H, H), "mlm/b": (H,), "mlm/ln_g": (H,),
              "mlm/ln_b": (H,), "mlm/out_b": (V,),
              "nsp/W": (H, 2), "nsp/b": (2,)}
    for n in ("Wq", "Wk", "Wv", "Wo"):
        shapes[f"encoder/{n}"] = (L, H, H)
    for n in ("bq", "bk", "bv", "bo", "attn_ln_g", "attn_ln_b", "bout",
              "out_ln_g", "out_ln_b"):
        shapes[f"encoder/{n}"] = (L, H)
    shapes.update({"encoder/Wi": (L, H, I), "encoder/bi": (L, I),
                   "encoder/Wout": (L, I, H)})
    return shapes


def _check_bert_leaf(conf: BertConfig, path: str, a) -> None:
    """``path`` names a leaf of the pretraining tree, or of the
    classifier's (``bert/...`` and ``cls/W``, ``cls/b``), with its
    shape."""
    shapes = bert_param_shapes(conf)
    if path.startswith("cls/"):
        if path not in ("cls/W", "cls/b"):
            raise ValueError(f"BERT entry {path!r} is not a leaf of the "
                             f"classifier head")
        return
    inner = path[len("bert/"):] if path.startswith("bert/") else path
    if inner not in shapes:
        raise ValueError(f"BERT entry {path!r} names no leaf of the "
                         f"configuration's tree")
    if tuple(np.shape(a)) != shapes[inner]:
        raise ValueError(f"BERT entry {path!r} has shape "
                         f"{tuple(np.shape(a))}, the configuration's is "
                         f"{shapes[inner]}")


def decoder_param_shapes(conf: DecoderConfig) -> Dict[str, tuple]:
    """``{"entry/leaf": shape}`` of a ``DecoderLM``'s tree."""
    c = conf
    d, f, v = c.d_model, c.d_ff, c.vocab_size
    shapes = {"embed/tok": (v, d), "embed/pos": (c.max_len, d),
              "head/ln_g": (d,), "head/ln_b": (d,), "head/w": (d, v)}
    layer = {"ln1_g": (d,), "ln1_b": (d,), "wq": (d, d), "wk": (d, d),
             "wv": (d, d), "wo": (d, d), "ln2_g": (d,), "ln2_b": (d,),
             "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}
    for i in range(c.n_layers):
        shapes.update({f"layer_{i}/{n}": s for n, s in layer.items()})
    return shapes


def _check_tree(shapes: Dict[str, tuple], flat: Dict[str, np.ndarray],
                what: str) -> None:
    """``flat`` holds exactly the leaves of ``shapes``, each with its
    shape."""
    for path, a in flat.items():
        if path not in shapes:
            raise ValueError(f"{what} entry {path!r} names no leaf of the "
                             f"configuration's tree")
        if tuple(np.shape(a)) != shapes[path]:
            raise ValueError(f"{what} entry {path!r} has shape "
                             f"{tuple(np.shape(a))}, the configuration's "
                             f"is {shapes[path]}")
    missing = sorted(set(shapes) - set(flat))
    if missing:
        raise ValueError(f"{what} tree lacks {missing}")


def params_from_jax(params_np: dict, states_np: dict, conf: _Conf
                    ) -> Tuple[_Tree, _Tree]:
    """The JAX package's numpy trees (flat npz keys or nested by vertex
    or ``layer_<i>``) as the port's CPU tensors: conv kernels HWIO ->
    OIHW, the rest as they are. For a ``BertConfig``: the nested BERT
    tree, checked leaf by leaf, and no states; for a ``DecoderConfig``
    the same with ``DecoderLM``'s two-level tree."""
    if isinstance(conf, DecoderConfig):
        flat = _flatten(params_np)
        _check_tree(decoder_param_shapes(conf), flat, "decoder")
        return unflatten_tree({p: torch.from_numpy(np.array(a))
                               for p, a in flat.items()}), {}
    if isinstance(conf, BertConfig):
        flat = _flatten(params_np)
        for path, a in flat.items():
            _check_bert_leaf(conf, path, a)
        return unflatten_tree({p: torch.from_numpy(np.array(a))
                               for p, a in flat.items()}), {}
    params: _Tree = {k: {} for k in _keys(conf)}
    for key, path, name, a in _split_key(conf, _flatten(params_np)):
        params[key]["/".join(path + [name])] = _to_port(conf, key, name, a)
    states: _Tree = {k: {} for k in _keys(conf)}
    for key, path, name, a in _split_key(conf, _flatten(states_np)):
        states[key]["/".join(path + [name])] = torch.from_numpy(np.array(a))
    return params, states


def params_to_jax(params: _Tree, conf: _Conf) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax` for parameters: flat npz
    keys, conv kernels OIHW -> HWIO."""
    if isinstance(conf, DecoderConfig):
        flat = {p: np.ascontiguousarray(t.detach().cpu().numpy())
                for p, t in sorted(flatten_tree(params).items())}
        _check_tree(decoder_param_shapes(conf), flat, "decoder")
        return flat
    if isinstance(conf, BertConfig):
        return {p: np.ascontiguousarray(t.detach().cpu().numpy())
                for p, t in sorted(flatten_tree(params).items())}
    return {f"{key}/{name}": _to_jax(conf, key, name, params[key][name])
            for key in sorted(params) for name in sorted(params[key])}


def updater_state_from_jax(upd_np: dict, conf: _Conf
                           ) -> Dict[str, Dict[str, _Tree]]:
    """The JAX package's updater state (``{key: {slot: {name: array}}}``
    nested, or flat ``"key/slot/name"`` npz keys) as the port's
    ``{key: {slot: {name: tensor}}}``: each slot of a conv kernel HWIO ->
    OIHW. For a ``BertConfig``: ``{slot: tree}`` (nested or flat
    ``"slot/group/name"``) as ``{slot: {"group/name": tensor}}``."""
    if isinstance(conf, BertConfig):
        bert: Dict[str, Dict[str, torch.Tensor]] = {}
        for full, a in _flatten(upd_np).items():
            slot, path = full.split("/", 1)
            _check_bert_leaf(conf, path, a)
            bert.setdefault(slot, {})[path] = torch.from_numpy(np.array(a))
        return bert
    out: Dict[str, Dict[str, _Tree]] = {k: {} for k in _keys(conf)}
    for key, path, name, a in _split_key(conf, _flatten(upd_np)):
        slot, *sub = path
        if slot == ENCODED_KEY:
            # the encoded rung's state: the residual in the parameters'
            # layout, and the scalars tau, step and sparsity
            enc = out[key].setdefault(ENCODED_KEY, {})
            if sub:
                enc.setdefault(sub[0], {})[name] = \
                    _to_port(conf, key, name, a)
            else:
                enc[name] = torch.from_numpy(np.array(a))
            continue
        out[key].setdefault(slot, {})["/".join(sub + [name])] = \
            _to_port(conf, key, name, a)
    return out


def updater_state_to_jax(upd: Dict[str, Dict[str, _Tree]], conf: _Conf
                         ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`updater_state_from_jax`: flat
    ``"key/slot/name"`` keys, conv kernel slots OIHW -> HWIO; for a
    ``BertConfig``, ``"slot/group/name"``."""
    if isinstance(conf, BertConfig):
        return {f"{slot}/{p}": np.ascontiguousarray(t.detach().cpu().numpy())
                for slot in sorted(upd) for p, t in sorted(upd[slot].items())}
    out = {}
    for key in sorted(upd):
        for slot in sorted(upd[key]):
            for name, t in sorted(upd[key][slot].items()):
                if isinstance(t, dict):         # the encoded residual
                    for n, leaf in sorted(t.items()):
                        out[f"{key}/{slot}/{name}/{n}"] = _to_jax(
                            conf, key, n, leaf)
                else:
                    out[f"{key}/{slot}/{name}"] = _to_jax(conf, key, name,
                                                          t)
    return out


def _jax_tree_to_port(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree_to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jax_tree_to_port(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def transformer_params_from_jax(params_np: dict) -> dict:
    """The JAX ``DistributedTransformerLM``'s global parameter tree
    (``init_global_params`` or a gathered step's, numpy or jax arrays:
    ``embed``, ``pos``, ``stages`` a list of stage-stacked block trees,
    ``ln_f_g``, ``ln_f_b``, ``head``) as the port's global tree of CPU
    tensors. Both packages compute ``x @ W`` with ``[in, out]`` weights
    and stack stages on the leading dimension, so no layout converts."""
    missing = {"embed", "pos", "stages", "ln_f_g", "ln_f_b", "head"} - \
        set(params_np)
    if missing:
        raise ValueError(f"transformer tree lacks {sorted(missing)}")
    return _jax_tree_to_port(params_np)


def transformer_state_from_jax(state_np) -> dict:
    """The JAX model's updater state (``()`` for a stateless updater, or
    ``{slot: params-shaped tree}``) as the port's ``{slot: tree}``."""
    if isinstance(state_np, tuple) and state_np == ():
        return {}
    return {slot: transformer_params_from_jax(tree)
            for slot, tree in state_np.items()}


def _check_leaves(want: dict, got: dict, what: str,
                  exact: bool = False) -> None:
    """Every leaf of ``got`` (``{key: {name: tensor}}``) is one of
    ``want``'s with its shape; with ``exact``, none of ``want``'s is
    missing either."""
    for key, sub in got.items():
        for n, t in sub.items():
            if n not in want.get(key, {}):
                raise ValueError(f"{what}: {key}/{n} is not a leaf of the "
                                 f"configuration")
            if tuple(t.shape) != tuple(want[key][n].shape):
                raise ValueError(
                    f"{what}: {key}/{n} has shape {tuple(t.shape)}, the "
                    f"configuration's is {tuple(want[key][n].shape)}")
    if exact:
        missing = [f"{k}/{n}" for k, sub in want.items() for n in sub
                   if n not in got.get(k, {})]
        if missing:
            raise ValueError(f"{what} lacks {missing[:5]}")


def _read_npz(zf: zipfile.ZipFile, name: str) -> dict:
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        return {k: data[k] for k in data.files}


def _write_npz(zf: zipfile.ZipFile, name: str, flat: dict):
    buf = io.BytesIO()
    np.savez(buf, **flat)
    zf.writestr(name, buf.getvalue())


class ModelSerializer:
    @staticmethod
    def peek_meta(path) -> dict:
        with zipfile.ZipFile(Path(path)) as zf:
            names = zf.namelist()
            meta = json.loads(zf.read(META_ENTRY).decode()) \
                if META_ENTRY in names else {}
            if "model_class" not in meta:
                meta["model_class"] = ("SameDiff" if "graph.json" in names
                                       else "MultiLayerNetwork")
        return meta

    @staticmethod
    def restore_model(path, device: Union[None, str, torch.device] = None,
                      load_updater: bool = True):
        """Restore a ComputationGraph, MultiLayerNetwork or SameDiff zip
        onto ``device`` (``None``: the card, raising when there is none),
        with its updater state when ``load_updater`` and the zip holds
        one."""
        from deeplearning4j_tpu_torch.common.environment import \
            resolve_device
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import \
            MultiLayerNetwork
        device = resolve_device(device)
        cls = ModelSerializer.peek_meta(path).get("model_class")
        if cls == "SameDiff":
            from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
            sd = SameDiff.load(str(path), device=device)
            if not load_updater:
                sd._loaded_updater_leaves = None
            return sd
        if cls == "ComputationGraph":
            conf_cls, net_cls = ComputationGraphConfiguration, \
                ComputationGraph
        elif cls == "MultiLayerNetwork":
            conf_cls, net_cls = MultiLayerConfiguration, MultiLayerNetwork
        else:
            raise NotImplementedError(
                f"restoring a {cls} is not ported yet (the port restores "
                f"ComputationGraph, MultiLayerNetwork and SameDiff zips)")
        with zipfile.ZipFile(Path(path)) as zf:
            names = zf.namelist()
            conf = conf_cls.from_json(zf.read(CONFIG_ENTRY).decode())
            states_np = (_read_npz(zf, STATE_ENTRY)
                         if STATE_ENTRY in names else {})
            params, states = params_from_jax(
                _read_npz(zf, COEFFICIENTS_ENTRY), states_np, conf)
            upd_np = (_read_npz(zf, UPDATER_ENTRY)
                      if load_updater and UPDATER_ENTRY in names else None)
            meta = json.loads(zf.read(META_ENTRY).decode()) \
                if META_ENTRY in names else {}
        # the configuration's own leaves, from a CPU initialisation
        template = net_cls(conf).init("cpu")
        _check_leaves(template.params, params, "coefficients",
                      exact=True)
        _check_leaves(template.states, states, "model state")
        states = {k: {**template.states[k], **states[k]}
                  for k in template.states}
        net = net_cls(conf).set_params(params, states, device)
        if upd_np is not None:
            upd = updater_state_from_jax(upd_np, conf)
            for key, slots in upd.items():
                enc = slots.pop(ENCODED_KEY, None)
                _check_leaves(template.updater_states[key], slots,
                              f"updater state of {key}")
                for slot, leaves in slots.items():
                    for n, t in leaves.items():
                        net.updater_states[key][slot][n] = t.to(device)
                if enc is not None:
                    # the encoded rung's error-feedback state, which a
                    # fresh network's updater state has no slot for
                    _check_leaves({key: template.params[key]},
                                  {key: enc.get("residual", {})},
                                  f"encoded residual of {key}", exact=True)
                    net.updater_states[key][ENCODED_KEY] = {
                        n: ({r: t.to(device) for r, t in v.items()}
                            if isinstance(v, dict) else v.to(device))
                        for n, v in enc.items()}
        net.iteration_count = meta.get("iteration_count", 0)
        net.epoch_count = meta.get("epoch_count", 0)
        return net

    @staticmethod
    def write_model(model, path, save_updater: bool = True):
        """Write ``model`` (a ComputationGraph or MultiLayerNetwork) as a
        zip the JAX package restores. With ``save_updater`` (the default,
        as in the reference) the updater state goes into
        ``updaterState.npz`` in the reference's layout, so training
        resumes where it stopped."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        states = {f"{k}/{n}": t.detach().cpu().numpy()
                  for k, sub in sorted(model.states.items())
                  for n, t in sorted(sub.items())}
        # the dense layout whatever the residency (under fsdp or a
        # flat tail a gather: every replica of the mesh writes), so the
        # zip restores on any replica count
        params = model.dense_params()
        upd = model.dense_updater_states() if save_updater else None
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(CONFIG_ENTRY, model.conf.to_json())
            _write_npz(zf, COEFFICIENTS_ENTRY,
                       params_to_jax(params, model.conf))
            _write_npz(zf, STATE_ENTRY, states)
            if save_updater:
                _write_npz(zf, UPDATER_ENTRY,
                           updater_state_to_jax(upd, model.conf))
            zf.writestr(META_ENTRY, json.dumps({
                "model_class": type(model).__name__,
                "iteration_count": model.iteration_count,
                "epoch_count": model.epoch_count,
                "format_version": 1,
            }))
