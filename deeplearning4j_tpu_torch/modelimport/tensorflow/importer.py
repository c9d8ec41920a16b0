"""Frozen TF GraphDef → SameDiff importer.

Counterpart of ``deeplearning4j_tpu/modelimport/tensorflow/importer.py``
(reference: ``TensorflowFrameworkImporter.runImport`` / ``ImportGraph``
in ``samediff-import-tensorflow``, and the legacy ``TFGraphMapper``).

The importer (a) constant-folds the GraphDef's shape-arithmetic chains
(Shape → StridedSlice → Pack → Reshape) with numpy, propagating static
shapes through every emitted op by running it on ``device="meta"``
tensors (shapes and dtypes only: no weight is copied, no kernel runs),
and (b) emits into the SameDiff op list, which runs on the graph's
device. After import the GraphOptimizer runs (``optimize=None``: on
unless ``DL4J_TORCH_GRAPHOPT=0``).

Control flow: functional ``While`` / ``StatelessWhile`` / ``If`` /
``StatelessIf`` import their library bodies into
``SameDiff.while_loop`` / ``cond``; the legacy v1 frames
(``Enter``/``Exit``/``Merge``/``Switch``/``NextIteration``) are first
rebuilt into that form (``v1_control_flow.deframe``). A static-size
TensorList (the TF2 ``tf.TensorArray``) is a dense ``[n, *element]``
tensor carried through the loop. ``while_max_iterations`` (an int, or a
dict by While node or TF loop name) bounds the loops, which makes them
differentiable; without it a loop reads its condition on the host each
trip and serves the forward only.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.registry import dtype_name, get_op
from deeplearning4j_tpu_torch.autodiff.samediff import (SameDiff,
                                                        SDVariable,
                                                        canonical_dtype)
from deeplearning4j_tpu_torch.modelimport.tensorflow import (
    mappings, v1_control_flow)
from deeplearning4j_tpu_torch.modelimport.tensorflow.mappings import \
    TF_OP_MAP
from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import (
    Attr, FunctionDef, NodeDef, parse_graphdef_with_library, tf_dtype_to_np)


class _Aval(NamedTuple):
    """A value's static shape and dtype (torch)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


_SKIP_OPS = {"NoOp", "Assert", "SaveV2", "RestoreV2", "MergeV2Checkpoints"}

#: functional control-flow ops (bodies in the GraphDef function library)
_FUNCTIONAL_OPS = {"While", "StatelessWhile", "If", "StatelessIf"}


def _canon(ref: str) -> str:
    """TF input ref → canonical var name ('x:0' == 'x'; '^x' is a
    control dep on x)."""
    if ref.startswith("^"):
        ref = ref[1:]
    if ref.endswith(":0"):
        ref = ref[:-2]
    return ref


def _node_of(ref: str) -> str:
    ref = _canon(ref)
    return ref.split(":")[0]


#: output-arg order of mapped multi-output TF ops: a function body names
#: an output by port ('node:indices:0'), the importer binds flat indices.
#: Single-output ops and ops with one repeated output arg need no entry.
_TF_MULTI_OUT_ARGS = {
    "TopKV2": ["values", "indices"],
    "Unique": ["y", "idx"],
    "UniqueV2": ["y", "idx"],
    "FusedBatchNorm": ["y", "batch_mean", "batch_variance",
                       "reserve_space_1", "reserve_space_2"],
    "FusedBatchNormV2": ["y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2"],
    "FusedBatchNormV3": ["y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2",
                         "reserve_space_3"],
    "SoftmaxCrossEntropyWithLogits": ["loss", "backprop"],
    "SparseSoftmaxCrossEntropyWithLogits": ["loss", "backprop"],
}


def _canon_func_ref(ref: str, producer_ops: Optional[dict] = None
                    ) -> str:
    """A function-body tensor ref (``node:out_arg_name:idx``) in the
    graph's style (``node`` for flat port 0, ``node:i`` otherwise);
    ``producer_ops`` (node name -> TF op) turns a named port of a
    multi-output op into its flat offset."""
    if ref.startswith("^"):
        return ref
    parts = ref.split(":")
    if len(parts) == 3:
        node, port, idx = parts
        flat = int(idx)
        op_name = (producer_ops or {}).get(node)
        args = _TF_MULTI_OUT_ARGS.get(op_name)
        if args is not None:
            if port not in args:
                raise NotImplementedError(
                    f"TF import: unknown output port '{port}' of "
                    f"{op_name} node '{node}'")
            flat += args.index(port)
        return node if flat == 0 else f"{node}:{flat}"
    if len(parts) == 2 and not parts[1].isdigit():
        return parts[0]
    return ref


class _Ctx:
    """Mapping context handed to each TF_OP_MAP rule (the attr/tensor
    adapter surface of the reference's MappingProcess)."""

    def __init__(self, importer: "GraphDefImporter"):
        self._imp = importer
        self.sd = importer.sd

    def var(self, ref: str) -> SDVariable:
        return self._imp._materialize(_canon(ref))

    def static(self, ref: str) -> Optional[np.ndarray]:
        return self._imp.static_values.get(_canon(ref))

    def require_static(self, node: NodeDef, i: int) -> np.ndarray:
        ref = _canon(node.inputs[i])
        val = self._imp.static_values.get(ref)
        if val is None:
            raise ValueError(
                f"TF import: input {i} ('{ref}') of node "
                f"'{node.name}' ({node.op}) must be statically known — "
                f"provide concrete input_shapes so shape chains fold")
        return val


class GraphDefImporter:
    """One-shot importer for a frozen (inference) GraphDef."""

    def __init__(self, graph_def, input_shapes: Optional[dict] = None,
                 while_max_iterations=None,
                 outputs: Optional[List[str]] = None, device=None):
        if isinstance(graph_def, (str, os.PathLike)):
            with open(graph_def, "rb") as fh:
                graph_def = fh.read()
        self.functions: Dict[str, FunctionDef] = {}
        if isinstance(graph_def, (bytes, bytearray, memoryview)):
            self.nodes, self.functions = parse_graphdef_with_library(
                graph_def)
        else:                        # already a parsed NodeDef list
            self.nodes = list(graph_def)
        self.input_shapes = {k: tuple(v) for k, v in
                             (input_shapes or {}).items()}
        #: int (every loop) or {While node or TF loop name: int}: the
        #: bounded, differentiable lowering of the imported loops; None
        #: leaves them unbounded (forward only)
        self.while_max_iterations = while_max_iterations
        self.sd = SameDiff(device)
        self.static_values: Dict[str, np.ndarray] = {}
        self.var_map: Dict[str, SDVariable] = {}
        self.avals: Dict[str, _Aval] = {}
        self.placeholders: List[str] = []
        #: requested fetches; None = infer terminals after import.
        #: ':0' normalizes to the bare name (var_map keys the FIRST
        #: output bare, 'name:i' for the rest — see _bind)
        self.requested_outputs = (
            [o[:-2] if o.endswith(":0") else o for o in outputs]
            if outputs else None)
        self.outputs: List[str] = []

    # -- name/value plumbing ------------------------------------------
    def _materialize(self, name: str) -> SDVariable:
        v = self.var_map.get(name)
        if v is not None:
            return v
        if name in self.static_values:
            arr = self.static_values[name]
            if arr.dtype == object:
                raise ValueError(f"string tensor '{name}' cannot be a "
                                 f"graph input")
            c = self.sd.constant(name, arr)
            if c.name != name:       # name collided with an sd-internal
                raise RuntimeError(f"constant name collision: {name}")
            self.var_map[name] = c
            self.avals[name] = _Aval(tuple(arr.shape),
                                     canonical_dtype(arr.dtype))
            return c
        raise KeyError(f"TF import: reference to unknown tensor "
                       f"'{name}'")

    def _bind(self, node: NodeDef, result, start_idx: int):
        """Attach mapping result vars to 'name', 'name:1', …"""
        if result is None:
            return
        outs = (list(result) if isinstance(result, (list, tuple))
                else [result])
        for i, v in enumerate(outs):
            target = node.name if i == 0 else f"{node.name}:{i}"
            if not isinstance(v, SDVariable):
                raise TypeError(f"mapping for {node.op} returned "
                                f"{type(v)}")
            if v.name in self.var_map:
                # passthrough of an already-bound tensor (constant
                # splat &c): alias the TF name to it, keep the var
                self.var_map[target] = v
                if v.name in self.avals:
                    self.avals[target] = self.avals[v.name]
            else:
                if v.name != target:
                    self._rename_local(v, target, start_idx)
                self.var_map[target] = v

    def _rename_local(self, v: SDVariable, new: str, start_idx: int):
        """Rename a var created by THIS mapping rule. Only ops emitted
        since start_idx can reference it, so the rewrite is O(ops in
        this rule) — not SameDiff._rename's whole-graph scan (which
        would make a 2000-node BERT import quadratic)."""
        sd = self.sd
        old = v.name
        if new in sd.vars:
            raise ValueError(f"variable '{new}' already exists")
        sd.vars.pop(old)
        v.name = new
        sd.vars[new] = v
        if old in sd._arrays:
            sd._arrays[new] = sd._arrays.pop(old)
        if old in sd._producer:
            sd._producer[new] = sd._producer.pop(old)
        for op_node in sd.ops[start_idx:]:
            op_node.inputs = [new if i == old else i
                              for i in op_node.inputs]
            op_node.outputs = [new if o == old else o
                               for o in op_node.outputs]

    # -- shape propagation --------------------------------------------
    def _infer_new_ops(self, start_idx: int):
        """Run every op emitted since start_idx on ``meta`` tensors;
        record avals and fill in SDVariable shapes (no FLOPs, no copy of
        any weight). An op that cannot run on meta is skipped, its
        shape left unknown."""
        for node in self.sd.ops[start_idx:]:
            metas = []
            for name in node.inputs:
                av = self.avals.get(name)
                if av is None:
                    arr = self.sd._arrays.get(name)
                    if arr is None:
                        break
                    av = _Aval(tuple(arr.shape), arr.dtype)
                    self.avals[name] = av
                metas.append(torch.empty(av.shape, dtype=av.dtype,
                                         device="meta"))
            else:
                try:
                    out = get_op(node.op_name)(metas, node.attrs)
                except Exception:                  # noqa: BLE001
                    continue
                outs = out if isinstance(out, (list, tuple)) else [out]
                for on, t in zip(node.outputs, outs):
                    self.avals[on] = _Aval(tuple(t.shape), t.dtype)
                    sv = self.sd.vars[on]
                    sv.shape = tuple(t.shape)
                    sv.dtype = dtype_name(t.dtype)



    def _known_shape(self, ref: str) -> Optional[Tuple[int, ...]]:
        av = self.avals.get(ref)
        if av is not None:
            return tuple(av.shape)
        arr = self.static_values.get(ref)
        if arr is not None:
            return tuple(arr.shape)
        return None

    # -- constant folding ---------------------------------------------
    def _try_fold(self, node: NodeDef) -> bool:
        fold = _FOLDERS.get(node.op)
        if fold is None:
            return False
        try:
            result = fold(self, node)
        except _NoFold:
            return False
        if result is None:
            return False
        if isinstance(result, (list, tuple)):
            for i, arr in enumerate(result):
                key = node.name if i == 0 else f"{node.name}:{i}"
                self.static_values[key] = np.asarray(arr)
        else:
            self.static_values[node.name] = np.asarray(result)
        return True

    def _statics(self, node: NodeDef) -> List[np.ndarray]:
        vals = []
        for ref in node.inputs:
            if ref.startswith("^"):
                continue
            v = self.static_values.get(_canon(ref))
            if v is None:
                raise _NoFold()
            vals.append(v)
        return vals

    # -- main loop -----------------------------------------------------
    def _all_reachable_nodes(self, order) -> List[NodeDef]:
        """Top-level nodes plus the bodies of every function reachable
        through functional control flow (transitively), so the
        unmapped-op precheck sees loop and branch internals too."""
        out = list(order)
        seen = set()
        stack = list(order)
        while stack:
            node = stack.pop()
            if node.op not in _FUNCTIONAL_OPS:
                continue
            for key in ("cond", "body", "then_branch", "else_branch"):
                fname = node.attr(key)
                if not fname or fname in seen:
                    continue
                seen.add(fname)
                fd = self.functions.get(fname)
                if fd is None:
                    continue        # _function raises at import time
                out.extend(fd.nodes)
                stack.extend(fd.nodes)
        return out

    def run(self, optimize: Optional[bool] = None) -> SameDiff:
        if any(n.op in v1_control_flow.V1_CONTROL_FLOW_OPS
               for n in self.nodes):
            # legacy v1 frames (frozen tf.while_loop / tf.cond) ->
            # functional While / If
            self.nodes = v1_control_flow.deframe(
                self.nodes, self.functions,
                keep=frozenset(_node_of(o) for o in
                               (self.requested_outputs or ())))
        _resolve_tensor_lists(self.nodes)
        by_name = {n.name: n for n in self.nodes}
        order = _topo_sort(self.nodes, by_name)
        unmapped = sorted({n.op
                           for n in self._all_reachable_nodes(order)
                           if n.op not in TF_OP_MAP
                           and n.op not in ("Const", "Placeholder")
                           and n.op not in _SKIP_OPS
                           and n.op not in _FUNCTIONAL_OPS
                           and n.op not in _FOLDERS})
        if unmapped:
            raise NotImplementedError(
                f"TF import: no mapping for ops {unmapped} "
                f"(reference parity: OpMappingRegistry lookup failure)")
        self._import_node_list(order, _Ctx(self))
        if self.requested_outputs is not None:
            missing = [o for o in self.requested_outputs
                       if o not in self.var_map]
            if missing:
                raise KeyError(f"TF import: requested outputs "
                               f"{missing} not found in graph")
            self.outputs = list(self.requested_outputs)
        else:
            self.outputs = _terminal_names(order, self.var_map)
        # post-import GraphOptimizer pipeline: canonicalize the
        # exporter's baked cast/mask/LayerNorm/GELU arithmetic and
        # fuse attention (autodiff.passes). Default on; kill with
        # DL4J_TORCH_GRAPHOPT=0 or optimize=False.
        from deeplearning4j_tpu_torch.autodiff.passes import \
            graphopt_enabled
        if optimize if optimize is not None else graphopt_enabled():
            self.graphopt_counts = self.sd.optimize()
            self.sd.graphopt_counts = self.graphopt_counts
        return self.sd

    def _import_node_list(self, order, ctx):
        """The per-node import loop, shared by the top-level graph and
        function bodies (While / If cond, body and branches)."""
        for node in order:
            if node.op in _SKIP_OPS:
                continue
            if node.op == "Const":
                val = node.attr("value")
                if isinstance(val, Exception):
                    raise NotImplementedError(
                        f"TF import: Const '{node.name}' holds a "
                        f"tensor this decoder cannot represent "
                        f"({val})") from val
                self.static_values[node.name] = val
                continue
            if node.op == "Placeholder":
                shape = self.input_shapes.get(node.name)
                if shape is None:
                    shape = node.attr("shape")
                dtype = canonical_dtype(tf_dtype_to_np(
                    int(node.attr("dtype", 1))))
                ph = self.sd.placeholder(node.name, shape, dtype)
                self.var_map[node.name] = ph
                self.placeholders.append(node.name)
                if shape is not None and all(
                        d is not None and d >= 0 for d in shape):
                    self.avals[node.name] = _Aval(tuple(shape), dtype)
                continue
            if node.op in ("While", "StatelessWhile"):
                self._import_while(node)
                continue
            if node.op in ("If", "StatelessIf"):
                self._import_if(node)
                continue
            if self._try_fold(node):
                continue
            # control deps ('^x') order execution in TF; the op walk
            # has no side effects to order, so they are dropped before
            # positional/variadic input handling
            node.inputs = [r for r in node.inputs
                           if not r.startswith("^")]
            rule = TF_OP_MAP[node.op]
            n_ops_before = len(self.sd.ops)
            result = rule(ctx, node)
            self._bind(node, result, n_ops_before)
            self._infer_new_ops(n_ops_before)

    # -- functional control flow (TF2 While / If: bodies in the
    # GraphDef's function library) ---------------------------------------
    def _function(self, name: str) -> FunctionDef:
        fd = self.functions.get(name)
        if fd is None:
            raise NotImplementedError(
                f"TF import: GraphDef references function '{name}' "
                f"but the library does not define it")
        return fd

    def _function_as_callable(self, fd: FunctionDef):
        """A FunctionDef as a Python function over SDVariables, for
        ``SameDiff.while_loop`` / ``cond`` to trace: the body's nodes
        import into the child graph the proxies live in, its arguments
        bound by position and its outputs read through ``ret``."""
        arg_names = [a for a, _ in fd.input_args]
        producer_ops = {n.name: n.op for n in fd.nodes}
        norm_nodes = [
            NodeDef(n.name, n.op,
                    [_canon_func_ref(r, producer_ops) for r in n.inputs],
                    n.attrs)
            for n in fd.nodes]
        _resolve_tensor_lists(norm_nodes)

        def fn(*args):
            # the child graph comes from the proxies, or (a zero-argument
            # branch) from the handle _trace_subgraph publishes
            child_sd = (args[0].sd if args
                        else getattr(fn, "_trace_child_sd", self.sd))
            sub = GraphDefImporter.__new__(GraphDefImporter)
            sub.nodes = norm_nodes
            sub.functions = self.functions
            sub.input_shapes = {}
            sub.while_max_iterations = self.while_max_iterations
            sub.sd = child_sd
            sub.static_values = {}
            sub.var_map = dict(zip(arg_names, args))
            sub.avals = {}
            sub.placeholders = []
            sub.outputs = []
            by_name = {n.name: n for n in norm_nodes}
            order = _topo_sort(norm_nodes, by_name,
                               external=set(arg_names))
            sub._import_node_list(order, _Ctx(sub))
            outs = []
            for out_name, _ in fd.output_args:
                ref = _canon_func_ref(fd.ret.get(out_name, out_name),
                                      producer_ops)
                outs.append(sub._materialize(_canon(ref)))
            return outs

        return fn

    def _import_while(self, node: NodeDef):
        cond_fd = self._function(node.attr("cond"))
        body_fd = self._function(node.attr("body"))
        loop_vars = [self._materialize(_canon(r)) for r in node.inputs
                     if not r.startswith("^")]
        mi = self.while_max_iterations
        if isinstance(mi, dict):
            key = node.name
            if key not in mi and key.endswith("__v1_while"):
                # a deframed v1 loop: its TF loop name
                key = key[:-len("__v1_while")]
            mi = mi.get(key)
        n_ops_before = len(self.sd.ops)
        outs = self.sd.while_loop(
            loop_vars, self._function_as_callable(cond_fd),
            self._function_as_callable(body_fd),
            max_iterations=None if mi is None else int(mi))
        self._bind(node, outs, n_ops_before)
        self._infer_new_ops(n_ops_before)

    def _import_if(self, node: NodeDef):
        then_fd = self._function(node.attr("then_branch"))
        else_fd = self._function(node.attr("else_branch"))
        ins = [r for r in node.inputs if not r.startswith("^")]
        pred = self._materialize(_canon(ins[0]))
        operands = [self._materialize(_canon(r)) for r in ins[1:]]
        n_ops_before = len(self.sd.ops)
        outs = self.sd.cond(
            pred, self._function_as_callable(then_fd),
            self._function_as_callable(else_fd), operands)
        self._bind(node, outs, n_ops_before)
        self._infer_new_ops(n_ops_before)


def _resolve_tensor_lists(nodes: Sequence[NodeDef]):
    """Pre-pass for TensorArray / TensorList graphs: a static-size list
    becomes a dense ``[n, *element_shape]`` zeros tensor carried through
    the loop. TF records element_shape=-1 on TensorListReserve but the
    concrete shape on the downstream Stack / GetItem / Gather consts, so
    the handle is followed (positionally through While boundaries too:
    a functional While maps inputs to outputs one to one) until a
    concrete shape appears. The result is stashed in the Reserve node's
    attrs for the mapping rule; an unresolved Reserve fails there."""
    by_name = {n.name: n for n in nodes}

    def const_ints(ref):
        nd = by_name.get(_node_of(ref))
        if nd is None or nd.op != "Const":
            return None
        val = nd.attr("value")
        if isinstance(val, Exception):
            return None
        arr = np.asarray(val).reshape(-1)
        if arr.size and (arr.astype(np.int64) < 0).any():
            return None
        return tuple(int(v) for v in arr)

    for res in nodes:
        if res.op != "TensorListReserve":
            continue
        data_in = [r for r in res.inputs if not r.startswith("^")]
        shape = const_ints(data_in[0])        # concrete on the nose?
        num = const_ints(data_in[1])
        num = num[0] if num else None
        aliases = {res.name}
        changed = True
        while changed and shape is None:
            changed = False
            for n in nodes:
                data = [r for r in n.inputs if not r.startswith("^")]
                for i, r in enumerate(data):
                    if _canon(r) not in aliases:
                        continue
                    if n.op in ("While", "StatelessWhile"):
                        al = n.name if i == 0 else f"{n.name}:{i}"
                        if al not in aliases:
                            aliases.add(al)
                            changed = True
                    elif n.op in ("Identity", "TensorListSetItem") \
                            and i == 0 and n.name not in aliases:
                        # SetItem returns the updated handle
                        aliases.add(n.name)
                        changed = True
                    elif n.op in ("TensorListStack",
                                  "TensorListGetItem",
                                  "TensorListGather") and i == 0:
                        sh = const_ints(data[-1])
                        if sh is not None:
                            shape = sh
        if shape is not None and num is not None:
            res.attrs["_tl_shape"] = Attr("resolved", shape)
            res.attrs["_tl_num"] = Attr("resolved", num)


class _NoFold(Exception):
    pass


def _topo_sort(nodes: Sequence[NodeDef], by_name,
               external=frozenset()) -> List[NodeDef]:
    """Nodes in dependency order (iterative DFS); ``external``: names
    resolvable outside this node list, legal dangling references."""
    order: List[NodeDef] = []
    state: Dict[str, int] = {}        # 0 visiting, 1 done

    def visit(n: NodeDef):
        stack = [(n, iter(n.inputs))]
        state[n.name] = 0
        while stack:
            node, it = stack[-1]
            advanced = False
            for ref in it:
                dep = by_name.get(_node_of(ref))
                if dep is None:
                    if _node_of(ref) in external:
                        continue
                    raise KeyError(f"missing node '{_node_of(ref)}'")
                st = state.get(dep.name)
                if st == 0:
                    raise ValueError(f"cycle at '{dep.name}' — "
                                     f"control-flow loops unsupported")
                if st is None:
                    state[dep.name] = 0
                    stack.append((dep, iter(dep.inputs)))
                    advanced = True
                    break
            if not advanced:
                state[node.name] = 1
                order.append(node)
                stack.pop()

    for n in nodes:
        if state.get(n.name) is None:
            visit(n)
    return order


def _terminal_names(order, var_map) -> List[str]:
    consumed = set()
    for n in order:
        for ref in n.inputs:
            consumed.add(_node_of(ref))
    return [n.name for n in order
            if n.name not in consumed and n.name in var_map]


# -- numpy constant folders -------------------------------------------------
def _f_shape(imp, node):
    ref = _canon(node.inputs[0])
    shape = imp._known_shape(ref)
    if shape is None or any(d is None or d < 0 for d in shape):
        raise _NoFold()
    return np.asarray(shape, np.int32)


def _f_identity(imp, node):
    return imp._statics(node)[0]


def _f_slice(imp, node):
    x, begin, size = imp._statics(node)
    idx = tuple(slice(int(b), None if int(s) == -1 else int(b) + int(s))
                for b, s in zip(begin.reshape(-1), size.reshape(-1)))
    return np.asarray(x)[idx]


def _f_strided_slice(imp, node):
    from deeplearning4j_tpu_torch.autodiff.registry import spec_to_index
    x, begin, end, strides = imp._statics(node)
    spec = mappings.strided_slice_spec(
        [int(v) for v in begin], [int(v) for v in end],
        [int(v) for v in strides], node.attr("begin_mask", 0),
        node.attr("end_mask", 0), node.attr("ellipsis_mask", 0),
        node.attr("new_axis_mask", 0), node.attr("shrink_axis_mask", 0))
    return np.asarray(x)[spec_to_index(spec)]


def _f_pack(imp, node):
    return np.stack(imp._statics(node), axis=node.attr("axis", 0))


def _f_concat(imp, node):
    vals = imp._statics(node)
    return np.concatenate(vals[:-1], axis=int(vals[-1]))


def _f_binop(fn):
    def fold(imp, node):
        a, b = imp._statics(node)
        return fn(a, b)
    return fold


def _f_unop(fn):
    def fold(imp, node):
        return fn(imp._statics(node)[0])
    return fold


def _f_reshape(imp, node):
    x, shape = imp._statics(node)
    return np.reshape(x, [int(s) for s in shape])


def _f_cast(imp, node):
    dst = tf_dtype_to_np(int(node.attr("DstT", 1)))
    return imp._statics(node)[0].astype(dst)


def _f_range(imp, node):
    s, l, d = [np.asarray(v).reshape(())[()] for v in
               imp._statics(node)]
    return np.arange(s, l, d)


def _f_fill(imp, node):
    dims, val = imp._statics(node)
    return np.full([int(d) for d in dims],
                   np.asarray(val).reshape(())[()])


def _f_gather_v2(imp, node):
    if int(node.attr("batch_dims", 0)) != 0:
        raise _NoFold()          # keep parity with the emit path
    x, idx, axis = imp._statics(node)
    return np.take(x, idx.astype(np.int64), axis=int(axis))


def _f_expand_dims(imp, node):
    x, ax = imp._statics(node)
    return np.expand_dims(x, int(np.asarray(ax).reshape(())[()]))


def _f_squeeze(imp, node):
    dims = node.attr("squeeze_dims") or None
    x = imp._statics(node)[0]
    return np.squeeze(x, tuple(int(d) for d in dims) if dims else None)


def _f_transpose(imp, node):
    x, perm = imp._statics(node)
    return np.transpose(x, [int(p) for p in perm])


def _f_prod(imp, node):
    x, axes = imp._statics(node)
    return np.prod(x, axis=tuple(int(a) for a in
                                 np.asarray(axes).reshape(-1)),
                   keepdims=bool(node.attr("keep_dims", False)))


def _f_unpack(imp, node):
    x = imp._statics(node)[0]
    axis = node.attr("axis", 0)
    return [np.squeeze(s, axis) for s in
            np.split(x, x.shape[axis], axis=axis)]


def _f_size(imp, node):
    ref = _canon(node.inputs[0])
    shape = imp._known_shape(ref)
    if shape is None or any(d is None or d < 0 for d in shape):
        raise _NoFold()
    return np.asarray(int(np.prod(shape)), np.int32)


def _f_rank(imp, node):
    ref = _canon(node.inputs[0])
    shape = imp._known_shape(ref)
    if shape is None:
        raise _NoFold()
    return np.asarray(len(shape), np.int32)


_FOLDERS = {
    "Shape": _f_shape, "ShapeN": None, "Size": _f_size, "Rank": _f_rank,
    "Identity": _f_identity, "StridedSlice": _f_strided_slice,
    "Slice": _f_slice,
    "Pack": _f_pack, "ConcatV2": _f_concat, "Reshape": _f_reshape,
    "Cast": _f_cast, "Range": _f_range, "Fill": _f_fill,
    "GatherV2": _f_gather_v2, "ExpandDims": _f_expand_dims,
    "Squeeze": _f_squeeze, "Transpose": _f_transpose, "Prod": _f_prod,
    "Unpack": _f_unpack,
    "Add": _f_binop(np.add), "AddV2": _f_binop(np.add),
    "Sub": _f_binop(np.subtract), "Mul": _f_binop(np.multiply),
    "RealDiv": _f_binop(np.true_divide),
    "FloorDiv": _f_binop(np.floor_divide),
    "FloorMod": _f_binop(np.mod),
    "Maximum": _f_binop(np.maximum), "Minimum": _f_binop(np.minimum),
    "Neg": _f_unop(np.negative),
}
_FOLDERS = {k: v for k, v in _FOLDERS.items() if v is not None}


class TensorflowFrameworkImporter:
    """Reference: org.nd4j.samediff.frameworkimport.tensorflow.importer.
    TensorflowFrameworkImporter. ``device=None`` imports onto the card
    (raising without one); ``device="cpu"`` onto the CPU.
    ``while_max_iterations`` bounds the imported loops (an int for every
    loop, or ``{While node or TF loop name: int}``): a bounded loop
    trains, an unbounded one serves the forward only."""

    @staticmethod
    def run_import(graph_def, input_shapes: Optional[dict] = None,
                   while_max_iterations=None,
                   outputs: Optional[List[str]] = None,
                   optimize: Optional[bool] = None,
                   device=None) -> SameDiff:
        return GraphDefImporter(graph_def, input_shapes,
                                while_max_iterations, outputs=outputs,
                                device=device).run(optimize=optimize)

    runImport = run_import


class TFGraphMapper:
    """Legacy front-door (reference: TFGraphMapper)."""

    @staticmethod
    def import_graph(graph_def, input_shapes: Optional[dict] = None,
                     while_max_iterations=None,
                     outputs: Optional[List[str]] = None,
                     optimize: Optional[bool] = None,
                     device=None) -> SameDiff:
        return TensorflowFrameworkImporter.run_import(
            graph_def, input_shapes, while_max_iterations, outputs,
            optimize, device)

    importGraph = import_graph
