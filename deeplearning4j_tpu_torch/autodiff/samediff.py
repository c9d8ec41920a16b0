"""SameDiff: a named-op graph builder, executor and trainer.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py``. The graph
is the same: ``SDVariable`` handles (VARIABLE, CONSTANT, PLACEHOLDER or
an op's ARRAY output) and an ordered list of ``OpNode``s naming ops of
``autodiff/registry.py``. Execution walks the ancestors of the
requested outputs eagerly in PyTorch on the graph's device (the JAX
package jits the same walk into one program); gradients are autograd
over that walk, and the train step applies ``learning/updaters.py``.

Dtypes are named as numpy names them (``"float32"``, ``"int32"``,
``"bfloat16"``). Arrays given as numpy or Python values follow the JAX
package's 32-bit rule: float64 becomes float32 and int64 int32; torch
tensors keep their dtype. ``output`` and ``calculate_gradients`` return
tensors on the graph's device.

``save`` / ``load`` keep the JAX package's zip (``graph.json``,
``arrays.npz``, ``updater.npz``), so a zip either package writes loads
in the other; bfloat16 arrays are stored as float32 (numpy has no
bfloat16) and cast back on load from the dtype ``graph.json`` records.

``set_remat_segments(n)`` cuts the training walk (the train step and
``calculate_gradients``) into ``n`` segments, each but the last under
``torch.utils.checkpoint``: only values that a later op reads (or a
requested output) cross a boundary, and the boundaries sit where the
bytes live across them are fewest (``min_cut_segment_plan``, sizes from
one pass of the walk on meta tensors), which on an imported transformer
are its layer boundaries.

Control flow (``while_loop`` / ``cond`` / ``scan``) traces each body
into a child ``SameDiff``; the op runs the child's walk as Python control
flow (``registry.py``'s control domain). A body may use variables of
the graphs that enclose it: captures of the graph being built become op
inputs (live, and differentiable), through every nesting level; only a
capture of an unrelated graph is read from its owner at call time
without a gradient. ``while_loop(max_iterations=N)`` runs N masked trips
and trains; an unbounded ``while_loop`` reads its condition on the host
each trip and raises when a gradient is asked through it. ``save`` keeps
the JAX package's ``graph.json`` form of a subgraph (its arrays in
``arrays.npz`` under ``__cf.op<i>...`` names).

Random ops (``dropout``, ``random_normal``, ``random_uniform``,
``random_bernoulli``) draw from a key of their own, ``fold_in(call key,
op index)`` (``common.rng.RngKey``): the graph's key splits once for each
``output`` call and each ``fit`` batch, and ``fit_steps`` folds the step
into its call's key, as the JAX package's does; ``calculate_gradients``
uses the fixed key 0. ``dropout`` is the identity unless training. A
checkpointed segment recomputes from the same keys, so it redraws the
same values.

Program export: ``to_stablehlo`` gives the text of the ``torch.export``
program of a subgraph, ``export_serialized`` its ``torch.export.save``
bytes, ``deserialize_and_call`` loads and runs them. The flash kernels
appear in it as ``dl4j::`` custom ops (``parallel/sequence.py``), random
ops draw under the program's key input (``common/rng.py``), and an
unbounded ``while_loop`` and ``cond`` lower to torch's control-flow
operators, so the loaded program's trip counts follow its inputs; an op
that cannot be exported raises naming it.

Data-parallel ``output(mesh=)`` and ``fit_steps(mesh=,
update_exchange=)`` are ``autodiff/samediff_dp.py``'s: each replica of
a ``parallel/mesh.DpMesh`` walks its rows of the global batch, and the
loss is the global batch's. Tensor-parallel arguments (``tp_specs``, and
mesh axes or placeholder specs other than ``data``) raise
``NotImplementedError`` (ROADMAP.md, Queue A item 12).
"""
from __future__ import annotations

import enum
import io
import json
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.autodiff import samediff_dp
from deeplearning4j_tpu_torch.autodiff.registry import (
    _on_meta, dtype_name, get_op, lowering_active, lowering_for_export,
    torch_dtype)
from deeplearning4j_tpu_torch.common.environment import resolve_device
from deeplearning4j_tpu_torch.common.remat import min_cut_segment_plan
from deeplearning4j_tpu_torch.common.rng import RngKey, TracedKey
from deeplearning4j_tpu_torch.parallel import zero

#: the exported program's side file: its device, outputs and placeholders
_EXPORT_META = "dl4j_samediff.json"

#: ops that draw random values: each gets a key of its own, folded out of
#: the call's key by its position in the graph
RNG_OPS = {"dropout", "random_normal", "random_uniform",
           "random_bernoulli"}


class VariableType(enum.Enum):
    """Reference: org.nd4j.autodiff.samediff.VariableType."""
    VARIABLE = "VARIABLE"          # trainable
    CONSTANT = "CONSTANT"
    PLACEHOLDER = "PLACEHOLDER"
    ARRAY = "ARRAY"                # op output


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bfloat16 as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def canonical_dtype(dt) -> torch.dtype:
    """The dtype a numpy array of dtype ``dt`` gets in a graph: the JAX
    package's 32-bit rule (float64 -> float32, int64 -> int32)."""
    dt = np.dtype(dt)
    return torch_dtype({np.dtype(np.float64): np.float32,
                        np.dtype(np.int64): np.int32}.get(dt, dt))


def as_tensor(value, device) -> torch.Tensor:
    """A tensor on ``device``: torch tensors keep their dtype; numpy and
    Python values get ``canonical_dtype``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    # ascontiguousarray makes a 0-d array 1-d: keep the scalar's shape
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
    return t.to(device=device, dtype=canonical_dtype(arr.dtype))


class SDVariable:
    """Symbolic handle into a SameDiff graph (reference: SDVariable).
    Operator overloads build graph nodes; ``eval`` executes."""

    def __init__(self, sd: "SameDiff", name: str, var_type: VariableType,
                 shape=None, dtype=None):
        self.sd = sd
        self.name = name
        self.var_type = var_type
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)

    # -- graph-building sugar ------------------------------------------
    def _bin(self, other, op):
        other = self.sd._as_var(other)
        return self.sd._op(op, [self, other])

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return self.sd._as_var(o)._bin(self, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return self.sd._as_var(o)._bin(self, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __rmul__(self, o):
        return self.sd._as_var(o)._bin(self, "mul")

    def __truediv__(self, o):
        return self._bin(o, "div")

    def __rtruediv__(self, o):
        return self.sd._as_var(o)._bin(self, "div")

    def __pow__(self, o):
        return self._bin(o, "pow")

    def __matmul__(self, o):
        return self._bin(o, "matmul")

    def __neg__(self):
        return self.sd._op("neg", [self])

    def __gt__(self, o):
        return self._bin(o, "gt")

    def __ge__(self, o):
        return self._bin(o, "gte")

    def __lt__(self, o):
        return self._bin(o, "lt")

    def __le__(self, o):
        return self._bin(o, "lte")

    # -- named methods (reference SDVariable surface) ------------------
    def add(self, o):
        return self.__add__(o)

    def sub(self, o):
        return self.__sub__(o)

    def mul(self, o):
        return self.__mul__(o)

    def div(self, o):
        return self.__truediv__(o)

    def rdiv(self, o):
        return self._bin(o, "rdiv")

    def mmul(self, o):
        return self._bin(o, "matmul")

    def dot(self, o):
        return self._bin(o, "dot")

    def _reduce(self, op, axis, keep_dims):
        return self.sd._op(op, [self], {"axis": axis,
                                        "keep_dims": keep_dims})

    def sum(self, axis=None, keep_dims=False):
        return self._reduce("reduce_sum", axis, keep_dims)

    def mean(self, axis=None, keep_dims=False):
        return self._reduce("reduce_mean", axis, keep_dims)

    def max(self, axis=None, keep_dims=False):
        return self._reduce("reduce_max", axis, keep_dims)

    def min(self, axis=None, keep_dims=False):
        return self._reduce("reduce_min", axis, keep_dims)

    def std(self, axis=None, keep_dims=False):
        return self._reduce("reduce_std", axis, keep_dims)

    def norm2(self, axis=None):
        return self.sd._op("reduce_norm2", [self], {"axis": axis})

    def argmax(self, axis=-1):
        return self.sd._op("argmax", [self], {"axis": axis})

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", [self], {"shape": list(shape)})

    def permute(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self.sd._op("permute", [self], {"axes": list(axes)})

    def transpose(self):
        return self.sd._op("permute", [self], {"axes": [1, 0]})

    def cast(self, dtype):
        return self.sd._op("cast", [self], {"dtype": dtype_name(dtype)})

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        return self

    # -- execution -----------------------------------------------------
    def eval(self, placeholders: Optional[dict] = None) -> torch.Tensor:
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def get_arr(self) -> Optional[np.ndarray]:
        """The stored value as numpy (bfloat16 as float32), or None."""
        a = self.sd._arrays.get(self.name)
        return to_numpy(a) if a is not None else None

    def set_arr(self, value):
        arr = as_tensor(value, self.sd.device)
        self.sd._arrays[self.name] = arr
        self.shape, self.dtype = tuple(arr.shape), dtype_name(arr.dtype)

    def __repr__(self):
        return (f"SDVariable(name='{self.name}', "
                f"type={self.var_type.value}, shape={self.shape})")


class OpNode:
    __slots__ = ("op_name", "inputs", "outputs", "attrs")

    def __init__(self, op_name, inputs, outputs, attrs):
        self.op_name = op_name
        self.inputs = inputs       # list of variable names
        self.outputs = outputs     # list of variable names
        self.attrs = attrs or {}


class _Plan:
    """What one (outputs, placeholders) request walks: the op indices in
    order, and the constants and variables it reads."""
    __slots__ = ("ops", "constants", "variables")

    def __init__(self, ops, constants, variables):
        self.ops = ops
        self.constants = constants
        self.variables = variables


class SameDiff:
    """The graph. Build with var/constant/placeholder and the op
    namespaces (``sd.math``, ``sd.nn``, ``sd.loss``); run with
    ``output`` / ``fit`` / ``fit_steps``. ``device=None`` is the card,
    and raises without one; ``device="cpu"`` runs on the CPU."""

    def __init__(self, device: Union[None, str, torch.device] = None):
        self.device = resolve_device(device)
        self.vars: Dict[str, SDVariable] = {}
        self.ops: List[OpNode] = []
        self._arrays: Dict[str, torch.Tensor] = {}   # VARIABLE/CONSTANT
        self._producer: Dict[str, int] = {}          # var name -> op idx
        self._name_counter: Dict[str, int] = {}
        #: execution plans by (outputs, placeholder names); cleared by
        #: every change to the graph
        self._exec_cache: Dict = {}
        self._generator = torch.Generator().manual_seed(0)
        #: the graph's random key: split once a call (the JAX package's
        #: ``PRNGKey(0)`` and its splits)
        self._rng = RngKey(0)
        self.loss_variables: List[str] = []
        self.training_config = None
        self._updater_state = None
        self._loaded_updater_leaves = None
        #: updater iteration, persisted across fit()/fit_steps() calls
        #: (Adam's bias correction must not restart per call)
        self.iteration_count: int = 0
        self.epoch_count: int = 0
        #: training walks in this many checkpointed segments (0: off)
        self.remat_segments: int = 0
        self.listeners: list = []
        self._score: float = float("nan")
        self.last_batch_size: int = 0
        #: per-pass rewrite counts of the last import's GraphOptimizer run
        self.graphopt_counts: Dict[str, int] = {}
        #: captures of other graphs' variables by control-flow bodies:
        #: local name -> (owner SameDiff, owner's name)
        self._captures: Dict[str, tuple] = {}
        #: the graph this one is traced into as a control-flow body
        self._tracing_parent: Optional["SameDiff"] = None
        from deeplearning4j_tpu_torch.autodiff.opsets import (
            SDCNN, SDNN, SDRNN, SDBitwise, SDImage, SDLinalg, SDLoss, SDMath,
            SDRandom)
        self.math = SDMath(self)
        self.nn = SDNN(self)
        self.cnn = SDCNN(self)
        self.rnn = SDRNN(self)
        self.loss = SDLoss(self)
        self.image = SDImage(self)
        self.bitwise = SDBitwise(self)
        self.linalg = SDLinalg(self)
        self.random = SDRandom(self)

    @staticmethod
    def create(device: Union[None, str, torch.device] = None) -> "SameDiff":
        return SameDiff(device)

    # -- naming --------------------------------------------------------
    def _unique(self, base: str) -> str:
        if base not in self.vars and base not in self._name_counter:
            self._name_counter[base] = 0
            return base
        n = self._name_counter.get(base, 0)
        while True:                      # skip user-taken suffixed names
            n += 1
            cand = f"{base}_{n}"
            if cand not in self.vars:
                self._name_counter[base] = n
                return cand

    def _rename(self, old: str, new: str):
        if new in self.vars:
            raise ValueError(f"variable '{new}' already exists")
        v = self.vars.pop(old)
        v.name = new
        self.vars[new] = v
        if old in self._arrays:
            self._arrays[new] = self._arrays.pop(old)
        if old in self._producer:
            self._producer[new] = self._producer.pop(old)
        for op_node in self.ops:
            op_node.inputs = [new if i == old else i
                              for i in op_node.inputs]
            op_node.outputs = [new if o == old else o
                               for o in op_node.outputs]
        self.loss_variables = [new if n == old else n
                               for n in self.loss_variables]
        self._exec_cache.clear()

    # -- variable creation (reference: sd.var/constant/placeHolder) ----
    def var(self, name: Optional[str] = None, shape=None, dtype="float32",
            *, init=None, array=None) -> SDVariable:
        """Trainable variable. Provide ``array``, or ``shape`` and an
        optional ``init``: a ``nn.weights.WeightInit`` or a callable
        ``init(generator, shape, dtype) -> tensor``."""
        name = self._unique(name or "var")
        if array is not None:
            arr = as_tensor(array, self.device)
        else:
            if shape is None:
                raise ValueError("var needs shape or array")
            dt = torch_dtype(dtype)
            if init is None:
                arr = torch.zeros(tuple(shape), dtype=dt)
            elif callable(getattr(init, "init", None)):
                fan_in = shape[0] if len(shape) >= 1 else 1
                fan_out = shape[-1] if len(shape) >= 2 else 1
                arr = init.init(self._generator, tuple(shape), fan_in,
                                fan_out, dt)
            else:
                arr = init(self._generator, tuple(shape), dt)
            arr = arr.to(self.device)
        v = SDVariable(self, name, VariableType.VARIABLE, arr.shape,
                       arr.dtype)
        self.vars[name] = v
        self._arrays[name] = arr
        self._exec_cache.clear()
        return v

    def constant(self, name_or_array, array=None) -> SDVariable:
        if array is None:
            name, array = None, name_or_array
        else:
            name = name_or_array
        arr = as_tensor(array, self.device)
        name = self._unique(name or "const")
        v = SDVariable(self, name, VariableType.CONSTANT, arr.shape,
                       arr.dtype)
        self.vars[name] = v
        self._arrays[name] = arr
        return v

    def placeholder(self, name: str, shape=None,
                    dtype="float32") -> SDVariable:
        name = self._unique(name)
        v = SDVariable(self, name, VariableType.PLACEHOLDER, shape, dtype)
        self.vars[name] = v
        return v

    place_holder = placeholder     # reference spelling

    def convert_to_variables(self, names: Sequence,
                             values: Optional[dict] = None):
        """Promote placeholders/constants to trainable VARIABLEs
        (reference: SameDiff.convertToVariable(s), used after import to
        make frozen weights trainable). ``values`` supplies initial
        arrays, for converted placeholders or to recast a constant."""
        for n in names:
            name = n.name if isinstance(n, SDVariable) else n
            v = self.vars[name]
            if values and name in values:
                arr = as_tensor(values[name], self.device)
                self._arrays[name] = arr
                v.shape, v.dtype = tuple(arr.shape), dtype_name(arr.dtype)
            if name not in self._arrays:
                raise ValueError(
                    f"convert_to_variables('{name}'): no stored value "
                    f"— pass one via values={{'{name}': array}}")
            v.var_type = VariableType.VARIABLE
        self._exec_cache.clear()

    convertToVariables = convert_to_variables

    def _as_var(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            return x
        return self.constant(x)

    # -- op creation ---------------------------------------------------
    def _op(self, op_name: str, inputs: Sequence[SDVariable],
            attrs: Optional[dict] = None, name: Optional[str] = None,
            n_out: int = 1) -> Union[SDVariable, Tuple[SDVariable, ...]]:
        get_op(op_name)               # validate early
        for v in inputs:
            if isinstance(v, SDVariable) and v.sd is not self and \
                    self._tracing_parent is None:
                raise ValueError(
                    f"variable '{v.name}' belongs to another SameDiff "
                    f"graph (cross-graph references are only valid "
                    f"inside control-flow bodies)")
        inputs = [self._import_foreign(v) if isinstance(v, SDVariable)
                  and v.sd is not self else v for v in inputs]
        in_names = [v.name for v in inputs]
        if n_out == 1:
            out_names = [self._unique(name or op_name)]
        else:
            base = name or op_name
            out_names = [self._unique(f"{base}:{i}")
                         for i in range(n_out)]
        node = OpNode(op_name, in_names, out_names, attrs)
        idx = len(self.ops)
        self.ops.append(node)
        outs = []
        for on in out_names:
            v = SDVariable(self, on, VariableType.ARRAY)
            self.vars[on] = v
            self._producer[on] = idx
            outs.append(v)
        self._exec_cache.clear()
        return outs[0] if n_out == 1 else tuple(outs)

    def invoke(self, op_name, inputs, attrs=None, name=None, n_out=1):
        """Public escape hatch: call any registered op by name."""
        return self._op(op_name, [self._as_var(i) for i in inputs],
                        attrs, name, n_out)

    def _import_foreign(self, v: SDVariable) -> SDVariable:
        """A variable of another graph used in this one (a control-flow
        body closing over an enclosing graph): a placeholder under a
        local capture name that cannot collide with this graph's own
        names, resolved from its owner when the subgraph is called."""
        for local, (sd, pname) in self._captures.items():
            if sd is v.sd and pname == v.name:
                return self.vars[local]
        local = self._unique(f"_cap_{v.name}")
        proxy = SDVariable(self, local, VariableType.PLACEHOLDER,
                           v.shape, v.dtype)
        self.vars[local] = proxy
        self._captures[local] = (v.sd, v.name)
        return proxy

    # -- execution -----------------------------------------------------
    def _ancestors(self, targets: Sequence[str]) -> List[int]:
        """Op indices needed to compute ``targets``, in execution order."""
        needed: set = set()
        stack = list(targets)
        seen_vars = set()
        while stack:
            vn = stack.pop()
            if vn in seen_vars:
                continue
            seen_vars.add(vn)
            if vn in self._producer:
                idx = self._producer[vn]
                if idx not in needed:
                    needed.add(idx)
                    stack.extend(self.ops[idx].inputs)
        return sorted(needed)

    def _op_attrs(self, idx: int, node: OpNode, rng, training: bool
                  ) -> dict:
        """``node``'s attrs as its op sees them: an op without inputs
        makes its output on the graph's device; a random op draws from
        its own key, ``fold_in(rng, idx)``."""
        attrs = node.attrs
        if node.op_name in RNG_OPS or not node.inputs:
            attrs = dict(attrs)
            attrs["_device"] = self.device
            if node.op_name in RNG_OPS:
                attrs["rng"] = (rng.fold_in(idx) if rng is not None
                                else None)
                if node.op_name == "dropout":
                    attrs["training"] = training
        return attrs

    def _execute(self, values: dict, op_indices: List[int],
                 rng: Optional[RngKey] = None, training: bool = False,
                 dp=None) -> dict:
        """Run ``op_indices`` over ``values`` in place. ``dp`` (a
        ``samediff_dp.DpRank``) makes it one replica's walk of a
        data-parallel mesh."""
        for idx in op_indices:
            node = self.ops[idx]
            attrs = self._op_attrs(idx, node, rng, training)
            ins = [values[i] for i in node.inputs]
            if dp is not None:
                attrs = dp.attrs(idx, attrs)
                ins = dp.inputs(idx, ins)
            try:
                out = get_op(node.op_name)(ins, attrs)
            except Exception as e:
                if lowering_active():
                    raise RuntimeError(
                        f"op '{node.outputs[0]}' ({node.op_name}) cannot "
                        f"be exported: {e}") from e
                raise
            if dp is not None:
                out = dp.combine(idx, out, ins, attrs)
            if len(node.outputs) == 1:
                values[node.outputs[0]] = out
            else:
                for on, o in zip(node.outputs, out):
                    values[on] = o
        return values

    def _plan(self, out_names: Tuple[str, ...],
              ph_names: Tuple[str, ...]) -> _Plan:
        key = ("plan", out_names, tuple(sorted(ph_names)))
        plan = self._exec_cache.get(key)
        if plan is not None:
            return plan
        for n in out_names:
            if n not in self.vars:
                raise KeyError(f"no variable '{n}' in the graph")
        op_indices = self._ancestors(list(out_names))
        needed = set(out_names)
        for idx in op_indices:
            needed.update(self.ops[idx].inputs)
        missing = {n for n in needed
                   if n in self.vars and self.vars[n].var_type
                   is VariableType.PLACEHOLDER} - set(ph_names)
        if missing:
            raise ValueError(
                f"missing placeholder values for {sorted(missing)} "
                f"(required to compute {list(out_names)}; "
                f"provided: {sorted(ph_names)})")
        # restrict to the requested subgraph: variables outside it get no
        # gradient and no l1/l2 term
        consts = [n for n in self._arrays if n in needed
                  and self.vars[n].var_type is VariableType.CONSTANT]
        variables = [n for n, v in self.vars.items()
                     if n in needed and v.var_type is VariableType.VARIABLE]
        plan = _Plan(op_indices, consts, variables)
        self._exec_cache[key] = plan
        return plan

    def _run(self, plan: _Plan, var_vals: dict, ph_vals: dict,
             out_names: Sequence[str], training: bool = False,
             rng: Optional[RngKey] = None) -> List[torch.Tensor]:
        values = {n: self._arrays[n] for n in plan.constants}
        values.update(var_vals)
        values.update(ph_vals)
        if training and self.remat_segments > 1 and len(plan.ops) > 1 \
                and torch.is_grad_enabled():
            self._execute_segmented(values, plan.ops, tuple(out_names), rng)
        else:
            self._execute(values, plan.ops, rng, training)
        return [values[n] for n in out_names]

    def _segment_cut_costs(self, op_indices: List[int],
                           out_names: Tuple[str, ...],
                           sizes: Optional[dict] = None) -> np.ndarray:
        """``cost[c]``: the bytes of the values live across a cut before
        walk position ``c`` (produced earlier, read at or after ``c`` or
        a requested output); a value of unknown size counts 1."""
        n = len(op_indices)
        first_prod, last_read = {}, {}
        for j, i in enumerate(op_indices):
            for name in self.ops[i].inputs:
                last_read[name] = j
            for name in self.ops[i].outputs:
                first_prod.setdefault(name, j)
        sizes = sizes or {}
        diff = np.zeros(n + 2)
        for name, j in first_prod.items():
            k = n if name in out_names else last_read.get(name, j)
            if k > j:
                w = float(sizes.get(name, 1.0))
                # crosses every cut c with j < c <= k
                diff[j + 1] += w
                diff[k + 1] -= w
        return np.cumsum(diff)[:n + 1]

    def _value_sizes(self, values: dict, op_indices: List[int],
                     rng: Optional[RngKey] = None) -> dict:
        """Bytes of every value of the walk, from one pass on meta
        tensors (shapes only: nothing computed or allocated). Empty when
        an op has no meta kernel; the cut costs then count values."""
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in values.items()}
        try:
            self._execute(meta, op_indices, rng, True)
        except (RuntimeError, NotImplementedError, TypeError,
                ValueError):
            return {}
        return {k: v.numel() * v.element_size() for k, v in meta.items()
                if isinstance(v, torch.Tensor)}

    def _execute_segmented(self, values: dict, op_indices: List[int],
                           out_names: Tuple[str, ...],
                           rng: Optional[RngKey] = None, dp=None) -> None:
        """The walk in ``remat_segments`` segments placed by
        ``min_cut_segment_plan``, each but the last checkpointed; only
        values read later (or requested) cross a boundary. A random op's
        key depends only on ``rng`` and its position, so a segment's
        recompute draws what its forward drew (``preserve_rng_state`` is
        not needed). ``dp`` (a ``samediff_dp.DpRank``) makes it one
        replica's walk, as in ``_execute``: the plan is sized from the
        replica's values, and a recomputed segment runs its collectives
        again, in the same order on every replica."""
        read_at = [set(self.ops[i].inputs) for i in op_indices]
        key = ("remat", tuple(op_indices), out_names, self.remat_segments,
               tuple((k, tuple(v.shape)) for k, v in values.items()))
        plan = self._exec_cache.get(key)
        if plan is None:
            sizes = dp.walk.sizes if dp is not None else {}
            plan = self._exec_cache[key] = min_cut_segment_plan(
                len(op_indices), self.remat_segments,
                self._segment_cut_costs(
                    op_indices, out_names,
                    sizes or self._value_sizes(values, op_indices, rng)))
        for lo, hi, wrap in plan:
            seg = op_indices[lo:hi]
            produced = {o for i in seg for o in self.ops[i].outputs}
            read = set().union(*read_at[lo:hi])
            needed_after = set(out_names).union(*read_at[hi:])
            seg_in = sorted((read - produced) & set(values))
            seg_out = sorted(produced & needed_after)

            def seg_fn(in_vals, seg=seg, seg_out=seg_out):
                vals = self._execute(dict(in_vals), seg, rng, True, dp=dp)
                return {k: vals[k] for k in seg_out}

            in_vals = {k: values[k] for k in seg_in}
            outs = (checkpoint(seg_fn, in_vals, use_reentrant=False,
                               preserve_rng_state=False)
                    if wrap else seg_fn(in_vals))
            # drop values dead past this boundary; variables, constants
            # and placeholders stay for later segments' inputs
            for k in list(values):
                if k not in needed_after:
                    del values[k]
            values.update(outs)

    def _placeholders(self, placeholders: dict) -> Dict[str, torch.Tensor]:
        return {k: as_tensor(v, self.device)
                for k, v in placeholders.items()}

    def output(self, placeholders: dict, outputs: Sequence,
               *, training: bool = False, mesh=None,
               ph_specs=None) -> Dict[str, torch.Tensor]:
        """Execute the graph (reference: SameDiff.output): the ancestors
        of ``outputs``, under ``torch.no_grad``. Returns ``{name:
        tensor}`` on the graph's device. Each call takes a new random
        key; ``training`` turns dropout on.

        ``mesh`` (a ``parallel.mesh.DpMesh``) runs it data-parallel: the
        batch placeholders shard over the replicas, the rest replicate,
        and every replica returns the global result
        (``autodiff/samediff_dp.py``); ``ph_specs`` maps placeholder
        names to explicit specs (``"data"`` / ``("data", None)`` shard
        the leading axis, ``None`` replicates)."""
        outputs = tuple(o.name if isinstance(o, SDVariable) else o
                        for o in outputs)
        ph_vals = self._placeholders(placeholders)
        self._rng, rng = self._rng.split(2)
        if mesh is not None:
            return samediff_dp.output(self, ph_vals, outputs, mesh,
                                      ph_specs, training, rng)
        plan = self._plan(outputs, tuple(ph_vals))
        with torch.no_grad():
            res = self._run(plan, {n: self._arrays[n]
                                   for n in plan.variables},
                            ph_vals, outputs, training, rng)
        return dict(zip(outputs, res))

    # -- program export --------------------------------------------------
    def _prepare(self, placeholders: dict, outputs: Sequence,
                 training: bool):
        """The shared preamble of ``to_stablehlo`` / ``export_serialized``:
        output names, placeholders on the graph's device (a ``meta``
        tensor gives the shape and dtype only, as JAX's
        ``ShapeDtypeStruct`` does) and the module of the closed
        program."""
        outputs = tuple(o.name if isinstance(o, SDVariable) else o
                        for o in outputs)
        ph_vals = {}
        for k, v in placeholders.items():
            if isinstance(v, torch.Tensor) and v.device.type == "meta":
                v = torch.zeros(v.shape, dtype=v.dtype, device=self.device)
            ph_vals[k] = as_tensor(v, self.device)
        plan = self._plan(outputs, tuple(ph_vals))
        return outputs, ph_vals, _ProgramModule(self, plan, outputs,
                                                training)

    def _export(self, placeholders: dict, outputs: Sequence,
                training: bool):
        outputs, ph_vals, module = self._prepare(placeholders, outputs,
                                                 training)
        key = torch.tensor(0, dtype=torch.int64)
        with torch.no_grad():
            program = torch.export.export(module, (ph_vals, key))
        return program, outputs, ph_vals

    def to_stablehlo(self, placeholders: dict, outputs: Sequence, *,
                     training: bool = False) -> str:
        """The text of the ``torch.export`` program this subgraph traces
        to (the name is the JAX package's, whose program is StableHLO;
        here the portable, inspectable artifact is PyTorch's exported
        graph): ``(placeholders, key) -> outputs`` with the variables as
        constants. The kernels appear as their ``dl4j::`` custom ops;
        ``placeholders`` give shapes and dtypes (tensors, arrays, or
        tensors on the ``meta`` device)."""
        return str(self._export(placeholders, outputs, training)[0])

    def export_serialized(self, placeholders: dict, outputs: Sequence, *,
                          training: bool = False) -> bytes:
        """The bytes of ``torch.export.save`` of the closed program
        ``(placeholders, key) -> outputs``, the variables as constants.
        The random key stays a program input, so a stochastic graph is
        reseeded each call. Round-trips with
        :meth:`deserialize_and_call`."""
        program, outputs, ph_vals = self._export(placeholders, outputs,
                                                 training)
        meta = {"device": str(self.device), "outputs": list(outputs),
                "placeholders": list(ph_vals)}
        buf = io.BytesIO()
        torch.export.save(program, buf,
                          extra_files={_EXPORT_META: json.dumps(meta)})
        return buf.getvalue()

    @staticmethod
    def deserialize_and_call(blob: bytes, placeholders: dict,
                             seed: int = 0) -> List[torch.Tensor]:
        """Run a program :meth:`export_serialized` wrote, with the port's
        custom ops registered, under the key of ``seed`` (a graph's walk
        with ``RngKey(seed)`` draws the same); returns the outputs as a
        list, on the device the program was exported on."""
        # registers dl4j::flash_* (dl4j::rng_draw comes with the registry)
        import deeplearning4j_tpu_torch.parallel.sequence  # noqa: F401
        extra = {_EXPORT_META: ""}
        program = torch.export.load(io.BytesIO(blob), extra_files=extra)
        meta = json.loads(extra[_EXPORT_META])
        device = torch.device(meta["device"])
        missing = set(meta["placeholders"]) - set(placeholders)
        if missing:
            raise ValueError(f"missing placeholder values for "
                             f"{sorted(missing)}")
        ph = {k: as_tensor(placeholders[k], device)
              for k in meta["placeholders"]}
        key = torch.tensor(RngKey(seed).seed, dtype=torch.int64)
        with torch.no_grad():
            return list(program.module()(ph, key))

    def set_remat_segments(self, n: int):
        """Cut training walks into ``n`` checkpointed segments (sqrt(N)
        activation checkpointing; 0 disables): only segment-boundary
        values are kept for the backward, interiors are recomputed.
        The memory lever for flat imported graphs, which have no layer
        structure to remat. Cached segment plans are dropped."""
        self.remat_segments = int(n)
        self._exec_cache.clear()
        return self

    # -- control flow ----------------------------------------------------
    def _trace_subgraph(self, fn, n_args: int):
        """Trace a Python function over ``n_args`` proxies into a child
        ``SameDiff``; returns ``(call, n_outputs, captured vars, spec)``.
        ``call(*args, *captures)`` runs the child's walk on tensors.

        Captures owned by this graph become extra op inputs, live and
        differentiable. Captures owned by a graph further up the tracing
        chain (nested bodies) are re-captured here, level by level, so
        they stay op inputs at every level. Only a capture of an
        unrelated graph is frozen: read from its owner at call time,
        without a gradient. Variables the child itself creates are
        constants of the body (loop bodies own no trainable state;
        thread it through the carry)."""
        child = SameDiff(self.device)
        child._tracing_parent = self
        proxies = [child.placeholder(f"_arg{i}", shape=None)
                   for i in range(n_args)]
        try:
            # a zero-argument body has no proxy to find its graph from:
            # the TF importer's function bodies read it here
            fn._trace_child_sd = child
        except (AttributeError, TypeError):
            pass
        res = fn(*proxies) if n_args else fn()
        outs = list(res) if isinstance(res, (list, tuple)) else [res]
        outs = [(o if o.sd is child else child._import_foreign(o))
                if isinstance(o, SDVariable) else child._as_var(o)
                for o in outs]
        out_names = [o.name for o in outs]
        proxy_names = [p.name for p in proxies]
        idxs = child._ancestors(out_names)
        parent_caps = []     # (local name, name in this graph)
        frozen_caps = []     # (local name, owner, owner's name)
        for local, (owner, pname) in child._captures.items():
            if owner is self:
                parent_caps.append((local, pname))
                continue
            anc = self._tracing_parent
            while anc is not None and anc is not owner:
                anc = anc._tracing_parent
            if anc is owner:
                proxy = self._import_foreign(owner.vars[pname])
                parent_caps.append((local, proxy.name))
                continue
            if pname not in owner._arrays:
                raise ValueError(
                    f"control-flow body captured '{pname}' from an "
                    f"outer subgraph where it has no stored value — "
                    f"thread it through the loop/branch arguments")
            frozen_caps.append((local, owner, pname))

        def call(*args):
            values = dict(child._arrays)
            for local, owner, pname in frozen_caps:
                values[local] = owner._arrays[pname]
            if args and _on_meta(args):
                values = {k: v.to("meta") for k, v in values.items()}
            values.update(zip(proxy_names, args[:n_args]))
            values.update({local: v for (local, _), v in
                           zip(parent_caps, args[n_args:])})
            child._execute(values, idxs)
            return [values[n] for n in out_names]

        cap_vars = [self.vars[pname] for _, pname in parent_caps]
        spec = {"child": child, "frozen_caps": frozen_caps,
                "proxies": proxy_names, "outs": out_names,
                "parent_cap_locals": [l for l, _ in parent_caps]}
        return call, len(out_names), cap_vars, spec

    def while_loop(self, loop_vars: Sequence, cond_fn, body_fn,
                   name: Optional[str] = None,
                   max_iterations: Optional[int] = None):
        """A loop over the graph (reference: SameDiff whileLoop / TF
        Enter..Exit frames). ``cond_fn`` maps the loop variables to a
        scalar boolean; ``body_fn`` returns the updated variables (same
        count and shapes).

        With ``max_iterations=N`` (TF ``maximum_iterations``) the loop
        runs N trips, masking its updates once the condition has gone
        false: differentiable through loop variables and captures, and
        truncated after N trips. Without it the condition is read on
        the host each trip: unbounded, forward only (a gradient asked
        through it raises)."""
        loop_vars = [self._as_var(v) for v in loop_vars]
        n = len(loop_vars)
        cond_call, _, cond_caps, cond_spec = self._trace_subgraph(
            cond_fn, n)
        body_call, n_body, body_caps, body_spec = self._trace_subgraph(
            body_fn, n)
        if n_body != n:
            raise ValueError(f"while_loop body returned {n_body} vars "
                             f"for {n} loop vars")
        return self._op("while_loop",
                        loop_vars + cond_caps + body_caps,
                        {"_cond_call": cond_call,
                         "_body_call": body_call,
                         "_cond_spec": cond_spec,
                         "_body_spec": body_spec,
                         "n_loop": n,
                         "n_cond_caps": len(cond_caps),
                         "n_body_caps": len(body_caps),
                         "max_iterations": max_iterations},
                        name=name, n_out=n)

    def cond(self, pred, true_fn, false_fn, operands: Sequence = (),
             name: Optional[str] = None):
        """A branch (reference: TF-import Switch/Merge pairs): the
        predicate is read on the host and one branch runs. Both
        branches take ``operands`` and return as many outputs.
        Differentiable through the branch taken."""
        operands = [self._as_var(v) for v in operands]
        t_call, nt, t_caps, t_spec = self._trace_subgraph(true_fn,
                                                          len(operands))
        f_call, nf, f_caps, f_spec = self._trace_subgraph(false_fn,
                                                          len(operands))
        if nt != nf:
            raise ValueError(f"cond branches disagree: {nt} vs {nf} "
                             f"outputs")
        return self._op("cond",
                        [self._as_var(pred)] + operands
                        + t_caps + f_caps,
                        {"_true_call": t_call, "_false_call": f_call,
                         "_true_spec": t_spec, "_false_spec": f_spec,
                         "n_operands": len(operands),
                         "n_true_caps": len(t_caps),
                         "n_false_caps": len(f_caps)},
                        name=name, n_out=nt)

    def scan(self, body_fn, init: Sequence, xs: Sequence = (),
             length: Optional[int] = None,
             name: Optional[str] = None):
        """``body_fn(*carry, *x_slices) -> (new_carry..., y_outputs...)``
        over the leading axis of ``xs`` (or ``length`` trips). Returns
        the final carries followed by the stacked per-step outputs.
        Differentiable."""
        init = [self._as_var(v) for v in init]
        xs = [self._as_var(v) for v in xs]
        body_call, n_total, caps, body_spec = self._trace_subgraph(
            body_fn, len(init) + len(xs))
        if n_total < len(init):
            raise ValueError("scan body must return at least the "
                             "carry")
        return self._op("scan", init + xs + caps,
                        {"_body_call": body_call,
                         "_body_spec": body_spec,
                         "n_carry": len(init), "n_xs": len(xs),
                         "length": length},
                        name=name, n_out=n_total)

    def fuse_attention_patterns(self) -> int:
        """The attention-fusion pass alone (``passes.attention_fuse``);
        returns the number of sites fused."""
        from deeplearning4j_tpu_torch.autodiff.passes import attention_fuse
        fused = attention_fuse(self)
        if fused:
            self._exec_cache.clear()
        return fused

    def optimize(self, passes=None) -> Dict[str, int]:
        """Run the GraphOptimizer pipeline (``autodiff/passes.py``): cast
        folding, mask strength reduction, LayerNorm/GELU re-fusion,
        attention fusion, iterated to a fixpoint. Importers run it after
        import unless ``DL4J_TORCH_GRAPHOPT=0``. Returns per-pass rewrite
        counts."""
        from deeplearning4j_tpu_torch.autodiff.passes import GraphOptimizer
        return GraphOptimizer(self, passes=passes).run()

    def batch_output(self):
        """Fluent executor (reference: sd.batchOutput())."""
        sd = self

        class _Builder:
            def __init__(self):
                self._ph = {}
                self._outs = []

            def input(self, name, arr):
                self._ph[name if isinstance(name, str) else name.name] \
                    = arr
                return self

            def output(self, *names):
                self._outs.extend(n if isinstance(n, str) else n.name
                                  for n in names)
                return self

            def output_all(self):
                self._outs = [n for n, v in sd.vars.items()
                              if v.var_type is VariableType.ARRAY]
                return self

            def exec(self):
                return sd.output(self._ph, self._outs)

        return _Builder()

    # -- gradients -----------------------------------------------------
    def set_loss_variables(self, *names):
        # accept varargs or a single list/tuple (reference overloads)
        if len(names) == 1 and isinstance(names[0], (list, tuple)):
            names = names[0]
        self.loss_variables = [n.name if isinstance(n, SDVariable) else n
                               for n in names]

    def calculate_gradients(self, placeholders: dict,
                            wrt: Sequence) -> Dict[str, torch.Tensor]:
        """Gradients of the summed loss variables with respect to the
        given VARIABLEs (reference: sd.calculateGradients); a variable
        the loss does not reach gets zeros. The walk trains (dropout on)
        from the fixed random key 0, as the JAX package's does."""
        if not self.loss_variables:
            raise ValueError("call set_loss_variables first")
        wrt = [w.name if isinstance(w, SDVariable) else w for w in wrt]
        ph_vals = self._placeholders(placeholders)
        plan = self._plan(tuple(self.loss_variables), tuple(ph_vals))
        leaves = {n: self._arrays[n].detach().requires_grad_(True)
                  for n in wrt}
        var_vals = {n: self._arrays[n] for n in plan.variables}
        var_vals.update(leaves)
        with torch.enable_grad():
            outs = self._run(plan, var_vals, ph_vals, self.loss_variables,
                             training=True, rng=RngKey(0))
            total = sum(o.sum() for o in outs)
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        return {n: (g if g is not None else torch.zeros_like(leaves[n]))
                for n, g in zip(wrt, grads)}

    # -- training ------------------------------------------------------
    def set_training_config(self, config):
        self.training_config = config

    def _check_training(self):
        if self.training_config is None:
            raise ValueError("call set_training_config first")
        if not self.loss_variables:
            raise ValueError("call set_loss_variables first")

    def _train_step(self, ph_vals: Dict[str, torch.Tensor],
                    rng: RngKey) -> torch.Tensor:
        """One update of every VARIABLE the loss reaches: autograd over
        the walk (random ops drawing from ``rng``), then the updater; the
        loss (l1/l2 terms included) as a 0-d tensor."""
        cfg = self.training_config
        plan = self._plan(tuple(self.loss_variables), tuple(ph_vals))
        names = plan.variables
        if self._updater_state is None:
            self._updater_state = cfg.updater.init_state(
                {n: self._arrays[n] for n in names})
            self._restore_updater_leaves()
        # an encoded run's error-feedback residual belongs to its exchange
        self._updater_state = zero.strip_encoded_state(self._updater_state)
        params = {n: self._arrays[n].detach().requires_grad_(True)
                  for n in names}
        with torch.enable_grad():
            outs = self._run(plan, params, ph_vals, self.loss_variables,
                             training=True, rng=rng)
            total = sum(o.sum() for o in outs)
            if cfg.l2:
                total = total + 0.5 * cfg.l2 * sum(
                    (p * p).sum() for p in params.values())
            if cfg.l1:
                total = total + cfg.l1 * sum(
                    p.abs().sum() for p in params.values())
            grads = torch.autograd.grad(total, list(params.values()),
                                        allow_unused=True)
        with torch.no_grad():
            grads = {n: (g if g is not None else torch.zeros_like(params[n]))
                     for n, g in zip(names, grads)}
            updates, self._updater_state = cfg.updater.apply(
                grads, self._updater_state, self.iteration_count,
                self.epoch_count)
            for n, p in params.items():
                u = updates[n]
                if p.dtype in (torch.float32, torch.float64):
                    self._arrays[n] = (p - u).to(p.dtype)
                else:
                    # a 16-bit variable steps at f32 and rounds once
                    self._arrays[n] = (p.float() - u.float()).to(p.dtype)
        return total.detach()

    def fit_steps(self, placeholders: Dict, n_steps: int, mesh=None,
                  update_exchange="auto", tp_specs=None, ph_specs=None,
                  encoding=None) -> float:
        """``n_steps`` train steps on ONE fixed placeholder batch; the
        updater iteration continues from ``iteration_count`` (shared with
        ``fit``), so ``fit_steps(b, 5)`` twice equals ``fit_steps(b,
        10)``. Returns the last step's loss; one listener round at the
        end, as the JAX package's fori-loop does. The call takes one
        random key and step ``i`` folds ``i`` into it.

        ``mesh`` (a ``parallel.mesh.DpMesh``) trains data-parallel on
        the global batch ``placeholders`` (``autodiff/samediff_dp.py``):
        the batch placeholders shard over the replicas, and the loss is
        the global batch's. ``update_exchange`` is ``parallel/zero.py``'s
        (``auto`` resolves to ``sharded`` over more than one replica;
        ``dense``, ``sharded``, ``encoded`` with ``encoding``, or
        ``fsdp``); ``ph_specs`` as ``output``'s. ``tp_specs`` raise
        (SameDiff's tensor-parallel specs are ROADMAP item 12)."""
        if tp_specs:
            raise samediff_dp._item12("tensor-parallel fit_steps "
                                      "(tp_specs=)")
        self._check_training()
        ph_vals = self._placeholders(placeholders)
        if mesh is not None:
            loss = samediff_dp.fit_steps(self, ph_vals, n_steps, mesh,
                                         update_exchange, ph_specs,
                                         encoding)
        else:
            zero.parse_update_exchange(update_exchange)
            loss = None
            self._rng, rng = self._rng.split(2)
            for i in range(int(n_steps)):
                loss = self._train_step(ph_vals, rng.fold_in(i))
                self.iteration_count += 1
        if loss is None:
            return self._score
        self._score = float(loss.float())
        first = next(iter(ph_vals.values()), None)
        if first is not None and first.dim():
            self.last_batch_size = int(first.shape[0])
        for lis in self.listeners:
            lis.iteration_done(self, self.iteration_count - 1,
                               self.epoch_count)
        return self._score

    # -- listener bus ---------------------------------------------------
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def score(self) -> float:
        """Loss of the most recent train step."""
        return float(self._score)

    def _run_validation(self, iterator, evaluations, placeholders_fn):
        """One pass over the validation iterator: mean loss and the
        requested per-output evaluations (reference: SameDiff.fit's
        validation ``History`` records)."""
        cfg = self.training_config
        evals = {}
        for name, spec in (evaluations or {}).items():
            factory, label_idx = (spec if isinstance(spec, tuple)
                                  else (spec, 0))
            evals[name] = (factory(), label_idx)
        if hasattr(iterator, "reset"):
            iterator.reset()
        data = [iterator] if hasattr(iterator, "features") else iterator
        losses = []
        want = list(evals) + [v for v in self.loss_variables
                              if v not in evals]
        for batch in data:
            ph = (placeholders_fn(batch) if placeholders_fn
                  else cfg.placeholders_from(batch))
            out = self.output(ph, want)
            losses.append(sum(float(out[v].sum())
                              for v in self.loss_variables))
            if not evals:
                continue
            if cfg.data_set_label_mapping and all(
                    n in ph for n in cfg.data_set_label_mapping):
                labels = [ph[n] for n in cfg.data_set_label_mapping]
            else:
                labels = getattr(batch, "labels", None)
                if labels is None:
                    raise ValueError(
                        "validation evaluation needs labels: map them "
                        "via data_set_label_mapping or provide "
                        "batches with a .labels attribute")
                labels = (labels if isinstance(labels, (list, tuple))
                          else [labels])
            for name, (e, li) in evals.items():
                e.eval(np.asarray(labels[li]), to_numpy(out[name]))
        val_loss = float(np.mean(losses)) if losses else float("nan")
        return {k: e for k, (e, _) in evals.items()}, val_loss

    def fit(self, iterator=None, *, n_epochs: int = 1,
            placeholders_fn=None, listeners=None, validation_iter=None,
            validation_evaluations=None, validation_frequency: int = 1):
        """Train over an iterator of batches. Each batch gives the
        placeholder dict through the training config's feature/label
        mappings, or through ``placeholders_fn(batch) -> dict``.
        ``validation_iter`` with ``validation_evaluations``
        (``{output: Evaluation factory or (factory, label index)}``) is
        evaluated every ``validation_frequency`` epochs into the
        returned ``History``."""
        from deeplearning4j_tpu_torch.autodiff.training import (
            History, device_prefetch_placeholders)
        from deeplearning4j_tpu_torch.common.environment import Environment
        self._check_training()
        cfg = self.training_config
        all_listeners = self.listeners + list(listeners or [])
        history = History()
        env = Environment.get()

        def make_ph(batch):
            return (placeholders_fn(batch) if placeholders_fn
                    else cfg.placeholders_from(batch))

        def to_host(v):
            # the graph's dtype rule on the host; a tensor stays put
            return v if isinstance(v, torch.Tensor) else as_tensor(v, "cpu")

        for epoch in range(n_epochs):
            for lis in all_listeners:
                lis.on_epoch_start(self)
            if hasattr(iterator, "reset"):
                iterator.reset()
            epoch_losses = []
            # the feeder thread maps each batch and copies it to the
            # device a batch ahead of the step
            staged = (device_prefetch_placeholders(
                          iterator, make_ph, to_host, self.device,
                          depth=env.device_prefetch_depth)
                      if env.device_prefetch
                      else (self._placeholders(make_ph(b)) for b in iterator))
            for ph_vals in staged:
                self._rng, rng = self._rng.split(2)
                loss = self._train_step(ph_vals, rng)
                epoch_losses.append(float(loss.float()))
                self._score = epoch_losses[-1]
                first = next(iter(ph_vals.values()))
                self.last_batch_size = (int(first.shape[0])
                                        if first.dim() else 0)
                # the counter advances before listeners fire, so a
                # checkpoint they write resumes at the next iteration
                self.iteration_count += 1
                for lis in all_listeners:
                    lis.iteration_done(self, self.iteration_count - 1,
                                       self.epoch_count)
            evals, val_loss = {}, float("nan")
            if validation_iter is not None and \
                    (epoch + 1) % max(1, validation_frequency) == 0:
                evals, val_loss = self._run_validation(
                    validation_iter, validation_evaluations,
                    placeholders_fn)
            history.add_epoch(epoch, epoch_losses, evals, val_loss)
            self.epoch_count += 1
            for lis in all_listeners:
                lis.on_epoch_end(self)
        return history

    # -- updater state as the JAX package's flat leaves -----------------
    def _updater_leaves(self) -> List[torch.Tensor]:
        """The updater state's leaves in ``jax.tree_util`` order (slots
        sorted, then names sorted), as ``updater.npz`` holds them."""
        st = self._updater_state or {}
        return [st[slot][n] for slot in sorted(st)
                for n in sorted(st[slot])]

    def _restore_updater_leaves(self):
        """Graft leaves loaded from a zip onto the freshly built state
        (same graph and updater -> same leaves), so a loaded model
        resumes with its optimizer moments."""
        loaded = self._loaded_updater_leaves
        if loaded is None:
            return
        st = self._updater_state
        slots = [(slot, n) for slot in sorted(st) for n in sorted(st[slot])]
        if len(slots) != len(loaded):
            raise ValueError(
                f"saved updater state has {len(loaded)} leaves, current "
                f"updater expects {len(slots)} — updater/graph changed "
                f"since save")
        for (slot, n), arr in zip(slots, loaded):
            ref = st[slot][n]
            st[slot][n] = as_tensor(arr, self.device).to(ref.dtype)
        self._loaded_updater_leaves = None

    # -- serialization -------------------------------------------------
    def save(self, path: str, save_updater_state: bool = True):
        """Zip: ``graph.json`` + ``arrays.npz`` (+ ``updater.npz``), the
        JAX package's layout; a control-flow subgraph's arrays go into
        ``arrays.npz`` under ``__cf.op<i>...`` names."""
        cf_arrays: dict = {}
        graph = {
            "variables": [
                {"name": v.name, "type": v.var_type.value,
                 "shape": list(v.shape) if v.shape else None,
                 "dtype": v.dtype}
                for v in self.vars.values()],
            "ops": [{"op": o.op_name, "inputs": o.inputs,
                     "outputs": o.outputs,
                     "attrs": _json_attrs(o.attrs, cf_arrays,
                                          f"__cf.op{i}")}
                    for i, o in enumerate(self.ops)],
            "loss_variables": self.loss_variables,
            "training_config": (self.training_config.to_map()
                                if self.training_config else None),
            "iteration_count": self.iteration_count,
            "epoch_count": self.epoch_count,
        }
        arrays = {k: to_numpy(v) for k, v in self._arrays.items()}
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("graph.json", json.dumps(graph, indent=1))
            buf = io.BytesIO()
            np.savez(buf, **arrays, **cf_arrays)
            z.writestr("arrays.npz", buf.getvalue())
            if save_updater_state and self._updater_state is not None:
                buf2 = io.BytesIO()
                np.savez(buf2, **{f"leaf_{i}": to_numpy(leaf) for i, leaf
                                  in enumerate(self._updater_leaves())})
                z.writestr("updater.npz", buf2.getvalue())

    @staticmethod
    def load(path: str, device: Union[None, str, torch.device] = None
             ) -> "SameDiff":
        """Load a zip ``save`` (of either package) wrote, onto ``device``
        (``None``: the card). An op of a domain not ported yet raises
        ``NotImplementedError`` here."""
        from deeplearning4j_tpu_torch.autodiff.training import TrainingConfig
        sd = SameDiff(device)
        with zipfile.ZipFile(path) as z:
            graph = json.loads(z.read("graph.json"))
            arrays = np.load(io.BytesIO(z.read("arrays.npz")))
            arr_map = {k: arrays[k] for k in arrays.files}
            upd = (np.load(io.BytesIO(z.read("updater.npz")))
                   if "updater.npz" in z.namelist() else None)
            if upd is not None:
                sd._loaded_updater_leaves = [
                    upd[f"leaf_{i}"] for i in range(len(upd.files))]
        for vd in graph["variables"]:
            v = SDVariable(sd, vd["name"], VariableType(vd["type"]),
                           vd["shape"], vd["dtype"])
            sd.vars[v.name] = v
            if v.name in arr_map:
                arr = as_tensor(arr_map[v.name], sd.device)
                if v.dtype is not None:
                    arr = arr.to(torch_dtype(v.dtype))
                sd._arrays[v.name] = arr
        for i, od in enumerate(graph["ops"]):
            get_op(od["op"])
            node = OpNode(od["op"], od["inputs"], od["outputs"],
                          _rebuild_cf_attrs(od["op"], od["attrs"], arr_map,
                                            sd.device))
            sd.ops.append(node)
            for on in node.outputs:
                sd._producer[on] = i
        sd.loss_variables = graph.get("loss_variables", [])
        sd.iteration_count = graph.get("iteration_count", 0)
        sd.epoch_count = graph.get("epoch_count", 0)
        tc = graph.get("training_config")
        if tc:
            sd.training_config = TrainingConfig.from_map(tc)
        return sd

    # -- introspection -------------------------------------------------
    def variables(self) -> List[SDVariable]:
        return list(self.vars.values())

    def get_variable(self, name: str) -> SDVariable:
        return self.vars[name]

    def has_variable(self, name: str) -> bool:
        return name in self.vars

    def summary(self) -> str:
        lines = [f"{'var':<28}{'type':<14}{'shape':<18}producer op"]
        for v in self.vars.values():
            prod = ""
            if v.name in self._producer:
                prod = self.ops[self._producer[v.name]].op_name
            lines.append(f"{v.name:<28}{v.var_type.value:<14}"
                         f"{str(v.shape):<18}{prod}")
        lines.append(f"{len(self.ops)} ops, {len(self.vars)} variables")
        return "\n".join(lines)


def _json_attrs(attrs: dict, array_sink: Optional[dict] = None,
                prefix: str = "") -> dict:
    out = {}
    for k, v in (attrs or {}).items():
        if callable(v):
            continue    # call closures are rebuilt from *_spec on load
        if k.endswith("_spec") and isinstance(v, dict) and "child" in v:
            v = _spec_to_json(v, array_sink, f"{prefix}.{k}")
        elif isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        elif isinstance(v, tuple):
            v = list(v)
        elif isinstance(v, (torch.dtype, np.dtype)):
            v = dtype_name(v)
        elif hasattr(v, "dtype") and hasattr(v, "tolist"):
            v = v.tolist()
        out[k] = v
    return out


def _spec_to_json(spec: dict, array_sink: Optional[dict] = None,
                  prefix: str = "") -> dict:
    """A control-flow subgraph as the JAX package writes it: the child
    graph's variables and ops, its constants and its frozen captures (at
    their values now). Arrays go into ``array_sink`` (``arrays.npz``)
    under ``prefix``; without a sink they are inlined."""
    child = spec["child"]
    arrays = {n: to_numpy(a) for n, a in child._arrays.items()}
    for local, owner, pname in spec["frozen_caps"]:
        arrays[local] = to_numpy(owner._arrays[pname])
    out = {
        "vars": [{"name": v.name, "type": v.var_type.value,
                  "shape": list(v.shape) if v.shape else None,
                  "dtype": v.dtype}
                 for v in child.vars.values()],
        "ops": [{"op": o.op_name, "inputs": o.inputs,
                 "outputs": o.outputs,
                 "attrs": _json_attrs(o.attrs, array_sink,
                                      f"{prefix}.op{i}")}
                for i, o in enumerate(child.ops)],
        "proxies": spec["proxies"],
        "outs": spec["outs"],
        "parent_cap_locals": spec["parent_cap_locals"],
    }
    if array_sink is not None:
        out["arrays_prefix"] = prefix
        out["array_names"] = sorted(arrays)
        for n, a in arrays.items():
            array_sink[f"{prefix}/{n}"] = a
    else:
        out["arrays"] = {n: {"dtype": str(a.dtype), "data": a.tolist()}
                         for n, a in arrays.items()}
    return out


def _call_from_json_spec(spec: dict, arr_map: Optional[dict], device):
    """The call closure of a subgraph read back from its JSON form (the
    load-side twin of ``SameDiff._trace_subgraph``'s)."""
    child = SameDiff(device)
    for vd in spec["vars"]:
        v = SDVariable(child, vd["name"], VariableType(vd["type"]),
                       vd["shape"], vd["dtype"])
        child.vars[v.name] = v
    if "arrays_prefix" in spec:
        pre = spec["arrays_prefix"]
        found = {n: arr_map[f"{pre}/{n}"] for n in spec["array_names"]}
    else:
        found = {n: np.asarray(rec["data"], dtype=rec["dtype"])
                 for n, rec in spec.get("arrays", {}).items()}
    for n, a in found.items():
        arr = as_tensor(a, device)
        dt = child.vars[n].dtype if n in child.vars else None
        child._arrays[n] = arr.to(torch_dtype(dt)) if dt else arr
    for i, od in enumerate(spec["ops"]):
        get_op(od["op"])
        child.ops.append(OpNode(od["op"], od["inputs"], od["outputs"],
                                _rebuild_cf_attrs(od["op"], od["attrs"],
                                                  arr_map, device)))
        for on in od["outputs"]:
            child._producer[on] = i
    idxs = child._ancestors(list(spec["outs"]))
    proxies = list(spec["proxies"])
    cap_locals = list(spec["parent_cap_locals"])
    outs = list(spec["outs"])
    n_args = len(proxies)

    def call(*args):
        values = dict(child._arrays)
        if args and _on_meta(args):
            values = {k: v.to("meta") for k, v in values.items()}
        values.update(zip(proxies, args[:n_args]))
        values.update(zip(cap_locals, args[n_args:]))
        child._execute(values, idxs)
        return [values[n] for n in outs]

    return call


#: control-flow attrs: call closure -> its serialized spec
_CF_CALL_SPECS = {"_cond_call": "_cond_spec", "_body_call": "_body_spec",
                  "_true_call": "_true_spec",
                  "_false_call": "_false_spec"}


def _rebuild_cf_attrs(op_name: str, attrs: dict,
                      arr_map: Optional[dict], device) -> dict:
    """The call closures of a (possibly nested) control-flow op loaded
    from JSON; other ops' attrs pass unchanged."""
    if op_name not in ("while_loop", "cond", "scan"):
        return attrs
    attrs = dict(attrs)
    for call_key, spec_key in _CF_CALL_SPECS.items():
        spec = attrs.get(spec_key)
        if spec is not None and call_key not in attrs:
            attrs[call_key] = _call_from_json_spec(spec, arr_map, device)
    return attrs


class _ProgramModule(torch.nn.Module):
    """A subgraph as a module for ``torch.export``: ``forward(
    placeholders, key)`` walks the ops of ``plan`` with the control ops
    lowered (``registry.lowering_for_export``) and the random ops drawing
    under the call key (``common.rng.TracedKey``); the variables and
    constants it reads are buffers, so the exported program holds
    them."""

    def __init__(self, sd: SameDiff, plan: _Plan, outputs: Tuple[str, ...],
                 training: bool):
        super().__init__()
        self._walk = (sd, list(plan.ops), tuple(outputs), bool(training))
        self._names = list(plan.variables) + list(plan.constants)
        for i, n in enumerate(self._names):
            self.register_buffer(f"a{i}", sd._arrays[n])

    def forward(self, placeholders: Dict[str, torch.Tensor],
                key: torch.Tensor):
        sd, ops, outputs, training = self._walk
        values = {n: getattr(self, f"a{i}")
                  for i, n in enumerate(self._names)}
        values.update(placeholders)
        with lowering_for_export():
            sd._execute(values, ops, TracedKey(key), training)
        return tuple(values[n] for n in outputs)

