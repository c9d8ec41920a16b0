"""GraphOptimizer — ordered, fixpoint-iterated rewrite passes over a
SameDiff op graph.

Counterpart of ``deeplearning4j_tpu/autodiff/passes.py`` (reference:
``org.nd4j.autodiff.samediff.optimize.GraphOptimizer`` +
``OptimizationConfig``, ordered ``Optimizer`` lists run until
quiescence). The passes target the arithmetic TF/ONNX *exporters* bake
into transformer graphs:

  cast_fold             constant-fold casts of constants, drop identity
                        casts and dead dtype round-trips
  mask_strength_reduce  rewrite the exporter's ``(1-mask)*-1e9`` additive
                        attention-bias chains into one ``apply_key_mask``
                        select — the native key-mask form ``sdpa_core``
                        accepts directly
  layernorm_refuse      re-fuse decomposed LayerNorm op walks
                        (mean/var/rsqrt TF form AND the HF-ONNX
                        sub/pow/sqrt/div form) into the native
                        ``layer_norm`` op
  gelu_refuse           re-fuse decomposed GELU chains (erf form and
                        tanh approximation) into ``gelu``/``gelu_tanh``
  attention_fuse        the existing attention fusion, now also matching
                        the ``apply_key_mask`` form so imported masked
                        attention lowers to ONE ``sdpa_core`` with a
                        native key mask

Every pass follows one fusion discipline: pattern interiors must be
consumed ONLY inside the matched pattern (conservative at
multi-consumer sites), the terminal op of the chain is rewritten IN
PLACE so requested output names stay stable, and dead interior ops are
simply left behind — the executor walks ancestors of the requested
outputs only. Rewrites are exactness-preserving for the exporter
conventions they target (see each pass docstring for the precise
contract); each pass is idempotent, so a second ``run()`` reports zero
rewrites.

Observability: ``dl4j_graphopt_rewrites_total{pass=...}`` counts
rewrites and each pass runs under a ``graphopt.<pass>`` span.
``DL4J_TORCH_GRAPHOPT=0`` (or ``Environment.extra["graphopt"]``) kills
the post-import pipeline entirely.

Dtypes are compared by their numpy names (``autodiff/registry.py:
dtype_name``); ``bfloat16``, which numpy lacks, is never value-preserving
to or from another dtype here.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.autodiff.registry import (dtype_name,
                                                        torch_dtype)
from deeplearning4j_tpu_torch.autodiff.samediff import (OpNode, SDVariable,
                                                        VariableType,
                                                        to_numpy)
from deeplearning4j_tpu_torch.common import telemetry

log = logging.getLogger("deeplearning4j_tpu_torch")

_REWRITES = telemetry.counter(
    "dl4j_graphopt_rewrites_total",
    "GraphOptimizer rewrites applied, labeled by pass")

#: ops that only select/rearrange elements — they commute with any
#: elementwise computation, so a chain of them between a matched
#: pattern and its use site can be replayed on a different input
_SHAPE_ONLY_OPS = frozenset({
    "reshape", "expand_dims", "squeeze", "index", "slice",
    "strided_slice", "permute", "transpose", "tile", "broadcast_to",
    "identity",
})


def graphopt_enabled() -> bool:
    """Post-import pipeline gate: on unless DL4J_TORCH_GRAPHOPT=0
    (Environment ``extra["graphopt"]`` overrides)."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    flag = Environment.get().extra.get("graphopt")
    if flag is None:
        flag = os.environ.get("DL4J_TORCH_GRAPHOPT", "1")
    return str(flag) in ("1", "true", "True", "yes")


# -- shared pattern-matching helpers ----------------------------------------
class _Ctx:
    """Per-pass view of the graph: consumer map + lookup helpers.
    Built once at pass start; rewrites within the pass only ever
    REMOVE consumers from matched sites (patterns are disjoint by the
    interior-consumer discipline), so stale entries overcount
    consumers — which errs conservative."""

    def __init__(self, sd):
        self.sd = sd
        self.consumers: Dict[str, List[int]] = {}
        for idx, o in enumerate(sd.ops):
            for inp in o.inputs:
                self.consumers.setdefault(inp, []).append(idx)

    def producer(self, name: str) -> Optional[OpNode]:
        i = self.sd._producer.get(name)
        return self.sd.ops[i] if i is not None else None

    def producer_idx(self, name: str) -> Optional[int]:
        return self.sd._producer.get(name)

    def single_use(self, name: str) -> bool:
        return len(self.consumers.get(name, ())) == 1

    def scalar_const(self, name: str) -> Optional[float]:
        a = self.sd._arrays.get(name)
        if a is None or a.numel() != 1:
            return None
        v = self.sd.vars.get(name)
        if v is None or v.var_type is not VariableType.CONSTANT:
            return None
        return float(a.reshape(()).item())

    def interiors_private(self, op_idxs, terminal_idx: int) -> bool:
        """True iff every value produced by ``op_idxs`` (except the
        terminal's outputs) is consumed only inside the matched
        pattern — the conservative multi-consumer guard every pass
        shares."""
        idx_set = set(op_idxs) | {terminal_idx}
        for i in idx_set:
            if i == terminal_idx:
                continue
            o = self.sd.ops[i]
            for out in o.outputs:
                for c in self.consumers.get(out, ()):
                    if c not in idx_set:
                        return False
        return True

    def append_op(self, op_name: str, inputs: List[str], attrs: dict,
                  base: str) -> str:
        """Append a fresh op at raw level (the pass runs outside
        ``_op``'s user-facing validation); returns the output name."""
        out = self.sd._unique(base)
        node = OpNode(op_name, list(inputs), [out], dict(attrs))
        idx = len(self.sd.ops)
        self.sd.ops.append(node)
        self.sd.vars[out] = SDVariable(self.sd, out, VariableType.ARRAY)
        self.sd._producer[out] = idx
        for inp in inputs:
            self.consumers.setdefault(inp, []).append(idx)
        return out

    def repoint(self, old: str, new: str) -> None:
        """Redirect every consumer of ``old`` to read ``new``."""
        for i in self.consumers.pop(old, []):
            o = self.sd.ops[i]
            o.inputs = [new if n == old else n for n in o.inputs]
            self.consumers.setdefault(new, []).append(i)


def _name_of(dt) -> Optional[str]:
    try:
        return dtype_name(dt)
    except (TypeError, KeyError, AttributeError):
        return None


def _dtype_of(ctx: _Ctx, name: str) -> Optional[str]:
    """Best statically-known dtype name of a value, or None. Sources, in
    order: a stored array (constants/variables), var metadata, the
    producing cast's target dtype."""
    a = ctx.sd._arrays.get(name)
    if a is not None:
        return _name_of(a.dtype)
    v = ctx.sd.vars.get(name)
    dt = getattr(v, "dtype", None)
    if dt is not None:
        return _name_of(dt)
    p = ctx.producer(name)
    if p is not None and p.op_name == "cast":
        return _name_of(p.attrs.get("dtype"))
    return None


def _kind(dt: Optional[str]) -> Optional[str]:
    """numpy's kind letter of a dtype name; None for bfloat16 and
    unknowns."""
    try:
        return np.dtype(dt).kind
    except TypeError:
        return None


def _value_preserving(src: str, dst: str) -> bool:
    """True iff casting src->dst loses no values (so a later cast of
    the result equals a direct cast of the source)."""
    try:
        return bool(np.can_cast(np.dtype(src), np.dtype(dst),
                                casting="safe"))
    except TypeError:
        return False


def _last_axis_reduce(ctx: _Ctx, node: OpNode) -> bool:
    if node.op_name != "reduce_mean":
        return False
    if not node.attrs.get("keep_dims"):
        return False
    ax = node.attrs.get("axis")
    if isinstance(ax, (list, tuple)):
        if len(ax) != 1:
            return False
        ax = ax[0]
    if ax is None:
        return False
    if int(ax) == -1:
        return True
    v = ctx.sd.vars.get(node.inputs[0])
    shp = getattr(v, "shape", None)
    return shp is not None and int(ax) == len(shp) - 1


def _close(val: Optional[float], target: float, rtol: float = 1e-3):
    return val is not None and abs(val - target) <= rtol * abs(target)


def _resort_ops(sd) -> None:
    """Restore topological op order (the executor runs ops in index
    order) after a pass appends ops whose consumers sit earlier in
    the walk. Stable Kahn sort — untouched regions keep their
    relative order — followed by a ``_producer`` rebuild."""
    import heapq
    prod = {}
    for i, o in enumerate(sd.ops):
        for out in o.outputs:
            prod[out] = i
    succs: Dict[int, List[int]] = {}
    indeg = [0] * len(sd.ops)
    for i, o in enumerate(sd.ops):
        for inp in o.inputs:
            j = prod.get(inp)
            if j is not None and j != i:
                succs.setdefault(j, []).append(i)
                indeg[i] += 1
    heap = [i for i, d in enumerate(indeg) if d == 0]
    heapq.heapify(heap)
    order = []
    while heap:
        i = heapq.heappop(heap)
        order.append(i)
        for s in succs.get(i, ()):
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, s)
    if len(order) != len(sd.ops):     # cycle — leave the walk alone
        log.warning("graphopt: topo re-sort found a cycle; "
                    "keeping existing op order")
        return
    sd.ops = [sd.ops[i] for i in order]
    sd._producer = {out: idx for idx, o in enumerate(sd.ops)
                    for out in o.outputs}


# -- pass 1: cast folding ---------------------------------------------------
def cast_fold(sd) -> int:
    """Constant-fold and eliminate exporter cast arithmetic.

    Three exact rewrites, fixpoint-composable:
      * identity cast (target dtype == known input dtype): consumers
        read the input directly;
      * cast-of-cast where the inner hop is value-preserving
        (np.can_cast 'safe'): skip the intermediate — this unwinds
        the f32->f64->f32 round-trips exporters bake, because after
        the skip the outer cast becomes an identity cast;
      * cast of a CONSTANT: folded to a new constant at import time
        (memoized per (const, dtype)), so the per-step graph never
        recasts frozen weights.

    The cast op itself is never deleted — a requested output named
    after it still executes; it merely goes dead when nothing reads
    it."""
    ctx = _Ctx(sd)
    folded_consts: Dict[Tuple[str, str], str] = {}
    count = 0
    for node in list(sd.ops):
        if node.op_name != "cast":
            continue
        target = _name_of(node.attrs.get("dtype"))
        if target is None:
            continue
        src_name = node.inputs[0]
        src_dt = _dtype_of(ctx, src_name)
        # identity cast: x.astype(x.dtype) is exact for every dtype
        if src_dt is not None and src_dt == target:
            if ctx.consumers.get(node.outputs[0]):
                ctx.repoint(node.outputs[0], src_name)
                count += 1
            continue
        # cast-of-cast: collapse through a value-preserving inner hop
        inner = ctx.producer(src_name)
        if inner is not None and inner.op_name == "cast":
            base = inner.inputs[0]
            base_dt = _dtype_of(ctx, base)
            if base_dt is not None and src_dt is not None \
                    and _value_preserving(base_dt, src_dt):
                idx = ctx.producer_idx(node.outputs[0])
                cons = ctx.consumers.get(src_name)
                if cons is not None and idx in cons:
                    cons.remove(idx)
                node.inputs = [base if n == src_name else n
                               for n in node.inputs]
                ctx.consumers.setdefault(base, []).append(idx)
                count += 1
                continue
        # constant folding: cast(CONSTANT) -> new constant
        v = sd.vars.get(src_name)
        arr = sd._arrays.get(src_name)
        if v is not None and arr is not None \
                and v.var_type is VariableType.CONSTANT \
                and ctx.consumers.get(node.outputs[0]):
            key = (src_name, target)
            new = folded_consts.get(key)
            if new is None:
                new = sd.constant(f"{src_name}__as_{target}",
                                  arr.to(torch_dtype(target))).name
                folded_consts[key] = new
            ctx.repoint(node.outputs[0], new)
            count += 1
    return count


# -- pass 2: mask strength reduction ----------------------------------------
def mask_strength_reduce(sd) -> int:
    """Rewrite the exporter's additive attention-mask arithmetic

        scores + broadcast((1 - mask) * neg)     (neg <= -1e4)

    into the native select form ``apply_key_mask(scores, mask)`` —
    the key-mask form ``sdpa_core`` accepts directly, and what unlocks
    the flash kernels (which stream a [b, t_k] key mask but cannot
    stream a dense additive bias).

    Exactness contract: requires (a) the mask provably 0/1-valued —
    its producer chain must bottom out in an integer/bool placeholder
    or cast-from-integer (the TF and HF-ONNX export conventions), or a
    constant whose values are all 0/1; (b) the rewritten add feeds
    ONLY a last-axis softmax. Then unmasked scores pass through
    bitwise (x + 0.0*neg == x) and masked scores underflow to exactly
    0.0 post-softmax in both forms (exp(x + neg - max) == exp(neg -
    max) == 0.0 in f32 for neg <= -1e4 and |scores| within any sane
    range), so the softmax output is identical. Rows with ALL keys
    masked are undefined by the exporter convention (padding masks
    always keep >= 1 token) and may differ.

    Shape-only ops between the mul and the add (the exporter's
    ``[:, None, None, :]`` broadcast) are replayed on the mask itself,
    memoized so N layers sharing one bias chain share one mask
    broadcast."""
    ctx = _Ctx(sd)
    memo: Dict[tuple, str] = {}
    count = 0

    def _binary_provenance(name: str) -> bool:
        # strip value-preserving unary hops to the mask's origin
        seen = 0
        while seen < 8:
            p = ctx.producer(name)
            if p is not None and p.op_name == "cast":
                name = p.inputs[0]
                seen += 1
                continue
            break
        if _kind(_dtype_of(ctx, name)) in ("i", "u", "b"):
            return True
        v = sd.vars.get(name)
        a = sd._arrays.get(name)
        if v is not None and a is not None \
                and v.var_type is VariableType.CONSTANT:
            vals = to_numpy(a)
            return bool(np.all((vals == 0) | (vals == 1)))
        return False

    def _match_bias_chain(name: str):
        """bias operand -> (mask_name, neg_const, shape_chain ops
        add-side-first) or None."""
        chain: List[OpNode] = []
        cur = name
        for _ in range(8):
            p = ctx.producer(cur)
            if p is None:
                return None
            if p.op_name in _SHAPE_ONLY_OPS:
                chain.append(p)
                cur = p.inputs[0]
                continue
            if p.op_name != "mul":
                return None
            # mul((1 - mask), neg) — neg on either side
            a, b = p.inputs
            neg = ctx.scalar_const(b)
            sub_name = a
            if neg is None:
                neg = ctx.scalar_const(a)
                sub_name = b
            if neg is None or neg > -1e4:
                return None
            s = ctx.producer(sub_name)
            if s is None or s.op_name != "sub":
                return None
            one = ctx.scalar_const(s.inputs[0])
            if one is None or one != 1.0:
                return None
            mask = s.inputs[1]
            if not _binary_provenance(mask):
                return None
            # interiors (mul out, sub out) may be shared across
            # layers — we clone, never mutate, so multi-consumer
            # chains are fine here
            return mask, float(neg), chain
        return None

    for node in list(sd.ops):
        if node.op_name != "add":
            continue
        out = node.outputs[0]
        cons = ctx.consumers.get(out, [])
        if len(cons) != 1:
            continue
        nxt = sd.ops[cons[0]]
        if nxt.op_name != "softmax" \
                or nxt.attrs.get("axis", -1) not in (-1, None):
            continue
        for x_name, b_name in (node.inputs, node.inputs[::-1]):
            m = _match_bias_chain(b_name)
            if m is None:
                continue
            mask, neg, chain = m
            key = (mask,) + tuple(
                (c.op_name, repr(sorted(c.attrs.items())))
                for c in chain)
            mvar = memo.get(key)
            if mvar is None:
                mvar = mask
                for c in reversed(chain):    # mul-side first
                    mvar = ctx.append_op(c.op_name, [mvar], c.attrs,
                                         "graphopt_mask")
                memo[key] = mvar
            node.op_name = "apply_key_mask"
            node.inputs = [x_name, mvar]
            node.attrs = {"neg": neg}
            count += 1
            break
    if count:
        # cloned mask-broadcast ops were appended at the end of the
        # walk; their consumers sit earlier — restore topo order
        _resort_ops(sd)
    return count


# -- pass 3: LayerNorm re-fusion --------------------------------------------
def layernorm_refuse(sd) -> int:
    """Re-fuse decomposed LayerNorm chains into the native
    ``layer_norm`` op. Matches BOTH exporter decompositions over the
    last axis:

      TF:   (x - mu) * rsqrt(mean(squared_difference(x, mu)) + eps)
            * gamma + beta
      ONNX: (x - mu) / sqrt(mean((x - mu)^2) + eps) * gamma + beta
            (the HF export: ReduceMean/Sub/Pow/ReduceMean/Add/Sqrt/
            Div/Mul/Add)

    plus the mul(d, d)/square(d) variance spellings. The native op
    computes the same mean/biased-variance formulation; the only float difference is
    rsqrt-mul vs sqrt-div association in the ONNX form, ~1 ulp.
    Conservative: every interior value must be consumed only inside
    the matched chain; eps must be a scalar constant."""
    ctx = _Ctx(sd)
    count = 0

    def _match_var(veps_name: str, x: str, mu: str, d: str):
        """add(var, eps) -> (eps, [op idxs]) or None."""
        veps = ctx.producer(veps_name)
        if veps is None or veps.op_name != "add":
            return None
        for var_name, eps_name in (veps.inputs, veps.inputs[::-1]):
            eps = ctx.scalar_const(eps_name)
            if eps is None or not (0.0 < eps < 1e-2):
                continue
            red = ctx.producer(var_name)
            if red is None or not _last_axis_reduce(ctx, red):
                continue
            sq = ctx.producer(red.inputs[0])
            if sq is None:
                continue
            ok = False
            if sq.op_name == "squared_difference":
                ok = sq.inputs[0] == x and sq.inputs[1] == mu
            elif sq.op_name == "pow":
                ok = sq.inputs[0] == d \
                    and _close(ctx.scalar_const(sq.inputs[1]), 2.0,
                               1e-9)
            elif sq.op_name == "mul":
                ok = sq.inputs[0] == d and sq.inputs[1] == d
            elif sq.op_name == "square":
                ok = sq.inputs[0] == d
            if not ok:
                continue
            idxs = [ctx.producer_idx(n) for n in
                    (veps_name, var_name, red.inputs[0])]
            return eps, idxs
        return None

    def _match_core(core_name: str):
        """normalized core -> (x, eps, op idxs) or None."""
        core = ctx.producer(core_name)
        if core is None or core.op_name not in ("mul", "div"):
            return None
        orders = [core.inputs] if core.op_name == "div" \
            else [core.inputs, core.inputs[::-1]]
        for d_name, r_name in orders:
            dnode = ctx.producer(d_name)
            if dnode is None or dnode.op_name != "sub":
                continue
            x, mu_name = dnode.inputs
            mu = ctx.producer(mu_name)
            if mu is None or not _last_axis_reduce(ctx, mu) \
                    or mu.inputs[0] != x:
                continue
            rnode = ctx.producer(r_name)
            if rnode is None:
                continue
            if core.op_name == "mul" and rnode.op_name == "rsqrt":
                pass
            elif core.op_name == "div" and rnode.op_name == "sqrt":
                pass
            else:
                continue
            got = _match_var(rnode.inputs[0], x, mu_name, d_name)
            if got is None:
                continue
            eps, var_idxs = got
            idxs = var_idxs + [ctx.producer_idx(n) for n in
                               (core_name, d_name, mu_name, r_name)]
            return x, eps, idxs
        return None

    for node in list(sd.ops):
        if node.op_name != "add":
            continue
        for yg_name, beta in (node.inputs, node.inputs[::-1]):
            yg = ctx.producer(yg_name)
            if yg is None or yg.op_name != "mul":
                continue
            hit = None
            for core_name, gamma in (yg.inputs, yg.inputs[::-1]):
                got = _match_core(core_name)
                if got is not None:
                    hit = (*got, core_name, gamma)
                    break
            if hit is None:
                continue
            x, eps, idxs, core_name, gamma = hit
            idxs = idxs + [ctx.producer_idx(yg_name)]
            term_idx = ctx.producer_idx(node.outputs[0])
            if None in idxs or term_idx is None \
                    or not ctx.interiors_private(idxs, term_idx):
                continue
            node.op_name = "layer_norm"
            node.inputs = [x, gamma, beta]
            node.attrs = {"axis": -1, "epsilon": float(eps)}
            count += 1
            break
    return count


# -- pass 4: GELU re-fusion -------------------------------------------------
def gelu_refuse(sd) -> int:
    """Re-fuse decomposed GELU chains into the native ops.

    erf form  (TF/ONNX exact GELU):
        0.5 * x * (1 + erf(x / sqrt(2)))      -> gelu
    tanh form (the BERT approximation):
        0.5 * x * (1 + tanh(0.79788456 * (x + 0.044715 * x^3)))
                                              -> gelu_tanh

    The multiplication tree is flattened, so any association of
    {0.5, x, (1 + ...)} matches; ``x / sqrt(2)`` and
    ``x * 0.7071067`` both match the erf argument; ``x^3`` matches
    pow(x, 3), x*x*x and square-mul spellings. The native ops are
    ``F.gelu`` (exact erf form and ``approximate="tanh"``) — the same
    formulas, ~1 ulp association differences. Conservative at multi-consumer interiors
    (x itself may of course fan out)."""
    ctx = _Ctx(sd)
    count = 0
    SQRT2, INV_SQRT2 = 1.4142135623730951, 0.7071067811865476
    C0, C1 = 0.7978845608028654, 0.044715

    def _factors(term: OpNode):
        """Flatten the terminal mul tree into <= 3 leaves + the
        interior mul op idxs."""
        leaves, idxs = [], []
        stack = [(term, 0)]
        while stack:
            op, depth = stack.pop()
            for inp in op.inputs:
                p = ctx.producer(inp)
                if p is not None and p.op_name == "mul" \
                        and depth < 2 and ctx.single_use(inp) \
                        and len(leaves) + len(stack) < 3:
                    idxs.append(ctx.producer_idx(inp))
                    stack.append((p, depth + 1))
                else:
                    leaves.append(inp)
        return leaves, idxs

    def _match_cube(name: str, x: str):
        p = ctx.producer(name)
        if p is None:
            return None
        if p.op_name == "pow" and p.inputs[0] == x \
                and _close(ctx.scalar_const(p.inputs[1]), 3.0, 1e-9):
            return [ctx.producer_idx(name)]
        if p.op_name == "mul":
            for a, b in (p.inputs, p.inputs[::-1]):
                q = ctx.producer(a)
                if q is None:
                    continue
                if b == x and ((q.op_name == "mul"
                                and q.inputs == [x, x])
                               or (q.op_name == "square"
                                   and q.inputs[0] == x)):
                    return [ctx.producer_idx(name),
                            ctx.producer_idx(a)]
        return None

    def _match_inner(name: str, x: str):
        """erf(x/sqrt2) -> ("gelu", idxs); tanh(...) ->
        ("gelu_tanh", idxs); else None."""
        g = ctx.producer(name)
        if g is None:
            return None
        if g.op_name == "erf":
            u = ctx.producer(g.inputs[0])
            if u is None:
                return None
            ok = False
            if u.op_name == "div" and u.inputs[0] == x:
                ok = _close(ctx.scalar_const(u.inputs[1]), SQRT2, 1e-4)
            elif u.op_name == "mul":
                for a, b in (u.inputs, u.inputs[::-1]):
                    if a == x and _close(ctx.scalar_const(b),
                                         INV_SQRT2, 1e-4):
                        ok = True
            if not ok:
                return None
            return "gelu", [ctx.producer_idx(name),
                            ctx.producer_idx(g.inputs[0])]
        if g.op_name == "tanh":
            arg = ctx.producer(g.inputs[0])
            if arg is None or arg.op_name != "mul":
                return None
            for c_name, inner_name in (arg.inputs, arg.inputs[::-1]):
                if not _close(ctx.scalar_const(c_name), C0, 1e-3):
                    continue
                inner = ctx.producer(inner_name)
                if inner is None or inner.op_name != "add":
                    continue
                for a, b in (inner.inputs, inner.inputs[::-1]):
                    if a != x:
                        continue
                    cub = ctx.producer(b)
                    if cub is None or cub.op_name != "mul":
                        continue
                    for cc, x3 in (cub.inputs, cub.inputs[::-1]):
                        if not _close(ctx.scalar_const(cc), C1, 1e-3):
                            continue
                        ci = _match_cube(x3, x)
                        if ci is None:
                            continue
                        return "gelu_tanh", (
                            [ctx.producer_idx(name),
                             ctx.producer_idx(g.inputs[0]),
                             ctx.producer_idx(inner_name),
                             ctx.producer_idx(b)] + ci)
            return None
        return None

    for node in list(sd.ops):
        if node.op_name != "mul":
            continue
        leaves, mul_idxs = _factors(node)
        if len(leaves) != 3:
            continue
        half = [n for n in leaves
                if _close(ctx.scalar_const(n), 0.5, 1e-6)]
        if len(half) != 1:
            continue
        rest = [n for n in leaves if n is not half[0]]
        hit = None
        for x, add1 in (rest, rest[::-1]):
            a = ctx.producer(add1)
            if a is None or a.op_name != "add":
                continue
            for one, g in (a.inputs, a.inputs[::-1]):
                if not _close(ctx.scalar_const(one), 1.0, 1e-9):
                    continue
                got = _match_inner(g, x)
                if got is not None:
                    hit = (x, got[0],
                           got[1] + [ctx.producer_idx(add1)])
                    break
            if hit:
                break
        if hit is None:
            continue
        x, fused_op, idxs = hit
        idxs = idxs + mul_idxs
        term_idx = ctx.producer_idx(node.outputs[0])
        if None in idxs or term_idx is None \
                or not ctx.interiors_private(idxs, term_idx):
            continue
        node.op_name = fused_op
        node.inputs = [x]
        node.attrs = {}
        count += 1
    return count


# -- pass 5: attention fusion ----------------------------------------------
def attention_fuse(sd) -> int:
    """Recognize the exporter's op-by-op attention —

        matmul(q, k, transpose_b) -> div/mul(const)
        [-> add(bias) | -> apply_key_mask(mask)] -> softmax
        -> matmul(., v)

    — and rewrite each occurrence to ONE fused ``sdpa_core`` op, which
    runs the whole pattern as one flash-attention call on the card.
    The ``apply_key_mask`` form (produced by the mask_strength_reduce
    pass) fuses to ``sdpa_core``'s native key-mask mode — the form the
    flash kernels can stream. Conservative: every interior
    value must have exactly one consumer and the scale must be a
    scalar constant; anything else is left untouched."""
    ctx = _Ctx(sd)
    fused = 0
    for sm in list(sd.ops):
        if sm.op_name != "softmax":
            continue
        ax = sm.attrs.get("axis", -1)
        if ax not in (-1, None):
            continue
        pre = ctx.producer(sm.inputs[0])
        bias = None
        mask = None
        if pre is not None and pre.op_name == "add":
            l, r = pre.inputs
            lp, rp = ctx.producer(l), ctx.producer(r)
            if lp is not None and lp.op_name in ("div", "mul"):
                scal, bias = lp, r
            elif rp is not None and rp.op_name in ("div", "mul"):
                scal, bias = rp, l
            else:
                continue
            if not ctx.single_use(scal.outputs[0]):
                continue
        elif pre is not None and pre.op_name == "apply_key_mask":
            scal = ctx.producer(pre.inputs[0])
            mask = pre.inputs[1]
            if scal is None or scal.op_name not in ("div", "mul") \
                    or not ctx.single_use(scal.outputs[0]):
                continue
        elif pre is not None and pre.op_name in ("div", "mul"):
            scal = pre
        else:
            continue
        # div's operand order is load-bearing; mul commutes, so
        # accept the constant on either side
        score_in, c = scal.inputs[0], ctx.scalar_const(scal.inputs[1])
        if c is None and scal.op_name == "mul":
            score_in, c = scal.inputs[1], \
                ctx.scalar_const(scal.inputs[0])
        if c is None or (scal.op_name == "div" and c == 0.0):
            continue
        scale = (1.0 / c) if scal.op_name == "div" else c
        mm = ctx.producer(score_in)
        if mm is None or mm.op_name != "matmul" \
                or mm.attrs.get("transpose_a") \
                or not ctx.single_use(mm.outputs[0]) \
                or not ctx.single_use(sm.inputs[0]):
            continue
        q_name, k_name = mm.inputs
        if not mm.attrs.get("transpose_b"):
            # the ONNX export spells k^T as an explicit Transpose
            # swapping the two trailing axes — absorb it
            tr = ctx.producer(k_name)
            axes = (tr.attrs.get("axes")
                    if tr is not None
                    and tr.op_name in ("transpose", "permute")
                    else None)
            n = len(axes) if axes else 0
            if not (n >= 2
                    and list(axes[:-2]) == list(range(n - 2))
                    and list(axes[-2:]) == [n - 1, n - 2]
                    and ctx.single_use(k_name)):
                continue
            k_name = tr.inputs[0]
        cons = ctx.consumers.get(sm.outputs[0], [])
        if len(cons) != 1:
            continue
        out_mm = sd.ops[cons[0]]
        if out_mm.op_name != "matmul" \
                or out_mm.inputs[0] != sm.outputs[0] \
                or out_mm.attrs.get("transpose_a") \
                or out_mm.attrs.get("transpose_b"):
            continue
        v_name = out_mm.inputs[1]
        # rewrite IN PLACE: the consumer matmul becomes the fused op;
        # the old chain is dead (the executor walks ancestors of the
        # requested outputs only)
        extra = mask if mask is not None else bias
        out_mm.op_name = "sdpa_core"
        out_mm.inputs = ([q_name, k_name, v_name] +
                         ([extra] if extra is not None else []))
        out_mm.attrs = {"scale": scale}
        if mask is not None:
            out_mm.attrs["mask_mode"] = "key"
        fused += 1
    return fused


# -- the pipeline -----------------------------------------------------------
PASSES: Tuple[Tuple[str, Callable], ...] = (
    ("cast_fold", cast_fold),
    ("mask_strength_reduce", mask_strength_reduce),
    ("layernorm_refuse", layernorm_refuse),
    ("gelu_refuse", gelu_refuse),
    ("attention_fuse", attention_fuse),
)


class GraphOptimizer:
    """Ordered, fixpoint-iterated pass pipeline over one SameDiff.

    ``run()`` applies the passes in order and repeats the whole
    pipeline until an iteration makes no rewrite (canonicalizations
    feed each other: cast folding exposes mask chains, mask strength
    reduction feeds the attention fusion), capped at
    ``max_iterations``. Returns {pass_name: total rewrites}. Compiled
    program caches are dropped iff anything changed."""

    def __init__(self, sd, passes=None, max_iterations: int = 8):
        self.sd = sd
        self.passes = tuple(passes) if passes is not None else PASSES
        self.max_iterations = int(max_iterations)

    def run(self) -> Dict[str, int]:
        sd = self.sd
        totals: Dict[str, int] = {name: 0 for name, _ in self.passes}
        for it in range(self.max_iterations):
            changed = 0
            for name, fn in self.passes:
                with telemetry.span(f"graphopt.{name}", iteration=it):
                    n = int(fn(sd))
                if n:
                    _REWRITES.inc(n, **{"pass": name})
                    totals[name] += n
                    changed += n
            if not changed:
                break
        if any(totals.values()):
            sd._exec_cache.clear()
            log.info("graphopt: %s", totals)
        return totals


def optimize(sd, passes=None) -> Dict[str, int]:
    """Convenience front door: run the full pipeline on ``sd``."""
    return GraphOptimizer(sd, passes=passes).run()
