"""TF v1 (legacy) control-flow frame reconstruction.

Counterpart of ``deeplearning4j_tpu/modelimport/tensorflow/
v1_control_flow.py`` (pure Python, copied; reference:
``org.nd4j.imports.graphmapper.tf.TFGraphMapper`` and the Kotlin
``samediff-import-tensorflow`` stack, which map the v1 dataflow ops
Enter/Exit/NextIteration/Merge/Switch/LoopCond). Frozen graphs, as
``convert_variables_to_constants`` writes them, lower every
``tf.while_loop`` / ``tf.cond`` into these frames.

Instead of replaying TF's tagged-token dataflow machine (per-op
dead/alive propagation), this pass reconstructs the structured form:
each while frame becomes a synthetic functional ``While`` node (cond and
body as synthetic FunctionDefs) and each Switch/Merge diamond a
synthetic ``If``, both of which the importer lowers to
``SameDiff.while_loop`` / ``SameDiff.cond``.

Frame anatomy (per loop variable i)::

    Enter_i -> Merge_i(Enter_i, NextIteration_i)
            -> Switch_i(Merge_i, LoopCond)
               ├── :0 (pred false) -> Exit_i        (leaves the frame)
               └── :1 (pred true)  -> body ... -> NextIteration_i

Loop invariants enter via ``Enter(is_constant=true)`` with no
Merge/Switch and are threaded as extra pass-through loop vars.  v1
``tf.cond`` has no frame: every external value enters a branch through
``Switch(value, pred)`` and the branch results join at ``Merge``;
port 1 is the true branch, port 0 the false branch.
"""
from __future__ import annotations

from typing import (AbstractSet, Dict, List, Optional, Sequence, Set,
                    Tuple)

from deeplearning4j_tpu_torch.modelimport.tensorflow.protobuf import (
    Attr, FunctionDef, NodeDef)

_ENTER = {"Enter", "RefEnter"}
_EXIT = {"Exit", "RefExit"}
_MERGE = {"Merge", "RefMerge"}
_SWITCH = {"Switch", "RefSwitch"}
_NEXT = {"NextIteration", "RefNextIteration"}
#: every op this pass must eliminate; anything left after deframing is
#: an irreducible structure and fails loudly
V1_CONTROL_FLOW_OPS = (_ENTER | _EXIT | _MERGE | _SWITCH | _NEXT
                       | {"LoopCond"})


def _node_of(ref: str) -> str:
    if ref.startswith("^"):
        ref = ref[1:]
    return ref.split(":")[0]


def _port_of(ref: str) -> int:
    if ref.startswith("^"):
        return -1
    parts = ref.split(":")
    return int(parts[-1]) if len(parts) > 1 else 0


def _data_inputs(node: NodeDef) -> List[str]:
    return [r for r in node.inputs if not r.startswith("^")]


class _Irreducible(NotImplementedError):
    pass


def _err(msg: str) -> _Irreducible:
    return _Irreducible(
        f"TF import: legacy v1 control flow: {msg} (reference parity: "
        f"TFGraphMapper frame reconstruction)")


def deframe(nodes: List[NodeDef], functions: Dict[str, FunctionDef],
            keep: AbstractSet[str] = frozenset()) -> List[NodeDef]:
    """Rewrite all v1 while frames and Switch/Merge conds in ``nodes``
    into functional While/If nodes.  Registers synthetic FunctionDefs
    into ``functions`` (mutated).  Returns the new node list.
    ``keep`` names requested graph outputs (fetches): they are never
    removed by the dead-node sweep even if rewriting swallowed their
    last consumer."""
    nodes = _deframe_whiles(nodes, functions, keep)
    nodes = _deframe_conds(nodes, functions, keep=keep)
    return _sweep_dead_v1(nodes)


# -- shared helpers ----------------------------------------------------------

def _consumers_map(nodes: Sequence[NodeDef]) -> Dict[str, List[NodeDef]]:
    out: Dict[str, List[NodeDef]] = {}
    for n in nodes:
        for ref in n.inputs:
            out.setdefault(_node_of(ref), []).append(n)
    return out


def _is_pivot_anchor(node: Optional[NodeDef], by_name) -> bool:
    """The switch_t/switch_f shape: an Identity whose single data
    input is a Switch port — the control anchor v1 conds hang
    constant-only branches on."""
    if node is None or node.op != "Identity":
        return False
    data = _data_inputs(node)
    if len(data) != 1:
        return False
    sw = by_name.get(_node_of(data[0]))
    return sw is not None and sw.op in _SWITCH


def _backslice(roots: Sequence[str], by_name: Dict[str, NodeDef],
               stops: Set[str], follow_anchors: bool = False
               ) -> Set[str]:
    """Backward data-flow closure from ``roots`` (node names), never
    entering ``stops``.  With ``follow_anchors`` the walk also crosses
    control deps whose target matches the PIVOT-ANCHOR shape
    (Identity-of-Switch) — while-frame slices need it so a nested
    cond's ``^switch_t`` chain (anchor → pivot Switch → pred) rides
    into the body function where the cond reconstruction can use it.
    Arbitrary control deps (e.g. ``^ext`` ordering against outer
    nodes) are NOT followed — swallowing out-of-frame nodes would
    delete them from the enclosing graph.  Names not in ``by_name``
    terminate the walk."""
    seen: Set[str] = set()
    stack = [r for r in roots if r not in stops]
    while stack:
        nm = stack.pop()
        if nm in seen or nm in stops:
            continue
        node = by_name.get(nm)
        if node is None:
            continue
        seen.add(nm)
        for ref in node.inputs:
            dep = _node_of(ref)
            if dep in seen or dep in stops:
                continue
            if ref.startswith("^"):
                if follow_anchors and _is_pivot_anchor(
                        by_name.get(dep), by_name):
                    stack.append(dep)
                continue
            stack.append(dep)
    return seen


def _fresh(base: str, taken) -> str:
    name = base
    k = 0
    while name in taken:
        k += 1
        name = f"{base}_{k}"
    return name


def _guarded_rewrite(ref: str, ref_map: Dict[str, str],
                     expect_port: Dict[str, int]) -> str:
    """Boundary ref → argument name, refusing dead-port reads (e.g.
    Switch:0 inside a loop body, Merge:1 value_index)."""
    nm = _node_of(ref)
    arg = ref_map.get(nm)
    if arg is None:
        return ref
    want = expect_port.get(nm)
    if want is not None and _port_of(ref) != want:
        raise _err(f"a subgraph reads port {_port_of(ref)} of '{nm}' "
                   f"(expected port {want})")
    return arg


def _rewrite_slice(slice_nodes: Sequence[NodeDef],
                   ref_map: Dict[str, str],
                   expect_port: Dict[str, int]) -> List[NodeDef]:
    """Copy slice nodes into a synthetic function body: boundary refs
    (``ref_map`` keyed by node name) become argument names.  Control
    deps are KEPT at this stage — a nested constant-only cond's branch
    parity lives in its ``^switch_t``/``^switch_f`` anchors, which the
    fn-level cond reconstruction still needs; `_strip_control_deps`
    runs after it."""
    out = []
    for n in slice_nodes:
        new_inputs = [r if r.startswith("^")
                      else _guarded_rewrite(r, ref_map, expect_port)
                      for r in n.inputs]
        out.append(NodeDef(n.name, n.op, new_inputs, n.attrs))
    return out


def _strip_control_deps(nodes: List[NodeDef]) -> List[NodeDef]:
    """Final fn-body pass: the lowered op walk has no side effects
    to order, and out-of-list control targets would break the
    importer's topo sort."""
    for n in nodes:
        n.inputs = [r for r in n.inputs if not r.startswith("^")]
    return nodes


# -- while frames ------------------------------------------------------------

class _LoopVar:
    __slots__ = ("enter", "merge", "nextiter", "switch", "exits")

    def __init__(self, enter, merge, nextiter, switch, exits):
        self.enter = enter
        self.merge = merge
        self.nextiter = nextiter
        self.switch = switch
        self.exits = exits


def _frame_structure(enters: List[NodeDef], nodes: List[NodeDef],
                     by_name, consumers):
    const_enters = [e for e in enters if e.attr("is_constant", False)]
    var_enters = [e for e in enters if not e.attr("is_constant", False)]
    var_enter_names = {e.name for e in var_enters}
    loop_vars: List[_LoopVar] = []
    loopcond: Optional[NodeDef] = None
    for m in nodes:
        if m.op not in _MERGE:
            continue
        ins = _data_inputs(m)
        if not any(_node_of(r) in var_enter_names for r in ins):
            continue
        if len(ins) != 2:
            raise _err(f"loop Merge '{m.name}' has {len(ins)} inputs")
        enter_ref = next(r for r in ins
                         if _node_of(r) in var_enter_names)
        other_ref = next(r for r in ins if r is not enter_ref)
        ni = by_name.get(_node_of(other_ref))
        if ni is None or ni.op not in _NEXT:
            raise _err(f"Merge '{m.name}' back edge is not a "
                       f"NextIteration")
        # only the LoopCond-gated Switch is the loop-var switch; a
        # tf.cond inside the loop's cond subgraph may ALSO switch on
        # the Merge (its pred is an ordinary bool, not a LoopCond)
        switches = []
        for c in consumers.get(m.name, ()):
            if c.op not in _SWITCH or _node_of(c.inputs[0]) != m.name:
                continue
            p = by_name.get(_node_of(c.inputs[1]))
            if p is not None and p.op == "LoopCond":
                switches.append(c)
        if len(switches) != 1:
            raise _err(f"loop var '{m.name}' has {len(switches)} "
                       f"LoopCond-gated Switches (expected 1)")
        sw = switches[0]
        lc = by_name[_node_of(sw.inputs[1])]
        if loopcond is not None and lc.name != loopcond.name:
            raise _err("frame spans two LoopConds")
        loopcond = lc
        exits = [c for c in consumers.get(sw.name, ())
                 if c.op in _EXIT]
        for e in exits:
            if _port_of(e.inputs[0]) != 0:
                raise _err(f"Exit '{e.name}' reads the body port")
        loop_vars.append(_LoopVar(by_name[_node_of(enter_ref)], m, ni,
                                  sw, exits))
    if not loop_vars or loopcond is None:
        raise _err("while frame has no Merge/LoopCond structure")
    return loop_vars, const_enters, loopcond


def _deframe_whiles(nodes: List[NodeDef],
                    functions: Dict[str, FunctionDef],
                    keep: AbstractSet[str] = frozenset()
                    ) -> List[NodeDef]:
    while True:
        frames: Dict[str, List[NodeDef]] = {}
        for n in nodes:
            if n.op in _ENTER:
                fname = n.attr("frame_name")
                if isinstance(fname, bytes):
                    fname = fname.decode()
                frames.setdefault(fname or n.name, []).append(n)
        if not frames:
            return nodes
        by_name = {n.name: n for n in nodes}
        consumers = _consumers_map(nodes)
        progressed = False
        for fname, enters in frames.items():
            plan = _plan_while(fname, enters, nodes, by_name, consumers)
            if plan is None:        # nested frame inside — do it first
                continue
            nodes = _apply_while(plan, nodes, functions, by_name, keep)
            progressed = True
            break                   # rebuild maps, rescan
        if not progressed:
            raise _err(f"no reducible frame among {sorted(frames)}")


def _plan_while(fname, enters, nodes, by_name, consumers):
    loop_vars, const_enters, loopcond = _frame_structure(
        enters, nodes, by_name, consumers)
    merge_names = {lv.merge.name for lv in loop_vars}
    switch_names = {lv.switch.name for lv in loop_vars}
    const_names = {c.name for c in const_enters}
    stops = merge_names | switch_names | const_names | {loopcond.name}
    cond_slice = _backslice([_node_of(loopcond.inputs[0])], by_name,
                            stops, follow_anchors=True)
    body_slice = _backslice(
        [_node_of(lv.nextiter.inputs[0]) for lv in loop_vars],
        by_name, stops, follow_anchors=True)
    for nm in cond_slice | body_slice:
        if by_name[nm].op in _ENTER:    # nested frame — defer
            return None
    return (fname, loop_vars, const_enters, loopcond, cond_slice,
            body_slice)


def _apply_while(plan, nodes, functions, by_name,
                 keep: AbstractSet[str] = frozenset()):
    (fname, loop_vars, const_enters, loopcond, cond_slice,
     body_slice) = plan
    n_lv, n_inv = len(loop_vars), len(const_enters)
    ref_map: Dict[str, str] = {}
    expect_port: Dict[str, int] = {}
    for i, lv in enumerate(loop_vars):
        ref_map[lv.merge.name] = f"__lv{i}"
        expect_port[lv.merge.name] = 0
        ref_map[lv.switch.name] = f"__lv{i}"
        expect_port[lv.switch.name] = 1       # body reads the true port
    for j, ce in enumerate(const_enters):
        ref_map[ce.name] = f"__inv{j}"

    in_args = ([(f"__lv{i}", 0) for i in range(n_lv)]
               + [(f"__inv{j}", 0) for j in range(n_inv)])

    def _rw_ref(ref: str) -> str:
        return _guarded_rewrite(ref, ref_map, expect_port)

    node_order = {n.name: k for k, n in enumerate(nodes)}

    def _fn_nodes(slice_set):
        picked = sorted(slice_set, key=node_order.get)
        rewritten = _rewrite_slice([by_name[nm] for nm in picked],
                                   ref_map, expect_port)
        # nested cond reconstruction inside the body: pivot anchors
        # (control-only Switch/Identity chains) live OUTSIDE the data
        # slice, so hand the full graph as a parity lookup
        return _strip_control_deps(
            _deframe_conds(rewritten, functions,
                           pivot_lookup=by_name))

    cond_fn_nodes = _fn_nodes(cond_slice)
    body_fn_nodes = _fn_nodes(body_slice)

    cond_name = _fresh(f"__v1_{fname}_cond", functions)
    functions[cond_name] = FunctionDef(
        cond_name, in_args, [("__pred", 0)], cond_fn_nodes,
        {"__pred": _rw_ref(loopcond.inputs[0])})
    body_name = _fresh(f"__v1_{fname}_body", functions)
    body_ret = {}
    for i, lv in enumerate(loop_vars):
        body_ret[f"__out{i}"] = _rw_ref(lv.nextiter.inputs[0])
    for j in range(n_inv):
        body_ret[f"__out{n_lv + j}"] = f"__inv{j}"
    functions[body_name] = FunctionDef(
        body_name, in_args,
        [(f"__out{k}", 0) for k in range(n_lv + n_inv)],
        body_fn_nodes, body_ret)

    # name after the user-facing TF loop name (frame names append
    # "/while_context") so while_max_iterations={"<loop name>": N}
    # keys keep working on deframed graphs
    base = (fname[:-len("/while_context")]
            if fname.endswith("/while_context") else fname)
    wname = _fresh(f"{base}__v1_while", by_name)
    while_node = NodeDef(
        wname, "While",
        [_data_inputs(lv.enter)[0] for lv in loop_vars]
        + [_data_inputs(ce)[0] for ce in const_enters],
        {"cond": Attr("func", cond_name),
         "body": Attr("func", body_name)})
    aliases = []
    for i, lv in enumerate(loop_vars):
        src = wname if i == 0 else f"{wname}:{i}"
        for e in lv.exits:
            aliases.append(NodeDef(e.name, "Identity", [src], {}))

    removed = (cond_slice | body_slice
               | {lv.merge.name for lv in loop_vars}
               | {lv.switch.name for lv in loop_vars}
               | {lv.nextiter.name for lv in loop_vars}
               | {lv.enter.name for lv in loop_vars}
               | {e.name for lv in loop_vars for e in lv.exits}
               | {ce.name for ce in const_enters} | {loopcond.name})
    exit_names = {e.name for lv in loop_vars for e in lv.exits}
    anchor = (min((k for k, n in enumerate(nodes)
                   if n.name in exit_names), default=len(nodes))
              if exit_names else
              min(k for k, n in enumerate(nodes)
                  if n.name in removed))
    out: List[NodeDef] = []
    for k, n in enumerate(nodes):
        if k == anchor:
            out.append(while_node)
            out.extend(aliases)
        if n.name in removed:
            continue
        out.append(n)
    if anchor == len(nodes):
        out.append(while_node)
        out.extend(aliases)
    return _check_no_dangling(out, removed, nodes, keep)


def _check_no_dangling(nodes, removed, original,
                       keep: AbstractSet[str] = frozenset()):
    """Post-rewrite integrity pass.  Two cleanups cascade to a
    fixpoint: (a) pivot residue — Switch/Identity/Const chains with
    dangling references into the swallowed structure; (b) DEAD nodes:
    anything that HAD consumers in the original graph but lost every
    one to the removal (e.g. a pred feeding only a pivot's control
    anchors).  Original graph outputs were never consumed, so (b)
    cannot touch them.  A node still dangling at the fixpoint means
    the structure was not reducible."""
    out = list(nodes)
    live_ok = {n.name for n in out}
    orig_consumed = {_node_of(r) for n in original for r in n.inputs}
    changed = True
    while changed:
        changed = False
        consumed_now = {_node_of(r) for n in out for r in n.inputs}
        for n in list(out):
            dangling = [r for r in _data_inputs(n)
                        if _node_of(r) in removed
                        and _node_of(r) not in live_ok]
            dead = (n.name in orig_consumed
                    and n.name not in consumed_now
                    and n.op != "Placeholder"    # feeds stay
                    and n.name not in keep)      # fetches stay
            cascadable = (n.op in _SWITCH
                          or n.op in ("Identity", "Const"))
            if (dangling and cascadable) or dead:
                out.remove(n)
                live_ok.discard(n.name)
                removed.add(n.name)
                changed = True
    for n in out:
        for r in _data_inputs(n):
            nm = _node_of(r)
            if nm in removed and nm not in live_ok:
                raise _err(f"node '{n.name}' references "
                           f"frame-internal '{nm}' from outside the "
                           f"frame")
        n.inputs = [r for r in n.inputs
                    if not (r.startswith("^")
                            and _node_of(r) in removed
                            and _node_of(r) not in live_ok)]
    return out


# -- v1 cond (Switch/Merge diamonds) -----------------------------------------

def _resolve_identity(name: str, by_name) -> str:
    """Follow Identity chains (pred_id pivots) to the producing node."""
    seen = set()
    while True:
        node = by_name.get(name)
        if (node is None or node.op != "Identity"
                or name in seen or not _data_inputs(node)):
            return name
        seen.add(name)
        name = _node_of(_data_inputs(node)[0])


class _CondMerge:
    __slots__ = ("merge", "branch_refs", "slices", "switches",
                 "pred_ref")

    def __init__(self, merge, branch_refs, slices, switches, pred_ref):
        self.merge = merge
        self.branch_refs = branch_refs  # {0: false_ref, 1: true_ref}
        self.slices = slices            # {0: set, 1: set}
        self.switches = switches        # {0: [names], 1: [names]}
        self.pred_ref = pred_ref        # raw ref driving the Switches


def _pivot_parity(slice_set: Set[str], root_ref: str, by_name
                  ) -> Tuple[Optional[int], Optional[str]]:
    """Branch parity for a slice with NO data Switch (constant-only
    branches): v1 anchors such branches with control deps on the
    pivot Identities (``^cond/switch_t`` = Identity(Switch:1),
    ``^cond/switch_f`` = Identity(Switch:0)).  Returns (port,
    pred_ref) or (None, None)."""
    names = set(slice_set) | {_node_of(root_ref)}
    for nm in names:
        node = by_name.get(nm)
        if node is None:
            continue
        for ref in node.inputs:
            if not ref.startswith("^"):
                continue
            anchor = by_name.get(_node_of(ref))
            if anchor is None or anchor.op != "Identity":
                continue
            data = _data_inputs(anchor)
            if not data:
                continue
            sw = by_name.get(_node_of(data[0]))
            if sw is not None and sw.op in _SWITCH:
                return _port_of(data[0]), sw.inputs[1]
    return None, None


def _plan_cond_merge(m: NodeDef, by_name,
                     pivot_lookup=None) -> Optional[_CondMerge]:
    """Classify one Merge's two inputs into true/false branches by the
    Switch ports their backward slices read.  Returns None if an inner
    Merge makes it not-yet-reducible."""
    ins = _data_inputs(m)
    if len(ins) != 2:
        raise _err(f"cond Merge '{m.name}' has {len(ins)} inputs")
    infos = []
    pred_ref = None
    for ref in ins:
        sl = _backslice_stop_switch([_node_of(ref)], by_name)
        if sl is None:
            return None
        slice_set, switch_refs = sl
        root = by_name.get(_node_of(ref))
        if root is not None and root.op in _SWITCH:
            switch_refs = switch_refs + [ref]
        ports = {_port_of(r) for r in switch_refs}
        sw_names = sorted({_node_of(r) for r in switch_refs})
        if len(ports) > 1:
            raise _err(f"branch of Merge '{m.name}' reads both Switch "
                       f"ports")
        port = ports.pop() if ports else None
        if port is None:
            # constant-only branch: parity lives in the control deps
            # anchoring it to the pivot (switch_t/switch_f)
            port, piv_pred = _pivot_parity(
                slice_set, ref, pivot_lookup or by_name)
            if pred_ref is None:
                pred_ref = piv_pred
        if sw_names and pred_ref is None:
            pred_ref = by_name[sw_names[0]].inputs[1]
        infos.append((ref, slice_set, port, sw_names))
    p0, p1 = infos[0][2], infos[1][2]
    if p0 is None and p1 is None:
        raise _err(f"Merge '{m.name}' has no Switch on either input — "
                   f"cannot reconstruct a cond")
    if p0 is None:
        p0 = 1 - p1
    elif p1 is None:
        p1 = 1 - p0
    if p0 == p1:
        raise _err(f"both inputs of Merge '{m.name}' read Switch "
                   f"port {p0}")
    if pred_ref is None:
        raise _err(f"Merge '{m.name}': no predicate source found")
    by_port = {p0: infos[0], p1: infos[1]}
    return _CondMerge(
        m,
        {port: by_port[port][0] for port in (0, 1)},
        {port: by_port[port][1] for port in (0, 1)},
        {port: by_port[port][3] for port in (0, 1)},
        pred_ref)


def _backslice_stop_switch(roots, by_name):
    """Backward slice stopping at (not entering) Switch nodes; collects
    the Switch-port refs crossed.  Returns None when the slice contains
    a Merge (inner cond not yet reduced)."""
    seen: Set[str] = set()
    switch_refs: List[str] = []
    stack = list(roots)
    while stack:
        nm = stack.pop()
        if nm in seen:
            continue
        node = by_name.get(nm)
        if node is None:
            continue
        if node.op in _SWITCH:
            continue
        if node.op in _MERGE:
            return None
        seen.add(nm)
        for ref in _data_inputs(node):
            dep = _node_of(ref)
            depn = by_name.get(dep)
            if depn is not None and depn.op in _SWITCH:
                switch_refs.append(ref)
                continue
            if dep not in seen:
                stack.append(dep)
    return seen, switch_refs


def _deframe_conds(nodes: List[NodeDef],
                   functions: Dict[str, FunctionDef],
                   pivot_lookup: Optional[Dict[str, NodeDef]] = None,
                   keep: AbstractSet[str] = frozenset()
                   ) -> List[NodeDef]:
    while True:
        by_name = {n.name: n for n in nodes}
        # parity anchors of nested const-only conds may live outside
        # this node list (while-body slices): consult the enclosing
        # graph for pivot lookups only — never for slicing
        lookup = ({**pivot_lookup, **by_name} if pivot_lookup
                  else by_name)
        merges = [n for n in nodes if n.op in _MERGE]
        if not merges:
            return nodes
        plans: Dict[str, List[_CondMerge]] = {}
        for m in merges:
            cm = _plan_cond_merge(m, by_name, lookup)
            if cm is None:
                continue
            pred = _resolve_identity(_node_of(cm.pred_ref), lookup)
            plans.setdefault(pred, []).append(cm)
        if not plans:
            raise _err(f"no reducible Switch/Merge diamond among "
                       f"{sorted(m.name for m in merges)}")
        # apply EVERY group planned this sweep (deferred members
        # re-plan next sweep): sweep count scales with cond nesting
        # depth, not with the number of diamonds
        for pred in sorted(plans):
            by_name = {n.name: n for n in nodes}
            group = _independent_subgroup(plans[pred], by_name)
            nodes = _apply_cond(group, nodes, functions, by_name,
                                keep)


def _independent_subgroup(group: List[_CondMerge], by_name
                          ) -> List[_CondMerge]:
    """Diamonds sharing a pred merge into ONE multi-output If — but
    only if they don't feed each other.  Chained conds on the same
    pred (cond B's Switch data input is cond A's Merge) must stay
    separate Ifs, or the combined node would reference its own output.
    Keeps the members whose inputs reach no other member's Merge; the
    rest reduce on a later sweep (once the alias exists)."""
    if len(group) == 1:
        return group
    merge_names = {cm.merge.name for cm in group}
    indep = []
    for cm in group:
        roots = [_node_of(by_name[nm].inputs[0])
                 for port in (0, 1) for nm in cm.switches[port]]
        reach = _backslice(roots, by_name, set())
        if not (reach & (merge_names - {cm.merge.name})):
            indep.append(cm)
    if not indep:
        raise _err("cyclic dependency between Switch/Merge diamonds "
                   "sharing a predicate")
    return indep


def _apply_cond(group: List[_CondMerge], nodes, functions, by_name,
                keep: AbstractSet[str] = frozenset()):
    node_order = {n.name: k for k, n in enumerate(nodes)}
    switch_names = sorted({nm for cm in group
                           for port in (0, 1)
                           for nm in cm.switches[port]},
                          key=node_order.get)
    ref_map = {nm: f"__br{k}" for k, nm in enumerate(switch_names)}
    in_args = [(ref_map[nm], 0) for nm in switch_names]

    def _branch_fn(port: int):
        slice_set: Set[str] = set()
        for cm in group:
            slice_set |= cm.slices[port]
        picked = sorted(slice_set, key=node_order.get)
        expect = {nm: port for nm in switch_names}
        fn_nodes = _strip_control_deps(
            _rewrite_slice([by_name[nm] for nm in picked],
                           ref_map, expect))
        ret = {}
        for i, cm in enumerate(group):
            ret[f"__out{i}"] = _guarded_rewrite(cm.branch_refs[port],
                                                ref_map, expect)
        return fn_nodes, ret

    then_nodes, then_ret = _branch_fn(1)
    else_nodes, else_ret = _branch_fn(0)
    base = group[0].merge.name
    then_name = _fresh(f"__v1_cond_{base}_then", functions)
    else_name = _fresh(f"__v1_cond_{base}_else", functions)
    out_args = [(f"__out{i}", 0) for i in range(len(group))]
    functions[then_name] = FunctionDef(then_name, in_args, out_args,
                                       then_nodes, then_ret)
    functions[else_name] = FunctionDef(else_name, in_args, out_args,
                                       else_nodes, else_ret)

    pred_ref = group[0].pred_ref
    if_name = _fresh(f"{group[0].merge.name}__v1_if", by_name)
    if_node = NodeDef(
        if_name, "If",
        [pred_ref] + [_data_inputs(by_name[nm])[0]
                      for nm in switch_names],
        {"then_branch": Attr("func", then_name),
         "else_branch": Attr("func", else_name)})
    aliases = [NodeDef(cm.merge.name, "Identity",
                       [if_name if i == 0 else f"{if_name}:{i}"], {})
               for i, cm in enumerate(group)]

    removed = set(switch_names) | {cm.merge.name for cm in group}
    for cm in group:
        removed |= cm.slices[0] | cm.slices[1]
    merge_names = {cm.merge.name for cm in group}
    # unconditional nodes pulled into a slice but still consumed
    # outside the diamond stay live (they are duplicated into the
    # branch, which is semantically identical)
    consumers = _consumers_map(nodes)
    changed = True
    while changed:
        changed = False
        for nm in sorted(removed - merge_names - set(switch_names)):
            for c in consumers.get(nm, ()):
                if c.name not in removed:
                    removed.discard(nm)
                    changed = True
                    break
    anchor = min(k for k, n in enumerate(nodes) if n.name in removed)
    out: List[NodeDef] = []
    for k, n in enumerate(nodes):
        if k == anchor:
            out.append(if_node)
            out.extend(aliases)
        if n.name in removed:
            continue
        out.append(n)
    return _check_no_dangling(out, removed, nodes, keep)


# -- final sweep -------------------------------------------------------------

def _sweep_dead_v1(nodes: List[NodeDef]) -> List[NodeDef]:
    """Remove pivot residue: pred Switches (data==pred) and the
    Identity/Const anchors hanging off them.  Anything else that still
    carries a v1 op — or real computation that would be swept with it —
    is an irreducible structure and raises."""
    removed = {n.name for n in nodes if n.op in V1_CONTROL_FLOW_OPS}
    if not removed:
        return nodes
    changed = True
    while changed:
        changed = False
        for n in nodes:
            if n.name in removed:
                continue
            if any(_node_of(r) in removed for r in _data_inputs(n)):
                if n.op not in ("Identity", "Const"):
                    raise _err(
                        f"irreducible v1 structure: '{n.name}' "
                        f"({n.op}) depends on an unreconstructed "
                        f"control-flow op")
                removed.add(n.name)
                changed = True
    out = []
    for n in nodes:
        if n.name in removed:
            continue
        n.inputs = [r for r in n.inputs
                    if not (r.startswith("^")
                            and _node_of(r) in removed)]
        out.append(n)
    return out
