"""Algorithm 1 — Aggify(G, Q, Δ): custom-aggregate construction (paper §5)
and the loop-elimination rewrite (paper §6).

Faithful implementation of the paper's equations:

    V_F      = (V_Δ − (V_fetch ∪ V_local)) ∪ {isInitialized}      (Eq. 1)
    R(v)     = 1 iff some use of v in the loop has a reaching
               definition outside the loop                          (Eq. 2)
    P_accum  = { v ∈ V_use | R(v) = 1 }                            (Eq. 3)
    V_init   = P_accum − V_fetch                                   (Eq. 4)
    V_term   = fields of V_F live at the end of the loop           (§5.4)

    Loop(Q, Δ)   ⇒  𝒢_{AggΔ(P_accum)}(Q)                           (Eq. 5)
    Loop(Q_s, Δ) ⇒  𝒢_{StreamAggΔ(P_accum)}(Sort_s(Q))             (Eq. 6)

The generated aggregate follows the Init/Accumulate/Terminate(/Merge)
contract of §3.1.  ``deferred_init=True`` reproduces the paper's deferred
field initialization (Init takes no arguments in SQL; fields are set from
Accumulate parameters under an ``isInitialized`` flag — §5.2).  Here the
aggregate is a closure, so eager initialization from the enclosing program
state is available and provably equivalent (the V_init parameters are
loop-constant); both paths are implemented.  Twin of
``repro/core/aggify.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Mapping, Optional, Sequence

import torch

from . import recognize as _recognize
from .aggregate import Aggregate
from .cfg import CFG, FETCH_STATUS
from .dataflow import DataflowResult, analyze
from .loop_ir import (Assign, Col, CursorLoop, Expr, If, InsertLocal, Program,
                      Stmt, Var, assigned_vars, body_vars, eval_expr, flatten,
                      stmt_uses)


# ---------------------------------------------------------------------------
# Analysis record (exactly the sets the paper derives; asserted in tests
# against the paper's own Figure-1/Figure-2 illustrations)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AggifyAnalysis:
    v_delta: frozenset[str]
    v_fetch: frozenset[str]
    v_local: frozenset[str]
    v_fields: frozenset[str]      # V_F without the isInitialized bookkeeping
    p_accum: tuple[str, ...]      # ordered: fetch params (FETCH order), then
                                  # outer params (first-use order)
    v_init: frozenset[str]
    v_term: tuple[str, ...]


@dataclass(frozen=True)
class CustomAggregate:
    """The generated aggregate AggΔ (paper Figure 4 template)."""
    name: str
    fields: tuple[str, ...]            # V_F
    fetch_params: tuple[str, ...]      # per-row Accumulate params (from Q)
    outer_params: tuple[str, ...]      # loop-constant Accumulate params
    init_fields: tuple[str, ...]       # V_init
    terminate_vars: tuple[str, ...]    # V_term
    body: tuple[Stmt, ...]             # Δ — placed verbatim in Accumulate
    analysis: AggifyAnalysis = None
    local_tables: Mapping[str, Any] = dc_field(default_factory=dict)
    recognized: Optional[tuple] = None  # recognize.FieldUpdate list, if any
    #: Program.var_dtypes carried along so executors can resolve the dtype
    #: of fields absent from the caller environment (the engine's AggCall
    #: path has no other channel for it)
    var_dtypes: Mapping[str, Any] = dc_field(default_factory=dict)

    @property
    def accum_params(self) -> tuple[str, ...]:
        return self.fetch_params + self.outer_params

    @property
    def mergeable(self) -> bool:
        return self.recognized is not None and not self.local_tables

    # -- compile to the aggregate contract ----------------------------------

    def as_torch_aggregate(self, outer_values: Mapping[str, Any],
                           deferred_init: bool = False) -> Aggregate:
        """Instantiate the Init/Accumulate/Terminate contract.

        ``outer_values`` supplies the current values of every field at the
        program point just before the loop (this is P_0 of §7) plus the
        outer Accumulate parameters.  The merge that parallel executors
        need comes with the slice that ports them.
        """
        fields = self.fields
        outer_state = {f: _as_val(outer_values[f]) for f in fields}
        consts = {p: _as_val(outer_values[p]) for p in self.outer_params}

        if deferred_init:
            # Faithful §5.2: fields start at type-default; first Accumulate
            # copies V_init params into fields under isInitialized.
            def init():
                st = {f: _tree(torch.zeros_like, outer_state[f])
                      for f in fields}
                st["isInitialized"] = torch.tensor(False)
                return st

            def accumulate(state, row):
                st = dict(state)
                init_now = ~st["isInitialized"]
                for f in self.init_fields:
                    st[f] = _select(init_now, consts[f], st[f])
                st["isInitialized"] = torch.tensor(True)
                env = dict(consts)
                env.update({k: v for k, v in st.items()
                            if k != "isInitialized"})
                env.update(row)
                env = exec_stmts(self.body, env)
                new = {f: env[f] for f in fields}
                new["isInitialized"] = st["isInitialized"]
                return new

            def terminate(state):
                return tuple(
                    _select(state["isInitialized"], state[v], outer_state[v])
                    for v in self.terminate_vars)

            return Aggregate(self.name, init, accumulate, terminate)

        # eager initialization: state starts at P_0
        def init():
            return dict(outer_state)

        def accumulate(state, row):
            env = dict(consts)
            env.update(state)
            env.update(row)
            env2 = exec_stmts(self.body, dict(env))
            return {f: env2[f] for f in fields}

        def terminate(state):
            return tuple(state[v] for v in self.terminate_vars)

        return Aggregate(self.name, init, accumulate, terminate)


def _tree(fn, *xs):
    """Apply ``fn`` leafwise over equally nested tuples (local-table state
    is a (buffers, count) tuple)."""
    if isinstance(xs[0], tuple):
        return tuple(_tree(fn, *parts) for parts in zip(*xs))
    return fn(*xs)


def _as_val(v):
    return _tree(torch.as_tensor, v)


def _select(c, a, b):
    """Elementwise ``c ? a : b`` over (nested) values."""
    return _tree(lambda x, y: torch.where(
        torch.as_tensor(c), torch.as_tensor(x), torch.as_tensor(y)), a, b)


# ---------------------------------------------------------------------------
# Statement execution with select semantics (used by Accumulate and by the
# cursor baseline; identical code ⇒ semantics preserved by construction)
# ---------------------------------------------------------------------------


def exec_stmts(stmts: Sequence[Stmt], env: dict[str, Any]) -> dict[str, Any]:
    for s in stmts:
        if isinstance(s, Assign):
            env[s.var] = eval_expr(s.expr, env)
        elif isinstance(s, If):
            c = eval_expr(s.cond, env)
            t_env = exec_stmts(s.then, dict(env))
            e_env = exec_stmts(s.orelse, dict(env))
            changed = assigned_vars(s.then) | assigned_vars(s.orelse)
            for v in changed:
                tv, ev = t_env.get(v), e_env.get(v)
                if tv is None and ev is None:
                    continue
                # A var defined on only one branch and absent before the If
                # is branch-local; its post-If value is never legitimately
                # read (it would be in V_init otherwise), so mirror the
                # defined side.
                tv = ev if tv is None else tv
                ev = tv if ev is None else ev
                env[v] = _select(c, tv, ev)
        elif isinstance(s, InsertLocal):
            buf, cnt = env[s.table_var]
            vals = tuple(eval_expr(e, env) for e in s.values)
            new_buf = []
            for b, v in zip(buf, vals):
                b = b.clone()
                b[min(max(int(cnt), 0), b.shape[0] - 1)] = torch.as_tensor(
                    v, dtype=b.dtype)
                new_buf.append(b)
            env[s.table_var] = (tuple(new_buf), cnt + 1)
        else:
            raise TypeError(type(s))
    return env


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------


def analyze_loop(prog: Program) -> tuple[AggifyAnalysis, DataflowResult, CFG]:
    """Run the dataflow pass A(L, R, UD, DU) and compute the Aggify sets."""
    if not isinstance(prog.loop, CursorLoop):
        raise TypeError("analyze_loop expects a CursorLoop (FOR loops are "
                        "not ported yet)")
    cfg = CFG.of_program(prog)
    dfa = analyze(cfg)
    loop = prog.loop

    v_fetch = frozenset(loop.fetch_vars)
    v_delta = frozenset(body_vars(loop.body))

    # V_local: declared (first defined) inside the body and dead at loop
    # end.  Local table variables are declared (initialized empty) before
    # the loop and accumulate ACROSS iterations, so they are never
    # body-local even when dead afterwards.
    defined_before = set(prog.params) | assigned_vars(prog.pre) \
        | set(v_fetch) | set(prog.local_tables)
    assigned_in_body = assigned_vars(loop.body)
    live_at_exit = dfa.live_in[cfg.loop_exit_point]
    v_local = frozenset(v for v in assigned_in_body
                        if v not in defined_before and v not in live_at_exit)

    v_fields = frozenset(v_delta - (v_fetch | v_local))

    # P_accum per Eq. 2/3, via UD chains over the per-statement CFG.
    body_nodes = cfg.body_nodes
    outside = lambda d: d not in body_nodes
    use_order: list[str] = []
    p_accum_set: set[str] = set()
    for nid in sorted(body_nodes):
        node = cfg.nodes[nid]
        for v in sorted(node.uses):
            if v == FETCH_STATUS or v in prog.local_tables:
                continue
            defs = dfa.defs_reaching_use(nid, v)
            if any(outside(d) for d in defs):
                if v not in p_accum_set:
                    p_accum_set.add(v)
                    use_order.append(v)

    fetch_params = tuple(v for v in loop.fetch_vars if v in p_accum_set)
    outer_params = tuple(v for v in use_order if v not in v_fetch)
    p_accum = fetch_params + outer_params

    v_init = frozenset(p_accum_set - set(v_fetch))

    # V_term: fields live at the end of the loop, deterministic order.
    v_term = tuple(sorted(v for v in v_fields if v in live_at_exit))

    ana = AggifyAnalysis(v_delta=v_delta, v_fetch=v_fetch, v_local=v_local,
                         v_fields=v_fields, p_accum=p_accum, v_init=v_init,
                         v_term=v_term)
    return ana, dfa, cfg


def build_aggregate(prog: Program, name: Optional[str] = None) -> CustomAggregate:
    """§5: construct AggΔ from the loop (the first half of Algorithm 1)."""
    check_applicability(prog)
    ana, _, _ = analyze_loop(prog)
    loop = prog.loop
    fields = tuple(sorted(ana.v_fields))
    local_tables = {k: v for k, v in prog.local_tables.items()
                    if k in ana.v_fields}
    recognized = None
    if not local_tables:
        written = assigned_vars(loop.body) & set(fields)
        recognized = _recognize.recognize(
            loop.body, fetch_vars=set(loop.fetch_vars),
            fields=written, outer_params=set(p for p in ana.p_accum
                                             if p not in ana.v_fetch))
    return CustomAggregate(
        name=name or f"{prog.name}_agg",
        fields=fields,
        fetch_params=tuple(v for v in ana.p_accum if v in ana.v_fetch),
        outer_params=tuple(v for v in ana.p_accum if v not in ana.v_fetch),
        init_fields=tuple(sorted(ana.v_init)),
        terminate_vars=ana.v_term,
        body=loop.body,
        analysis=ana,
        local_tables=local_tables,
        recognized=recognized,
        var_dtypes=dict(prog.var_dtypes),
    )


# ---------------------------------------------------------------------------
# Applicability (Theorem 4.2 preconditions, §4.2)
# ---------------------------------------------------------------------------


class NotAggifyable(Exception):
    pass


def check_applicability(prog: Program) -> None:
    """Theorem 4.2: any cursor loop that does not modify persistent database
    state can be rewritten.  Our IR admits persistent-state mutation only
    via InsertLocal targeting a table NOT declared in ``local_tables`` —
    reject that; everything else (assignments, branching, local-table DML,
    pure function calls) is supported."""
    if not isinstance(prog.loop, CursorLoop):
        raise NotAggifyable("not a cursor loop (FOR loops are not ported yet)")
    for s in flatten(prog.loop.body):
        if isinstance(s, InsertLocal) and s.table_var not in prog.local_tables:
            raise NotAggifyable(
                f"loop mutates persistent table {s.table_var!r}; aggregates "
                "cannot modify database state (paper §4.1)")


def is_aggifyable(prog: Program) -> bool:
    try:
        check_applicability(prog)
        return True
    except NotAggifyable:
        return False


# ---------------------------------------------------------------------------
# Rewrite (Eq. 5 / Eq. 6) — second half of Algorithm 1
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RewrittenProgram:
    """The loop-free output: pre statements (dead code eliminated), one
    AggCall query, bindings of its result tuple to the V_term variables,
    then the post statements."""
    name: str
    params: tuple[str, ...]
    pre: tuple[Stmt, ...]
    agg_call: Any                      # relational.plan.AggCall
    bind: tuple[str, ...]              # V_term, in result-tuple order
    post: tuple[Stmt, ...]
    returns: tuple[str, ...]
    aggregate: CustomAggregate = None
    var_dtypes: Mapping[str, Any] = dc_field(default_factory=dict)


def aggify(prog: Program, mode: str = "auto",
           group_keys: Sequence[str] = ()) -> RewrittenProgram:
    """Full Algorithm 1: build AggΔ, then replace the loop with
    𝒢_{AggΔ(P_accum)}(Q) (Eq. 5) or the order-enforced variant (Eq. 6)."""
    from ..relational.plan import AggCall, strip_order

    agg = build_aggregate(prog)
    loop = prog.loop
    fetch_map = dict(loop.fetch)   # var -> column

    q = loop.query
    child, sort_keys, sort_desc = strip_order(q)
    ordered = bool(sort_keys)

    binding: list[tuple[str, Expr]] = []
    for p in agg.fetch_params:
        binding.append((p, Col(fetch_map[p])))
    for p in agg.outer_params:
        binding.append((p, Var(p)))

    call = AggCall(child=child, aggregate=agg,
                   param_binding=tuple(binding),
                   ordered=ordered, sort_keys=sort_keys, sort_desc=sort_desc,
                   group_keys=tuple(group_keys), mode=mode)

    pre = _dead_code_eliminate(prog, agg)
    return RewrittenProgram(
        name=prog.name, params=prog.params, pre=pre, agg_call=call,
        bind=agg.terminate_vars, post=prog.post, returns=prog.returns,
        aggregate=agg, var_dtypes=prog.var_dtypes)


def _dead_code_eliminate(prog: Program, agg: CustomAggregate) -> tuple[Stmt, ...]:
    """§6.2: 'This transformation may render some variables as dead' —
    backward sweep over the pre statements keeping only definitions that
    feed the rewritten query (fields P_0, outer params), the post
    statements, or the returns."""
    needed: set[str] = set(agg.fields) | set(agg.outer_params) | set(prog.returns)
    for s in flatten(prog.post):
        needed |= stmt_uses(s)
    kept: list[Stmt] = []
    for s in reversed(prog.pre):
        if isinstance(s, Assign):
            if s.var in needed:
                kept.append(s)
                needed |= stmt_uses(s)
            # else: dead — dropped (e.g. @pCost/@sName decls in Figure 7)
        elif isinstance(s, If):
            defs = assigned_vars([s])
            if defs & needed:
                kept.append(s)
                needed |= set().union(*(stmt_uses(x) for x in flatten([s])))
        else:
            kept.append(s)
    return tuple(reversed(kept))
