"""Logical query plans (twin of ``repro/relational/plan.py``).

A plan is an introspectable tree (needed by Aggify: the rewrite composes the
cursor query as a subquery under an aggregation node — Eq. 5/6 — and acyclic
code motion pushes predicates into it).  Plans are deliberately small: Scan,
Filter, Project, Join (PK-FK gather + semi/anti), OrderBy, GroupAgg, Limit,
and AggCall (the 𝒢_{AggΔ} operator produced by the rewrite).

Expressions in plans use the shared AST of ``core.loop_ir``: ``Col``
references name columns of the child; ``Var`` references enclosing program
variables (correlation parameters), bound at execution time from the scalar
environment — mirroring how the paper's cursor query references UDF
parameters (e.g. ``@pkey``).

Plans execute per-node (engine._exec).  The whole-plan fusion of the
reference (a ``Filter*/Project* → Join`` chain feeding a grouped aggregate)
and the builtin ``GroupAgg`` operator wait for a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

from ..core.loop_ir import Col, Expr, wrap


@dataclass(frozen=True)
class Plan:
    def filter(self, pred: Expr) -> "Filter":
        return Filter(self, pred)

    def project(self, **exprs: Any) -> "Project":
        return Project(self, tuple((k, wrap(v)) for k, v in exprs.items()))

    def select(self, *names: str) -> "Project":
        return Project(self, tuple((n, Col(n)) for n in names))

    def order_by_(self, keys: Sequence[str], descending: Sequence[bool] = ()) -> "OrderBy":
        return OrderBy(self, tuple(keys), tuple(descending) or (False,) * len(keys))

    def limit(self, n: int) -> "Limit":
        return Limit(self, n)

    # -- protocol used by Aggify ------------------------------------------
    @property
    def order_by(self) -> tuple[str, ...]:
        """Sort keys the result is guaranteed to carry (empty = unordered)."""
        return ()

    @property
    def columns(self) -> tuple[str, ...]:
        raise NotImplementedError


@dataclass(frozen=True)
class Scan(Plan):
    table: str
    schema: tuple[str, ...] = ()

    @property
    def columns(self) -> tuple[str, ...]:
        return self.schema


@dataclass(frozen=True)
class IterSpace(Plan):
    """Iteration-space relation for FOR-loop rewriting (paper §8.2's
    recursive-CTE analogue).  init/bound/step are expressions over program
    variables, evaluated from the scalar environment at execution time."""
    init: Expr
    bound: Expr
    step: Expr
    inclusive: bool
    capacity: int
    column: str

    @property
    def columns(self) -> tuple[str, ...]:
        return (self.column,)


@dataclass(frozen=True)
class Filter(Plan):
    child: Plan
    pred: Expr

    @property
    def columns(self) -> tuple[str, ...]:
        return self.child.columns

    @property
    def order_by(self) -> tuple[str, ...]:
        return self.child.order_by


@dataclass(frozen=True)
class Project(Plan):
    child: Plan
    exprs: tuple[tuple[str, Expr], ...]

    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.exprs)

    @property
    def order_by(self) -> tuple[str, ...]:
        return self.child.order_by


@dataclass(frozen=True)
class Join(Plan):
    """Lookup join: ``right`` must be unique on ``right_key`` (PK).  Each left
    row picks up the matching right row (inner: unmatched dropped; left:
    unmatched keep nulls=0).  ``how`` in {'inner','left','semi','anti'}.
    Lowered as a keyslot hash build/probe (engine._hash_lookup; the
    stable-argsort + searchsorted lookup runs under
    ``REPRO_JOIN_HASH=off``)."""
    left: Plan
    right: Plan
    left_key: str
    right_key: str
    how: str = "inner"

    @property
    def columns(self) -> tuple[str, ...]:
        if self.how in ("semi", "anti"):
            return self.left.columns
        return tuple(dict.fromkeys(self.left.columns + self.right.columns))

    @property
    def order_by(self) -> tuple[str, ...]:
        return self.left.order_by


@dataclass(frozen=True)
class OrderBy(Plan):
    child: Plan
    keys: tuple[str, ...]
    descending: tuple[bool, ...] = ()

    @property
    def columns(self) -> tuple[str, ...]:
        return self.child.columns

    @property
    def order_by(self) -> tuple[str, ...]:
        return self.keys


@dataclass(frozen=True)
class Limit(Plan):
    child: Plan
    n: int

    @property
    def columns(self) -> tuple[str, ...]:
        return self.child.columns

    @property
    def order_by(self) -> tuple[str, ...]:
        return self.child.order_by


@dataclass(frozen=True)
class GroupAgg(Plan):
    """Built-in grouped aggregation: aggs = ((out, op, col), ...) with op in
    {sum,min,max,count,mean,prod,argmin,argmax}.  For the arg-extremum
    ops ``col`` is a ``(key_col, payload_col)`` pair: the output is the
    payload value of the FIRST row attaining the group's key extremum
    (strict-comparison tie order — the cursor loop's ``If(key < best)``).
    ``max_groups`` declares a dense bound on the group count (see
    relational/group_bound.py): segment tensors are sized by its
    power-of-two bucket plus an overflow slot instead of the input row
    capacity, and the bound is validated (concrete overflow raises;
    traced overflow NaN-poisons the outputs)."""
    child: Plan
    keys: tuple[str, ...]
    aggs: tuple[tuple[str, str, Optional[str]], ...]
    max_groups: Optional[int] = None

    @property
    def columns(self) -> tuple[str, ...]:
        return self.keys + tuple(a[0] for a in self.aggs)


@dataclass(frozen=True)
class AggCall(Plan):
    """𝒢_{AggΔ(P_accum)}(child) — the operator introduced by the Aggify
    rewrite (Eq. 5).  ``param_binding`` maps each Accumulate parameter to a
    Col of the child (fetch-derived) or a Var/Const of the enclosing program
    (outer-derived).  ``ordered`` + ``sort_keys`` encode Eq. 6.  ``group_keys``
    optionally turns it into a grouped invocation (decorrelation)."""
    child: Plan
    aggregate: Any                      # core.aggify.CustomAggregate
    param_binding: tuple[tuple[str, Expr], ...]
    ordered: bool = False
    sort_keys: tuple[str, ...] = ()
    sort_desc: tuple[bool, ...] = ()
    group_keys: tuple[str, ...] = ()
    mode: str = "auto"                  # auto|stream|chunked|recognized|fused
    #: dense group-count bound for the grouped invocation (bucketed +
    #: validated; see relational/group_bound.py); None = row capacity
    max_groups: Optional[int] = None

    @property
    def columns(self) -> tuple[str, ...]:
        return self.group_keys + tuple(self.aggregate.terminate_vars)


def is_unordered(plan: Plan) -> bool:
    return not plan.order_by


def strip_order(plan: Plan) -> tuple[Plan, tuple[str, ...], tuple[bool, ...]]:
    """Split Q_s into (Q, s) per Eq. 6 — peel the topmost OrderBy."""
    if isinstance(plan, OrderBy):
        return plan.child, plan.keys, plan.descending or (False,) * len(plan.keys)
    return plan, (), ()


def push_filter(plan: Plan, pred: Expr) -> Plan:
    """Conjoin ``pred`` into the plan (used by acyclic code motion, §8.1).
    The predicate references child columns, so it composes on top of Q —
    the engine's filter is pipelined, matching the paper's 'merge into the
    cursor query WHERE clause'."""
    if isinstance(plan, OrderBy):
        return OrderBy(push_filter(plan.child, pred), plan.keys, plan.descending)
    return Filter(plan, pred)
