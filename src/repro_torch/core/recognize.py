"""Aggregate recognition (twin of ``repro/core/recognize.py``).

The port carries recognition and the closed-form evaluation; the merge
synthesis that feeds the chunked/tree executors waits for the slice that
ports those executors.

Recognized field-update algebras:

    sum      f = f + e            (count is sum with e = 1)
    prod     f = f * e
    min/max  f = min/max(f, e)   or   If(e < f, f = e)
    argmin/argmax group:
             If(e ⊲ f_key [and acyclic-guard], f_key = e; payload_i = p_i)
             with ⊲ ∈ {<, <=, >, >=}
    last     f = e               (e acyclic; order-sensitive)

where every contribution ``e``/``p_i``/guard is *acyclic*: it reads only
fetch variables, outer parameters, and constants — never a state field.
Bodies mixing recognized updates are recognized field-by-field; any
unrecognized statement makes the whole body unrecognized (stream-only,
exactly the paper's execution model).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import torch

from .loop_ir import Assign, BinOp, Expr, If, Stmt, UnOp, Var, expr_vars


@dataclass(frozen=True)
class FieldUpdate:
    kind: str                       # sum|prod|min|max|arg_group|last
    fields: tuple[str, ...]         # updated fields (1 for scalars; key+payloads for arg_group)
    exprs: tuple[Expr, ...]         # contribution per field (key expr first for arg_group)
    guard: Optional[Expr] = None    # acyclic guard (None = always)
    op: str = ""                    # for arg_group: the comparison < <= > >=


# ---------------------------------------------------------------------------
# Recognition
# ---------------------------------------------------------------------------


def recognize(body: Sequence[Stmt], fetch_vars: set[str], fields: set[str],
              outer_params: set[str]) -> Optional[tuple[FieldUpdate, ...]]:
    """``fields`` must be the set of fields *written* in the body: a field
    that is only read (e.g. the @lb lower bound of the paper's Figure 1) is
    loop-constant and therefore acyclic — it participates in contributions
    and guards like any outer parameter."""
    updates: list[FieldUpdate] = []
    written: set[str] = set()

    def is_acyclic(e: Expr) -> bool:
        return not (expr_vars(e) & fields)

    for s in body:
        u = _match_stmt(s, fields, is_acyclic)
        if u is None:
            return None
        # each field may be target of exactly one recognized update, and a
        # contribution may not read a field written earlier in the body
        for f in u.fields:
            if f in written:
                return None
            written.add(f)
        updates.append(u)
    return tuple(updates)


def _match_stmt(s: Stmt, fields: set[str], is_acyclic) -> Optional[FieldUpdate]:
    if isinstance(s, Assign):
        return _match_assign(s, fields, is_acyclic)
    if isinstance(s, If) and not s.orelse:
        return _match_guarded(s, fields, is_acyclic)
    return None


def _match_assign(s: Assign, fields: set[str], is_acyclic) -> Optional[FieldUpdate]:
    f, e = s.var, s.expr
    if f not in fields:
        return None
    # f = f + e   /  f = e + f
    if isinstance(e, BinOp) and e.op in ("+", "*", "min", "max"):
        for self_side, other in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
            if isinstance(self_side, Var) and self_side.name == f and is_acyclic(other):
                kind = {"+": "sum", "*": "prod", "min": "min", "max": "max"}[e.op]
                return FieldUpdate(kind, (f,), (other,))
    # f = f - e  (sum of negated contribution)
    if isinstance(e, BinOp) and e.op == "-":
        if isinstance(e.lhs, Var) and e.lhs.name == f and is_acyclic(e.rhs):
            return FieldUpdate("sum", (f,), (UnOp("neg", e.rhs),))
    # f = e (acyclic) — last value
    if is_acyclic(e):
        return FieldUpdate("last", (f,), (e,))
    return None


_CMP_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _match_guarded(s: If, fields: set[str], is_acyclic) -> Optional[FieldUpdate]:
    """If(conj ∧ (e ⊲ f_key) ∧ conj, f_key = e; payload...) — argmin/argmax
    with optional acyclic guard conjuncts."""
    conjs = split_conjuncts(s.cond)
    assigns: list[Assign] = []
    for b in s.then:
        if not isinstance(b, Assign):
            return None
        assigns.append(b)
    targets = {a.var for a in assigns}
    if not targets <= fields:
        return None

    # find the single cyclic comparison conjunct
    key_cmp = None
    guard_conjs: list[Expr] = []
    for c in conjs:
        if is_acyclic(c):
            guard_conjs.append(c)
            continue
        if key_cmp is not None:
            return None
        key_cmp = c
    guard = _conjoin(guard_conjs)

    if key_cmp is None:
        # uniformly guarded recognized update: If(acyclic, f = f + e)
        if len(assigns) != 1:
            return None
        u = _match_assign(assigns[0], fields, is_acyclic)
        if u is None:
            return None
        return FieldUpdate(u.kind, u.fields, u.exprs, guard=guard)

    # key comparison: e ⊲ key_field, with key_field ∈ fields and e acyclic
    if not isinstance(key_cmp, BinOp) or key_cmp.op not in ("<", "<=", ">", ">="):
        return None
    lhs, rhs, op = key_cmp.lhs, key_cmp.rhs, key_cmp.op
    if isinstance(rhs, Var) and rhs.name in fields and is_acyclic(lhs):
        key_field, key_expr = rhs.name, lhs
    elif isinstance(lhs, Var) and lhs.name in fields and is_acyclic(rhs):
        key_field, key_expr, op = lhs.name, rhs, _CMP_FLIP[op]
    else:
        return None
    # now semantics: update when  key_expr ⟨op⟩ current_key

    # the branch must assign key_field = key_expr and acyclic payloads
    key_assigned = False
    payload_fields: list[str] = []
    payload_exprs: list[Expr] = []
    for a in assigns:
        if a.var == key_field:
            if a.expr != key_expr:
                return None
            key_assigned = True
        else:
            if not is_acyclic(a.expr):
                return None
            payload_fields.append(a.var)
            payload_exprs.append(a.expr)
    if not key_assigned:
        return None
    return FieldUpdate("arg_group",
                       (key_field,) + tuple(payload_fields),
                       (key_expr,) + tuple(payload_exprs),
                       guard=guard, op=op)


def split_conjuncts(e: Expr) -> list[Expr]:
    if isinstance(e, BinOp) and e.op == "and":
        return split_conjuncts(e.lhs) + split_conjuncts(e.rhs)
    return [e]


def _conjoin(es: Sequence[Expr]) -> Optional[Expr]:
    if not es:
        return None
    out = es[0]
    for e in es[1:]:
        out = BinOp("and", out, e)
    return out


# ---------------------------------------------------------------------------
# Identities and closed-form (fully vectorized) evaluation
# ---------------------------------------------------------------------------


def _minmax_id(kind: str, dtype: torch.dtype) -> torch.Tensor:
    """Identity of a min (``kind='min'``) or max reduction in ``dtype``."""
    if dtype.is_floating_point:
        return torch.tensor(float("inf") if kind == "min" else float("-inf"),
                            dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if kind == "min" else info.min, dtype=dtype)


_MINMAX_ID = {"min": lambda d: _minmax_id("min", d),
              "max": lambda d: _minmax_id("max", d)}


def _column(e: Any, dtype: torch.dtype, n: int, device) -> torch.Tensor:
    """An expression value as an (n,) column of ``dtype``."""
    return torch.as_tensor(e, dtype=dtype, device=device).expand(n)


def vectorized_eval(updates: tuple[FieldUpdate, ...],
                    col_env: Mapping[str, Any],
                    valid: torch.Tensor,
                    outer_state: Mapping[str, Any]) -> dict[str, Any]:
    """Evaluate all recognized updates set-orientedly over whole columns.

    ``col_env`` binds fetch params to columns and outer params to scalars.
    Tie order matches the sequential loop (first/last attaining row for
    strict/non-strict comparisons; 'last' takes the final valid row).
    """
    from .loop_ir import eval_expr

    n = valid.shape[0]
    dev = valid.device
    out: dict[str, Any] = {}
    for u in updates:
        g = valid
        if u.guard is not None:
            g = g & torch.as_tensor(eval_expr(u.guard, col_env),
                                    device=dev).to(torch.bool)
        if u.kind in ("sum", "prod", "min", "max"):
            f = u.fields[0]
            d = outer_state[f].dtype
            e = _column(eval_expr(u.exprs[0], col_env), d, n, dev)
            if u.kind == "sum":
                out[f] = outer_state[f] + torch.where(
                    g, e, torch.zeros((), dtype=d, device=dev)).sum(dtype=d)
            elif u.kind == "prod":
                out[f] = outer_state[f] * torch.where(
                    g, e, torch.ones((), dtype=d, device=dev)).prod(dtype=d)
            else:
                ident = _MINMAX_ID[u.kind](d).to(dev)
                r = torch.where(g, e, ident)
                r = r.amin() if u.kind == "min" else r.amax()
                red = torch.minimum if u.kind == "min" else torch.maximum
                out[f] = red(outer_state[f], r)
        elif u.kind == "arg_group":
            kf = u.fields[0]
            kd = outer_state[kf].dtype
            key = _column(eval_expr(u.exprs[0], col_env), kd, n, dev)
            minimize = u.op in ("<", "<=")
            worst = _MINMAX_ID["min" if minimize else "max"](kd).to(dev)
            masked = torch.where(g, key, worst)
            if u.op == "<":                   # first min
                idx = masked.argmin()
            elif u.op == "<=":                # last min
                idx = n - 1 - masked.flip(0).argmin()
            elif u.op == ">":
                idx = masked.argmax()
            else:
                idx = n - 1 - masked.flip(0).argmax()
            best = masked[idx]
            cmp = {"<": best < outer_state[kf], "<=": best <= outer_state[kf],
                   ">": best > outer_state[kf],
                   ">=": best >= outer_state[kf]}[u.op]
            beat = cmp & g[idx]
            out[kf] = torch.where(beat, best, outer_state[kf])
            for f, pe in zip(u.fields[1:], u.exprs[1:]):
                pv = _column(eval_expr(pe, col_env), outer_state[f].dtype, n,
                             dev)
                out[f] = torch.where(beat, pv[idx], outer_state[f])
        elif u.kind == "last":
            f = u.fields[0]
            e = _column(eval_expr(u.exprs[0], col_env), outer_state[f].dtype,
                        n, dev)
            any_valid = g.any()
            last_idx = torch.where(g, torch.arange(n, device=dev), -1).amax()
            out[f] = torch.where(any_valid, e[last_idx.clamp(0, n - 1)],
                                 outer_state[f])
        else:  # pragma: no cover
            raise ValueError(u.kind)
    return out
