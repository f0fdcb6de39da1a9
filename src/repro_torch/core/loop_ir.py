"""Loop IR — the language model of Section 4.2 of the paper (twin of
``repro/core/loop_ir.py``; expressions evaluate on torch tensors).

A cursor loop is ``CL(Q, Δ)``: a query ``Q`` plus a program fragment ``Δ``
evaluated once per result row (Definition 4.1).  This module defines the
typed AST for ``Δ`` and the enclosing program, plus expression evaluation.

The same expression AST is reused by the relational layer for vectorized
predicate/projection evaluation (a column environment instead of a scalar
one), which is what makes *acyclic code motion* (paper §8.1) a pure IR
transplant: an expression hoisted out of the loop body becomes a WHERE
predicate with identical semantics.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence, Union

import torch

# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    def __add__(self, o): return BinOp("+", self, wrap(o))
    def __radd__(self, o): return BinOp("+", wrap(o), self)
    def __sub__(self, o): return BinOp("-", self, wrap(o))
    def __rsub__(self, o): return BinOp("-", wrap(o), self)
    def __mul__(self, o): return BinOp("*", self, wrap(o))
    def __rmul__(self, o): return BinOp("*", wrap(o), self)
    def __truediv__(self, o): return BinOp("/", self, wrap(o))
    def __rtruediv__(self, o): return BinOp("/", wrap(o), self)
    def __mod__(self, o): return BinOp("%", self, wrap(o))
    def __lt__(self, o): return BinOp("<", self, wrap(o))
    def __le__(self, o): return BinOp("<=", self, wrap(o))
    def __gt__(self, o): return BinOp(">", self, wrap(o))
    def __ge__(self, o): return BinOp(">=", self, wrap(o))
    def eq(self, o): return BinOp("==", self, wrap(o))
    def ne(self, o): return BinOp("!=", self, wrap(o))
    def and_(self, o): return BinOp("and", self, wrap(o))
    def or_(self, o): return BinOp("or", self, wrap(o))
    def __neg__(self): return UnOp("neg", self)


@dataclass(frozen=True)
class Const(Expr):
    value: Any
    dtype: Optional[str] = None


@dataclass(frozen=True)
class Var(Expr):
    """A program (scalar) variable reference."""
    name: str


@dataclass(frozen=True)
class Col(Expr):
    """A cursor-column reference (an attribute of the current row of Q)."""
    name: str


@dataclass(frozen=True)
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class UnOp(Expr):
    op: str
    operand: Expr


@dataclass(frozen=True)
class Where(Expr):
    """Ternary select ``cond ? t : f`` (pure expression-level branch)."""
    cond: Expr
    t: Expr
    f: Expr


@dataclass(frozen=True)
class Call(Expr):
    """Pure scalar function invocation (e.g. the ``getLowerBound`` UDF in
    the paper's Figure 1).  ``fn`` must be a pure torch-compatible callable."""
    name: str
    fn: Callable[..., Any]
    args: tuple[Expr, ...]


def wrap(x: Any) -> Expr:
    if isinstance(x, Expr):
        return x
    return Const(x)


def _tensor(x: Any, like: Any = None) -> torch.Tensor:
    """``x`` as a tensor, on ``like``'s device when ``like`` is one."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, device=dev)


def _tensors(a: Any, b: Any) -> tuple[torch.Tensor, torch.Tensor]:
    return _tensor(a, b), _tensor(b, a)


_BINOPS: dict[str, Callable[[Any, Any], Any]] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "and": lambda a, b: torch.logical_and(*_tensors(a, b)),
    "or": lambda a, b: torch.logical_or(*_tensors(a, b)),
    "min": lambda a, b: torch.minimum(*_tensors(a, b)),
    "max": lambda a, b: torch.maximum(*_tensors(a, b)),
    "pow": lambda a, b: a ** b,
}

_UNOPS: dict[str, Callable[[Any], Any]] = {
    "neg": lambda a: -a,
    "not": lambda a: torch.logical_not(_tensor(a)),
    "abs": lambda a: torch.abs(_tensor(a)),
    "log": lambda a: torch.log(_tensor(a)),
    "exp": lambda a: torch.exp(_tensor(a)),
    "sqrt": lambda a: torch.sqrt(_tensor(a)),
    "float": lambda a: a.to(torch.float32) if isinstance(a, torch.Tensor)
    else float(a),
}


def eval_expr(e: Expr, env: Mapping[str, Any]) -> Any:
    """Evaluate an expression under ``env`` (vars and cols share the
    namespace; columns are bound by the executor).  Works identically for
    scalar (per-row) and vectorized (whole-column) environments; constants
    stay Python numbers until an operand is a tensor."""
    if isinstance(e, Const):
        v = e.value
        if e.dtype is not None:
            return torch.as_tensor(v, dtype=e.dtype)
        return v
    if isinstance(e, Var):
        return env[e.name]
    if isinstance(e, Col):
        return env[e.name]
    if isinstance(e, BinOp):
        return _BINOPS[e.op](eval_expr(e.lhs, env), eval_expr(e.rhs, env))
    if isinstance(e, UnOp):
        return _UNOPS[e.op](eval_expr(e.operand, env))
    if isinstance(e, Where):
        c, t, f = (eval_expr(e.cond, env), eval_expr(e.t, env),
                   eval_expr(e.f, env))
        c = _tensor(c, t if isinstance(t, torch.Tensor) else f)
        return torch.where(c, _tensor(t, c), _tensor(f, c))
    if isinstance(e, Call):
        return e.fn(*(eval_expr(a, env) for a in e.args))
    raise TypeError(f"unknown expression node {type(e)}")


def expr_vars(e: Expr) -> set[str]:
    """All Var names referenced by ``e``."""
    out: set[str] = set()
    _walk(e, lambda n: out.add(n.name) if isinstance(n, Var) else None)
    return out


def expr_cols(e: Expr) -> set[str]:
    out: set[str] = set()
    _walk(e, lambda n: out.add(n.name) if isinstance(n, Col) else None)
    return out


def _walk(e: Expr, visit: Callable[[Expr], None]) -> None:
    visit(e)
    if isinstance(e, BinOp):
        _walk(e.lhs, visit); _walk(e.rhs, visit)
    elif isinstance(e, UnOp):
        _walk(e.operand, visit)
    elif isinstance(e, Where):
        _walk(e.cond, visit); _walk(e.t, visit); _walk(e.f, visit)
    elif isinstance(e, Call):
        for a in e.args:
            _walk(a, visit)


def substitute(e: Expr, mapping: Mapping[str, Expr]) -> Expr:
    """Replace Var references by expressions (used by code motion / FOR
    rewrite)."""
    if isinstance(e, Var) and e.name in mapping:
        return mapping[e.name]
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute(e.lhs, mapping), substitute(e.rhs, mapping))
    if isinstance(e, UnOp):
        return UnOp(e.op, substitute(e.operand, mapping))
    if isinstance(e, Where):
        return Where(substitute(e.cond, mapping), substitute(e.t, mapping), substitute(e.f, mapping))
    if isinstance(e, Call):
        return Call(e.name, e.fn, tuple(substitute(a, mapping) for a in e.args))
    return e


def vars_to_cols(e: Expr, names: Iterable[str]) -> Expr:
    """Rewrite Var(v)->Col(c) per a fetch binding (used by acyclic code
    motion to turn a loop predicate into a query predicate)."""
    names = set(names)
    if isinstance(e, Var) and e.name in names:
        return Col(e.name)
    if isinstance(e, BinOp):
        return BinOp(e.op, vars_to_cols(e.lhs, names), vars_to_cols(e.rhs, names))
    if isinstance(e, UnOp):
        return UnOp(e.op, vars_to_cols(e.operand, names))
    if isinstance(e, Where):
        return Where(vars_to_cols(e.cond, names), vars_to_cols(e.t, names), vars_to_cols(e.f, names))
    if isinstance(e, Call):
        return Call(e.name, e.fn, tuple(vars_to_cols(a, names) for a in e.args))
    return e


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Stmt:
    pass


@dataclass(frozen=True)
class Assign(Stmt):
    var: str
    expr: Expr


@dataclass(frozen=True)
class If(Stmt):
    cond: Expr
    then: tuple[Stmt, ...]
    orelse: tuple[Stmt, ...] = ()

    def __init__(self, cond, then, orelse=()):
        object.__setattr__(self, "cond", cond)
        object.__setattr__(self, "then", tuple(then))
        object.__setattr__(self, "orelse", tuple(orelse))


@dataclass(frozen=True)
class InsertLocal(Stmt):
    """INSERT INTO a *local* table variable (supported per paper §4.2:
     'DML operations on local table variables ... are supported')."""
    table_var: str
    values: tuple[Expr, ...]

    def __init__(self, table_var, values):
        object.__setattr__(self, "table_var", table_var)
        object.__setattr__(self, "values", tuple(values))


def stmt_uses(s: Stmt) -> set[str]:
    """Var names *used* (read) by a statement (non-recursive into branches:
    for If, only the condition; branch statements are separate CFG nodes)."""
    if isinstance(s, Assign):
        return expr_vars(s.expr)
    if isinstance(s, If):
        return expr_vars(s.cond)
    if isinstance(s, InsertLocal):
        out: set[str] = set()
        for e in s.values:
            out |= expr_vars(e)
        out.add(s.table_var)
        return out
    raise TypeError(type(s))


def stmt_defs(s: Stmt) -> set[str]:
    if isinstance(s, Assign):
        return {s.var}
    if isinstance(s, If):
        return set()
    if isinstance(s, InsertLocal):
        return {s.table_var}
    raise TypeError(type(s))


def body_vars(stmts: Sequence[Stmt]) -> set[str]:
    """All variables referenced (used or defined) in a statement list,
    recursively — this is V_Δ of paper Eq. 1 (columns excluded)."""
    out: set[str] = set()
    for s in flatten(stmts):
        out |= stmt_uses(s) | stmt_defs(s)
    return out


def body_cols(stmts: Sequence[Stmt]) -> set[str]:
    out: set[str] = set()
    for s in flatten(stmts):
        if isinstance(s, Assign):
            out |= expr_cols(s.expr)
        elif isinstance(s, If):
            out |= expr_cols(s.cond)
        elif isinstance(s, InsertLocal):
            for e in s.values:
                out |= expr_cols(e)
    return out


def assigned_vars(stmts: Sequence[Stmt]) -> set[str]:
    out: set[str] = set()
    for s in flatten(stmts):
        out |= stmt_defs(s)
    return out


def flatten(stmts: Sequence[Stmt]) -> list[Stmt]:
    """Depth-first list of statements including branch bodies."""
    out: list[Stmt] = []
    for s in stmts:
        out.append(s)
        if isinstance(s, If):
            out.extend(flatten(s.then))
            out.extend(flatten(s.orelse))
    return out


# --------------------------------------------------------------------------
# Loops and programs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class CursorLoop:
    """CL(Q, Δ).  ``query`` is any object implementing the QuerySource
    protocol (``columns`` property; ``order_by`` property; ``execute``) —
    the relational layer provides LogicalPlan.  ``fetch`` binds query
    columns to loop variables in FETCH order."""
    query: Any
    fetch: tuple[tuple[str, str], ...]  # (var_name, column_name)
    body: tuple[Stmt, ...]

    def __init__(self, query, fetch, body):
        object.__setattr__(self, "query", query)
        object.__setattr__(self, "fetch", tuple((v, c) for v, c in fetch))
        object.__setattr__(self, "body", tuple(body))

    @property
    def fetch_vars(self) -> tuple[str, ...]:
        return tuple(v for v, _ in self.fetch)


@dataclass(frozen=True)
class ForLoop:
    """FOR (var=init; var </<= bound; var+=step) { body } — §8.2.
    init/bound/step are expressions over program variables (values need not
    be statically determinable, exactly as the paper requires)."""
    var: str
    init: Expr
    bound: Expr
    step: Expr
    body: tuple[Stmt, ...]
    inclusive: bool = True

    def __init__(self, var, init, bound, step, body, inclusive=True):
        object.__setattr__(self, "var", var)
        object.__setattr__(self, "init", wrap(init))
        object.__setattr__(self, "bound", wrap(bound))
        object.__setattr__(self, "step", wrap(step))
        object.__setattr__(self, "body", tuple(body))
        object.__setattr__(self, "inclusive", inclusive)


@dataclass(frozen=True)
class Program:
    """The module enclosing the cursor loop (e.g. the UDF in Figure 1).

    ``params``: formal parameters (defined at entry).
    ``pre``:    statements before the loop.
    ``loop``:   the cursor loop (or ForLoop before rewriting).
    ``post``:   statements after the loop.
    ``returns``: variables returned (their liveness extends to exit).
    ``var_dtypes``: optional dtype hints for state variables.
    ``local_tables``: name -> (column dtypes tuple, capacity) for local
                      table variables (InsertLocal targets).
    """
    name: str
    params: tuple[str, ...]
    pre: tuple[Stmt, ...]
    loop: Union[CursorLoop, ForLoop]
    post: tuple[Stmt, ...]
    returns: tuple[str, ...]
    var_dtypes: Mapping[str, Any] = field(default_factory=dict)
    local_tables: Mapping[str, Any] = field(default_factory=dict)

    def __init__(self, name, params, pre, loop, post, returns,
                 var_dtypes=None, local_tables=None):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "params", tuple(params))
        object.__setattr__(self, "pre", tuple(pre))
        object.__setattr__(self, "loop", loop)
        object.__setattr__(self, "post", tuple(post))
        object.__setattr__(self, "returns", tuple(returns))
        object.__setattr__(self, "var_dtypes", dict(var_dtypes or {}))
        object.__setattr__(self, "local_tables", dict(local_tables or {}))


# Convenience builders ------------------------------------------------------

def let(var: str, e: Any) -> Assign:
    return Assign(var, wrap(e))


def minimum(a: Any, b: Any) -> Expr:
    return BinOp("min", wrap(a), wrap(b))


def maximum(a: Any, b: Any) -> Expr:
    return BinOp("max", wrap(a), wrap(b))
