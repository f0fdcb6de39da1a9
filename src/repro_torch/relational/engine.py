"""Plan execution over columnar Tables on torch tensors (twin of
``repro/relational/engine.py``).

Every operator keeps the fixed-capacity + validity-mask representation, so
a plan runs as whole-column tensor ops on the device with no per-row host
work.  The cursor baseline, by contrast, calls ``materialize()`` between
the query and the loop — the temp-table barrier.

The builtin ``GroupAgg`` operator and whole-plan fusion (``fuse.py``) wait
for a later slice of the port.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..configs import flags
from ..core.loop_ir import Col, eval_expr
from ..device import resolve_device
from .plan import (AggCall, Filter, GroupAgg, IterSpace, Join, Limit, OrderBy,
                   Plan, Project, Scan)
from .table import Table

Catalog = Mapping[str, Table]
Env = Mapping[str, Any]


def execute(plan: Plan, catalog: Catalog, env: Optional[Env] = None,
            device=None) -> Table:
    """Run ``plan`` over ``catalog`` on ``device`` — the card unless the
    caller names another; the catalog's tables must live there."""
    dev = resolve_device(device)
    check_catalog(catalog, dev)
    return _exec(plan, catalog, dict(env or {}), dev)


def check_catalog(catalog: Catalog, device: torch.device) -> None:
    for name, t in catalog.items():
        if t.device.type != device.type:
            raise ValueError(f"table {name!r} lives on {t.device}, the "
                             f"execution runs on {device}")


def _col_env(t: Table, env: Env) -> dict[str, Any]:
    e = dict(env)
    e.update(t.columns)
    return e


def _exec(plan: Plan, catalog: Catalog, env: Env,
          device: torch.device) -> Table:
    if isinstance(plan, Scan):
        return catalog[plan.table]

    if isinstance(plan, IterSpace):
        init = torch.as_tensor(eval_expr(plan.init, env), device=device)
        bound = torch.as_tensor(eval_expr(plan.bound, env), device=device)
        step = torch.as_tensor(eval_expr(plan.step, env), device=device)
        idx = init + torch.arange(plan.capacity, dtype=init.dtype,
                                  device=device) * step
        ok = (idx <= bound) if plan.inclusive else (idx < bound)
        # descending iteration (negative step)
        ok_desc = (idx >= bound) if plan.inclusive else (idx > bound)
        ok = torch.where(step < 0, ok_desc, ok)
        return Table({plan.column: idx}, ok)

    if isinstance(plan, Filter):
        t = _exec(plan.child, catalog, env, device)
        mask = eval_expr(plan.pred, _col_env(t, env))
        return t.filter(torch.as_tensor(mask, device=device).to(torch.bool))

    if isinstance(plan, Project):
        t = _exec(plan.child, catalog, env, device)
        cenv = _col_env(t, env)
        cols = {}
        for name, e in plan.exprs:
            v = torch.as_tensor(eval_expr(e, cenv), device=device)
            cols[name] = v.expand(t.capacity) if v.ndim == 0 else v
        # computed expressions can mint columns with more distinct values
        # than the declared group bound covers; only pure column renames
        # keep the declaration honest
        keep = t.group_bound if all(isinstance(e, Col)
                                    for _, e in plan.exprs) else None
        return Table(cols, t.valid, keep)

    if isinstance(plan, Join):
        lt = _exec(plan.left, catalog, env, device)
        rt = _exec(plan.right, catalog, env, device)
        return _gather_join(lt, rt, plan.left_key, plan.right_key, plan.how)

    if isinstance(plan, OrderBy):
        t = _exec(plan.child, catalog, env, device)
        return t.sort_by(plan.keys, plan.descending)

    if isinstance(plan, Limit):
        # first-n valid rows by prefix sum of the validity mask
        t = _exec(plan.child, catalog, env, device)
        keep = torch.cumsum(t.mask().to(torch.int32), 0) <= plan.n
        return t.filter(keep)

    if isinstance(plan, GroupAgg):
        raise NotImplementedError(
            "GroupAgg (the engine's builtin grouped aggregation) is not "
            "ported yet: it comes with the slice that ports _group_agg and "
            "whole-plan fusion")

    if isinstance(plan, AggCall):
        # import here: core.executors depends on this module
        from ..core.executors import execute_agg_call
        return execute_agg_call(plan, catalog, env, device=device)

    raise TypeError(f"unknown plan node {type(plan)}")


def execute_for_agg(child: Plan, catalog: Catalog, env: Env,
                    device: torch.device) -> Table:
    """Execute an aggregate's child plan.  The reference first tries to
    fuse a ``Filter*/Project* → Join`` chain into the aggregate input;
    its unfused result is identical, and the fusion waits for a later
    slice, so this runs the child per node."""
    return _exec(child, catalog, env, device)


# ---------------------------------------------------------------------------
# Join
# ---------------------------------------------------------------------------


def join_hash_enabled() -> bool:
    """Kill switch for the sort-free keyslot hash join (default: on).
    ``REPRO_JOIN_HASH=off`` selects the stable-argsort + searchsorted
    lookup."""
    return flags.enabled("REPRO_JOIN_HASH")


_TO_NUMPY = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
             torch.int16: np.int16, torch.int32: np.int32,
             torch.int64: np.int64, torch.float16: np.float16,
             torch.float32: np.float32, torch.float64: np.float64}
_FROM_NUMPY = {np.dtype(v): k for k, v in _TO_NUMPY.items()}


def _common_key_cast(lk: torch.Tensor, rk: torch.Tensor):
    """Harmonize the two key columns onto one exact comparison dtype by
    *numpy's* promotion lattice: ``int32`` against ``float32`` compares in
    float64, exact for every int32 (torch's own lattice would answer
    float32 and round keys above 2^24)."""
    if lk.dtype == rk.dtype:
        return lk, rk
    d = _FROM_NUMPY[np.promote_types(_TO_NUMPY[lk.dtype], _TO_NUMPY[rk.dtype])]
    return lk.to(d), rk.to(d)


def _key_for_search(k: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    if k.dtype.is_floating_point:
        big = float("inf")
    else:
        big = torch.iinfo(k.dtype).max
    return torch.where(valid, k, torch.tensor(big, dtype=k.dtype,
                                              device=k.device))


def _sorted_lookup(lk: torch.Tensor, rk: torch.Tensor, rvalid: torch.Tensor):
    """Sort the right keys (invalid rows to +inf), binary-search each left
    key, verify equality and right validity.  The sort is stable, so a
    duplicate right key picks the smallest right row."""
    rk_sortkey = _key_for_search(rk, rvalid)
    rk_sorted, order = torch.sort(rk_sortkey, stable=True)
    pos = torch.searchsorted(rk_sorted, lk).clamp(0, rk.shape[0] - 1)
    ridx = order[pos]
    found = (rk[ridx] == lk) & rvalid[ridx]
    return ridx.to(torch.int32), found


def _hash_lookup(lk: torch.Tensor, rk: torch.Tensor, rvalid: torch.Tensor):
    """Sort-free lookup on the keyslot hash table: build on the right
    keys' canonical words, probe one walk per left row."""
    from . import keyslot
    ridx, found = keyslot.build_probe(
        keyslot.key_words_for([rk]), rvalid, keyslot.key_words_for([lk]))
    if lk.dtype.is_floating_point:
        # canonical words equate NaN per bit pattern (grouping semantics);
        # join equality is value equality, where NaN never matches
        found = found & (lk == lk)
    return ridx, found


def _join_lookup(lt: Table, rt: Table, lkey: str, rkey: str):
    """Resolve each left row against the unique-keyed right side: returns
    ``(ridx, found)`` — right-row indices (clip-safe sentinel where
    unmatched) and the left rows with a valid right match."""
    lk, rk = _common_key_cast(lt.columns[lkey], rt.columns[rkey])
    if join_hash_enabled():
        return _hash_lookup(lk, rk, rt.mask())
    return _sorted_lookup(lk, rk, rt.mask())


def _apply_join(lt: Table, rt: Table, rkey: str, how: str,
                ridx: torch.Tensor, found: torch.Tensor) -> Table:
    """Materialize the joined Table from a ``_join_lookup`` result."""
    if how == "semi":
        return lt.filter(found)
    if how == "anti":
        return lt.filter(~found)

    gidx = ridx.to(torch.int64).clamp(0, rt.capacity - 1)
    cols = dict(lt.columns)
    for name, v in rt.columns.items():
        if name == rkey or name in cols:
            continue
        cols[name] = v[gidx]
    if how == "inner":
        valid = lt.mask() & found
    elif how == "left":
        valid = lt.mask()
        # null out unmatched right columns (zeros)
        for name in rt.columns:
            if name == rkey or name in lt.columns:
                continue
            c = cols[name]
            m = found.reshape(found.shape + (1,) * (c.ndim - 1))
            cols[name] = torch.where(m, c, torch.zeros_like(c))
    else:
        raise ValueError(f"unsupported join how={how}")
    # right-side columns were never covered by the left table's bound
    return Table(cols, valid)


def _gather_join(lt: Table, rt: Table, lkey: str, rkey: str,
                 how: str) -> Table:
    ridx, found = _join_lookup(lt, rt, lkey, rkey)
    return _apply_join(lt, rt, rkey, how, ridx, found)


# ---------------------------------------------------------------------------
# Segment ids for the sorted grouped route
# ---------------------------------------------------------------------------


def segment_ids_for(t: Table, keys: tuple[str, ...],
                    num_segments: Optional[int] = None):
    """Sort by group keys and derive segment ids.  Returns (sorted table,
    segment_ids int32, segment_starts_mask).  Invalid rows park in the
    last slot of the ``num_segments`` range (default: row capacity) — the
    overflow segment when a dense bound is declared."""
    st = t.sort_by(keys)
    m = st.mask()
    same = torch.ones(st.capacity, dtype=torch.bool, device=st.device)
    for k in keys:
        c = st.columns[k]
        same = same & torch.cat([torch.zeros(1, dtype=torch.bool,
                                             device=st.device),
                                 c[1:] == c[:-1]])
    starts = m & ~same
    seg = torch.cumsum(starts, 0, dtype=torch.int32) - 1
    overflow = (st.capacity if num_segments is None else num_segments) - 1
    seg = torch.where(m, seg, overflow).to(torch.int32)
    return st, seg, starts
