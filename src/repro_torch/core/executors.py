"""Executors: the cursor baseline and the Aggify execution paths on torch
tensors (twin of ``repro/core/executors.py``).

Baseline (paper §2.3 — what Aggify eliminates):
  * ``run_cursor`` — the cursor query is **materialized** (temp table
    barrier), then folded row by row.

Aggify paths:
  * ``mode='stream'``     — Eq. 6 streaming aggregate (sequential).
  * ``mode='recognized'`` — fully set-oriented closed form (no scan).
  * ``mode='fused'``      — grouped: recognized updates lowered onto ONE
                            fused segment-aggregate launch
                            (kernels/segment_agg.py) computing every
                            sum/count/min/max moment and the tie-ordered
                            arg-extremum row index for every recognized
                            column; the remaining update kinds stay on
                            torch segment ops.  Ungrouped, the closed form
                            is already one pass, so 'fused' coincides with
                            'recognized'.
  * ``mode='auto'``       — fused > recognized > stream.

Grouped invocation (``AggCall.group_keys``) decorrelates per-group loops
(the paper's Q2 pattern) into a single pass on one of two routes: with a
dense group bound declared, sort-free hash slotting (relational/keyslot.py)
and the ``segagg_unsorted`` kernel; otherwise the group sort and the
``segagg_sorted`` kernel.  The chunked executors and the sharded launcher
wait for later slices.

Every entry point runs on the card unless the caller passes
``device="cpu"``; the catalog's tables must live on that device.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from ..configs import flags
from ..device import resolve_device
from ..relational import engine as _engine
from ..relational.plan import AggCall
from ..relational.table import Table
from . import recognize as _recognize
from .recognize import _column
from .aggify import CustomAggregate, RewrittenProgram, aggify, exec_stmts
from .aggregate import streaming
from .loop_ir import Col, CursorLoop, Program, assigned_vars, eval_expr


def _scalar(v: Any, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Environment setup
# ---------------------------------------------------------------------------


def _default_missing_fields(agg, env, outer_vals, var_dtypes,
                            device) -> None:
    """Fill ``outer_vals`` defaults for aggregate fields absent from the
    caller environment: the explicit ``var_dtypes`` wins, then the mapping
    the aggregate carried from ``Program.var_dtypes``, else float32."""
    dtypes = var_dtypes if var_dtypes is not None \
        else getattr(agg, "var_dtypes", None)
    for f in agg.fields:
        if f in env:
            outer_vals.setdefault(f, _scalar(env[f], device))
        else:
            dt = (dtypes or {}).get(f, torch.float32)
            outer_vals.setdefault(f, torch.zeros((), dtype=dt,
                                                 device=device))


def _local_tables(tables, device) -> dict:
    return {tv: (tuple(torch.zeros((cap,), dtype=d, device=device)
                       for d in dtypes),
                 torch.tensor(0, dtype=torch.int32, device=device))
            for tv, (dtypes, cap) in tables.items()}


def _bind_params(names, params, device) -> dict:
    env: dict[str, Any] = {}
    for p in names:
        if params is None or p not in params:
            raise ValueError(f"missing parameter {p!r}")
        env[p] = _scalar(params[p], device)
    return env


def build_env(prog, catalog, params: Optional[Mapping[str, Any]] = None,
              device=None) -> dict:
    dev = resolve_device(device)
    env = _bind_params(prog.params, params, dev)
    env.update(_local_tables(prog.local_tables, dev))
    return exec_stmts(prog.pre, env)


# ---------------------------------------------------------------------------
# Cursor baseline
# ---------------------------------------------------------------------------


def run_cursor(prog: Program, catalog, params=None, device=None):
    """Reference semantics: materialize Q, iterate Δ row by row."""
    dev = resolve_device(device)
    _engine.check_catalog(catalog, dev)
    env = build_env(prog, catalog, params, dev)
    loop = prog.loop
    if not isinstance(loop, CursorLoop):
        raise TypeError("run_cursor expects a CursorLoop")
    t = _engine._exec(loop.query, catalog, env, dev)
    t = t.compress().materialize()       # the temp-table barrier (§2.3)

    state_vars = sorted(assigned_vars(loop.body))
    state = {v: env[v] if v in env else _default_for(prog, v, dev)
             for v in state_vars}
    rows = {v: t.columns[c] for v, c in loop.fetch}
    for i in range(int(t.count())):     # compress put the valid rows first
        e = dict(env)
        e.update(state)
        e.update({v: c[i] for v, c in rows.items()})
        e2 = exec_stmts(loop.body, e)
        state = {v: e2[v] for v in state_vars}
    env.update(state)
    env = exec_stmts(prog.post, env)
    return {r: env[r] for r in prog.returns}


def _default_for(prog, name, device):
    dt = prog.var_dtypes.get(name, torch.float32)
    return torch.zeros((), dtype=dt, device=device)


# ---------------------------------------------------------------------------
# Rewritten execution
# ---------------------------------------------------------------------------


def run_rewritten(rp: RewrittenProgram, catalog, params=None,
                  mode: Optional[str] = None, deferred_init: bool = False,
                  device=None):
    dev = resolve_device(device)
    _engine.check_catalog(catalog, dev)
    env = _bind_params(rp.params, params, dev)
    env.update(_local_tables(rp.aggregate.local_tables, dev))
    env = exec_stmts(rp.pre, env)

    call = rp.agg_call if mode is None else AggCall(
        rp.agg_call.child, rp.agg_call.aggregate, rp.agg_call.param_binding,
        rp.agg_call.ordered, rp.agg_call.sort_keys, rp.agg_call.sort_desc,
        rp.agg_call.group_keys, mode, rp.agg_call.max_groups)
    vals = agg_call_values(call, catalog, env, deferred_init=deferred_init,
                           var_dtypes=rp.var_dtypes, device=dev)
    env.update(vals)
    env = exec_stmts(rp.post, env)
    return {r: env[r] for r in rp.returns}


def run_aggify(prog: Program, catalog, params=None, mode: str = "auto",
               deferred_init: bool = False, device=None):
    """Convenience: Algorithm 1 + execute."""
    rp = aggify(prog, mode=mode)
    return run_rewritten(rp, catalog, params, deferred_init=deferred_init,
                         device=device)


# ---------------------------------------------------------------------------
# AggCall evaluation
# ---------------------------------------------------------------------------


def fused_eligible(agg: CustomAggregate) -> bool:
    """True when the accumulator decomposes into moments the fused segment
    kernels compute: at least one recognized sum/min/max update or an
    argmin/argmax group (key extremum and attaining row both from the
    kernel's index moment)."""
    return (agg.recognized is not None and not agg.local_tables
            and any(u.kind in ("sum", "min", "max", "arg_group")
                    for u in agg.recognized))


def _resolve_mode(call: AggCall, agg: CustomAggregate,
                  deferred_init: bool) -> str:
    mode = call.mode
    if deferred_init:
        # deferred V_init (paper §5.2) only exists on the streaming fold
        if mode not in ("auto", "stream"):
            raise ValueError(
                f"deferred_init=True requires streaming execution; "
                f"incompatible with explicit mode={mode!r}")
        return "stream"
    if mode == "auto":
        if agg.recognized is not None and not agg.local_tables:
            return "recognized"
        return "stream"
    if mode == "fused":
        # ungrouped: the closed form already is one fused pass
        if agg.recognized is None:
            raise ValueError(f"aggregate {agg.name!r} not recognized; cannot "
                             "run in fused mode")
        return "recognized"
    if mode == "recognized" and agg.recognized is None:
        raise ValueError(f"aggregate {agg.name!r} not recognized; cannot "
                         "run in recognized mode")
    if mode == "chunked":
        raise NotImplementedError("mode='chunked' is not ported yet")
    return mode


def _bind_call(call: AggCall, t: Table, env, agg, var_dtypes, device):
    """Fetch-derived params → columns of ``t``; outer-derived → values."""
    rows: dict[str, torch.Tensor] = {}
    outer_vals: dict[str, Any] = {}
    for name, e in call.param_binding:
        if isinstance(e, Col):
            rows[name] = t.columns[e.name]
        else:
            outer_vals[name] = _scalar(eval_expr(e, env), device)
    _default_missing_fields(agg, env, outer_vals, var_dtypes, device)
    return rows, outer_vals


def agg_call_values(call: AggCall, catalog, env, deferred_init=False,
                    var_dtypes=None, device=None) -> dict[str, Any]:
    """Evaluate 𝒢_{AggΔ}(Q) (ungrouped) → {V_term var: value}."""
    if call.group_keys:
        raise ValueError("grouped AggCall: use execute_agg_call / engine")
    dev = resolve_device(device)
    agg: CustomAggregate = call.aggregate
    t = _engine.execute_for_agg(call.child, catalog, env, dev)
    if call.ordered:
        t = t.sort_by(call.sort_keys, call.sort_desc)
    rows, outer_vals = _bind_call(call, t, env, agg, var_dtypes, dev)
    valid = t.mask()
    mode = _resolve_mode(call, agg, deferred_init)

    if mode == "recognized":
        col_env = dict(outer_vals)
        col_env.update(rows)
        outer_state = {f: _scalar(outer_vals[f], dev) for f in agg.fields}
        out = _recognize.vectorized_eval(agg.recognized, col_env, valid,
                                         outer_state)
        return {v: out.get(v, outer_state[v]) for v in agg.terminate_vars}

    tagg = agg.as_torch_aggregate(outer_vals, deferred_init=deferred_init)
    res = streaming(tagg, rows, valid)
    return dict(zip(agg.terminate_vars, res))


def execute_agg_call(call: AggCall, catalog, env, var_dtypes=None,
                     device=None) -> Table:
    """Engine entry point: returns a Table (1 row, or one row per group).
    ``var_dtypes`` (Program.var_dtypes) resolves the dtype of aggregate
    fields absent from ``env`` — without it they default to float32."""
    dev = resolve_device(device)
    if call.group_keys:
        return grouped_agg_call(call, catalog, env, var_dtypes=var_dtypes,
                                device=dev)
    vals = agg_call_values(call, catalog, env, var_dtypes=var_dtypes,
                           device=dev)
    cols = {k: _scalar(v, dev)[None] for k, v in vals.items()}
    return Table(cols, torch.ones(1, dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# Grouped invocation (decorrelation)
# ---------------------------------------------------------------------------


#: recognized update kinds whose merge algebra is commutative — the
#: sort-free grouped route only fires when every update is one of these
#: ('last' is positional over the iteration order, so it stays sorted)
_ORDER_INSENSITIVE_KINDS = ("sum", "prod", "min", "max", "arg_group")


def _sortfree_eligible(call: AggCall, agg: CustomAggregate, mode: str,
                       bound) -> bool:
    """True when the grouped call may skip the group sort: a dense bound
    is declared, the call is order-insensitive (no Eq.-6 ordering, no sort
    keys), the mode is set-oriented, and every recognized update folds
    with a commutative merge."""
    from ..relational.keyslot import sortfree_enabled
    return (bound is not None and sortfree_enabled()
            and not call.ordered and not call.sort_keys
            and mode in ("fused", "recognized")
            and agg.recognized is not None
            and all(u.kind in _ORDER_INSENSITIVE_KINDS
                    for u in agg.recognized))


def grouped_agg_call(call: AggCall, catalog, env, var_dtypes=None,
                     device=None) -> Table:
    from ..relational.engine import segment_ids_for
    from ..relational.group_bound import (check_group_overflow,
                                          poison_overflow,
                                          resolve_group_bound)
    from ..relational.keyslot import (overflow_extended, slot_segment_ids,
                                      sortfree_result)
    dev = resolve_device(device)
    agg: CustomAggregate = call.aggregate
    t = _engine.execute_for_agg(call.child, catalog, env, dev)
    # dense segment range: AggCall-declared max_groups beats the table hint
    declared = call.max_groups if call.max_groups is not None \
        else t.group_bound
    nsegments, bound = resolve_group_bound(declared, t.capacity)
    cap = t.capacity
    mode = _resolve_grouped_mode(call, agg)

    # bind params against the unsorted table first: routing only consults
    # dtypes, and the sort-free route consumes these bindings as they are
    rows, outer_vals = _bind_call(call, t, env, agg, var_dtypes, dev)

    if _sortfree_eligible(call, agg, mode, bound):
        m = t.mask()
        seg, owner, occupied, unplaced = slot_segment_ids(
            t, call.group_keys, bound)
        rep, out_valid = overflow_extended(owner, occupied, cap)
        if mode == "fused":
            out = _grouped_fused(agg, rows, outer_vals, m, seg, nsegments,
                                 backend=_segagg_backend(),
                                 require_kernel=call.mode == "fused",
                                 layout="unsorted")
        else:
            out = _grouped_recognized(agg, rows, outer_vals, m, seg,
                                      nsegments)
        return sortfree_result(t, call.group_keys, rep, out_valid, unplaced,
                               bound, {v: out[v] for v in agg.terminate_vars})

    sort_keys = tuple(call.group_keys) + tuple(call.sort_keys)
    sort_desc = (False,) * len(call.group_keys) + tuple(
        call.sort_desc or (False,) * len(call.sort_keys))
    # segment_ids_for re-sorts by the group keys only (stable), keeping
    # the intra-group order established by the first sort
    st, seg, starts = segment_ids_for(
        t.sort_by(sort_keys, sort_desc), call.group_keys,
        num_segments=nsegments)
    m = st.mask()
    nseg = starts.sum()
    overflow_ok = check_group_overflow(nseg, bound)
    out_valid = torch.arange(nsegments, device=dev) < nseg

    # re-bind fetch-derived params against the SORTED rows
    for name, e in call.param_binding:
        if isinstance(e, Col):
            rows[name] = st.columns[e.name]

    seg64 = seg.to(torch.int64)
    first_idx = torch.where(starts, torch.arange(cap, device=dev), cap)
    first_of_seg = torch.full((nsegments,), cap, dtype=torch.int64,
                              device=dev).scatter_reduce_(
        0, seg64, first_idx, "amin")
    safe_first = first_of_seg.clamp(0, cap - 1)
    cols: dict[str, torch.Tensor] = {}
    for k in call.group_keys:
        cols[k] = st.columns[k][safe_first]

    if mode == "fused":
        out = _grouped_fused(agg, rows, outer_vals, m, seg, nsegments,
                             backend=_segagg_backend(),
                             require_kernel=call.mode == "fused")
    elif mode == "recognized":
        out = _grouped_recognized(agg, rows, outer_vals, m, seg, nsegments)
    else:
        out = _grouped_scan(agg, rows, outer_vals, m, seg, nsegments)
    for v in agg.terminate_vars:
        cols[v] = out[v]
    return Table(poison_overflow(cols, overflow_ok), out_valid)


def _resolve_grouped_mode(call: AggCall, agg: CustomAggregate) -> str:
    """Grouped physical-mode selection: fused > recognized > scan.
    'stream' lowers to the generic per-group sequential scan."""
    mode = call.mode
    recognized = agg.recognized is not None and not agg.local_tables
    if mode == "auto":
        if fused_eligible(agg):
            return "fused"
        return "recognized" if recognized else "scan"
    if mode == "fused":
        if not fused_eligible(agg):
            raise ValueError(
                f"aggregate {agg.name!r} has no fused-eligible recognized "
                "updates (sum/min/max/argmin/argmax); cannot run in fused "
                "mode")
        return "fused"
    if mode == "recognized":
        if not recognized:
            raise ValueError(f"aggregate {agg.name!r} not recognized; cannot "
                             "run in recognized mode")
        return "recognized"
    if mode == "chunked":
        raise NotImplementedError("mode='chunked' is not ported yet")
    return "scan"


def _segagg_backend() -> str:
    """Backend for the fused grouped path: ``"auto"`` — the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor.  Only an
    explicit ``REPRO_SEGAGG_BACKEND`` changes it: ``jnp`` asks for the
    plain version on either device, ``pallas``/``interpret`` insist on the
    kernel (``"cuda"``)."""
    env = flags.choice("REPRO_SEGAGG_BACKEND", ("pallas", "interpret", "jnp"))
    if env is None:
        return "auto"
    return "jnp" if env == "jnp" else "cuda"


def _f32_exact_key_dtype(dt: torch.dtype) -> bool:
    """True when every value of ``dt`` survives the cast to the kernel's
    f32 accumulator exactly: ≤32-bit floats, bools, ≤16-bit ints."""
    if dt.is_floating_point:
        return dt.itemsize <= 4
    if dt == torch.bool:
        return True
    return dt.itemsize <= 2


def _split_kernel_updates(agg, outer_vals, col_env):
    """Partition the recognized updates into (kernel_updates, rest): the
    kernels accumulate in f32, so only sum/min/max/arg_group updates over
    ≤32-bit floating fields, with f32-exact arg keys, take the kernel
    pass; everything else stays on torch segment ops."""
    kernel_updates = []
    rest = []
    for u in agg.recognized:
        d = outer_vals[u.fields[0]].dtype
        ok = (u.kind in ("sum", "min", "max", "arg_group")
              and d.is_floating_point and d.itemsize <= 4)
        if ok and u.kind == "arg_group":
            key = torch.as_tensor(eval_expr(u.exprs[0], col_env))
            ok = _f32_exact_key_dtype(key.dtype)
        (kernel_updates if ok else rest).append(u)
    return kernel_updates, rest


def _guard(u, valid, col_env):
    if u.guard is None:
        return valid
    return valid & torch.as_tensor(eval_expr(u.guard, col_env),
                                   device=valid.device).to(torch.bool)


def _grouped_fused(agg, rows, outer_vals, valid, seg, num_segments,
                   backend="auto", require_kernel=False, layout="sorted"):
    """Fused grouped aggregation: every recognized sum/min/max/arg-extremum
    update over a ≤32-bit floating field is batched into ONE
    segment-aggregate launch (each column carries its own guard mask);
    the remaining updates run on torch segment ops.

    Arg-extremum updates request the kernel's index moment: the attaining
    row comes back as output rows 4/5 with the loop's tie order, so the
    payload is one num_segments-sized take (``_arg_select_from_index``).
    ``require_kernel`` (an explicit ``mode='fused'``) raises instead of
    running a kernel-free pass.  ``layout='unsorted'`` is the sort-free
    route (hash-slotted segment ids)."""
    from ..kernels.segment_agg import (ARGMAX_ROW, ARGMIN_ROW,
                                       fused_segment_agg, index_moment_ok)

    col_env = dict(outer_vals)
    col_env.update(rows)
    n = valid.shape[0]
    dev = valid.device
    # f32 row indices are exact below 2^24 padded rows; beyond, the
    # arg-extremum keeps the kernel's key extremum and picks by hits
    use_index = index_moment_ok(n)

    kernel_updates, rest = _split_kernel_updates(agg, outer_vals, col_env)
    if require_kernel and not kernel_updates:
        raise ValueError(
            f"aggregate {agg.name!r}: no recognized update targets a ≤32-bit "
            "floating field (the kernel accumulates in f32), so mode='fused' "
            "would run no kernel work — use mode='recognized' or 'auto'")

    out: dict[str, torch.Tensor] = {}
    if kernel_updates:
        cols, masks = [], []
        moments: list[set] = []
        col_of: dict = {}          # (expr, guard[, tie]) -> column index
        upd_col, upd_mname = [], []
        for u in kernel_updates:
            ck = (u.exprs[0], u.guard)
            mname = None
            if u.kind == "arg_group" and use_index:
                minimize = u.op in ("<", "<=")
                tie_first = u.op in ("<", ">")
                mname = (("argmin" if minimize else "argmax")
                         + ("_first" if tie_first else "_last"))
                conflict = (("argmin" if minimize else "argmax")
                            + ("_last" if tie_first else "_first"))
                if ck in col_of and conflict in moments[col_of[ck]]:
                    # one index row per extremum direction: an update with
                    # the opposite tie order gets its own column
                    ck = ck + (mname,)
            if ck not in col_of:    # min+max over one column share a pass
                col_of[ck] = len(cols)
                cols.append(_column(eval_expr(u.exprs[0], col_env),
                                    torch.float32, n, dev))
                masks.append(_guard(u, valid, col_env))
                moments.append(set())
            c = col_of[ck]
            upd_col.append(c)
            upd_mname.append(mname)
            if u.kind == "arg_group":
                moments[c].add("min" if u.op in ("<", "<=") else "max")
                if mname is not None:
                    moments[c].add(mname)
            else:
                moments[c].add(u.kind)
        kernel_moments = tuple(tuple(sorted(ms)) for ms in moments)

        # sorted layout: the group sort established the sorted-segs
        # precondition, so the kernel skips its check; the unsorted layout
        # (sort-free) never had an order
        fused = fused_segment_agg(
            torch.stack(cols, dim=1), seg.to(torch.int32),
            torch.stack(masks, dim=1), num_segments, backend=backend,
            moments=kernel_moments, assume_sorted=True, layout=layout)
        for j, (u, c) in enumerate(zip(kernel_updates, upd_col)):
            f = u.fields[0]
            d = outer_vals[f].dtype
            if u.kind == "arg_group":
                minimize = u.op in ("<", "<=")
                best = fused[c, 2 if minimize else 3].to(d)
                if upd_mname[j] is not None:
                    pick = _index_row_to_pick(
                        fused[c, ARGMIN_ROW if minimize else ARGMAX_ROW],
                        n, tie_first=u.op in ("<", ">"))
                    _arg_select_from_index(u, outer_vals, col_env, best,
                                           pick, n, out)
                else:
                    worst = _recognize._MINMAX_ID[
                        "min" if minimize else "max"](d).to(dev)
                    masked = torch.where(masks[c], cols[c].to(d), worst)
                    _arg_group_select(u, outer_vals, col_env, masks[c],
                                      masked, best, seg, num_segments, out)
                continue
            r = fused[c, {"sum": 0, "min": 2, "max": 3}[u.kind]].to(d)
            if u.kind == "sum":
                out[f] = outer_vals[f] + r
            elif u.kind == "min":
                out[f] = torch.minimum(outer_vals[f], r)
            else:
                out[f] = torch.maximum(outer_vals[f], r)
    if rest:
        out.update(_grouped_recognized(agg, rows, outer_vals, valid, seg,
                                       num_segments, updates=tuple(rest)))
    return out


def _index_row_to_pick(idx_row: torch.Tensor, n: int,
                       tie_first: bool) -> torch.Tensor:
    """Kernel index row (f32, tie identity ±inf for empty segments) → the
    int64 pick convention of the select tails: ``n`` is the empty
    sentinel for first-attaining order, ``-1`` for last-attaining.  The
    ±inf → sentinel mapping happens in f32, before the int cast."""
    if tie_first:
        return torch.where(idx_row < n, idx_row,
                           torch.tensor(float(n), device=idx_row.device)
                           ).to(torch.int64)
    return torch.where(idx_row >= 0, idx_row,
                       torch.tensor(-1.0, device=idx_row.device)
                       ).to(torch.int64)


def _arg_select_from_index(u, outer_vals, col_env, best, pick, n,
                           out) -> None:
    """Arg-extremum tail on the kernel's index moment: the attaining row
    arrives from the fused pass, so the only data movement left is one
    num_segments-sized payload take per payload column, then the
    beat-compare against the pre-loop state."""
    kf = u.fields[0]
    got = (pick >= 0) & (pick < n)
    ov = outer_vals[kf]
    cmp = {"<": best < ov, "<=": best <= ov,
           ">": best > ov, ">=": best >= ov}[u.op]
    beat = cmp & got
    out[kf] = torch.where(beat, best, ov)
    safe = pick.clamp(0, n - 1)
    for f, pe in zip(u.fields[1:], u.exprs[1:]):
        pd = outer_vals[f].dtype
        pv = _column(eval_expr(pe, col_env), pd, n, best.device)
        out[f] = torch.where(beat, pv[safe], outer_vals[f])


def _arg_group_select(u, outer_vals, col_env, g, masked, best, seg,
                      num_segments, out) -> None:
    """Hit-detection tail of the grouped argmin/argmax: given the
    per-segment key extremum ``best``, pick the attaining row (first for
    strict comparisons, last for non-strict), then the payload take and
    beat-compare."""
    n = masked.shape[0]
    seg64 = seg.to(torch.int64)
    hit = g & (masked == best[seg64])
    first = u.op in ("<", ">")
    none = n if first else -1
    cand = torch.where(hit, torch.arange(n, device=masked.device), none)
    pick = torch.full((num_segments,), none, dtype=torch.int64,
                      device=masked.device).scatter_reduce_(
        0, seg64, cand, "amin" if first else "amax")
    _arg_select_from_index(u, outer_vals, col_env, best, pick, n, out)


def _segment_reduce(x: torch.Tensor, seg64: torch.Tensor, num_segments: int,
                    how: str) -> torch.Tensor:
    """Per-segment reduction with the identity for empty segments."""
    if how == "sum":
        return torch.zeros(num_segments, dtype=x.dtype,
                           device=x.device).index_add_(0, seg64, x)
    ident = {"prod": torch.tensor(1, dtype=x.dtype),
             "amin": _recognize._MINMAX_ID["min"](x.dtype),
             "amax": _recognize._MINMAX_ID["max"](x.dtype)}[how]
    return torch.full((num_segments,), ident.item(), dtype=x.dtype,
                      device=x.device).scatter_reduce_(0, seg64, x, how)


def _grouped_recognized(agg, rows, outer_vals, valid, seg, num_segments,
                        updates=None):
    """Segment-vectorized recognized aggregation on torch segment ops
    (``updates`` restricts to a subset — the fused path's leftovers)."""
    col_env = dict(outer_vals)
    col_env.update(rows)
    out: dict[str, torch.Tensor] = {}
    n = valid.shape[0]
    dev = valid.device
    seg64 = seg.to(torch.int64)
    for u in (agg.recognized if updates is None else updates):
        g = _guard(u, valid, col_env)
        if u.kind in ("sum", "prod", "min", "max"):
            f = u.fields[0]
            d = outer_vals[f].dtype
            e = _column(eval_expr(u.exprs[0], col_env), d, n, dev)
            if u.kind == "sum":
                out[f] = outer_vals[f] + _segment_reduce(
                    torch.where(g, e, torch.zeros((), dtype=d, device=dev)),
                    seg64, num_segments, "sum")
            elif u.kind == "prod":
                out[f] = outer_vals[f] * _segment_reduce(
                    torch.where(g, e, torch.ones((), dtype=d, device=dev)),
                    seg64, num_segments, "prod")
            else:
                how = "amin" if u.kind == "min" else "amax"
                ident = _recognize._MINMAX_ID[u.kind](d).to(dev)
                r = _segment_reduce(torch.where(g, e, ident), seg64,
                                    num_segments, how)
                red = torch.minimum if u.kind == "min" else torch.maximum
                out[f] = red(outer_vals[f], r)
        elif u.kind == "arg_group":
            kf = u.fields[0]
            kd = outer_vals[kf].dtype
            key = _column(eval_expr(u.exprs[0], col_env), kd, n, dev)
            minimize = u.op in ("<", "<=")
            worst = _recognize._MINMAX_ID["min" if minimize
                                          else "max"](kd).to(dev)
            masked = torch.where(g, key, worst)
            best = _segment_reduce(masked, seg64, num_segments,
                                   "amin" if minimize else "amax")
            _arg_group_select(u, outer_vals, col_env, g, masked, best,
                              seg, num_segments, out)
        elif u.kind == "last":
            f = u.fields[0]
            e = _column(eval_expr(u.exprs[0], col_env), outer_vals[f].dtype,
                        n, dev)
            cand = torch.where(g, torch.arange(n, device=dev), -1)
            pick = _segment_reduce(cand, seg64, num_segments, "amax")
            out[f] = torch.where(pick >= 0, e[pick.clamp(0, n - 1)],
                                 outer_vals[f])
        else:  # pragma: no cover
            raise ValueError(u.kind)
    return out


def _grouped_scan(agg, rows, outer_vals, valid, seg, num_segments):
    """Generic grouped custom aggregate: each segment's valid rows folded
    sequentially in row order, from ``init``; empty segments keep the
    pre-loop values."""
    tagg = agg.as_torch_aggregate(outer_vals, deferred_init=False)
    dev = valid.device
    idx = torch.nonzero(valid).flatten()
    segs = seg[idx].tolist()
    by_seg: dict[int, list[int]] = {}
    for i, s in zip(idx.tolist(), segs):
        by_seg.setdefault(s, []).append(i)
    out = {v: _scalar(outer_vals.get(v, 0.0), dev).expand(
        num_segments).clone() for v in agg.terminate_vars}
    for s, members in by_seg.items():
        state = tagg.init()
        for i in members:
            state = tagg.accumulate(state, {k: c[i] for k, c in rows.items()})
        for v, r in zip(agg.terminate_vars, tagg.terminate(state)):
            out[v][s] = r
    return out
