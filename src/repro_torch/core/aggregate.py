"""The aggregation contract (paper §3.1) on torch tensors — twin of
``repro/core/aggregate.py``.

  * ``streaming``     — sequential fold over rows (the *Streaming
                        Aggregate* physical operator of Eq. 6).
  * ``fold_moments``  — merge of two (C, R, S) fused-moment tensors.

The chunked, tree, associative-scan and shard-merge combinators wait for
the slice that ports them.  State is a dict of tensors (or tuples of
tensors for local tables).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

State = Any


@dataclass(frozen=True)
class Aggregate:
    """init/accumulate/merge/terminate — the custom-aggregate contract.

    init:       (init_args) -> state
    accumulate: (state, row) -> state          (row: dict of per-row values)
    merge:      (state, state) -> state | None  (optional; None => stream-only)
    terminate:  (state) -> result
    identity:   optional () -> state that is an identity of merge.
    """
    name: str
    init: Callable[..., State]
    accumulate: Callable[[State, State], State]
    terminate: Callable[[State], State]
    merge: Optional[Callable[[State, State], State]] = None
    identity: Optional[Callable[[], State]] = None

    @property
    def mergeable(self) -> bool:
        return self.merge is not None


def streaming(agg: Aggregate, rows: dict, valid: Optional[torch.Tensor] = None,
              *init_args) -> State:
    """Sequential fold over the leading axis of ``rows`` (Eq. 6
    semantics).  Rows where ``valid`` is False are skipped: the state
    passes through them unchanged, so only valid rows are visited."""
    state = agg.init(*init_args)
    if valid is None:
        n = next(iter(rows.values())).shape[0] if rows else 0
        order = range(n)
    else:
        order = torch.nonzero(valid).flatten().tolist()
    for i in order:
        state = agg.accumulate(state, {k: v[i] for k, v in rows.items()})
    return agg.terminate(state)


def fold_moments(a: torch.Tensor, b: torch.Tensor,
                 moments=None) -> torch.Tensor:
    """Merge two (C, R, S) fused-moment tensors: sum and count rows add,
    min/max extremize, and with R = 6 the index rows merge as the
    lexicographic (key, global row) extremum — each operand's index row
    enters only where its key row attains the merged extremum, reduced by
    min (first-attaining) or max (last-attaining).  Both operands' index
    rows must use one global row numbering.  ``moments`` follows
    ``kernels.segment_agg.normalize_moments`` (default: the four value
    moments, R = 4)."""
    from ..kernels.segment_agg import (MOMENTS, NEG_INF, POS_INF,
                                       _index_tie, moment_rows,
                                       normalize_moments)
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    if a.shape != b.shape or a.ndim != 3:
        raise ValueError(f"fold_moments: operands must share one "
                         f"(C, R, S) shape, got {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    num_cols = a.shape[0]
    norm = normalize_moments(MOMENTS if moments is None else moments,
                             num_cols)
    nrows = moment_rows(norm)
    if a.shape[1] != nrows:
        raise ValueError(f"fold_moments: moments spec implies {nrows} "
                         f"rows per column, operands have {a.shape[1]}")
    mn = torch.minimum(a[:, 2], b[:, 2])
    mx = torch.maximum(a[:, 3], b[:, 3])
    merged = [a[:, 0] + b[:, 0], a[:, 1] + b[:, 1], mn, mx]
    if nrows == 6:
        for which, row, key_row, gkey in (("argmin", 4, 2, mn),
                                          ("argmax", 5, 3, mx)):
            out_rows = []
            for c in range(num_cols):
                tie_first = _index_tie(norm[c], which)
                if tie_first is None:
                    out_rows.append(torch.full_like(gkey[c], POS_INF))
                    continue
                ident = POS_INF if tie_first else NEG_INF
                ca = torch.where(a[c, key_row] == gkey[c], a[c, row], ident)
                cb = torch.where(b[c, key_row] == gkey[c], b[c, row], ident)
                out_rows.append(torch.minimum(ca, cb) if tie_first
                                else torch.maximum(ca, cb))
            merged.append(torch.stack(out_rows))
    return torch.stack(merged, dim=1)
