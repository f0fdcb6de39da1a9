"""Plain segment oracles (twin of the segment part of
``repro/kernels/ref.py``): the correctness contracts the kernels and the
plain version are held against, written as directly as torch allows."""
from __future__ import annotations

import torch


def _segment(x, segs, num_segments, how, ident):
    out = torch.full((num_segments,), ident, dtype=x.dtype, device=x.device)
    idx = segs.to(torch.int64)
    if how == "sum":
        return out.index_add_(0, idx, x)
    return out.scatter_reduce_(0, idx, x, how)


def segment_agg_ref(vals: torch.Tensor, segs: torch.Tensor,
                    valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[sum, count, min, max] per segment, (4, num_segments) f32."""
    v = vals.to(torch.float32)
    valid = valid.to(torch.bool)
    inf = float("inf")
    s = _segment(torch.where(valid, v, 0.0), segs, num_segments, "sum", 0.0)
    c = _segment(valid.to(torch.float32), segs, num_segments, "sum", 0.0)
    mn = _segment(torch.where(valid, v, inf), segs, num_segments, "amin", inf)
    mx = _segment(torch.where(valid, v, -inf), segs, num_segments, "amax",
                  -inf)
    return torch.stack([s, c, mn, mx])


def fused_segment_agg_ref(vals: torch.Tensor, segs: torch.Tensor,
                          valid: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Multi-column oracle: (N, C) vals, (N, C) per-column validity →
    (C, 4, num_segments) f32 with moment rows [sum, count, min, max]."""
    return torch.stack([segment_agg_ref(vals[:, c], segs, valid[:, c],
                                        num_segments)
                        for c in range(vals.shape[1])])


def segment_arg_index_ref(keys: torch.Tensor, segs: torch.Tensor,
                          valid: torch.Tensor, num_segments: int, *,
                          minimize: bool, tie_first: bool) -> torch.Tensor:
    """The row attaining each segment's key extremum, first- or
    last-attaining on ties, valid rows only — the classic hit-detection
    formulation.  Returns int64 with the empty-segment sentinel ``n`` for
    first-attaining order, ``-1`` for last-attaining."""
    n = keys.shape[0]
    k = keys.to(torch.float32)
    valid = valid.to(torch.bool)
    worst = float("inf") if minimize else float("-inf")
    masked = torch.where(valid, k, worst)
    best = _segment(masked, segs, num_segments,
                    "amin" if minimize else "amax", worst)
    hit = valid & (masked == best[segs.to(torch.int64)])
    idx = torch.arange(n, device=keys.device)
    if tie_first:
        return _segment(torch.where(hit, idx, n), segs, num_segments,
                        "amin", n)
    return _segment(torch.where(hit, idx, -1), segs, num_segments, "amax",
                    -1)
