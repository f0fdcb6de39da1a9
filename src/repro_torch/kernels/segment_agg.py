"""Fused grouped aggregation: the hot path of Aggify's grouped execution.

One pass over N rows of C value columns (each with its own validity mask)
and int32 segment ids computes, per segment and column, SUM / COUNT / MIN /
MAX and optionally the row index attaining the min or max with the loop's
tie order — the (C, R, S) float32 moment tensor the grouped executors
terminate.  Twin of ``repro/kernels/segment_agg.py``.

Two hand-written CUDA kernels (``csrc/segment_agg.cu``) carry it on the
card:

* ``segagg_unsorted`` replaces the Pallas ``_segment_agg_kernel``
  (``src/repro/kernels/segment_agg.py:287``): segment ids in any order, one
  pass of global atomics.  Bound: bytes — N·C·(4+1) + 4N read, C·R·S·4
  written.  Design: sum/count by atomicAdd, min/max by atomicMin/Max on
  order-preserving u32 encodings of the f32 bits, each index row by one
  64-bit atomic on the packed (ordered key, row) word, so no row is read
  twice and no membership mask is built.
* ``segagg_sorted`` replaces ``_segment_agg_kernel_pruned``
  (``src/repro/kernels/segment_agg.py:304``): segment ids sorted ascending.
  Same bound.  Design: a warp-level segmented scan over each warp's row
  range writes every segment lying inside the range once, with a plain
  store; only the runs crossing a range boundary use atomics.

Beside them, ``_segment_agg_plain`` is the plain PyTorch version with the
same arithmetic (``scatter_reduce`` / ``index_add_``, the two index
formulations of the reference's jnp path).  ``fused_segment_agg`` takes it
for a tensor on the CPU; for a CUDA tensor it launches a kernel or raises,
unless the caller names ``backend="jnp"`` itself.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = float("-inf")
POS_INF = float("inf")

#: index of each fused value moment in the kernel output
MOMENTS = ("sum", "count", "min", "max")

#: optional index moments: the row attaining the per-segment min (row
#: ``ARGMIN_ROW``) or max (row ``ARGMAX_ROW``); ``*_first`` keeps the
#: earliest attaining row, ``*_last`` the latest
INDEX_MOMENTS = ("argmin_first", "argmin_last", "argmax_first", "argmax_last")

ARGMIN_ROW = 4
ARGMAX_ROW = 5

#: f32-exact row-index ceiling: the index rows are f32 in the output
#: contract, so index moments at or above this many padded rows are refused
INDEX_EXACT_ROWS = 1 << 24

#: most value columns one launch takes (the kernels' per-column flag table)
MAX_COLS = 32


def index_moment_ok(n: int, block_rows: int = 256) -> bool:
    """True when every row index up to ``n`` padded to a ``block_rows``
    multiple is exactly representable in f32 — the one gate shared by the
    kernels' validation and the executors' use-index decision."""
    return n + (-n) % block_rows < INDEX_EXACT_ROWS


def normalize_moments(moments, num_cols: int) -> tuple[tuple[str, ...], ...]:
    """Canonicalize ``moments`` to one validated tuple per column: a flat
    tuple applies to every column, a tuple of tuples is per column.  Index
    moments imply their extremum; one column carries at most one tie order
    per direction; unknown names raise."""
    known = MOMENTS + INDEX_MOMENTS
    if not moments or isinstance(moments[0], str):
        per_col = (tuple(moments),) * num_cols
    else:
        per_col = tuple(tuple(ms) for ms in moments)
    if len(per_col) != num_cols:
        raise ValueError(f"per-column moments: got {len(per_col)} entries "
                         f"for {num_cols} columns")
    out = []
    for ms in per_col:
        bad = [m for m in ms if m not in known]
        if bad:
            raise ValueError(f"unknown moment(s) {bad!r}; expected a subset "
                             f"of {known}")
        ms = set(ms)
        for which in ("argmin", "argmax"):
            if which + "_first" in ms and which + "_last" in ms:
                raise ValueError(
                    f"a column cannot carry both {which}_first and "
                    f"{which}_last (one index row per extremum direction) "
                    "— use separate columns")
        if "argmin_first" in ms or "argmin_last" in ms:
            ms.add("min")
        if "argmax_first" in ms or "argmax_last" in ms:
            ms.add("max")
        out.append(tuple(m for m in known if m in ms))
    return tuple(out)


def has_index_moments(moments: tuple[tuple[str, ...], ...]) -> bool:
    return any(m in INDEX_MOMENTS for ms in moments for m in ms)


def moment_rows(moments: tuple[tuple[str, ...], ...]) -> int:
    """Rows per column: 4 value rows, 6 when any column asks for an index."""
    return 6 if has_index_moments(moments) else 4


def _index_tie(ms: tuple[str, ...], which: str):
    """Tie order of ``which`` ('argmin'/'argmax') for one column: True =
    first-attaining, False = last-attaining, None = not requested."""
    if which + "_first" in ms:
        return True
    if which + "_last" in ms:
        return False
    return None


def _row_fills(moments: tuple[tuple[str, ...], ...]) -> tuple[float, ...]:
    """Per-output-row identities, column-major: [0, 0, +inf, -inf], then
    the index rows' tie identity (+inf first or unrequested, -inf last)."""
    nrows = moment_rows(moments)
    fills: list[float] = []
    for ms in moments:
        fills += [0.0, 0.0, POS_INF, NEG_INF]
        if nrows == 6:
            fills += [NEG_INF if _index_tie(ms, "argmin") is False
                      else POS_INF,
                      NEG_INF if _index_tie(ms, "argmax") is False
                      else POS_INF]
    return tuple(fills)


def _validate_sorted(segs: torch.Tensor, prune: bool, assume_sorted: bool,
                     backend: str) -> None:
    """The sorted kernel's precondition: only the kernel backend with
    pruning on cares (the plain version is order-independent); unsorted
    input raises.  Torch is eager, so the check always runs on concrete
    values — the reference's traced NaN poison has no twin."""
    if not prune or assume_sorted or backend != "cuda":
        return
    if segs.numel() > 1 and bool(torch.any(segs[1:] < segs[:-1])):
        raise ValueError(
            "fused_segment_agg: the sorted kernel requires `segs` sorted "
            "ascending — sort rows by segment (the grouped executors do) "
            "or pass prune=False")


def _normalize(vals: torch.Tensor, valid: torch.Tensor):
    """Lift (N,)/(N,C) vals and valid to matching (N, C)."""
    if vals.ndim == 1:
        vals = vals[:, None]
    if valid.ndim == 1:
        valid = valid[:, None]
    if valid.shape[1] == 1 and vals.shape[1] > 1:
        valid = valid.expand(vals.shape)
    return vals, valid


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ENC_POS_INF = 0xFF800000
_ENC_NEG_INF = 0x007FFFFF
#: ordered keys standing for NaN: below every value for min, above for max
_NAN_MIN, _NAN_MAX = 0, _M32


def _ordered(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving encoding of f32 bits as int64 in [0, 2^32):
    a < b (with -0.0 < +0.0) iff enc(a) < enc(b) — the kernels' u32
    encoding, so both sides pick the same extremum bit for bit."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & _M32
    return torch.where(b >= 1 << 31, b ^ _M32, b | (1 << 31))


def _unordered(k: torch.Tensor) -> torch.Tensor:
    b = torch.where(k >= 1 << 31, k ^ (1 << 31), k ^ _M32)
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def _extremum(v, ok, seg, num_segments, minimize: bool) -> torch.Tensor:
    """Segment min/max on ordered encodings: deterministic for -0.0/+0.0
    (which ``scatter_reduce`` on floats is not) and NaN-propagating."""
    nan_key, ident = (_NAN_MIN, _ENC_POS_INF) if minimize \
        else (_NAN_MAX, _ENC_NEG_INF)
    k = torch.where(torch.isnan(v), nan_key, _ordered(v))
    k = torch.where(ok, k, ident)
    r = torch.full((num_segments,), ident, dtype=torch.int64,
                   device=v.device).scatter_reduce_(
        0, seg, k, "amin" if minimize else "amax")
    return torch.where(r == nan_key, torch.tensor(float("nan"),
                                                  device=v.device),
                       _unordered(r))


def _index_keys(v, minimize: bool) -> torch.Tensor:
    """Ordered index key: -0.0 equals +0.0 (the tie order decides), NaN
    maps to the direction's sentinel (no row attains a NaN extremum)."""
    k = _ordered(torch.where(v == 0, torch.zeros_like(v), v))
    return torch.where(torch.isnan(v), _NAN_MIN if minimize else _NAN_MAX, k)


def _segment_arg_index_unsorted(v, ok, seg, num_segments, *, minimize: bool,
                                tie_first: bool) -> torch.Tensor:
    """Attaining row per segment for ARBITRARY segment ids: the
    hit-detection form (segment extremum, one row-sized ``best[seg]``
    gather, tie-ordered index reduce).  Returns the f32 index row."""
    n = v.shape[0]
    sentinel = _NAN_MIN if minimize else _NAN_MAX
    key = _index_keys(v, minimize)
    worst = (1 << 32) if minimize else -1          # beyond every real key
    key = torch.where(ok, key, worst)
    best = torch.full((num_segments,), worst, dtype=torch.int64,
                      device=v.device).scatter_reduce_(
        0, seg, key, "amin" if minimize else "amax")
    bk = best[seg]
    hit = ok & (key == bk) & (bk != sentinel)
    none = n if tie_first else -1
    rows = torch.arange(n, device=v.device)
    cand = torch.where(hit, rows, none)
    r = torch.full((num_segments,), none, dtype=torch.int64,
                   device=v.device).scatter_reduce_(
        0, seg, cand, "amin" if tie_first else "amax")
    ident = POS_INF if tie_first else NEG_INF
    return torch.where((r >= 0) & (r < n), r.to(torch.float32),
                       torch.tensor(ident, device=v.device))


def _segment_arg_index_scan(v, ok, seg, num_segments, *, minimize: bool,
                            tie_first: bool) -> torch.Tensor:
    """Attaining row per segment WITHOUT a row-sized gather, for segment
    ids sorted ascending: each row packs (ordered key, row part) into one
    int64 word whose order is the lexicographic (key, row) compare, a
    segmented inclusive scan (log-step, resetting at segment changes)
    reduces the words, and each segment's result is read at its last row
    (an S-sized take)."""
    n = v.shape[0]
    dev = v.device
    sentinel = _NAN_MIN if minimize else _NAN_MAX
    rows = torch.arange(n, device=dev, dtype=torch.int64)
    # the row part makes min (argmin) / max (argmax) pick the tie order
    part = rows if tie_first == minimize else _M32 - rows
    word = ((_index_keys(v, minimize) - (1 << 31)) << 32) + part
    neutral = torch.iinfo(torch.int64).max if minimize \
        else torch.iinfo(torch.int64).min
    word = torch.where(ok, word, neutral)
    pick = torch.minimum if minimize else torch.maximum
    d = 1
    while d < n:
        prev = torch.cat([torch.full((d,), neutral, dtype=torch.int64,
                                     device=dev), word[:-d]])
        same = torch.cat([torch.zeros((d,), dtype=torch.bool, device=dev),
                          seg[d:] == seg[:-d]])
        word = torch.where(same, pick(prev, word), word)
        d <<= 1
    last = torch.full((num_segments,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, seg, rows, "amax")
    w = word[last.clamp(0, max(n - 1, 0))] if n else \
        torch.full((num_segments,), neutral, dtype=torch.int64, device=dev)
    got = (last >= 0) & (w != neutral) & ((w >> 32) + (1 << 31) != sentinel)
    rp = w & _M32
    row = rp if tie_first == minimize else _M32 - rp
    ident = POS_INF if tie_first else NEG_INF
    return torch.where(got, row.to(torch.float32),
                       torch.tensor(ident, device=dev))


def _segment_agg_plain(vals: torch.Tensor, segs: torch.Tensor,
                       valid: torch.Tensor, num_segments: int,
                       moments: tuple[tuple[str, ...], ...],
                       sorted_segs: bool = True) -> torch.Tensor:
    """Plain PyTorch version, identical math: (N, C) → (C, R, S) f32.
    Moment rows a column does not request hold their identity.  Index
    rows use the gather-free scan for sorted segments and the
    hit-detection form otherwise; both give the same rows."""
    dev = vals.device
    v = vals.to(torch.float32)
    seg = segs.to(torch.int64)
    num_cols = v.shape[1]
    nrows = moment_rows(moments)
    # out-of-range ids drop, as the reference's segment ops drop them
    in_range = (seg >= 0) & (seg < num_segments)
    seg = seg.clamp(0, max(num_segments - 1, 0))
    out = torch.tensor(_row_fills(moments), dtype=torch.float32,
                       device=dev).reshape(num_cols, nrows, 1).repeat(
        1, 1, num_segments)
    for c in range(num_cols):
        ms = moments[c]
        ok = valid[:, c].to(torch.bool) & in_range
        vc = v[:, c]
        if "sum" in ms:
            out[c, 0] = torch.zeros(num_segments, device=dev).index_add_(
                0, seg, torch.where(ok, vc, torch.zeros_like(vc)))
        if "count" in ms:
            out[c, 1] = torch.zeros(num_segments, device=dev).index_add_(
                0, seg, ok.to(torch.float32))
        if "min" in ms:
            out[c, 2] = _extremum(vc, ok, seg, num_segments, True)
        if "max" in ms:
            out[c, 3] = _extremum(vc, ok, seg, num_segments, False)
        for which, row, minimize in (("argmin", ARGMIN_ROW, True),
                                     ("argmax", ARGMAX_ROW, False)):
            tie = _index_tie(ms, which)
            if tie is None:
                continue
            argf = (_segment_arg_index_scan if sorted_segs
                    else _segment_arg_index_unsorted)
            out[c, row] = argf(vc, ok, seg, num_segments, minimize=minimize,
                               tie_first=tie)
    return out


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_F_SUM, _F_CNT, _F_MIN, _F_MAX = 1, 2, 4, 8
_F_AMIN, _F_AMIN_FIRST, _F_AMAX, _F_AMAX_FIRST = 16, 32, 64, 128


class _ColFlags(ctypes.Structure):
    _fields_ = [("f", ctypes.c_int * MAX_COLS)]


def _col_flags(moments) -> _ColFlags:
    flags = _ColFlags()
    for c, ms in enumerate(moments):
        f = 0
        for m, bit in (("sum", _F_SUM), ("count", _F_CNT), ("min", _F_MIN),
                       ("max", _F_MAX)):
            if m in ms:
                f |= bit
        amin, amax = _index_tie(ms, "argmin"), _index_tie(ms, "argmax")
        if amin is not None:
            f |= _F_AMIN | (_F_AMIN_FIRST if amin else 0)
        if amax is not None:
            f |= _F_AMAX | (_F_AMAX_FIRST if amax else 0)
        flags.f[c] = f
    return flags


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, _ColFlags, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def _launch(fn_name: str, vals, segs, valid, num_segments: int,
            moments) -> torch.Tensor:
    from .build import load
    for name, t, dt in (("vals", vals, torch.float32),
                        ("segs", segs, torch.int32),
                        ("valid", valid, torch.bool)):
        if not t.is_cuda:
            raise ValueError(f"{fn_name}: {name} must be a CUDA tensor")
        if t.dtype != dt:
            raise ValueError(f"{fn_name}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous")
    n, num_cols = vals.shape
    if segs.shape != (n,) or valid.shape != (n, num_cols):
        raise ValueError(f"{fn_name}: shapes vals {tuple(vals.shape)}, segs "
                         f"{tuple(segs.shape)}, valid {tuple(valid.shape)} "
                         "do not match")
    if not 1 <= num_cols <= MAX_COLS:
        raise ValueError(f"{fn_name}: {num_cols} columns; the kernel takes "
                         f"1 to {MAX_COLS}")
    if num_segments < 1 or n >= 1 << 31:
        raise ValueError(f"{fn_name}: num_segments={num_segments}, n={n} "
                         "out of range")
    if len(moments) != num_cols:
        raise ValueError(f"{fn_name}: {len(moments)} moment tuples for "
                         f"{num_cols} columns")
    nrows = moment_rows(moments)
    out = torch.empty((num_cols, nrows, num_segments), dtype=torch.float32,
                      device=vals.device)
    idxw = (torch.empty((num_cols, 2, num_segments), dtype=torch.int64,
                        device=vals.device) if nrows == 6 else None)
    lib = load("segment_agg")
    fn = getattr(lib, fn_name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(vals.data_ptr(), segs.data_ptr(), valid.data_ptr(),
             out.data_ptr(), None if idxw is None else idxw.data_ptr(),
             _col_flags(moments), n, num_cols, nrows, num_segments,
             torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
    return out


def segagg_unsorted(vals: torch.Tensor, segs: torch.Tensor,
                    valid: torch.Tensor, num_segments: int,
                    moments: tuple[tuple[str, ...], ...]) -> torch.Tensor:
    """CUDA kernel for segment ids in any order (global atomics).
    ``vals`` (N, C) f32, ``segs`` (N,) i32, ``valid`` (N, C) bool, all
    contiguous on the card; ``moments`` normalized.  → (C, R, S) f32."""
    out = _launch("segagg_unsorted", vals, segs, valid, num_segments,
                  moments)
    segagg_unsorted.launches += 1
    return out


def segagg_sorted(vals: torch.Tensor, segs: torch.Tensor,
                  valid: torch.Tensor, num_segments: int,
                  moments: tuple[tuple[str, ...], ...]) -> torch.Tensor:
    """CUDA kernel for segment ids sorted ascending (warp segmented scan;
    atomics only where a segment crosses a warp's row range).  Same
    arguments and result as ``segagg_unsorted``."""
    out = _launch("segagg_sorted", vals, segs, valid, num_segments, moments)
    segagg_sorted.launches += 1
    return out


#: launches of each kernel since the count was last set to 0
segagg_unsorted.launches = 0
segagg_sorted.launches = 0


def fused_segment_agg(vals: torch.Tensor, segs: torch.Tensor,
                      valid: torch.Tensor, num_segments: int, *,
                      block_rows: int = 256, block_segs=None,
                      backend: str = "auto",
                      moments: tuple[str, ...] = MOMENTS,
                      prune: bool = True,
                      assume_sorted: bool = False,
                      layout: str = "sorted") -> torch.Tensor:
    """Fused multi-column segmented aggregation.

    ``vals`` (N,) or (N, C); ``segs`` (N,) int in [0, num_segments),
    sorted ascending under ``layout='sorted'``, any order under
    ``layout='unsorted'``; ``valid`` (N,) or (N, C) bool per-column
    guards.  ``moments`` as in ``normalize_moments``.  Returns
    (C, R, num_segments) f32 with rows [sum, count, min, max(, argmin
    row, argmax row)]; empty segments read the identities.

    ``backend``: ``"auto"`` launches a CUDA kernel for a CUDA tensor and
    runs the plain version for a CPU tensor; ``"cuda"`` insists on the
    kernel; ``"jnp"`` is the caller's own request for the plain version
    on either device.  On the kernel, ``layout='sorted'`` with ``prune``
    runs ``segagg_sorted`` — its precondition is validated (unsorted
    input raises ``ValueError``) unless ``assume_sorted`` — and
    everything else runs ``segagg_unsorted``.  ``block_rows`` sets the
    padding the f32 index-row gate counts (index moments at 2^24 padded
    rows or more raise); ``block_segs`` is the TPU kernel's segment-tile
    width and has no effect here.
    """
    if layout not in ("sorted", "unsorted"):
        raise ValueError(f"unknown segment_agg layout {layout!r}; expected "
                         "'sorted' or 'unsorted'")
    if layout == "unsorted":
        prune = False
    vals, valid = _normalize(torch.as_tensor(vals), torch.as_tensor(valid))
    num_cols = vals.shape[1]
    moments = normalize_moments(moments, num_cols)
    if has_index_moments(moments) and not index_moment_ok(vals.shape[0],
                                                          block_rows):
        raise ValueError(
            f"index moments record f32 row indices, exact only below 2^24 "
            f"(padded) rows; got {vals.shape[0]} — split the input")
    if backend == "auto":
        backend = "cuda" if vals.is_cuda else "jnp"
    if backend == "jnp":
        return _segment_agg_plain(vals, segs, valid, num_segments, moments,
                                  sorted_segs=layout == "sorted")
    if backend != "cuda":
        raise ValueError(f"unknown segment_agg backend {backend!r}")
    if not vals.is_cuda:
        raise ValueError("fused_segment_agg: backend='cuda' needs CUDA "
                         "tensors")
    _validate_sorted(segs, prune, assume_sorted, backend)
    kernel = segagg_sorted if (layout == "sorted" and prune) \
        else segagg_unsorted
    return kernel(vals.to(torch.float32).contiguous(),
                  segs.to(torch.int32).contiguous(),
                  valid.to(torch.bool).contiguous(), num_segments, moments)
