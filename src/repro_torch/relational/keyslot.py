"""Sort-free dense group slotting: hash-slotted segment ids (twin of the
one-shot part of ``repro/relational/keyslot.py``).

Grouping by order-insensitive moments needs a key → dense-segment
*assignment*, not a total order.  This module is that assignment: a
power-of-two, quadratic-probe hash table (scatter-min claims + gathers in
a host-driven probe loop) over-provisioned to ``expand ×`` the declared
dense group bound, whose occupied slots then renumber densely into
``[0, bucket)`` by one prefix sum.

Contract, as in the reference: every valid row with one group-key tuple
gets one slot in ``[0, bucket)``; distinct tuples get distinct slots
(collisions resolve by probing on full key equality); invalid rows park
in the overflow slot ``bucket``; more distinct keys than slots raise
``GroupBoundOverflow``.  Key equality is bitwise on canonical words: −0.0
and +0.0 share a group, NaN keys share one per bit pattern.  Claims are a
deterministic scatter-min by row, so ``seg``, ``owner`` and ``occupied``
equal the reference's bit for bit.

Canonical key words are uint32 values carried in int64 tensors (torch has
no uint32 arithmetic on the CPU); the murmur mix runs in int64 and masks
to 32 bits, with products split so that none exceeds 2^49.

The resident, extendable slot state of the serving layer (``SlotState``,
``slot_ids_extend``) waits for the slice that ports serving.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Iterable, Mapping, Optional

import torch

from ..configs import flags
from .group_bound import GroupBoundOverflow

_M32 = 0xFFFFFFFF


def sortfree_enabled() -> bool:
    """Kill switch for the sort-free grouped route (default: on).
    ``REPRO_GROUPAGG_SORTFREE=off`` forces every grouped call back onto
    the sorted route."""
    return flags.enabled("REPRO_GROUPAGG_SORTFREE")


# ---------------------------------------------------------------------------
# Canonical key words
# ---------------------------------------------------------------------------


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """The 32 bits of a 32-bit tensor as int64 in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & _M32


def canonical_key_words(col: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Lower one key column to uint32 words (int64 tensors) with
    group-equality semantics: equal keys ⇒ equal words, distinct keys ⇒
    distinct words, with no narrowing cast.  Floats normalize −0.0 to
    +0.0 first; 64-bit dtypes split into (hi, lo) words."""
    d = col.dtype
    if d == torch.bool or d == torch.uint8:
        return (col.to(torch.int64),)
    if d in (torch.int8, torch.int16, torch.int32):
        return (_bits32(col.to(torch.int32)),)
    if d in (torch.uint16, torch.uint32):
        return (col.to(torch.int64),)
    if d in (torch.int64, torch.uint64):
        u = col.view(torch.int64)
        return ((u >> 32) & _M32, u & _M32)
    if d.is_floating_point:
        if d == torch.float64:
            f = torch.where(col == 0, torch.zeros_like(col), col)
            u = f.view(torch.int64)
            return ((u >> 32) & _M32, u & _M32)
        f = col.to(torch.float32)              # f16/bf16 embed exactly
        f = torch.where(f == 0, torch.zeros_like(f), f)
        return (_bits32(f),)
    raise TypeError(f"unhashable group-key dtype {d} (expected bool, "
                    "integer, or floating)")


def key_words_for(columns: Iterable[torch.Tensor]) -> torch.Tensor:
    """Stack the canonical words of every key column into one (N, K)
    int64 matrix of uint32 values."""
    words: list[torch.Tensor] = []
    for c in columns:
        words.extend(canonical_key_words(c))
    return torch.stack(words, dim=1)


# ---------------------------------------------------------------------------
# Hash + probe loop
# ---------------------------------------------------------------------------


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for a in [0, 2^32), without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _hash_words(words: torch.Tensor) -> torch.Tensor:
    """murmur3-style mix of the (N, K) word matrix into one uint32 hash
    per row (int64 tensor), equal to the reference's uint32 arithmetic."""
    h = torch.full(words.shape[:1], 0x9E3779B9, dtype=torch.int64,
                   device=words.device)
    for k in range(words.shape[1]):
        w = _mul32(words[:, k], 0xCC9E2D51)
        w = _mul32(_rotl(w, 15), 0x1B873593)
        h = (_mul32(_rotl(h ^ w, 13), 5) + 0xE6546B64) & _M32
    h = h ^ words.shape[1]
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _probe_offset(rnd: int) -> int:
    """Triangular probe offset p(p+1)/2 of round ``rnd``, in the
    reference's uint32 arithmetic."""
    return ((rnd * (rnd + 1)) & _M32) // 2


#: probe-table expansion ceiling: ``EXPAND × bucket`` slots bound the load
#: factor at 1/EXPAND; eager builds shrink it from the distinct-count sketch
EXPAND = 16
#: adaptive sizing targets estimated distinct keys / slots ≤ 1/8
_TARGET_LOAD_INV = 8
#: floor on the adaptive expansion
_MIN_EXPAND = 4


def adaptive_enabled() -> bool:
    """Kill switch for sketch-driven probe-table sizing (default: on).
    ``REPRO_KEYSLOT_ADAPTIVE=off`` pins the fixed ``EXPAND`` ceiling."""
    return flags.enabled("REPRO_KEYSLOT_ADAPTIVE")


def adaptive_expand(est_distinct: int, bucket: int) -> int:
    """Probe-table expansion factor from a distinct-count estimate: the
    smallest power of two keeping the estimated load factor at or below
    ``1/_TARGET_LOAD_INV``, clamped to ``[_MIN_EXPAND, EXPAND]``."""
    need = _TARGET_LOAD_INV * max(1, int(est_distinct))
    e = 1
    while e * bucket < need and e < EXPAND:
        e <<= 1
    return max(_MIN_EXPAND, min(EXPAND, e))


def slot_ids_from_words(words: torch.Tensor, valid: torch.Tensor,
                        bucket: int, expand: int = EXPAND):
    """Assign each valid row a dense slot in ``[0, bucket)`` keyed by its
    canonical word tuple.  Returns ``(seg, owner, occupied, overflowed)``:

    * ``seg``        (N,)      int32 — the slot; invalid rows and rows
                     whose key exceeded the bucket hold ``bucket``;
    * ``owner``      (bucket,) int32 — the row that claimed each slot
                     (``N`` where the slot is empty);
    * ``occupied``   (bucket,) bool  — slots holding a real group (a dense
                     prefix: slot numbers follow probe-table order);
    * ``overflowed`` ()        int64 — valid rows parked in the overflow
                     slot (nonzero means the key set overflowed).

    Probe round ``p`` of a row with hash ``h`` tries probe-table slot
    ``(h + p(p+1)/2) mod M`` (``M = expand × bucket``): empty slots are
    claimed by the smallest contending row (scatter-min), then every
    prober compares its key words with the slot owner's — equal places,
    different probes on.  Only still-active rows take part in a round,
    which changes nothing (finished rows never claimed), and the loop
    ends when none is left, as the reference's ``while_loop`` does."""
    if bucket & (bucket - 1) or bucket <= 0:
        raise ValueError(f"bucket must be a positive power of two, got "
                         f"{bucket}")
    if expand & (expand - 1) or expand <= 0:
        raise ValueError(f"expand must be a positive power of two, got "
                         f"{expand}")
    dev = words.device
    n = words.shape[0]
    m = bucket * expand
    h = _hash_words(words)
    valid = valid.to(torch.bool)
    tbl = torch.full((m,), n, dtype=torch.int32, device=dev)
    slot = torch.full((n,), m, dtype=torch.int64, device=dev)
    act = torch.nonzero(valid).flatten()
    rnd = 0
    while rnd < m and act.numel():
        cand = (h[act] + _probe_offset(rnd)) & (m - 1)
        claim = torch.full((m,), n, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, cand, act.to(torch.int32), "amin")
        tbl = torch.where(tbl == n, claim, tbl)
        own = tbl[cand].to(torch.int64)
        ow = words[own.clamp(0, max(n - 1, 0))]
        eq = (own < n) & (ow == words[act]).all(dim=1)
        slot[act[eq]] = cand[eq]
        act = act[~eq]
        rnd += 1
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    active[act] = True

    # densify: occupied probe slots renumber to [0, #groups) in slot order;
    # groups past the bucket overflow
    occ_m = tbl < n
    dense = torch.cumsum(occ_m, 0, dtype=torch.int64) - 1
    d = dense[slot.clamp(0, m - 1)]
    placed = ~active & valid & (d < bucket)
    seg = torch.where(placed, d, bucket).to(torch.int32)
    keep = torch.nonzero(occ_m & (dense < bucket)).flatten()
    owner = torch.full((bucket,), n, dtype=torch.int32, device=dev)
    owner[dense[keep]] = tbl[keep]
    ngroups = min(int(dense[-1]) + 1, bucket) if m else 0
    occupied = torch.arange(bucket, device=dev) < ngroups
    overflowed = (valid & (seg == bucket)).sum()
    return seg, owner, occupied, overflowed


#: build-side probe-table expansion for ``build_probe``: the next power of
#: two ≥ 4 × build rows, so every build key has a slot (no overflow state)
_JOIN_EXPAND = 4


def _probe_table_size(n_build: int) -> int:
    need = max(8, _JOIN_EXPAND * max(1, n_build))
    return 1 << (need - 1).bit_length()


def build_probe(build_words: torch.Tensor, build_valid: torch.Tensor,
                probe_words: torch.Tensor,
                probe_valid: Optional[torch.Tensor] = None):
    """Hash-join lookup on canonical key words: build an open-addressing
    table over the build rows, then resolve each probe row to the build
    row with equal words by one lockstep probe walk.  Returns
    ``(ridx, found)``: ``ridx`` (Np,) int32 build-row index (``Nb``
    where none matches), ``found`` (Np,) bool.  Duplicate build keys
    award their slot to the smallest valid build row; the probe walk stops
    at key equality or at the first empty slot.  Equality is bitwise on
    canonical words (NaN matches NaN per bit pattern): join routes that
    need SQL value equality mask NaN keys out of ``found`` themselves."""
    dev = probe_words.device
    nb = build_words.shape[0]
    npr = probe_words.shape[0]
    pvalid = (torch.ones(npr, dtype=torch.bool, device=dev)
              if probe_valid is None else probe_valid.to(torch.bool))
    if nb == 0:
        return (torch.zeros(npr, dtype=torch.int32, device=dev),
                torch.zeros(npr, dtype=torch.bool, device=dev))
    m = _probe_table_size(nb)
    hb = _hash_words(build_words)
    tbl = torch.full((m,), nb, dtype=torch.int32, device=dev)
    act = torch.nonzero(build_valid.to(torch.bool)).flatten()
    rnd = 0
    while rnd < m and act.numel():
        cand = (hb[act] + _probe_offset(rnd)) & (m - 1)
        claim = torch.full((m,), nb, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, cand, act.to(torch.int32), "amin")
        tbl = torch.where(tbl == nb, claim, tbl)
        own = tbl[cand].to(torch.int64)
        eq = (own < nb) & (build_words[own.clamp(0, nb - 1)]
                           == build_words[act]).all(dim=1)
        act = act[~eq]
        rnd += 1

    hp = _hash_words(probe_words)
    ridx = torch.full((npr,), nb, dtype=torch.int32, device=dev)
    found = torch.zeros(npr, dtype=torch.bool, device=dev)
    act = torch.nonzero(pvalid).flatten()
    rnd = 0
    while rnd < m and act.numel():
        cand = (hp[act] + _probe_offset(rnd)) & (m - 1)
        own = tbl[cand].to(torch.int64)
        empty = own >= nb
        eq = ~empty & (build_words[own.clamp(0, nb - 1)]
                       == probe_words[act]).all(dim=1)
        ridx[act[eq]] = own[eq].to(torch.int32)
        found[act[eq]] = True
        act = act[~eq & ~empty]
        rnd += 1
    return ridx, found


# ---------------------------------------------------------------------------
# Slot-table reuse: a caller that amortizes the probe loop across repeated
# calls computes the four slot arrays once per (table, key set, bucket)
# and provides them for the scope of an execution; ``slot_segment_ids``
# then returns them instead of probing.  Thread-local, keyed by
# ``(key-name tuple, bucket)``; the provider guarantees the arrays were
# built from the table being executed.
# ---------------------------------------------------------------------------

_PROVIDED = threading.local()


def provided_slots(keys, bucket: int):
    """The slot arrays provided for ``(keys, bucket)`` by an enclosing
    ``provide_slots`` scope, or None."""
    stack = getattr(_PROVIDED, "stack", None)
    if not stack:
        return None
    k = (tuple(keys), int(bucket))
    for mapping in reversed(stack):
        got = mapping.get(k)
        if got is not None:
            return got
    return None


@contextmanager
def provide_slots(mapping: Mapping):
    """Provide precomputed slot arrays for the dynamic extent of the
    context: ``mapping`` maps ``(key-name tuple, bucket)`` to the
    ``(seg, owner, occupied, overflowed)`` tuple of
    ``slot_ids_from_words``.  Nested scopes stack; inner providers win."""
    norm = {(tuple(k), int(b)): tuple(v) for (k, b), v in mapping.items()}
    stack = getattr(_PROVIDED, "stack", None)
    if stack is None:
        stack = _PROVIDED.stack = []
    stack.append(norm)
    try:
        yield
    finally:
        stack.pop()


def slot_segment_ids(table, keys: Iterable[str], bucket: int):
    """``slot_ids_from_words`` over a Table's group-key columns and row
    mask — the sort-free counterpart of ``engine.segment_ids_for``.  The
    probe table is sized from the distinct-count sketch unless
    ``REPRO_KEYSLOT_ADAPTIVE=off``; an enclosing ``provide_slots`` scope
    short-circuits the probe loop."""
    keys = tuple(keys)
    pre = provided_slots(keys, bucket)
    if pre is not None:
        return pre
    words = key_words_for(table.columns[k] for k in keys)
    expand = EXPAND
    if adaptive_enabled():
        expand = adaptive_expand(distinct_count_sketch(table, keys), bucket)
    return slot_ids_from_words(words, table.mask(), bucket, expand)


def distinct_count_sketch(table, keys: Iterable[str], m: int = 4096) -> int:
    """Linear-counting estimate of the table's distinct group-key tuples:
    the canonical words hash into an ``m``-bucket occupancy bitmap and
    ``d̂ = -m·ln(1 - b/m)`` for ``b`` occupied buckets, clamped to
    ``[1, #valid rows]``; a saturated bitmap gives the valid-row count."""
    words = key_words_for(table.columns[k] for k in keys)
    valid = table.mask()
    nvalid = int(valid.sum())
    if nvalid == 0:
        return 1
    h = _hash_words(words) & (m - 1)
    occ = torch.zeros(m + 1, dtype=torch.int32, device=words.device)
    occ[torch.where(valid, h, m)] = 1
    b = int(occ[:m].sum())
    if b >= m:
        return nvalid
    return max(1, min(nvalid, int(math.ceil(-m * math.log(1.0 - b / m)))))


def overflow_extended(owner: torch.Tensor, occupied: torch.Tensor,
                      capacity: int):
    """Extend the (bucket,)-sized ``owner``/``occupied`` tables with the
    overflow slot: the representative-row and output-validity arrays of
    ``num_segments`` size.  The overflow slot is never a real group and
    its representative parks at ``capacity``."""
    rep = torch.cat([owner, torch.full((1,), capacity, dtype=torch.int32,
                                       device=owner.device)])
    out_valid = torch.cat([occupied, torch.zeros(1, dtype=torch.bool,
                                                 device=occupied.device)])
    return rep, out_valid


def sortfree_result(table, keys: Iterable[str], rep: torch.Tensor,
                    out_valid: torch.Tensor, unplaced, bucket: int,
                    agg_cols: dict):
    """Assemble the sort-free grouped result Table: validate the overflow
    count (raises), gather one representative row of key values per slot,
    and stamp the claim-order validity mask."""
    from .table import Table
    check_slot_overflow(unplaced, bucket)
    safe_rep = rep.clamp(0, table.capacity - 1).to(torch.int64)
    cols = {k: table.columns[k][safe_rep] for k in keys}
    cols.update(agg_cols)
    return Table(cols, out_valid)


def check_slot_overflow(unplaced, bucket: int) -> None:
    """Validate that every valid row found a real slot: valid rows land in
    the overflow slot exactly when the input carries more distinct keys
    than the declared bucket, and then this raises."""
    if int(unplaced) > 0:
        raise GroupBoundOverflow(
            f"sort-free grouped aggregation: {int(unplaced)} rows carry "
            f"group keys beyond the declared dense bound ({bucket} slots; "
            f"max_groups bucketed to the next power-of-two lane multiple) "
            f"— raise max_groups or drop the declaration")
