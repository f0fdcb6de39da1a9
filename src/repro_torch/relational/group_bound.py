"""Dense segment-id bound for grouped aggregation (twin of
``repro/relational/group_bound.py``).

Without a bound, every segment tensor of the grouped executors is sized
by the input's *row capacity*.  A caller declares ``max_groups`` on an
``AggCall`` (or on the input table via ``Table.declare_group_bound``) to
size them by the group count instead.  The declared value is **bucketed**
— rounded up to the next power of two, floored at 128 — so nearby bounds
share one shape.  The segment range becomes ``bucket + 1``: real groups
occupy ``[0, bucket)`` and the extra slot is a dedicated **overflow
segment** where invalid rows park.

The bound is *validated, not assumed*: a group count above the bucket
raises ``GroupBoundOverflow``.  ``poison_overflow`` and its sentinels carry
the reference's output-poisoning contract for callers that hold a guard
tensor instead.
"""
from __future__ import annotations

from typing import Optional

import torch

#: floor of every bucket (the reference's TPU lane width, kept so both
#: packages bucket a declared bound alike)
LANE = 128


class GroupBoundOverflow(ValueError):
    """A concrete group count (or slot-overflow count) exceeded the
    declared dense bound.  Subclasses ValueError, as in the reference."""


def poison_sentinel(dtype):
    """The poison value ``poison_overflow`` writes for ``dtype`` — NaN
    for floats, the dtype minimum for signed ints, the maximum for
    unsigned ints (whose minimum is 0, indistinguishable from a real
    aggregate), False for bools; None for dtypes poisoning cannot mark."""
    d = dtype
    if d.is_floating_point:
        return torch.tensor(float("nan"), dtype=d)
    if d == torch.bool:
        return torch.tensor(False)
    if d in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        return torch.tensor(torch.iinfo(d).max, dtype=d)
    if not d.is_complex:
        return torch.tensor(torch.iinfo(d).min, dtype=d)
    return None


def bucket_group_bound(max_groups: int) -> int:
    """Round a declared group bound up to its recompilation bucket: the
    next power of two, floored at one 128-lane tile.  Every bucket is a
    multiple of ``LANE`` (so the kernel's segment tiles stay lane-aligned)
    and a power of two (so distinct compiled shapes grow logarithmically
    in the declared bound)."""
    mg = int(max_groups)
    if mg <= 0:
        raise ValueError(f"max_groups must be positive, got {max_groups}")
    if mg <= LANE:
        return LANE
    return 1 << (mg - 1).bit_length()


def resolve_group_bound(max_groups: Optional[int],
                        capacity: int) -> tuple[int, Optional[int]]:
    """Resolve a declared bound into ``(num_segments, validated_bound)``.

    ``num_segments`` is the static segment range every grouped tensor is
    sized by: ``bucket(max_groups) + 1`` (the +1 is the overflow slot for
    invalid rows) when a useful bound is declared, the row ``capacity``
    otherwise.  ``validated_bound`` is the bucket the group count must stay
    within (``None`` means nothing to validate — the capacity already
    bounds the count).  A declared bound whose bucket reaches the capacity
    is a no-op: the dense range would not be smaller than the legacy one.
    """
    if max_groups is None:
        return capacity, None
    bucket = bucket_group_bound(max_groups)
    if bucket + 1 >= capacity:
        return capacity, None
    return bucket + 1, bucket


def check_group_overflow(nseg, bound: Optional[int]):
    """Validate the measured group count against the dense bound: counts
    above it raise.  Torch is eager, so the count is always concrete and
    the reference's traced ``ok`` guard has no twin; returns ``None``
    (nothing left for ``poison_overflow`` to do)."""
    if bound is None:
        return None
    if int(nseg) > bound:
        raise GroupBoundOverflow(
            f"grouped aggregation: input has {int(nseg)} groups but the "
            f"declared dense bound admits at most {bound} (max_groups "
            f"bucketed to the next power-of-two lane multiple) — raise "
            f"max_groups or drop the declaration")
    return None


#: auxiliary stamp column ``poison_overflow`` adds when NO output column
#: carries a strong sentinel (every column bool or unmarkable): False is
#: an everyday bool value, so an all-bool result would otherwise be
#: undetectably poisoned.  The stamp is 0.0 on a clean result and NaN on
#: a poisoned one — a strong float column the serving detector
#: (``serve.guard.is_poisoned``) reads like any other; the serving layer
#: strips it before handing the result out.
STAMP_COL = "__poison_stamp__"


def _any_strong(cols: dict) -> bool:
    """True when some column can carry a strong (non-bool) sentinel."""
    for v in cols.values():
        if v.dtype != torch.bool and poison_sentinel(v.dtype) is not None:
            return True
    return False


def poison_overflow(cols: dict, ok) -> dict:
    """Poison every output column where the overflow guard ``ok`` failed:
    NaN for floating columns; for integers — which cannot hold NaN — the
    dtype minimum if signed, the dtype maximum if unsigned (whose minimum
    is 0, indistinguishable from a real aggregate); False for booleans.
    ``ok=None`` (no runtime guard) is the identity.

    When no column can carry a strong sentinel (every output bool), an
    auxiliary f32 ``STAMP_COL`` is added — 0.0 clean, NaN poisoned — so
    the detector's all-or-none scan still has one strong column to read
    (the bool-only blind spot fix; the serving layer strips the stamp
    after its scan)."""
    if ok is None:
        return cols
    out = {}
    for k, v in cols.items():
        bad = poison_sentinel(v.dtype)
        out[k] = v if bad is None else torch.where(ok, v, bad.to(v.device))
    if cols and not _any_strong(cols):
        ref = next(iter(cols.values()))
        out[STAMP_COL] = torch.where(
            ok, torch.zeros(ref.shape, device=ref.device),
            torch.full(ref.shape, float("nan"), device=ref.device))
    return out
