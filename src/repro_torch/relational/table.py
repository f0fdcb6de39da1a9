"""Columnar Table: structure-of-arrays with a validity mask (twin of
``repro/relational/table.py``).

Relational results keep a fixed capacity plus a boolean ``valid`` mask, as
the reference does for XLA's static shapes; here it also keeps every
operator a handful of whole-column tensor ops on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device


@dataclass
class Table:
    columns: Dict[str, torch.Tensor]
    valid: Optional[torch.Tensor] = None  # bool (capacity,); None => all valid
    #: declared dense bound (its power-of-two bucket) on the distinct-group
    #: count of this table's rows — see relational/group_bound.py.
    #: Row-preserving ops keep it; ops that can mint new values drop it.
    group_bound: Optional[int] = None

    # -- construction ---------------------------------------------------------
    @staticmethod
    def from_columns(*, device=None, **cols) -> "Table":
        """A Table of ``cols`` (arrays or tensors) on ``device`` — the card
        unless the caller names another (see ``device.resolve_device``)."""
        dev = resolve_device(device)
        return Table({k: torch.as_tensor(v).to(dev) for k, v in cols.items()})

    # -- basic properties -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self.device)
        return self.valid

    def count(self) -> torch.Tensor:
        return self.mask().sum(dtype=torch.int32)

    # -- row ops ---------------------------------------------------------------
    def filter(self, mask: torch.Tensor) -> "Table":
        return Table(dict(self.columns), self.mask() & mask,
                     self.group_bound)

    def project(self, names: Iterable[str]) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.valid,
                     self.group_bound)

    def with_column(self, name: str, values: torch.Tensor) -> "Table":
        cols = dict(self.columns)
        cols[name] = values
        # a new column may have more distinct values than the declared
        # group bound covers, so the declaration does not survive
        return Table(cols, self.valid)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        cols = {mapping.get(k, k): v for k, v in self.columns.items()}
        return Table(cols, self.valid, self.group_bound)

    def take(self, idx: torch.Tensor,
             idx_valid: Optional[torch.Tensor] = None) -> "Table":
        """Gather rows ``idx`` (clipped into range, as the reference's
        ``mode='clip'``)."""
        idx = idx.clamp(0, self.capacity - 1)
        cols = {k: v[idx] for k, v in self.columns.items()}
        base = self.mask()[idx]
        v = base if idx_valid is None else base & idx_valid
        return Table(cols, v, self.group_bound)

    def compress(self) -> "Table":
        """Stable-compact valid rows to the front (fixed capacity)."""
        m = self.mask()
        order = torch.sort((~m).to(torch.uint8), stable=True).indices
        t = self.take(order)
        n = m.sum()
        return Table(t.columns,
                     torch.arange(self.capacity, device=self.device) < n,
                     self.group_bound)

    def sort_by(self, keys: Iterable[str],
                descending: Iterable[bool] = ()) -> "Table":
        """Stable multi-key sort; invalid rows sort last.

        Least-significant key first, one stable sort per key and a last
        one on the validity flag, each carrying the permutation — the
        order ``lax.sort`` gives the reference with the flag leading and
        the keys following.  Float keys order as there: -0.0 ties +0.0
        and NaN sorts after +inf."""
        keys = list(keys)
        desc = list(descending) or [False] * len(keys)
        m = self.mask()
        order = torch.arange(self.capacity, device=self.device)
        for k, d in reversed(list(zip(keys, desc))):
            key = _sort_key(self.columns[k], d, m)[order]
            order = order[torch.sort(key, stable=True).indices]
        inv = (~m).to(torch.uint8)[order]
        order = order[torch.sort(inv, stable=True).indices]
        return self.take(order)

    def head(self, n: int) -> "Table":
        c = self.compress()
        cols = {k: v[:n] for k, v in c.columns.items()}
        return Table(cols, c.mask()[:n], self.group_bound)

    def declare_group_bound(self, max_groups: int) -> "Table":
        """Declare a dense bound on how many distinct groups this table's
        rows can form.  The grouped executors size their segment tensors
        by the bound's power-of-two bucket instead of the row capacity and
        validate it (more groups raise).  See relational/group_bound.py."""
        from .group_bound import bucket_group_bound
        return Table(dict(self.columns), self.valid,
                     bucket_group_bound(max_groups))

    def materialize(self) -> "Table":
        """The cursor temp-table barrier: wait until every column has been
        computed on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return Table(dict(self.columns), self.valid, self.group_bound)

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for v in self.columns.values())

    def to_numpy(self) -> dict[str, np.ndarray]:
        m = self.mask().cpu().numpy()
        return {k: v.cpu().numpy()[m] for k, v in self.columns.items()}


def _sort_key(col: torch.Tensor, descending: bool,
              valid: torch.Tensor) -> torch.Tensor:
    if col.dtype == torch.bool:
        col = col.to(torch.int32)
    key = -col if descending else col
    if key.dtype.is_floating_point:
        big = torch.tensor(float("inf"), dtype=key.dtype, device=key.device)
    else:
        big = torch.tensor(torch.iinfo(key.dtype).max, dtype=key.dtype,
                           device=key.device)
    return torch.where(valid, key, big)
