"""One door for every ``REPRO_*`` environment switch (a copy of
``repro/configs/flags.py``: the port reads the same names).

This module is the single accessor: every flag is declared
in ``KNOWN`` (so a typo'd name raises instead of silently defaulting),
and the three read shapes the codebase actually uses are provided as

* ``enabled(name)``   — kill-switch convention: on unless the env var is
  exactly ``"off"`` (every ``REPRO_*=off`` switch in the docs);
* ``value(name)``     — the raw string (or ``default``) for free-form
  flags like ``REPRO_FAULTS`` / ``REPRO_HLO_DIR``;
* ``choice(name, options)`` — mode selectors (``REPRO_SEGAGG_BACKEND``
  et al.): the value when it is one of ``options``, else ``None``.

Reads are deliberately **uncached**: tests monkeypatch ``os.environ``
around single calls, and several flags (faults, backends) are flipped
mid-process.  A read costs one dict lookup — caching would only buy
staleness.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

#: every REPRO_* flag the codebase reads, with a one-line contract.
#: Reading an undeclared name raises — the registry is the inventory
#: docs/serving.md and docs/execution-modes.md enumerate switches from.
KNOWN = {
    "REPRO_AGG_SERVE": "serving layer kill switch (off = uncached paths)",
    "REPRO_SERVE_GUARD": "serving fault-tolerance ladder kill switch",
    "REPRO_INCR_AGG": "incremental ingest kill switch (off = ingest "
                      "appends but every snapshot recomputes)",
    "REPRO_SERVE_CKPT": "durable checkpoint/restore kill switch (off = "
                        "checkpoint() is a no-op, restore() recomputes)",
    "REPRO_PLAN_FUSE": "whole-plan fusion pass kill switch",
    "REPRO_JOIN_HASH": "keyslot hash-join lowering kill switch",
    "REPRO_GROUPAGG_SORTFREE": "sort-free grouped route kill switch",
    "REPRO_KEYSLOT_ADAPTIVE": "sketch-driven probe-table sizing switch",
    "REPRO_GROUPAGG_FUSED": "fused grouped backend: pallas|interpret|"
                            "jnp|off",
    "REPRO_SEGAGG_BACKEND": "segment-agg backend: pallas|interpret|jnp",
    "REPRO_SEGAGG_PALLAS": "legacy truthy switch for the pallas backend",
    "REPRO_SEGAGG_SHARDED": "sharded segment-agg launch kill switch",
    "REPRO_USE_PALLAS": "global pallas-kernels kill switch",
    "REPRO_FAULTS": "comma list of armed fault-injection sites",
    "REPRO_HLO_DIR": "directory for dry-run HLO dumps",
}


def _check(name: str) -> None:
    if name not in KNOWN:
        raise KeyError(
            f"unknown repro flag {name!r} — declare it in "
            f"repro_torch.configs.flags.KNOWN (known: {sorted(KNOWN)})")


def value(name: str, default: Optional[str] = None) -> Optional[str]:
    """The flag's raw environment value, or ``default`` when unset."""
    _check(name)
    return os.environ.get(name, default)


def enabled(name: str) -> bool:
    """Kill-switch read: True unless the env var is exactly ``"off"``."""
    _check(name)
    return os.environ.get(name) != "off"


def choice(name: str, options: Sequence[str]) -> Optional[str]:
    """Mode-selector read: the value when it names one of ``options``,
    else ``None`` (unset or unrecognized fall through to the default)."""
    _check(name)
    got = os.environ.get(name)
    return got if got in options else None


__all__ = ["KNOWN", "enabled", "value", "choice"]
