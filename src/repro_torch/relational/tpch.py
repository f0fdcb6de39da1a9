"""Synthetic TPC-H-shaped data generation (deterministic, seeded) — a copy
of ``repro/relational/tpch.py``: the same numpy generator, so one seed
gives one catalog in both packages, placed on ``device``.

Cardality ratios follow the TPC-H spec at a configurable micro scale factor
(sf=1 ⇒ PART=200k, SUPP=10k, PARTSUPP=800k, CUSTOMER=150k, ORDERS=1.5M,
LINEITEM≈6M; we default to sf=0.001-ish for CPU benchmarks).  Column
domains mirror the spec where the workloads need them (supplycost,
quantity, prices, dates as integer days, etc.).
"""
from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .table import Table


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def gen_tpch(scale: float = 0.001, seed: int = 0,
             device=None) -> dict[str, Table]:
    """The six tables at ``scale`` on ``device`` (the card unless the
    caller names another)."""
    dev = resolve_device(device)
    r = _rng(seed)
    n_part = max(8, int(200_000 * scale))
    n_supp = max(4, int(10_000 * scale))
    n_psupp = n_part * 4                       # 4 suppliers per part
    n_cust = max(8, int(150_000 * scale))
    n_ord = max(16, int(1_500_000 * scale))
    n_li = n_ord * 4

    part = Table.from_columns(
        device=dev,
        p_partkey=np.arange(n_part, dtype=np.int32),
        p_retailprice=(900 + (np.arange(n_part) % 1000)).astype(np.float32),
        p_type_promo=(r.random(n_part) < 0.2),
    )

    supplier = Table.from_columns(
        device=dev,
        s_suppkey=np.arange(n_supp, dtype=np.int32),
        s_name=np.arange(n_supp, dtype=np.int32),  # dictionary-encoded name
        s_nationkey=r.integers(0, 25, n_supp).astype(np.int32),
        s_acctbal=r.uniform(-999, 9999, n_supp).astype(np.float32),
    )

    partsupp = Table.from_columns(
        device=dev,
        ps_partkey=np.repeat(np.arange(n_part, dtype=np.int32), 4),
        ps_suppkey=r.integers(0, n_supp, n_psupp).astype(np.int32),
        ps_supplycost=r.uniform(1.0, 1000.0, n_psupp).astype(np.float32),
        ps_availqty=r.integers(1, 10_000, n_psupp).astype(np.int32),
    )

    customer = Table.from_columns(
        device=dev,
        c_custkey=np.arange(n_cust, dtype=np.int32),
        c_mktsegment=r.integers(0, 5, n_cust).astype(np.int32),
    )

    orders = Table.from_columns(
        device=dev,
        o_orderkey=np.arange(n_ord, dtype=np.int32),
        o_custkey=r.integers(0, n_cust, n_ord).astype(np.int32),
        o_orderdate=r.integers(0, 2556, n_ord).astype(np.int32),  # days
        o_totalprice=r.uniform(800, 500_000, n_ord).astype(np.float32),
        o_comment_special=(r.random(n_ord) < 0.01),  # "special requests"
    )

    lineitem = Table.from_columns(
        device=dev,
        l_orderkey=np.repeat(np.arange(n_ord, dtype=np.int32), 4),
        l_partkey=r.integers(0, n_part, n_li).astype(np.int32),
        l_suppkey=r.integers(0, n_supp, n_li).astype(np.int32),
        l_quantity=r.integers(1, 51, n_li).astype(np.float32),
        l_extendedprice=r.uniform(900, 100_000, n_li).astype(np.float32),
        l_discount=(r.integers(0, 11, n_li) / 100).astype(np.float32),
        l_shipdate=r.integers(0, 2556, n_li).astype(np.int32),
        l_receiptdate=r.integers(0, 2556, n_li).astype(np.int32),
        l_commitdate=r.integers(0, 2556, n_li).astype(np.int32),
        l_returnflag=r.integers(0, 3, n_li).astype(np.int32),
    )

    return {
        "PART": part, "SUPPLIER": supplier, "PARTSUPP": partsupp,
        "CUSTOMER": customer, "ORDERS": orders, "LINEITEM": lineitem,
    }


SCHEMAS = {
    "PART": ("p_partkey", "p_retailprice", "p_type_promo"),
    "SUPPLIER": ("s_suppkey", "s_name", "s_nationkey", "s_acctbal"),
    "PARTSUPP": ("ps_partkey", "ps_suppkey", "ps_supplycost", "ps_availqty"),
    "CUSTOMER": ("c_custkey", "c_mktsegment"),
    "ORDERS": ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice",
               "o_comment_special"),
    "LINEITEM": ("l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                 "l_extendedprice", "l_discount", "l_shipdate",
                 "l_receiptdate", "l_commitdate", "l_returnflag"),
}


def scan(table: str):
    from .plan import Scan
    return Scan(table, SCHEMAS[table])
