"""The TPC-H cursor loops of the paper's §10.1 workload that reach the
grouped kernels, and their Aggify+ form (twin of ``benchmarks/queries.py``
Q2, Q13, Q18 and Q21 and of ``benchmarks/tpch_loops.py:_grouped_call``).

Each loop is a per-key UDF (Q2's per-part ``minCostSupp`` of the paper's
Figure 1, and per-customer, per-order and per-supplier loops).  Aggify+
strips the correlation filter from the cursor query and groups by the
correlation column: ONE grouped pass replaces every invocation.
"""
from __future__ import annotations

import torch

from ..core import (Assign, BinOp, Col, Const, CursorLoop, If, Program, UnOp,
                    Var, aggify, build_env, let)
from ..relational import Filter, Join, Scan
from ..relational.plan import AggCall
from ..relational.tpch import SCHEMAS


def scan(t):
    return Scan(t, SCHEMAS[t])


def q2_min_cost_supp() -> Program:
    """Per-part minimum-cost supplier with lower bound (paper Figure 1)."""
    q = Filter(
        Join(scan("PARTSUPP"), scan("SUPPLIER"),
             left_key="ps_suppkey", right_key="s_suppkey"),
        Col("ps_partkey").eq(Var("pkey")))
    body = [If(BinOp("and", Var("pCost") < Var("minCost"),
                     Var("pCost") > Var("lb")),
               [Assign("minCost", Var("pCost")),
                Assign("suppName", Var("sName"))])]
    return Program(
        "minCostSupp", params=("pkey", "lb"),
        pre=[let("minCost", Const(100000.0)), let("suppName", Const(-1))],
        loop=CursorLoop(q, fetch=[("pCost", "ps_supplycost"),
                                  ("sName", "s_name")], body=body),
        post=[], returns=("suppName",),
        var_dtypes={"suppName": torch.int32})


def q13_order_count() -> Program:
    """Per-customer count of orders without 'special request' comments."""
    q = Filter(scan("ORDERS"), Col("o_custkey").eq(Var("ck")))
    body = [If(UnOp("not", Var("special")),
               [Assign("cnt", Var("cnt") + 1.0)])]
    return Program(
        "orderCount", params=("ck",),
        pre=[let("cnt", Const(0.0))],
        loop=CursorLoop(q, fetch=[("special", "o_comment_special")],
                        body=body),
        post=[], returns=("cnt",))


def q18_order_quantity() -> Program:
    """Per-order total quantity (large-volume-order detection)."""
    q = Filter(scan("LINEITEM"), Col("l_orderkey").eq(Var("ok")))
    return Program(
        "orderQty", params=("ok",),
        pre=[let("qty", Const(0.0))],
        loop=CursorLoop(q, fetch=[("lq", "l_quantity")],
                        body=[Assign("qty", Var("qty") + Var("lq"))]),
        post=[], returns=("qty",))


def q21_waiting_suppliers() -> Program:
    """Per-supplier count of line items whose receipt exceeded commit."""
    q = Filter(scan("LINEITEM"), Col("l_suppkey").eq(Var("sk")))
    body = [If(Var("rd") > Var("cd"), [Assign("late", Var("late") + 1.0)])]
    return Program(
        "lateCount", params=("sk",),
        pre=[let("late", Const(0.0))],
        loop=CursorLoop(q, fetch=[("rd", "l_receiptdate"),
                                  ("cd", "l_commitdate")], body=body),
        post=[], returns=("late",))


# (program factory, correlation param name, group key, table that holds
# the key's domain) for Aggify+
QUERIES = {
    "Q2": (q2_min_cost_supp, "pkey", "ps_partkey", "PART"),
    "Q13": (q13_order_count, "ck", "o_custkey", "CUSTOMER"),
    "Q18": (q18_order_quantity, "ok", "l_orderkey", "ORDERS"),
    "Q21": (q21_waiting_suppliers, "sk", "l_suppkey", "SUPPLIER"),
}

DEFAULT_PARAMS = {"Q2": {"lb": 4.0}, "Q13": {}, "Q18": {}, "Q21": {}}


def grouped_call(prog: Program, group_key: str, mode: str = "auto",
                 max_groups=None) -> AggCall:
    """The decorrelated (Aggify+) plan: strip the correlation filter from
    the cursor query and group by the correlation column.  With
    ``max_groups`` the call declares a dense group bound and takes the
    sort-free route; without it, the sorted route."""
    rp = aggify(prog)
    child = rp.agg_call.child
    if not isinstance(child, Filter):
        raise ValueError(f"{prog.name}: the cursor query has no correlation "
                         "filter to decorrelate")
    return AggCall(child.child, rp.agg_call.aggregate,
                   rp.agg_call.param_binding, rp.agg_call.ordered,
                   rp.agg_call.sort_keys, rp.agg_call.sort_desc,
                   group_keys=(group_key,), mode=mode, max_groups=max_groups)


def grouped_env(qname: str, catalog, device=None) -> dict:
    """The environment a grouped call of ``qname`` runs in: the default
    parameters plus the pre-loop state (the correlation parameter is
    bound to 0; the grouped call never reads it)."""
    factory, corr, _key, _domain = QUERIES[qname]
    params = dict(DEFAULT_PARAMS[qname], **{corr: 0})
    return build_env(factory(), catalog, params, device)
