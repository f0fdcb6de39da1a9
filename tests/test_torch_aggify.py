"""Parity of the port's Aggify compiler and executors with the reference's:
the analysis sets of the paper's Figures 1 and 2 are equal in both
packages, and on the port ``run_cursor`` equals ``run_aggify`` in the
stream, recognized and fused modes, and equals the reference's results."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.relational as tr
from helpers import fig1_catalog, fig1_program, fig2_catalog, fig2_program
from repro.core import aggify as jaggify
from repro.core import analyze_loop as janalyze
from repro.core import run_cursor as jrun_cursor
from repro.core.executors import execute_agg_call as jexecute_agg_call
from repro.relational.plan import AggCall as JAggCall
from repro.relational.plan import Filter as JFilter
from repro_torch.core.executors import execute_agg_call
from repro_torch.relational.plan import OrderBy


def port_fig1_program():
    q = tr.Filter(
        tr.Join(tr.Scan("PARTSUPP", ("ps_partkey", "ps_suppkey",
                                     "ps_supplycost")),
                tr.Scan("SUPPLIER", ("s_suppkey", "s_name")),
                left_key="ps_suppkey", right_key="s_suppkey", how="inner"),
        tc.Col("ps_partkey").eq(tc.Var("pkey")))
    body = [tc.If(tc.BinOp("and", tc.Var("pCost") < tc.Var("minCost"),
                           tc.Var("pCost") > tc.Var("lb")),
                  [tc.Assign("minCost", tc.Var("pCost")),
                   tc.Assign("suppName", tc.Var("sName"))])]
    loop = tc.CursorLoop(q, fetch=[("pCost", "ps_supplycost"),
                                   ("sName", "s_name")], body=body)
    return tc.Program(
        "minCostSupp", params=("pkey", "lb"),
        pre=[tc.let("minCost", tc.Const(100000.0)),
             tc.let("suppName", tc.Const(-1))],
        loop=loop, post=[], returns=("suppName",),
        var_dtypes={"suppName": torch.int32, "minCost": torch.float32})


def port_fig2_program():
    q = OrderBy(tr.Filter(tr.Scan("MONTHLY", ("investor_id", "month", "roi")),
                          tc.Col("investor_id").eq(tc.Var("id"))), ("month",))
    return tc.Program(
        "computeCumulativeReturn", params=("id",),
        pre=[tc.let("cumulativeROI", tc.Const(1.0))],
        loop=tc.CursorLoop(q, fetch=[("monthlyROI", "roi")],
                           body=[tc.Assign("cumulativeROI",
                                           tc.Var("cumulativeROI")
                                           * (tc.Var("monthlyROI") + 1.0))]),
        post=[tc.Assign("cumulativeROI", tc.Var("cumulativeROI") - 1.0)],
        returns=("cumulativeROI",))


def _port_catalog(jcat):
    return {name: tr.Table.from_columns(
        device="cpu", **{k: np.array(v) for k, v in t.columns.items()})
        for name, t in jcat.items()}


@pytest.mark.parametrize("jprog,tprog", [(fig1_program, port_fig1_program),
                                         (fig2_program, port_fig2_program)])
def test_analysis_sets_equal(jprog, tprog):
    ja, _, _ = janalyze(jprog())
    ta, _, _ = tc.analyze_loop(tprog())
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    jagg = tc.build_aggregate(tprog())
    assert jagg.fields == tuple(sorted(ja.v_fields))
    assert jagg.terminate_vars == ja.v_term


@pytest.mark.parametrize("mode", ["stream", "recognized", "fused"])
@pytest.mark.parametrize("pkey,lb", [(0, 0.0), (0, 4.0), (1, 2.5), (1, 9.0),
                                     (5, 0.0)])
def test_fig1_cursor_equals_aggify(mode, pkey, lb):
    cat = _port_catalog(fig1_catalog())
    params = {"pkey": pkey, "lb": lb}
    want = jrun_cursor(fig1_program(), fig1_catalog(), params)
    cur = tc.run_cursor(port_fig1_program(), cat, params, device="cpu")
    got = tc.run_aggify(port_fig1_program(), cat, params, mode=mode,
                        device="cpu")
    assert int(cur["suppName"]) == int(got["suppName"]) == \
        int(want["suppName"])


@pytest.mark.parametrize("mode", ["stream", "recognized", "fused"])
@pytest.mark.parametrize("ident", [1, 2, 3])
def test_fig2_cursor_equals_aggify(mode, ident):
    cat = _port_catalog(fig2_catalog())
    want = jrun_cursor(fig2_program(), fig2_catalog(), {"id": ident})
    cur = tc.run_cursor(port_fig2_program(), cat, {"id": ident},
                        device="cpu")
    got = tc.run_aggify(port_fig2_program(), cat, {"id": ident}, mode=mode,
                        device="cpu")
    # the closed-form product multiplies in another order than the loop:
    # f32 products of ≤4 factors near 1 agree to 1e-6
    np.testing.assert_allclose(float(got["cumulativeROI"]),
                               float(cur["cumulativeROI"]), rtol=1e-6)
    np.testing.assert_allclose(float(cur["cumulativeROI"]),
                               float(want["cumulativeROI"]), rtol=1e-6)


def test_deferred_init_matches_eager():
    cat = _port_catalog(fig1_catalog())
    for params in ({"pkey": 0, "lb": 4.0}, {"pkey": 7, "lb": 0.0}):
        a = tc.run_aggify(port_fig1_program(), cat, params, mode="stream",
                          device="cpu")
        b = tc.run_aggify(port_fig1_program(), cat, params,
                          deferred_init=True, device="cpu")
        assert int(a["suppName"]) == int(b["suppName"])


@pytest.mark.parametrize("mode", ["stream", "recognized", "fused"])
@pytest.mark.parametrize("max_groups", [None, 2])
def test_fig1_grouped_matches_reference(mode, max_groups):
    """Aggify+ of Figure 1: one grouped call per part, on each route."""
    jcat, cat = fig1_catalog(), _port_catalog(fig1_catalog())
    jrp = jaggify(fig1_program())
    trp = tc.aggify(port_fig1_program())
    jchild, tchild = jrp.agg_call.child, trp.agg_call.child
    assert isinstance(jchild, JFilter) and isinstance(tchild, tr.Filter)
    jcall = JAggCall(jchild.child, jrp.agg_call.aggregate,
                     jrp.agg_call.param_binding, group_keys=("ps_partkey",),
                     mode=mode, max_groups=max_groups)
    tcall = tr.AggCall(tchild.child, trp.agg_call.aggregate,
                       trp.agg_call.param_binding, group_keys=("ps_partkey",),
                       mode=mode, max_groups=max_groups)
    env = {"lb": 2.5, "minCost": 100000.0, "suppName": -1}
    want = jexecute_agg_call(jcall, jcat, env).to_numpy()
    got = execute_agg_call(tcall, cat, {k: torch.as_tensor(v)
                                        for k, v in env.items()},
                           device="cpu").to_numpy()
    jo, to = np.argsort(want["ps_partkey"]), np.argsort(got["ps_partkey"])
    for k in want:
        np.testing.assert_array_equal(got[k][to], want[k][jo], err_msg=k)


def test_entry_points_refuse_to_default_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = _port_catalog(fig1_catalog())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_cursor(port_fig1_program(), cat, {"pkey": 0, "lb": 0.0})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_aggify(port_fig1_program(), cat, {"pkey": 0, "lb": 0.0})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.execute(tr.Scan("SUPPLIER"), cat)
