"""The slice end to end against the reference: Q2, Q13, Q18 and Q21 of the
paper's TPC-H cursor-loop workload in Aggify+ form (one grouped call per
query) at ``scale=0.0005``, on the sorted route (no bound) and on the
sort-free route (``max_groups`` = the key's domain), through
``repro.relational.execute`` (JAX on the CPU) and
``repro_torch.relational.execute`` (torch on the CPU).  Group keys, counts
and sums are integer-valued, so the comparison is exact; the rows are
compared in key order (the sort-free route numbers groups in probe-table
order)."""
import numpy as np
import pytest

from benchmarks.queries import DEFAULT_PARAMS as JPARAMS
from benchmarks.queries import QUERIES as JQUERIES
from repro.core import aggify as jaggify
from repro.core.executors import build_env as jbuild_env
from repro.relational import execute as jexecute
from repro.relational.plan import AggCall as JAggCall
from repro.relational.tpch import gen_tpch as jgen_tpch
from repro_torch.kernels import segment_agg as tsa
from repro_torch.relational import execute
from repro_torch.relational.tpch import gen_tpch
from repro_torch.workloads.tpch_queries import (QUERIES, grouped_call,
                                                grouped_env)

SCALE = 0.0005


@pytest.fixture(scope="module")
def catalogs():
    return jgen_tpch(SCALE, seed=0), gen_tpch(SCALE, seed=0, device="cpu")


def _reference(qname, jcat, max_groups):
    factory, corr, key = JQUERIES[qname]
    prog = factory()
    rp = jaggify(prog)
    child = rp.agg_call.child
    call = JAggCall(child.child, rp.agg_call.aggregate,
                    rp.agg_call.param_binding, group_keys=(key,),
                    max_groups=max_groups)
    env = jbuild_env(prog, jcat, dict(JPARAMS[qname], **{corr: 0}))
    return jexecute(call, jcat, env).to_numpy()


def _by_key(cols, key):
    order = np.argsort(cols[key], kind="stable")
    return {k: v[order] for k, v in cols.items()}


@pytest.mark.parametrize("route", ["sorted", "sortfree", "bounded_sorted"])
@pytest.mark.parametrize("qname", ["Q2", "Q13", "Q18", "Q21"])
def test_grouped_query_matches_reference(catalogs, qname, route,
                                         monkeypatch):
    """``bounded_sorted``: a declared bound with the sort-free route
    switched off — the sorted route over the dense segment range."""
    jcat, cat = catalogs
    factory, _corr, key, domain = QUERIES[qname]
    max_groups = None if route == "sorted" else cat[domain].capacity
    if route == "bounded_sorted":
        monkeypatch.setenv("REPRO_GROUPAGG_SORTFREE", "off")
    want = _by_key(_reference(qname, jcat, max_groups), key)
    call = grouped_call(factory(), key, max_groups=max_groups)
    got = _by_key(execute(call, cat, grouped_env(qname, cat, "cpu"),
                          device="cpu").to_numpy(), key)
    assert set(got) == set(want)
    assert len(got[key]) == len(want[key]) > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fused_mode_is_the_default_and_counts_no_kernel_on_the_cpu(catalogs):
    _jcat, cat = catalogs
    before = (tsa.segagg_sorted.launches, tsa.segagg_unsorted.launches)
    factory, _corr, key, domain = QUERIES["Q18"]
    for mg in (None, cat[domain].capacity):
        execute(grouped_call(factory(), key, max_groups=mg), cat,
                grouped_env("Q18", cat, "cpu"), device="cpu")
    # CPU tensors take the plain version: no kernel launch is counted
    assert (tsa.segagg_sorted.launches,
            tsa.segagg_unsorted.launches) == before


@pytest.mark.parametrize("sortfree", ["on", "off"])
def test_overflow_raises_where_the_reference_raises(catalogs, monkeypatch,
                                                    sortfree):
    from repro.relational.group_bound import GroupBoundOverflow as JOverflow
    from repro_torch.relational.group_bound import GroupBoundOverflow
    monkeypatch.setenv("REPRO_GROUPAGG_SORTFREE", sortfree)
    jcat, cat = catalogs
    factory, _corr, key, _domain = QUERIES["Q18"]
    with pytest.raises(JOverflow):
        _reference("Q18", jcat, 100)
    with pytest.raises(GroupBoundOverflow):
        execute(grouped_call(factory(), key, max_groups=100), cat,
                grouped_env("Q18", cat, "cpu"), device="cpu")


def test_plain_backend_env_is_honoured(catalogs, monkeypatch):
    _jcat, cat = catalogs
    factory, _corr, key, domain = QUERIES["Q2"]
    call = grouped_call(factory(), key, max_groups=cat[domain].capacity)
    env = grouped_env("Q2", cat, "cpu")
    a = execute(call, cat, env, device="cpu").to_numpy()
    monkeypatch.setenv("REPRO_SEGAGG_BACKEND", "jnp")
    b = execute(call, cat, env, device="cpu").to_numpy()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    monkeypatch.setenv("REPRO_SEGAGG_BACKEND", "pallas")   # insists: kernel
    with pytest.raises(ValueError, match="CUDA"):
        execute(call, cat, env, device="cpu")
