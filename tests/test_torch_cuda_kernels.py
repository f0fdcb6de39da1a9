"""The CUDA kernels on the card: each against its plain version, bit for
bit, and the grouped TPC-H path on the card against the same path on the
CPU.  Every test here needs a CUDA card and skips without one; this file
imports neither ``jax`` nor ``repro``, so on a GPU machine it runs alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import segment_agg as sa
from repro_torch.relational import Table, execute
from repro_torch.relational.tpch import gen_tpch
from repro_torch.workloads.tpch_queries import (QUERIES, grouped_call,
                                                grouped_env)

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card (the kernels have "
                                       "no CPU mode)")

VALUE = ("sum", "count", "min", "max")
INDEX = (("argmin_first", "argmax_last", "sum"),
         ("argmin_last", "argmax_first", "count"))


def _inputs(seed, n, s, sorted_segs):
    r = np.random.default_rng(seed)
    segs = r.integers(0, s, n).astype(np.int32)
    segs[segs % 5 == 2] += 1                     # empty segments
    segs = np.minimum(segs, s - 1)
    if sorted_segs:
        segs = np.sort(segs)
    vals = r.integers(-20, 20, (n, 2)).astype(np.float32)
    pick = r.random((n, 2))
    vals[pick < 0.01] = np.nan
    vals[(pick >= 0.01) & (pick < 0.02)] = -0.0
    vals[(pick >= 0.02) & (pick < 0.03)] = np.inf
    vals[(pick >= 0.03) & (pick < 0.04)] = -np.inf
    valid = r.random((n, 2)) < 0.9
    return [torch.as_tensor(x).cuda() for x in (vals, segs, valid)]


@pytest.mark.parametrize("moments", [VALUE, INDEX])
@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
@pytest.mark.parametrize("n,s", [(200_000, 5000), (100_000, 17),
                                 (3000, 100_000)])
def test_kernel_matches_plain_version(layout, moments, n, s):
    args = _inputs(n + s, n, s, layout == "sorted")
    got = sa.fused_segment_agg(*args, s, moments=moments, layout=layout)
    want = sa.fused_segment_agg(*args, s, moments=moments, layout=layout,
                                backend="jnp")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_launch_counts_and_checks():
    vals, segs, valid = _inputs(1, 1000, 50, sorted_segs=True)
    norm = sa.normalize_moments(VALUE, 2)
    before = sa.segagg_sorted.launches, sa.segagg_unsorted.launches
    sa.fused_segment_agg(vals, segs, valid, 50)
    sa.fused_segment_agg(vals, segs, valid, 50, layout="unsorted")
    assert (sa.segagg_sorted.launches, sa.segagg_unsorted.launches) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="sorted ascending"):
        sa.fused_segment_agg(vals, segs.flip(0), valid, 50)
    with pytest.raises(ValueError, match="float32"):
        sa.segagg_unsorted(vals.double(), segs, valid, 50, norm)
    with pytest.raises(ValueError, match="contiguous"):
        sa.segagg_sorted(vals.t().contiguous().t(), segs, valid, 50, norm)


def test_entry_points_default_to_the_card():
    t = Table.from_columns(k=np.arange(4, dtype=np.int32))
    assert t.device.type == "cuda"


@pytest.mark.parametrize("qname", ["Q2", "Q13", "Q18", "Q21"])
def test_grouped_queries_on_the_card_match_the_cpu(qname):
    factory, _corr, key, domain = QUERIES[qname]
    out = {}
    for dev in ("cuda", "cpu"):
        cat = gen_tpch(0.002, seed=3, device=dev)
        for mg in (None, cat[domain].capacity):
            kernel = sa.segagg_sorted if mg is None else sa.segagg_unsorted
            before = kernel.launches
            res = execute(grouped_call(factory(), key, max_groups=mg), cat,
                          grouped_env(qname, cat, dev), device=dev)
            assert kernel.launches == before + (dev == "cuda")
            cols = res.to_numpy()
            order = np.argsort(cols[key], kind="stable")
            out[dev, mg is None] = {k: v[order] for k, v in cols.items()}
    for route in (True, False):
        for k, v in out["cpu", route].items():
            np.testing.assert_array_equal(out["cuda", route][k], v)
