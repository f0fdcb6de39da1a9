"""Parity of the port's fused segment aggregation with the reference's.

The same numpy inputs go through ``repro.kernels.segment_agg`` (the Pallas
kernels under the interpreter, at most 2k rows, and the jnp path) and
through ``repro_torch.kernels.segment_agg`` on the CPU, where it runs its
plain version.  Data is integer-valued wherever sums are compared, so the
summation order cannot matter and the comparison is exact; the one case
with arbitrary floats states its tolerance.  NaN compares equal to NaN and
-0.0 equal to +0.0 (``assert_array_equal``), except where a test pins the
port's sign of zero.  The CUDA kernels themselves are held against the
plain version on the card by ``test_torch_cuda_kernels.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

jsa = importlib.import_module("repro.kernels.segment_agg")
tsa = importlib.import_module("repro_torch.kernels.segment_agg")

VALUE = ("sum", "count", "min", "max")
INDEX = (("argmin_first", "argmax_last", "sum"),
         ("argmin_last", "argmax_first", "count"))


def _data(seed, n, s, c=2, sorted_segs=True, specials=True, empty=(3,)):
    r = np.random.default_rng(seed)
    segs = r.integers(0, s, n).astype(np.int32)
    for e in empty:                          # segments no row touches
        segs[segs == e] = (e + 1) % s
    if sorted_segs:
        segs = np.sort(segs)
    vals = r.integers(-6, 6, (n, c)).astype(np.float32)
    if specials:
        pick = r.random((n, c))
        vals[pick < 0.04] = np.nan
        vals[(pick >= 0.04) & (pick < 0.08)] = -0.0
        vals[(pick >= 0.08) & (pick < 0.10)] = np.inf
        vals[(pick >= 0.10) & (pick < 0.12)] = -np.inf
    valid = r.random((n, c)) < 0.85
    return vals, segs, valid


def _port(vals, segs, valid, s, **kw):
    return tsa.fused_segment_agg(torch.as_tensor(vals), torch.as_tensor(segs),
                                 torch.as_tensor(valid), s, **kw).numpy()


def _ref(vals, segs, valid, s, **kw):
    return np.asarray(jsa.fused_segment_agg(vals, segs, valid, s, **kw))


@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
@pytest.mark.parametrize("backend", ["interpret", "jnp"])
def test_value_moments_match_reference(layout, backend):
    vals, segs, valid = _data(0, 600, 40, sorted_segs=layout == "sorted")
    got = _port(vals, segs, valid, 40, moments=VALUE, layout=layout)
    want = _ref(vals, segs, valid, 40, moments=VALUE, layout=layout,
                backend=backend)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[:, 2:4]).any()           # NaN members propagate
    np.testing.assert_array_equal(got[:, :, 3], [[0, 0, np.inf, -np.inf]] * 2)


@pytest.mark.parametrize("layout", ["sorted", "unsorted"])
def test_index_moments_match_pallas_interpreter(layout):
    # NaN, ±0 and ±inf keys, ties, empty segments and invalid rows; every
    # segment sits inside one 256-row block, where the Pallas kernel gives
    # a NaN segment the tie identity as the port does
    vals, segs, valid = _data(1, 200, 24, sorted_segs=layout == "sorted")
    got = _port(vals, segs, valid, 24, moments=INDEX, layout=layout)
    want = _ref(vals, segs, valid, 24, moments=INDEX, layout=layout,
                backend="interpret")
    np.testing.assert_array_equal(got, want)


def test_index_moments_unsorted_match_reference_jnp():
    vals, segs, valid = _data(2, 1500, 64, sorted_segs=False)
    got = _port(vals, segs, valid, 64, moments=INDEX, layout="unsorted")
    want = _ref(vals, segs, valid, 64, moments=INDEX, layout="unsorted",
                backend="jnp")
    np.testing.assert_array_equal(got, want)


def test_index_moments_sorted_match_reference_scan():
    # the reference's scan formulation is order-dependent on NaN keys, so
    # this comparison uses data without NaN
    vals, segs, valid = _data(3, 1500, 64, specials=False)
    vals[::7] = np.inf
    got = _port(vals, segs, valid, 64, moments=INDEX)
    want = _ref(vals, segs, valid, 64, moments=INDEX, backend="jnp")
    np.testing.assert_array_equal(got, want)


def test_both_index_formulations_agree():
    vals, segs, valid = _data(4, 3000, 100)
    a = _port(vals, segs, valid, 100, moments=INDEX, layout="sorted")
    b = _port(vals, segs, valid, 100, moments=INDEX, layout="unsorted")
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_all_inf_segment_records_its_row():
    vals = np.array([[np.inf], [np.inf], [-np.inf], [-np.inf]], np.float32)
    segs = np.array([0, 0, 1, 1], np.int32)
    valid = np.array([[False], [True], [True], [True]])
    m = (("argmin_first", "argmax_last"),)
    for layout in ("sorted", "unsorted"):
        got = _port(vals, segs, valid, 2, moments=m, layout=layout)
        want = _ref(vals, segs, valid, 2, moments=m, layout=layout,
                    backend="interpret")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0, 4], [1, 2])   # argmin rows
        np.testing.assert_array_equal(got[0, 5], [1, 3])   # argmax rows


def test_signed_zero_is_pinned():
    vals = np.array([[0.0], [-0.0], [-0.0], [0.0], [-0.0]], np.float32)
    segs = np.array([0, 0, 1, 1, 2], np.int32)
    valid = np.ones((5, 1), bool)
    m = (("sum", "min", "max", "argmin_first", "argmax_last"),)
    for layout in ("sorted", "unsorted"):
        got = _port(vals, segs, valid, 3, moments=m, layout=layout)
        want = _ref(vals, segs, valid, 3, moments=m, layout=layout,
                    backend="jnp")
        np.testing.assert_array_equal(got, want)
        # min orders -0.0 below +0.0, max +0.0 above; sums are +0.0
        assert np.signbit(got[0, 2]).tolist() == [True, True, True]
        assert np.signbit(got[0, 3]).tolist() == [False, False, True]
        assert not np.signbit(got[0, 0]).any()
        # the index key ties -0.0 with +0.0: the tie order decides
        np.testing.assert_array_equal(got[0, 4], [0, 2, 4])
        np.testing.assert_array_equal(got[0, 5], [1, 3, 4])


def test_identities_for_empty_segments():
    vals, segs, valid = _data(5, 50, 8, empty=())
    got = _port(vals, segs, valid, 12, moments=INDEX)
    ident = np.array(jsa._row_fills(jsa.normalize_moments(INDEX, 2)),
                     np.float32).reshape(2, 6)
    np.testing.assert_array_equal(got[:, :, 8:],
                                  np.broadcast_to(ident[:, :, None],
                                                  (2, 6, 4)))
    assert tsa._row_fills(tsa.normalize_moments(INDEX, 2)) == \
        jsa._row_fills(jsa.normalize_moments(INDEX, 2))


def test_arbitrary_float_sums_within_reassociation():
    # f32 sums of arbitrary values depend on the summation order: rtol
    # 1e-5 covers reassociating ~40 terms of one magnitude
    r = np.random.default_rng(6)
    vals = r.normal(size=(1000, 1)).astype(np.float32)
    segs = np.sort(r.integers(0, 25, 1000)).astype(np.int32)
    valid = np.ones((1000, 1), bool)
    got = _port(vals, segs, valid, 25, moments=("sum",))
    want = _ref(vals, segs, valid, 25, moments=("sum",), backend="jnp")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_contract_helpers_match_reference():
    for n in (0, 1, (1 << 24) - 256, (1 << 24) - 255, 1 << 24):
        assert tsa.index_moment_ok(n) == jsa.index_moment_ok(n)
    for spec in (VALUE, INDEX, (("argmax_first",), ("count",))):
        c = 2 if isinstance(spec[0], tuple) else 3
        assert tsa.normalize_moments(spec, c) == jsa.normalize_moments(spec, c)
        norm = tsa.normalize_moments(spec, c)
        assert tsa.moment_rows(norm) == jsa.moment_rows(norm)
        for ms in norm:
            for which in ("argmin", "argmax"):
                assert tsa._index_tie(ms, which) == jsa._index_tie(ms, which)
    assert (tsa.MOMENTS, tsa.INDEX_MOMENTS, tsa.ARGMIN_ROW, tsa.ARGMAX_ROW,
            tsa.INDEX_EXACT_ROWS) == (jsa.MOMENTS, jsa.INDEX_MOMENTS,
                                      jsa.ARGMIN_ROW, jsa.ARGMAX_ROW,
                                      jsa.INDEX_EXACT_ROWS)


def test_value_errors():
    v = torch.zeros(8, 1)
    s = torch.zeros(8, dtype=torch.int32)
    ok = torch.ones(8, 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="layout"):
        tsa.fused_segment_agg(v, s, ok, 2, layout="diagonal")
    with pytest.raises(ValueError, match="unknown moment"):
        tsa.fused_segment_agg(v, s, ok, 2, moments=("median",))
    with pytest.raises(ValueError, match="both argmin_first"):
        tsa.fused_segment_agg(v, s, ok, 2,
                              moments=("argmin_first", "argmin_last"))
    with pytest.raises(ValueError, match="backend"):
        tsa.fused_segment_agg(v, s, ok, 2, backend="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsa.fused_segment_agg(v, s, ok, 2, backend="cuda")
    big = torch.zeros(1, 1).expand(1 << 24, 1)
    with pytest.raises(ValueError, match="2\\^24"):
        tsa.fused_segment_agg(big, torch.zeros(1 << 24, dtype=torch.int32),
                              torch.ones(1, 1, dtype=torch.bool).expand(
                                  1 << 24, 1), 2, moments=("argmin_first",))
    for kernel in (tsa.segagg_sorted, tsa.segagg_unsorted):
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernel(v, s, ok, 2, tsa.normalize_moments(VALUE, 1))
    unsorted = torch.tensor([0, 2, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted ascending"):
        tsa._validate_sorted(unsorted, True, False, "cuda")
    tsa._validate_sorted(unsorted, True, True, "cuda")      # assumed
    tsa._validate_sorted(unsorted, False, False, "cuda")    # unpruned
    tsa._validate_sorted(unsorted, True, False, "jnp")      # plain


def test_oracles_match_reference_oracles():
    vals, segs, valid = _data(7, 400, 30, sorted_segs=False, specials=False)
    np.testing.assert_array_equal(
        tref.fused_segment_agg_ref(torch.as_tensor(vals),
                                   torch.as_tensor(segs),
                                   torch.as_tensor(valid), 30).numpy(),
        np.asarray(jref.fused_segment_agg_ref(vals, segs, valid, 30)))
    for minimize in (True, False):
        for tie_first in (True, False):
            np.testing.assert_array_equal(
                tref.segment_arg_index_ref(
                    torch.as_tensor(vals[:, 0]), torch.as_tensor(segs),
                    torch.as_tensor(valid[:, 0]), 30, minimize=minimize,
                    tie_first=tie_first).numpy(),
                np.asarray(jref.segment_arg_index_ref(
                    vals[:, 0], segs, valid[:, 0], 30, minimize=minimize,
                    tie_first=tie_first)))


def test_plain_matches_oracles():
    vals, segs, valid = _data(8, 500, 20, sorted_segs=False, specials=False)
    tv, ts, tk = (torch.as_tensor(x) for x in (vals, segs, valid))
    got = tsa.fused_segment_agg(tv, ts, tk, 20, moments=INDEX,
                                layout="unsorted")
    want4 = tref.fused_segment_agg_ref(tv, ts, tk, 20).numpy()
    np.testing.assert_array_equal(got[0, [0, 2, 3]].numpy(),
                                  want4[0, [0, 2, 3]])      # sum, min, max
    np.testing.assert_array_equal(got[1, 1:4].numpy(), want4[1, 1:4])
    pick = tref.segment_arg_index_ref(tv[:, 0], ts, tk[:, 0], 20,
                                      minimize=True, tie_first=True)
    want = torch.where(pick < 500, pick.float(), float("inf"))
    np.testing.assert_array_equal(got[0, 4].numpy(), want.numpy())


@pytest.mark.parametrize("moments", [None, INDEX])
def test_fold_moments_matches_reference(moments):
    from repro.core.aggregate import fold_moments as jfold
    from repro_torch.core.aggregate import fold_moments as tfold
    kw = {} if moments is None else {"moments": moments}
    v1, s1, ok1 = _data(10, 300, 16, specials=False)
    v2, s2, ok2 = _data(11, 300, 16, specials=False)
    a = _port(v1, s1, ok1, 16, **kw)
    b = _port(v2, s2, ok2, 16, **kw)
    if moments is not None:            # one global row numbering
        b[:, 4:] += 300
    got = tfold(torch.as_tensor(a), torch.as_tensor(b), moments).numpy()
    want = np.asarray(jfold(a, b, moments))
    np.testing.assert_array_equal(got, want)
    both = _port(np.concatenate([v1, v2]), np.concatenate([s1, s2]),
                 np.concatenate([ok1, ok2]), 16, layout="unsorted", **kw)
    np.testing.assert_array_equal(got, both)
