"""Parity of the port's columnar Table with the reference's: the same numpy
columns through ``repro.relational.table`` (JAX on the CPU) and
``repro_torch.relational.table`` (torch on the CPU) give the same rows,
masks and order."""
import numpy as np
import pytest
import torch

from repro.relational.table import Table as JTable
from repro.relational.tpch import gen_tpch as jgen_tpch
from repro_torch.relational.table import Table as TTable
from repro_torch.relational.tpch import gen_tpch as tgen_tpch


def _cols(seed=0, n=64):
    r = np.random.default_rng(seed)
    return {
        "k1": r.integers(0, 4, n).astype(np.int32),
        "k2": r.integers(-3, 3, n).astype(np.int32),
        "f": r.choice(np.array([np.nan, -0.0, 0.0, 1.5, -2.0, np.inf],
                               np.float32), n),
        "b": r.random(n) < 0.5,
        "row": np.arange(n, dtype=np.int32),
    }


def _pair(cols, valid=None):
    j = JTable.from_columns(**cols)
    t = TTable.from_columns(device="cpu", **cols)
    if valid is not None:
        j = j.filter(valid)
        t = t.filter(torch.as_tensor(valid))
    return j, t


def _same(j, t):
    assert set(j.columns) == set(t.columns)
    np.testing.assert_array_equal(np.asarray(j.mask()), t.mask().numpy())
    for k in j.columns:
        np.testing.assert_array_equal(np.asarray(j.columns[k]),
                                      t.columns[k].numpy(), err_msg=k)
    assert j.group_bound == t.group_bound


def test_row_ops_match_reference():
    cols = _cols()
    valid = np.random.default_rng(1).random(64) < 0.7
    j, t = _pair(cols, valid)
    _same(j, t)
    assert int(j.count()) == int(t.count())
    _same(j.project(["k1", "f"]), t.project(["k1", "f"]))
    _same(j.rename({"k1": "key"}), t.rename({"k1": "key"}))
    extra = np.arange(64, dtype=np.float32)
    _same(j.with_column("x", extra), t.with_column("x", torch.as_tensor(extra)))
    idx = np.array([5, 0, 63, 70, -2, 7], np.int32)      # clipped like XLA
    _same(j.take(idx), t.take(torch.as_tensor(idx)))
    _same(j.compress(), t.compress())
    _same(j.head(10), t.head(10))
    _same(j.declare_group_bound(300), t.declare_group_bound(300))
    _same(j.declare_group_bound(5).project(["k1"]),
          t.declare_group_bound(5).project(["k1"]))


@pytest.mark.parametrize("keys,desc", [
    (["k1"], []),
    (["k1", "k2"], [False, True]),
    (["f"], []),                  # NaN after +inf, -0.0 ties +0.0
    (["f", "k1"], [True, False]),
    (["b", "k2"], []),
])
def test_sort_by_stable_invalid_last(keys, desc):
    cols = _cols(seed=2, n=200)
    valid = np.random.default_rng(3).random(200) < 0.8
    j, t = _pair(cols, valid)
    js, ts = j.sort_by(keys, desc), t.sort_by(keys, desc)
    _same(js, ts)
    m = ts.mask().numpy()
    assert not m[np.argmin(m):].any() or m.all()     # invalid rows last


def test_sort_by_keeps_ties_in_row_order():
    cols = {"k": np.array([2, 1, 2, 1, 2], np.int32),
            "row": np.arange(5, dtype=np.int32)}
    t = TTable.from_columns(device="cpu", **cols).sort_by(["k"])
    np.testing.assert_array_equal(t.columns["row"].numpy(), [1, 3, 0, 2, 4])


def test_entry_points_refuse_to_default_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTable.from_columns(k=np.arange(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen_tpch(0.0001, seed=0)


def test_gen_tpch_same_seed_same_catalog():
    jc = jgen_tpch(0.0005, seed=7)
    tc = tgen_tpch(0.0005, seed=7, device="cpu")
    assert set(jc) == set(tc)
    for name in jc:
        _same(jc[name], tc[name])
