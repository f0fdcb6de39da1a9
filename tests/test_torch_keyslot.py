"""Parity of the port's sort-free slotting with the reference's keyslot:
canonical key words, the murmur hash, slot ids (``seg``, ``owner``,
``occupied``, ``overflowed``) and the join's build/probe agree bit for bit
on the same numpy keys, and overflow raises where the reference raises."""
import jax
import numpy as np
import pytest
import torch

from repro.relational import keyslot as jks
from repro.relational.group_bound import GroupBoundOverflow as JOverflow
from repro.relational.table import Table as JTable
from repro_torch.relational import group_bound as tgb
from repro_torch.relational import keyslot as tks
from repro_torch.relational.table import Table as TTable


def _keys(seed=0, n=300):
    r = np.random.default_rng(seed)
    f = r.choice(np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, -np.inf],
                          np.float32), n)
    f[::11] = np.float32(np.nan) * -1            # a second NaN bit pattern
    return {
        "i32": r.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
            np.int32),
        "small": r.integers(0, 40, n).astype(np.int32),
        "f32": f,
        "b": r.random(n) < 0.5,
        "u8": r.integers(0, 256, n).astype(np.uint8),
        "i16": r.integers(-300, 300, n).astype(np.int16),
    }


@pytest.mark.parametrize("name", ["i32", "f32", "b", "u8", "i16"])
def test_canonical_key_words_bit_for_bit(name):
    col = _keys()[name]
    want = [np.asarray(w) for w in jks.canonical_key_words(col)]
    got = [w.numpy() for w in tks.canonical_key_words(torch.as_tensor(col))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(np.int64))


def test_canonical_key_words_64_bit():
    r = np.random.default_rng(1)
    cols = {"i64": r.integers(-2**62, 2**62, 50, dtype=np.int64),
            "f64": np.array([0.0, -0.0, np.nan, 1e300, -3.5] * 10)}
    with jax.enable_x64(True):
        for col in cols.values():
            want = [np.asarray(w) for w in jks.canonical_key_words(col)]
            got = [w.numpy()
                   for w in tks.canonical_key_words(torch.as_tensor(col))]
            assert len(got) == 2
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.astype(np.int64))


def test_hash_words_bit_for_bit():
    k = _keys()
    cols = [k["i32"], k["f32"], k["small"]]
    jw = jks.key_words_for(cols)
    tw = tks.key_words_for(torch.as_tensor(c) for c in cols)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tks._hash_words(tw).numpy(),
                                  np.asarray(jks._hash_words(jw)).astype(
                                      np.int64))


@pytest.mark.parametrize("names,bucket,expand", [
    (("small",), 128, 16),
    (("small",), 128, 4),
    (("f32", "b"), 128, 8),
    (("small", "u8"), 256, 1),        # collisions: many probe rounds
])
def test_slot_ids_bit_for_bit(names, bucket, expand):
    k = _keys(2, 400)
    valid = np.random.default_rng(3).random(400) < 0.8
    jw = jks.key_words_for([k[n] for n in names])
    tw = tks.key_words_for(torch.as_tensor(k[n]) for n in names)
    want = jks.slot_ids_from_words(jw, valid, bucket, expand)
    got = tks.slot_ids_from_words(tw, torch.as_tensor(valid), bucket, expand)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_slot_overflow_counts_and_raises():
    k = _keys(4, 600)
    words = np.stack([k["u8"].astype(np.uint32), k["small"].view(np.uint32)],
                     axis=1)                  # far more keys than 128 slots
    valid = np.ones(600, bool)
    want = jks.slot_ids_from_words(words, valid, 128, 4)
    got = tks.slot_ids_from_words(torch.as_tensor(words.astype(np.int64)),
                                  torch.as_tensor(valid), 128, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) > 0
    with pytest.raises(JOverflow):
        jks.check_slot_overflow(want[3], 128)
    with pytest.raises(tgb.GroupBoundOverflow):
        tks.check_slot_overflow(got[3], 128)
    tks.check_slot_overflow(torch.tensor(0), 128)


def test_slot_segment_ids_and_sketch_match_reference():
    k = _keys(5, 500)
    valid = np.random.default_rng(6).random(500) < 0.9
    jt = JTable.from_columns(a=k["small"], b=k["f32"]).filter(valid)
    tt = TTable.from_columns(device="cpu", a=k["small"], b=k["f32"]).filter(
        torch.as_tensor(valid))
    assert tks.distinct_count_sketch(tt, ("a", "b")) == \
        jks.distinct_count_sketch(jt, ("a", "b"))
    for est, bucket in ((3, 128), (500, 128), (10_000, 256)):
        assert tks.adaptive_expand(est, bucket) == \
            jks.adaptive_expand(est, bucket)
    want = jks.slot_segment_ids(jt, ("a", "b"), 512)
    got = tks.slot_segment_ids(tt, ("a", "b"), 512)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rep, out_valid = tks.overflow_extended(got[1], got[2], 500)
    jrep, jvalid = jks.overflow_extended(want[1], want[2], 500)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(jrep))
    np.testing.assert_array_equal(out_valid.numpy(), np.asarray(jvalid))


def test_provided_slots_short_circuit():
    tt = TTable.from_columns(device="cpu", a=np.arange(10, dtype=np.int32))
    fake = (torch.zeros(10, dtype=torch.int32),) * 4
    with tks.provide_slots({(("a",), 128): fake}):
        assert tks.slot_segment_ids(tt, ("a",), 128) is not None
        assert tks.slot_segment_ids(tt, ("a",), 128)[0] is fake[0]
        assert tks.provided_slots(("a",), 256) is None
    assert tks.provided_slots(("a",), 128) is None


def test_build_probe_bit_for_bit():
    r = np.random.default_rng(7)
    build = r.integers(0, 60, 80).astype(np.int32)      # duplicate keys
    bvalid = r.random(80) < 0.9
    probe = r.integers(-5, 70, 300).astype(np.int32)
    pvalid = r.random(300) < 0.95
    want = jks.build_probe(jks.key_words_for([build]), bvalid,
                           jks.key_words_for([probe]), pvalid)
    got = tks.build_probe(tks.key_words_for([torch.as_tensor(build)]),
                          torch.as_tensor(bvalid),
                          tks.key_words_for([torch.as_tensor(probe)]),
                          torch.as_tensor(pvalid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fb = _keys(8, 50)["f32"]
    fp = _keys(9, 120)["f32"]
    want = jks.build_probe(jks.key_words_for([fb]), np.ones(50, bool),
                           jks.key_words_for([fp]))
    got = tks.build_probe(tks.key_words_for([torch.as_tensor(fb)]),
                          torch.ones(50, dtype=torch.bool),
                          tks.key_words_for([torch.as_tensor(fp)]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_group_bound_helpers_match_reference():
    from repro.relational import group_bound as jgb
    for mg in (1, 128, 129, 5000):
        assert tgb.bucket_group_bound(mg) == jgb.bucket_group_bound(mg)
        for cap in (100, 300, 10_000):
            assert tgb.resolve_group_bound(mg, cap) == \
                jgb.resolve_group_bound(mg, cap)
    with pytest.raises(tgb.GroupBoundOverflow):
        tgb.check_group_overflow(torch.tensor(200), 128)
    assert tgb.check_group_overflow(torch.tensor(128), 128) is None
    for dt, jdt in ((torch.float32, np.float32), (torch.int32, np.int32),
                    (torch.uint8, np.uint8), (torch.bool, np.bool_)):
        got = tgb.poison_sentinel(dt).numpy()
        want = np.asarray(jgb.poison_sentinel(jdt))
        np.testing.assert_array_equal(got, want)
    cols = {"x": torch.tensor([1.0, 2.0]), "b": torch.tensor([True, True])}
    ok = torch.tensor([True, False])
    out = tgb.poison_overflow(cols, ok)
    assert torch.isnan(out["x"][1]) and not out["b"][1]
    only_bool = tgb.poison_overflow({"b": cols["b"]}, ok)
    assert torch.isnan(only_bool[tgb.STAMP_COL][1])
    assert tgb.poison_overflow(cols, None) is cols
