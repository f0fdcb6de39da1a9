"""The port's attention layers against the JAX package's
(``repro/models/attention.py``, ``flash.py``, ``layers.py``) on the same
inputs and parameters made with numpy from a seed: the rotary embedding,
the qk-normed projections, blockwise flash prefill, the decode attention
the model runs (``decode_attention_jnp``) and one decode step; and the
online-softmax aggregate's Merge over a split cache.

Tolerances: 1e-5 in float32 (the order of float32 sums differs); 2e-2 in
bf16, where a different sum order may flip a bf16 rounding (2^-8 relative)
that later products carry on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jatt
from repro.models import flash as jflash
from repro.models import layers as jlayers
from repro_torch.models import attention as tatt
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tlayers

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(arr, dtype):
    return (torch.from_numpy(np.asarray(arr)).to(getattr(torch, dtype)),
            jnp.asarray(arr, getattr(jnp, dtype)))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _params(seed, d=48, h=6, hkv=2, dh=16, dtype="float32"):
    r = _rng(seed)
    arrs = {"wq": r.standard_normal((d, h, dh)) / np.sqrt(d),
            "wk": r.standard_normal((d, hkv, dh)) / np.sqrt(d),
            "wv": r.standard_normal((d, hkv, dh)) / np.sqrt(d),
            "wo": r.standard_normal((h, dh, d)) / np.sqrt(h * dh),
            "q_norm": 1 + 0.1 * r.standard_normal(dh),
            "k_norm": 1 + 0.1 * r.standard_normal(dh)}
    t, j = {}, {}
    for k, a in arrs.items():
        t[k], j[k] = _pair(a.astype(np.float32), dtype)
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches(dtype):
    r = _rng(0)
    x_t, x_j = _pair(r.standard_normal((2, 9, 3, 16)).astype(np.float32),
                     dtype)
    pos = np.tile(np.arange(9, dtype=np.int32) * 7, (2, 1))
    got = tlayers.apply_rope(x_t, torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(x_j, jnp.asarray(pos), 1e6)
    assert got.dtype == x_t.dtype
    _close(got, want, dtype)
    np.testing.assert_allclose(
        tlayers.rope_frequencies(128, 1e6).numpy(),
        np.asarray(jlayers.rope_frequencies(128, 1e6)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_qkv_with_qk_norm_matches(dtype):
    tp, jp = _params(1, dtype=dtype)
    x_t, x_j = _pair(_rng(2).standard_normal((2, 7, 48)).astype(np.float32),
                     dtype)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    got = tatt.project_qkv(tp, x_t, torch.from_numpy(pos), 1e6)
    want = jatt.project_qkv(jp, x_j, jnp.asarray(pos), 1e6)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,s,s_kv,qc,kc", [
    (True, 37, 37, 16, 8), (True, 40, 40, 8, 16), (False, 13, 21, 8, 8)])
def test_flash_attention_matches(dtype, causal, s, s_kv, qc, kc):
    """Blockwise flash forward: GQA (6 heads over 2), q_chunk != kv_chunk,
    S with a tail block."""
    r = _rng(s * 10 + qc)
    q_t, q_j = _pair(r.standard_normal((2, s, 6, 16)).astype(np.float32),
                     dtype)
    k_t, k_j = _pair(r.standard_normal((2, s_kv, 2, 16)).astype(np.float32),
                     dtype)
    v_t, v_j = _pair(r.standard_normal((2, s_kv, 2, 16)).astype(np.float32),
                     dtype)
    got = tflash.flash_attention(q_t, k_t, v_t, causal, 0, qc, kc)
    want = jflash.flash_attention(q_j, k_j, v_j, causal, 0, qc, kc)
    assert got.dtype == q_t.dtype and tuple(got.shape) == (2, s, 6, 16)
    _close(got, want, dtype)


def test_attention_layer_matches_and_refuses_what_is_not_ported():
    tp, jp = _params(3)
    x = _rng(4).standard_normal((1, 11, 48)).astype(np.float32)
    pos = np.arange(11, dtype=np.int32)[None]
    y, (k, v) = tatt.attention_layer(tp, torch.from_numpy(x),
                                     torch.from_numpy(pos), n_heads=6,
                                     rope_theta=1e6, q_chunk=4, kv_chunk=8)
    jy, (jk, jv) = jatt.attention_layer(jp, jnp.asarray(x), jnp.asarray(pos),
                                        n_heads=6, rope_theta=1e6,
                                        q_chunk=4, kv_chunk=8)
    for g, w in ((y, jy), (k, jk), (v, jv)):
        _close(g, w, "float32")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tatt.attention_layer(tp, torch.from_numpy(x), torch.from_numpy(pos),
                             n_heads=6, cross_kv=(k, v))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tflash.flash_attention(k, k, v, True, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_jnp_matches(dtype):
    r = _rng(5)
    q_t, q_j = _pair(r.standard_normal((3, 6, 16)).astype(np.float32), dtype)
    k_t, k_j = _pair(r.standard_normal((3, 20, 2, 16)).astype(np.float32),
                     dtype)
    v_t, v_j = _pair(r.standard_normal((3, 20, 2, 16)).astype(np.float32),
                     dtype)
    lens = np.asarray([1, 13, 20], np.int32)
    got = tatt.decode_attention_jnp(q_t, k_t, v_t, torch.from_numpy(lens))
    want = jatt.decode_attention_jnp(q_j, k_j, v_j, jnp.asarray(lens))
    assert got.dtype == q_t.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_attention_matches(dtype):
    tp, jp = _params(6, dtype=dtype)
    r = _rng(7)
    cache = r.standard_normal((2, 2, 12, 2, 16)).astype(np.float32)
    lens = np.asarray([3, 11], np.int32)      # the second writes the last row
    x_t, x_j = _pair(r.standard_normal((2, 1, 48)).astype(np.float32), dtype)
    tc = {"k": _pair(cache[0], dtype)[0], "v": _pair(cache[1], dtype)[0],
          "len": torch.from_numpy(lens)}
    jc = {"k": _pair(cache[0], dtype)[1], "v": _pair(cache[1], dtype)[1],
          "len": jnp.asarray(lens)}
    for _ in range(2):                         # the second step hits the cap
        y, tc = tatt.decode_step_attention(tp, x_t, tc, n_heads=6,
                                           rope_theta=1e6)
        jy, jc = jatt.decode_step_attention(jp, x_j, jc, n_heads=6,
                                            rope_theta=1e6)
        _close(y, jy, dtype)
        for k in ("k", "v"):
            _close(tc[k], jc[k], dtype)
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))


def test_scatter_rows_equals_the_one_hot_blend():
    r = _rng(8)
    cache = r.standard_normal((3, 5, 2, 4)).astype(np.float32)
    new = r.standard_normal((3, 1, 2, 4)).astype(np.float32)
    slot = np.asarray([0, 4, 2])
    got = tatt._scatter_rows(torch.from_numpy(cache), torch.from_numpy(slot),
                             torch.from_numpy(new))
    want = jatt._scatter_rows(jnp.asarray(cache), jnp.asarray(slot),
                              jnp.asarray(new))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_softmax_aggregate_merge_matches_monolithic():
    """Four shards of a KV cache accumulated alone and merged in order
    equal monolithic softmax attention (tests/test_distribution.py:69)."""
    r = _rng(0)
    d, s = 16, 64
    q = torch.from_numpy(r.standard_normal(d).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((s, d)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((s, d)).astype(np.float32))
    logits = k @ q / np.sqrt(d)
    agg = tatt.softmax_aggregate(d)
    partials = []
    for i in range(4):
        st = agg.identity()
        for j in range(16):
            st = agg.accumulate(st, {"s": logits[16 * i + j],
                                     "v": v[16 * i + j]})
        partials.append(st)
    merged = partials[0]
    for p in partials[1:]:
        merged = agg.merge(merged, p)
    want = torch.softmax(logits, 0) @ v
    np.testing.assert_allclose(agg.terminate(merged).numpy(), want.numpy(),
                               rtol=1e-5)


def test_split_cache_merge_equals_decode_attention():
    """decode_attention_jnp over a cache split in two and merged equals
    it over the whole cache (tests/test_distribution.py:99)."""
    r = _rng(1)
    b, h, d, s = 2, 4, 16, 64
    q = torch.from_numpy(r.standard_normal((b, h, d)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((b, s, h, d)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((b, s, h, d)).astype(np.float32))
    kv_len = torch.tensor([64, 40], dtype=torch.int32)
    want = tatt.decode_attention_jnp(q, k, v, kv_len)
    agg = tatt.softmax_aggregate(d)
    got = torch.zeros((b, h, d))
    for bi in range(b):
        for hi in range(h):
            partials = []
            for shard in range(2):
                st = agg.identity()
                for j in range(32):
                    pos = shard * 32 + j
                    logit = k[bi, pos, hi] @ q[bi, hi] / np.sqrt(d) \
                        if pos < kv_len[bi] else torch.tensor(-1e30)
                    st = agg.accumulate(st, {"s": logit,
                                             "v": v[bi, pos, hi]})
                partials.append(st)
            got[bi, hi] = agg.terminate(agg.merge(*partials))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
