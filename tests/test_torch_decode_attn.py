"""The port's flash-decode attention against the JAX package's: the plain
version (``repro_torch.kernels.ref.decode_attention_chunked``, what
``decode_attention`` runs for a CPU tensor) against the Pallas kernel in
interpret mode, and the float32 oracle against its JAX twin, on the same
inputs made with numpy from a seed.

Tolerances: 1e-6 in float32, where the two differ only in the order of
float32 sums; 2 bf16 ulps in bf16, where a different sum order may flip the
bf16 rounding of a p or of the output by one ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attn import decode_attention as jax_decode
from repro_torch.kernels import decode_attn as tda
from repro_torch.kernels import ref as tref

#: the reference sweep (tests/test_kernels.py:51-53), qwen3-14b's group
#: (G = 5, D = 128) with S not a multiple of the chunk, and a short cache
SHAPES = [(2, 8, 128, 256, 128), (1, 16, 128, 300, 128),
          (4, 8, 256, 512, 256), (3, 5, 128, 333, 128), (2, 4, 64, 40, 16)]


def _inputs(seed, bh, g, d, s, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g, d)).astype(np.float32)
    k = rng.standard_normal((bh, s, d)).astype(np.float32)
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, s + 1, bh)
    return q, k, v, np.asarray(lens, np.int32)


def _torch(arrs, dtype):
    q, k, v, lens = arrs
    return (*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
            torch.from_numpy(lens))


def _jax(arrs, dtype):
    q, k, v, lens = arrs
    return (*(jnp.asarray(a, dtype) for a in (q, k, v)), jnp.asarray(lens))


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    # 2 ulps of bf16 (8 significant bits) at the larger magnitude
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= 2 * ulp), \
        float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("bh,g,d,s,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(bh, g, d, s, chunk, dtype):
    arrs = _inputs(bh * 100 + s, bh, g, d, s)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tref.decode_attention_chunked(*_torch(arrs, tdt), chunk=chunk)
    assert got.dtype == tdt and got.shape == (bh, g, d)
    want = jax_decode(*_jax(arrs, jdt), chunk=chunk, interpret=True)
    _close(got, want, dtype)
    # the dispatcher takes the plain version for a CPU tensor
    before = tda.decode_attention_cuda.launches
    again = tda.decode_attention(*_torch(arrs, tdt), chunk=chunk)
    assert torch.equal(again, got)
    assert tda.decode_attention_cuda.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_and_edge_lengths(dtype):
    """kv_len in {0, 1, chunk - 1, chunk, chunk + 1, S}: kv_len = 0 gives
    zeros in the plain version and the Pallas kernel (NaN in the oracle)."""
    s, chunk = 300, 128
    arrs = _inputs(7, 6, 8, 128, s, lens=[0, 1, 127, 128, 129, s])
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tref.decode_attention_chunked(*_torch(arrs, tdt), chunk=chunk)
    want = jax_decode(*_jax(arrs, jdt), chunk=chunk, interpret=True)
    _close(got, want, dtype)
    assert bool((got[0] == 0).all())
    oracle = tref.decode_attention_ref(*_torch(arrs, tdt))
    assert bool(torch.isnan(oracle[0]).all())


def test_tiny_cache_attends_one_position():
    """kv_len = 1 attends position 0 exactly (tests/test_kernels.py:68)."""
    q = torch.ones((1, 8, 128))
    k = torch.ones((1, 256, 128))
    v = torch.cat([torch.full((1, 1, 128), 7.0), torch.zeros((1, 255, 128))],
                  dim=1)
    out = tda.decode_attention(q, k, v, torch.tensor([1], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), 7.0, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracle_matches_its_jax_twin(dtype):
    arrs = _inputs(11, 3, 8, 128, 200)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tref.decode_attention_ref(*_torch(arrs, tdt))
    want = jref.decode_attention_ref(*_jax(arrs, jdt))
    assert got.dtype == tdt
    _close(got, want, dtype)


def test_plain_version_is_near_the_oracle():
    """The reference test's own gate between its kernel and its oracle
    (2e-5 in float32)."""
    arrs = _inputs(3, 4, 8, 128, 512)
    got = tref.decode_attention_chunked(*_torch(arrs, torch.float32))
    want = tref.decode_attention_ref(*_torch(arrs, torch.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_kernel_geometry():
    """The tile and split sizes the wrapper hands the CUDA kernel: tiles a
    power of two of at most 16 KB of K, splits a multiple of 128."""
    assert tda.tile_rows(128, 2) == 64 and tda.tile_rows(128, 4) == 32
    assert tda.tile_rows(256, 4) == 16 and tda.tile_rows(80, 2) == 64
    assert tda.tile_rows(8, 2) == 128
    assert tda.default_split(1024, 32768) == 4096
    assert tda.default_split(32, 128) == 128
    assert tda.default_split(64, 4173) == 128
    for tk, g, d, e in ((16, 16, 256, 4), (64, 5, 128, 2), (128, 16, 64, 2)):
        assert tda.smem_bytes(tk, g, d, e) <= tda.SMEM_LIMIT
    with pytest.raises(ValueError, match="backend"):
        tda.decode_attention(*_torch(_inputs(0, 1, 2, 8, 4), torch.float32),
                             backend="pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tda.decode_attention_cuda(*_torch(_inputs(0, 1, 2, 8, 4),
                                          torch.float32))
