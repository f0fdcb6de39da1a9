"""The port's SSD scan against the JAX package's: the plain version
(``repro_torch.kernels.ref.ssd_scan_chunked``, what ``ssd_scan`` runs for
a CPU tensor) against the Pallas kernel in interpret mode and against the
sequential oracle, on the same inputs made with numpy from a seed.

Tolerances are those of the reference's own sweep
(``tests/test_kernels.py::test_ssd_scan_sweep``): 2e-4 in float32, where
the two differ only in the order of float32 sums; 6e-2 in bf16, where y is
rounded to bf16 (one bf16 ulp is 2^-8 relative) after sums taken in
different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss

F32_TOL, BF16_TOL = 2e-4, 6e-2


def _inputs(seed, bh, t, p, n, g=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bh, t, p)) * 0.5).astype(np.float32)
    log_a = (-np.abs(rng.standard_normal((bh, t))) * 0.1).astype(np.float32)
    b = (rng.standard_normal((g or bh, t, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((g or bh, t, n)) * 0.3).astype(np.float32)
    return x, log_a, b, c


def _torch(arrs, dtype):
    x, log_a, b, c = (torch.from_numpy(a) for a in arrs)
    return x.to(dtype), log_a, b.to(dtype), c.to(dtype)


def _jax(arrs, dtype):
    x, log_a, b, c = arrs
    return (jnp.asarray(x, dtype), jnp.asarray(log_a, jnp.float32),
            jnp.asarray(b, dtype), jnp.asarray(c, dtype))


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("bh,t,p,n,chunk", [
    (2, 128, 64, 16, 32), (1, 256, 128, 32, 64), (3, 64, 32, 8, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_oracle(bh, t, p, n, chunk, dtype):
    arrs = _inputs(t + p, bh, t, p, n)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    got = tref.ssd_scan_chunked(*_torch(arrs, tdt), chunk=chunk)
    assert got.dtype == tdt and got.shape == (bh, t, p)
    assert tss.ssd_scan(*_torch(arrs, tdt), chunk=chunk).dtype == tdt
    pallas = jax_ssd_scan(*_jax(arrs, jdt), chunk=chunk, interpret=True)
    oracle = jref.ssd_scan_ref(*_jax(arrs, jdt))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequential_oracle_matches_the_reference(dtype):
    arrs = _inputs(5, 2, 48, 16, 8)
    got = tref.ssd_scan_ref(*_torch(arrs, getattr(torch, dtype)))
    want = jref.ssd_scan_ref(*_jax(arrs, getattr(jnp, dtype)))
    # the same float32 recurrence in the same order: float32 rounding only
    # (bf16: one final rounding of values equal to ~1e-6)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_oracle_in_float64():
    """float64 inputs run the recurrence in float64 (the card's oracle)."""
    arrs = _inputs(6, 2, 64, 8, 8)
    x, log_a, b, c = (torch.from_numpy(a).double() for a in arrs)
    got = tref.ssd_scan_ref(x, log_a, b, c)
    assert got.dtype == torch.float64
    want = tref.ssd_scan_ref(*_torch(arrs, torch.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_chunk_invariance():
    """The Merge across chunks makes the result independent of the chunk
    size (the reference's ``test_ssd_chunk_invariance``, same bound)."""
    arrs = _inputs(0, 1, 128, 32, 8)
    outs = [tref.ssd_scan_chunked(*_torch(arrs, torch.float32), chunk=cs)
            for cs in (16, 32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_padding_leaves_the_prefix_alone():
    """Padded steps carry log_a = 0 and x = 0 (the model's padding): the
    first T outputs equal the unpadded scan's."""
    t, pad = 100, 28
    x, log_a, b, c = _torch(_inputs(2, 2, t, 16, 8), torch.float32)
    padded = (torch.nn.functional.pad(x, (0, 0, 0, pad)),
              torch.nn.functional.pad(log_a, (0, pad)),
              torch.nn.functional.pad(b, (0, 0, 0, pad)),
              torch.nn.functional.pad(c, (0, 0, 0, pad)))
    got = tss.ssd_scan(*padded, chunk=32)[:, :t]
    want = tref.ssd_scan_ref(x, log_a, b, c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tss.ssd_scan(x, log_a, b, c, chunk=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_bc_equals_the_broadcast_layout(dtype):
    """B/C given once per batch row and shared by H heads (the model's
    layout) computes the reference's broadcast (BH, T, N) function."""
    heads, g = 4, 2
    arrs = _inputs(3, g * heads, 64, 16, 8, g=g)
    x, log_a, b, c = _torch(arrs, getattr(torch, dtype))
    shared = tss.ssd_scan(x, log_a, b, c, chunk=16)
    full = tss.ssd_scan(x, log_a, b.repeat_interleave(heads, 0),
                        c.repeat_interleave(heads, 0), chunk=16)
    np.testing.assert_allclose(_np(shared), _np(full), rtol=1e-6, atol=1e-6)
    jb = np.repeat(arrs[2], heads, 0)
    jc = np.repeat(arrs[3], heads, 0)
    jdt = getattr(jnp, dtype)
    want = jax_ssd_scan(*_jax((arrs[0], arrs[1], jb, jc), jdt), chunk=16,
                        interpret=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(shared), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="must divide"):
        tss.ssd_scan(x, log_a, b[:1].expand(3, -1, -1), c[:1].expand(3, -1, -1),
                     chunk=16)


def test_dispatch_and_kernel_checks_on_the_cpu():
    x, log_a, b, c = _torch(_inputs(4, 2, 32, 8, 8), torch.float32)
    before = tss.ssd_scan_cuda.launches
    auto = tss.ssd_scan(x, log_a, b, c, chunk=16)
    plain = tss.ssd_scan(x, log_a, b, c, chunk=16, backend="plain")
    assert torch.equal(auto, plain)
    assert tss.ssd_scan_cuda.launches == before      # CPU: no kernel launch
    with pytest.raises(ValueError, match="CUDA tensor"):
        tss.ssd_scan_cuda(x, log_a, b, c, 16)
    with pytest.raises(ValueError, match="unknown ssd_scan backend"):
        tss.ssd_scan(x, log_a, b, c, chunk=16, backend="pallas")
    # the model's shape fits one block's shared memory at chunk 64 and 128
    assert tss.smem_bytes(128, 128) <= tss.SMEM_LIMIT
    assert tss.smem_bytes(64, 128) <= tss.SMEM_LIMIT
    assert tss.smem_bytes(256, 128) > tss.SMEM_LIMIT
