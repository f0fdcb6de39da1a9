"""The port's dispatching entry points (``repro_torch.kernels.ops``)
against the JAX package's (``repro.kernels.ops``) on CPU inputs made with
numpy from a seed: the default route and ``REPRO_USE_PALLAS=0`` both take
the plain routes, which equal the reference's non-Pallas routes (exactly
for the segment moments of integer-valued data, to float32 summation order
otherwise); a request for a kernel on a CPU tensor raises; no kernel's
launch count moves on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attn as tda
from repro_torch.kernels import ops
from repro_torch.kernels import segment_agg as tsa
from repro_torch.kernels import ssd_scan as tss


def _launches():
    return (tsa.segagg_sorted.launches, tsa.segagg_unsorted.launches,
            tss.ssd_scan_cuda.launches, tda.decode_attention_cuda.launches)


def _segment_inputs(seed=0, n=500, cols=2, s=40):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-20, 20, (n, cols)).astype(np.float32)
    segs = np.sort(rng.integers(0, s, n)).astype(np.int32)
    valid = rng.random((n, cols)) < 0.9
    return vals, segs, valid, s


def _decode_inputs(seed=1, bh=3, g=4, d=32, s=50):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g, d)).astype(np.float32)
    k = rng.standard_normal((bh, s, d)).astype(np.float32)
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    return q, k, v, rng.integers(1, s + 1, bh).astype(np.int32)


def _ssd_inputs(seed=2, bh=2, t=64, p=16, n=8):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((bh, t, p)) * 0.5).astype(np.float32),
            (-np.abs(rng.standard_normal((bh, t))) * 0.1).astype(np.float32),
            (rng.standard_normal((bh, t, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((bh, t, n)) * 0.3).astype(np.float32))


def _both(name, arrs, kw):
    """(port result, reference result) of ops.<name> on the same inputs."""
    got = getattr(ops, name)(*(torch.from_numpy(np.asarray(a))
                               if isinstance(a, np.ndarray) else a
                               for a in arrs), **kw)
    want = getattr(jops, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in arrs), **kw)
    return got.numpy(), np.asarray(want)


CASES = [
    ("segment_agg", lambda: (lambda v, s, ok, n: (v[:, 0], s, ok[:, 0], n))(
        *_segment_inputs()), {}, 0.0),
    ("fused_segment_agg", _segment_inputs, {}, 0.0),
    ("decode_attention", _decode_inputs, {}, 1e-6),
    ("ssd_scan", _ssd_inputs, {"chunk": 16}, 1e-5),
]


@pytest.mark.parametrize("env", [None, "0"])
@pytest.mark.parametrize("name,make,kw,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_routes_match_the_reference(monkeypatch, name, make, kw, tol,
                                          env):
    if env is None:
        monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    else:
        monkeypatch.setenv("REPRO_USE_PALLAS", env)
    before = _launches()
    got, want = _both(name, make(), kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert _launches() == before


@pytest.mark.parametrize("name,make,kw,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_a_kernel_request_on_the_cpu_raises(monkeypatch, name, make, kw,
                                            tol):
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in make()]
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    with pytest.raises(ValueError, match="no CPU mode"):
        getattr(ops, name)(*args, use_pallas=True, **kw)
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    with pytest.raises(ValueError, match="no CPU mode"):
        getattr(ops, name)(*args, **kw)
    # the switch overrides the caller, as in the reference
    monkeypatch.setenv("REPRO_USE_PALLAS", "false")
    getattr(ops, name)(*args, use_pallas=True, **kw)


def test_want_kernel_follows_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_USE_PALLAS", raising=False)
    cpu = torch.zeros(1)
    assert not ops.want_kernel(tensor=cpu) and not ops.want_kernel()
    assert ops.want_kernel(True, tensor=cpu)
    assert not jops.want_pallas() and jops.want_pallas(True)
    for env, want in (("0", False), ("false", False), ("False", False),
                      ("1", True), ("yes", True)):
        monkeypatch.setenv("REPRO_USE_PALLAS", env)
        assert ops.want_kernel(not want, tensor=cpu) is want
        assert jops.want_pallas(not want) is want
