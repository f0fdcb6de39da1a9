"""The port's Mamba-2 layer against the JAX package's, at the reduced
``mamba2-2.7b`` size: the full-sequence layer on the reference's kernel
route (``use_pallas=True``: the Pallas SSD kernel in interpret mode) and
the one-token decode, from the same parameters (``params_from_jax``) and
inputs made with numpy from a seed.

Tolerances: 1e-5 in float32, where the two differ only in the order of
float32 sums; 3e-2 in bf16, the bound the reference puts on its own bf16
decode-vs-forward agreement (``tests/test_arch_smoke.py``), since both
sides round the same intermediates to bf16 but may land one ulp
(2^-8 relative) apart where their float32 sums differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _cfg():
    return get_config("mamba2-2.7b").reduced()


def _kw(cfg):
    return dict(state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                expand=cfg.ssm_expand)


def _params(dtype, seed=0):
    cfg = _cfg()
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), cfg.d_model,
                       state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                       expand=cfg.ssm_expand, conv_width=cfg.conv_width,
                       dtype=getattr(jnp, dtype))
    # a nonzero decay, bias and skip, so every term of the layer counts
    rng = np.random.default_rng(seed)
    h = jp["a_log"].shape[0]
    for k, scale in (("a_log", 0.5), ("dt_bias", 0.5), ("d_skip", 0.5)):
        jp[k] = jnp.asarray(rng.standard_normal(h) * scale, jnp.float32)
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jp, params_from_jax(host, dtype=getattr(torch, dtype))


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_params_match_the_reference_layout():
    cfg = _cfg()
    jp = jssm.init_ssm(jax.random.PRNGKey(0), cfg.d_model,
                       state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                       expand=cfg.ssm_expand, conv_width=cfg.conv_width)
    tp = tssm.init_ssm(torch.Generator().manual_seed(0), cfg.d_model,
                       state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                       expand=cfg.ssm_expand, conv_width=cfg.conv_width,
                       device="cpu")
    assert set(jp) == set(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert str(jp[k].dtype) == str(tp[k].dtype).replace("torch.", ""), k
    stacked = tssm.init_ssm(torch.Generator().manual_seed(0), cfg.d_model,
                            state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                            expand=cfg.ssm_expand, conv_width=cfg.conv_width,
                            device="cpu", layers=3)
    assert all(stacked[k].shape == (3,) + tp[k].shape for k in tp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,chunk", [(16, 8), (13, 8), (24, 16)])
def test_ssm_layer_matches_the_kernel_route(dtype, seq, chunk):
    cfg = _cfg()
    jp, tp = _params(dtype, seed=seq)
    jx, tx = _x((2, seq, cfg.d_model), dtype, seed=seq + chunk)
    want = jssm.ssm_layer(jp, jx, chunk=chunk, use_pallas=True, **_kw(cfg))
    got = tssm.ssm_layer(tp, tx, chunk=chunk, **_kw(cfg))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, seq, cfg.d_model)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches(dtype):
    cfg = _cfg()
    jp, tp = _params(dtype, seed=7)
    jc = jssm.init_ssm_cache(2, cfg.d_model, conv_width=cfg.conv_width,
                             dtype=getattr(jnp, dtype), **_kw(cfg))
    tc = tssm.init_ssm_cache(2, cfg.d_model, conv_width=cfg.conv_width,
                             dtype=getattr(torch, dtype), device="cpu",
                             **_kw(cfg))
    for k in jc:
        assert tuple(jc[k].shape) == tuple(tc[k].shape)
    for step in range(5):
        jx, tx = _x((2, 1, cfg.d_model), dtype, seed=100 + step)
        jy, jc = jssm.decode_step_ssm(jp, jx, jc, **_kw(cfg))
        ty, tc = tssm.decode_step_ssm(tp, tx, tc, **_kw(cfg))
        _close(ty, jy, dtype)
        _close(tc["h"], jc["h"], dtype)
        _close(tc["conv"], jc["conv"], dtype)


def test_causal_conv_matches():
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    got = tssm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                            torch.from_numpy(b))
    _close(got, want, "float32")


def test_softplus_is_logaddexp():
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tssm._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
