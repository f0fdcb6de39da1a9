"""The dense slice of the port against the JAX package, at the reduced
``qwen3-14b`` size (2 layers, d_model 64, 4 query heads over 2 KV heads,
head dim 16): the config and parameter count, ``LM.forward`` (with the
per-layer KV caches), ``prefill`` and ``decode_step``, and the
continuous-batching ``Server``, from the same parameters
(``params_from_jax`` of the reference's ``LM.init``) and the same tokens.

Tolerances: 1e-5 in float32 (the order of float32 sums differs); 3e-2 in
bf16, the bound of the reference's own bf16 decode-vs-forward test
(``tests/test_arch_smoke.py``).  Served tokens are compared exactly, in
float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro.serve.serving import Request as JRequest
from repro.serve.serving import Server as JServer
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.serving import Request, Server

ARCH = "qwen3-14b"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
QC, KC = 8, 4        # q_chunk != kv_chunk, both below the sequence


def _cfg(**kw):
    return dataclasses.replace(get_config(ARCH).reduced(), **kw)


def _jcfg(**kw):
    return dataclasses.replace(jget_config(ARCH).reduced(), **kw)


def _pair(dtype, seed=0, **kw):
    """(JAX LM, its params, port LM, the same params)."""
    jlm = JLM(_jcfg(**kw), q_chunk=QC, kv_chunk=KC, remat=False,
              dtype=getattr(jnp, dtype))
    jp = jlm.init(jax.random.PRNGKey(seed))
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    tlm = LM(_cfg(**kw), q_chunk=QC, kv_chunk=KC, dtype=getattr(torch, dtype),
             device="cpu")
    return jlm, jp, tlm, params_from_jax(host, dtype=getattr(torch, dtype))


def _tokens(shape, vocab=128, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_config_and_param_count_match_the_reference():
    for mine, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (_cfg(), _jcfg())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
    assert get_config(ARCH).param_count() == 14_768_291_840
    cfg = _cfg()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim) == (2, 64, 4, 2, 16)


def test_init_layout_and_conversion_match_the_reference():
    jlm = JLM(_jcfg(), q_chunk=QC, kv_chunk=KC)
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(_cfg(), q_chunk=QC, kv_chunk=KC, device="cpu")
    tp = tlm.init(torch.Generator().manual_seed(0))
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    conv = params_from_jax(host)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == 14
    for path, leaf in jflat:
        node, cnode = tp, conv
        for k in path:
            node, cnode = node[k.key], cnode[k.key]
        for t in (node, cnode):
            assert tuple(t.shape) == tuple(leaf.shape), path
            assert str(t.dtype) == f"torch.{leaf.dtype}", path
        np.testing.assert_array_equal(cnode.to(torch.float32).numpy(),
                                      np.asarray(leaf, np.float32))
    # the analytic count leaves out the qk-norm and final-norm scales
    n = sum(leaf.size for _, leaf in jflat)
    cfg = _cfg()
    assert n == cfg.param_count() + cfg.n_layers * 2 * cfg.head_dim \
        + cfg.d_model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_caches_and_prefill_match(dtype):
    jlm, jp, tlm, tp = _pair(dtype)
    toks = _tokens((2, 19))                    # 19: tail blocks of 8 and 4
    jl, _, jc = jlm.forward(jp, jnp.asarray(toks), collect_cache=True)
    tl, aux, tc = tlm.forward(tp, toks, collect_cache=True)
    assert tl.dtype == torch.float32 and tl.shape == (2, 19, 128)
    assert float(aux) == 0.0
    _close(tl, jl, dtype)
    for got, want in zip(tc, jc):
        assert tuple(got.shape) == tuple(want.shape) == (2, 2, 19, 2, 16)
        _close(got, want, dtype)
    assert tlm.forward(tp, toks)[2] is None
    jlast, _ = jlm.prefill(jp, jnp.asarray(toks))
    tlast, _ = tlm.prefill(tp, toks)
    _close(tlast, jlast, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match(dtype):
    jlm, jp, tlm, tp = _pair(dtype, seed=2)
    toks = _tokens((3, 6), seed=3)
    jc = jlm.init_cache(3, 16, params=jp, start_len=2)
    tc = tlm.init_cache(3, 16, params=tp, start_len=2)
    for k in ("k", "v", "len"):
        assert tuple(jc["layers"][k].shape) == tuple(tc["layers"][k].shape)
    np.testing.assert_array_equal(tc["layers"]["len"].numpy(),
                                  np.asarray(jc["layers"]["len"]))
    step = jax.jit(jlm.decode_step)
    for i in range(6):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = tlm.decode_step(tp, tc, toks[:, i:i + 1])
        _close(tl, jl, dtype)
        for k in ("k", "v"):
            _close(tc["layers"][k], jc["layers"][k], dtype)
        np.testing.assert_array_equal(tc["layers"]["len"].numpy(),
                                      np.asarray(jc["layers"]["len"]))


def test_decode_matches_forward():
    """Greedy decode logits equal teacher-forced forward logits (KV-cache
    correctness; tests/test_arch_smoke.py:85), in bf16 at its 2e-2."""
    tlm = LM(_cfg(), q_chunk=16, kv_chunk=16, device="cpu")
    tp = tlm.init(torch.Generator().manual_seed(3))
    toks = _tokens((1, 8), seed=4)
    full, _, _ = tlm.forward(tp, toks)
    cache = tlm.init_cache(1, 32, params=tp)
    for i in range(8):
        step, cache = tlm.decode_step(tp, cache, toks[:, i:i + 1])
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(),
                                   rtol=2e-2, atol=2e-2)


def test_unported_options_raise():
    for kw in ({"sliding_window": 16}, {"family": "moe"}):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            LM(_cfg(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        LM(_cfg(), pad_heads_multiple=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        LM(_cfg(norm="ln"), device="cpu").init(torch.Generator())


def _requests(cls, n, vocab=128):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab,
                                           rng.integers(3, 12)).tolist(),
                max_new=16) for i in range(n)]


def test_server_matches_the_reference():
    """Float32, 8 requests: with a slot per request the port serves the
    reference's tokens exactly; with 4 slots (slots reused, each zeroed on
    admission, "len" too) the same tokens again — batching changes no
    answer (ROADMAP Queue C)."""
    jlm, jp, tlm, tp = _pair("float32", seed=0)
    jreqs = _requests(JRequest, 8)
    js = JServer(jlm, jp, slots=8, max_len=128)
    for r in jreqs:
        js.submit(r)
    js.run()
    for slots in (8, 4):
        treqs = _requests(Request, 8)
        ts = Server(tlm, tp, slots=slots, max_len=128)
        for r in treqs:
            ts.submit(r)
        ts.run()
        assert all(r.done and len(r.out) == 16 for r in treqs)
        assert [r.out for r in treqs] == [r.out for r in jreqs], slots


def test_launcher(capsys):
    launch_serve.main(["--workload", "lm", "--arch", ARCH, "--smoke",
                       "--device", "cpu"])
    assert capsys.readouterr().out.startswith("8/8 requests, 128 tokens")
