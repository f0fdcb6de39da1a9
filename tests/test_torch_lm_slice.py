"""The LM slice of the port against the JAX package, at the reduced
``mamba2-2.7b`` size: configs, ``LM.forward``/``prefill``/``decode_step``
and the continuous-batching ``Server``, from the same parameters
(``params_from_jax`` of the reference's ``LM.init``) and the same tokens.
The reference runs its kernel route (``use_pallas=True``: the Pallas SSD
kernel in interpret mode), whose dtype contract the port keeps.

Tolerances: 1e-5 in float32 (the order of float32 sums differs); 3e-2 in
bf16, the bound of the reference's own bf16 decode-vs-forward test
(``tests/test_arch_smoke.py``).  Served tokens are compared exactly, in
float32, where the logits of the two packages agree to ~1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import LM as JLM
from repro.serve.serving import Request as JRequest
from repro.serve.serving import Server as JServer
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import LM
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import layer
from repro_torch.serve.serving import Request, Server

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
CHUNK = 8


def _cfg(**kw):
    return dataclasses.replace(get_config("mamba2-2.7b").reduced(), **kw)


def _jcfg(**kw):
    return dataclasses.replace(jget_config("mamba2-2.7b").reduced(), **kw)


def _pair(dtype, seed=0, **kw):
    """(JAX LM, its params, port LM, the same params)."""
    jlm = JLM(_jcfg(**kw), ssd_chunk=CHUNK, remat=False, use_pallas=True,
              dtype=getattr(jnp, dtype))
    jp = jlm.init(jax.random.PRNGKey(seed))
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    tlm = LM(_cfg(**kw), ssd_chunk=CHUNK, dtype=getattr(torch, dtype),
             device="cpu")
    return jlm, jp, tlm, params_from_jax(host, dtype=getattr(torch, dtype))


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_configs_match_the_reference():
    for mine, ref in ((get_config("mamba2-2.7b"),
                       jget_config("mamba2-2.7b")),
                      (_cfg(), _jcfg())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
    assert 2.8e9 < get_config("mamba2-2.7b").param_count() < 2.9e9
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    with pytest.raises(KeyError, match="not ported yet"):
        get_config("olmoe-1b-7b")


def test_other_families_and_the_default_device():
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        LM(_cfg(family="moe"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        _cfg(family="moe").param_count()
    if torch.cuda.is_available():
        assert LM(_cfg()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LM(_cfg())


def test_building_an_lm_changes_no_backend_switch():
    """The numerics switches are the entry points' to set, not ``LM``'s."""
    flags = torch.backends
    saved = (flags.cuda.matmul.allow_tf32, flags.cudnn.allow_tf32)
    try:
        flags.cuda.matmul.allow_tf32 = flags.cudnn.allow_tf32 = True
        LM(_cfg(), device="cpu")
        assert flags.cuda.matmul.allow_tf32 and flags.cudnn.allow_tf32
    finally:
        flags.cuda.matmul.allow_tf32, flags.cudnn.allow_tf32 = saved


def test_init_layout_matches_the_reference():
    jlm = JLM(_jcfg(), ssd_chunk=CHUNK)
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(_cfg(), ssd_chunk=CHUNK, device="cpu")
    tp = tlm.init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == 14
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype) == f"torch.{leaf.dtype}", path
    assert tlm.vocab_padded == jlm.vocab_padded == 128
    assert layer(tp["blocks"], 1)["ssm"]["w_out"].shape == (128, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match(dtype):
    jlm, jp, tlm, tp = _pair(dtype)
    toks = _tokens((2, 21), 128)               # 21: a padded last chunk
    jl, _, _ = jlm.forward(jp, jnp.asarray(toks))
    tl, aux, caches = tlm.forward(tp, toks)
    assert tl.dtype == torch.float32 and tl.shape == (2, 21, 128)
    assert caches is None and float(aux) == 0.0
    _close(tl, jl, dtype)
    jlast, _ = jlm.prefill(jp, jnp.asarray(toks))
    tlast, _ = tlm.prefill(tp, toks)
    _close(tlast, jlast, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match(dtype):
    jlm, jp, tlm, tp = _pair(dtype, seed=2)
    toks = _tokens((3, 6), 128, seed=3)
    jc = jlm.init_cache(3, 16, params=jp)
    tc = tlm.init_cache(3, 16, params=tp)
    for k in ("conv", "h"):
        assert tuple(jc["layers"][k].shape) == tuple(tc["layers"][k].shape)
    step = jax.jit(jlm.decode_step)
    for i in range(6):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = tlm.decode_step(tp, tc, toks[:, i:i + 1])
        _close(tl, jl, dtype)
        _close(tc["layers"]["h"], jc["layers"]["h"], dtype)


def test_pad_vocab_logits_masked_in_decode_only():
    """vocab 100 pads to 128: forward leaves the pad logits as computed,
    decode masks them to -1e30 — the reference's quirk, kept."""
    jlm, jp, tlm, tp = _pair("float32", vocab=100)
    toks = _tokens((1, 4), 100)
    tl, _, _ = tlm.forward(tp, toks)
    jl, _, _ = jlm.forward(jp, jnp.asarray(toks))
    _close(tl, jl, "float32")
    assert bool((tl[..., 100:].abs() < 1.0).all())
    dl, _ = tlm.decode_step(tp, tlm.init_cache(1, 8), toks[:, :1])
    jdl, _ = jlm.decode_step(jp, jlm.init_cache(1, 8), jnp.asarray(toks[:, :1]))
    _close(dl, jdl, "float32")
    assert bool((dl[:, 100:] == -1e30).all())


def test_prefill_agrees_with_step_by_step_decode():
    """The chunked scan (prefill) and the one-token recurrence (decode)
    compute one function; float32, sums in different orders: 1e-4."""
    tlm = LM(_cfg(), ssd_chunk=CHUNK, dtype=torch.float32, device="cpu")
    tp = tlm.init(torch.Generator().manual_seed(5))
    toks = _tokens((2, 19), 128, seed=6)
    full, _, _ = tlm.forward(tp, toks)
    cache = tlm.init_cache(2, 32)
    for i in range(19):
        step, cache = tlm.decode_step(tp, cache, toks[:, i:i + 1])
        np.testing.assert_allclose(step.numpy(), full[:, i].numpy(),
                                   rtol=1e-4, atol=1e-4)


def _requests(cls, n, vocab=128):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab,
                                           rng.integers(3, 12)).tolist(),
                max_new=16) for i in range(n)]


def test_server_matches_the_reference():
    """Float32, 8 requests: with a slot per request the port serves the
    reference's tokens exactly; with 4 slots (slots reused) it serves the
    same tokens again — batching changes no answer.  (The reference's
    Server keeps a reused slot's old state, so there some of requests
    4-7 answer differently; ROADMAP Queue C.)"""
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


def test_server_run_counts_its_steps_and_stops_at_max_steps():
    tlm = LM(_cfg(), ssd_chunk=CHUNK, dtype=torch.float32, device="cpu")
    tp = tlm.init(torch.Generator().manual_seed(0))
    ts = Server(tlm, tp, slots=4, max_len=128)
    for r in _requests(Request, 8):
        ts.submit(r)
    assert ts.run(max_steps=5) == 5
    assert ts.pending and any(ts.active)
    left = ts.run()
    assert 0 < left and not ts.pending and not any(ts.active)


def test_server_in_bf16_answers_every_request():
    tlm = LM(_cfg(), ssd_chunk=CHUNK, device="cpu")
    tp = tlm.init(torch.Generator().manual_seed(0))
    reqs = launch_serve.make_requests(128, 8, 16)
    res = launch_serve.serve_requests(tlm, tp, reqs, slots=4, max_len=128)
    assert res["done"] == 8 and res["tokens"] == 128
    assert res["steps"] >= 2 * (16 + 2)     # two rounds of 4 slots at least
    assert all(0 <= t < 128 for r in reqs for t in r.out)


def test_launcher(capsys):
    launch_serve.main(["--workload", "lm", "--arch", "mamba2-2.7b",
                       "--smoke", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("8/8 requests, 128 tokens")
    with pytest.raises(SystemExit, match="ROADMAP A9"):
        launch_serve.main(["--workload", "agg"])
