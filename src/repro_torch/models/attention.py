"""GQA attention — twin of the self-attention part of
``repro/models/attention.py``: flash (blockwise) causal prefill and the
aggregate-contract decode.

The online-softmax state (m, l, acc) is a paper-contract ``Aggregate``
(``softmax_aggregate``): prefill accumulates over KV blocks
(``models/flash.py``) and a split cache merges its partials with its Merge.
The model's decode step runs ``decode_attention_jnp`` (the reference's
name, kept so a reader finds the twin), in plain torch as in the
reference; the hand-written flash-decode kernel is reached through
``kernels.ops.decode_attention`` only, as the reference reaches its Pallas
kernel (no model path calls it).

Sliding windows and cross-attention are not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.aggregate import Aggregate

from . import flash
from .layers import F32, apply_rope, normal, rms_norm

NEG_INF = -1e30


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A10)")


def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                   d_head: int, qkv_bias: bool, qk_norm: bool,
                   dtype=torch.bfloat16, device=None,
                   layers: int | None = None) -> dict:
    """One attention sublayer's parameters, or ``layers`` of them stacked
    on a leading axis; the reference's names, shapes and scales."""
    lead = () if layers is None else (layers,)
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(n_heads * d_head)

    def const(shape, value):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    p = {"wq": normal(gen, lead + (d, n_heads, d_head), s, dtype, device),
         "wk": normal(gen, lead + (d, n_kv, d_head), s, dtype, device),
         "wv": normal(gen, lead + (d, n_kv, d_head), s, dtype, device),
         "wo": normal(gen, lead + (n_heads, d_head, d), so, dtype, device)}
    if qkv_bias:
        p["bq"] = const((n_heads, d_head), 0.0)
        p["bk"] = const((n_kv, d_head), 0.0)
        p["bv"] = const((n_kv, d_head), 0.0)
    if qk_norm:
        p["q_norm"] = const((d_head,), 1.0)
        p["k_norm"] = const((d_head,), 1.0)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") in x's dtype."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                rope_theta: float):
    q, k, v = (_heads(x, params[w]) for w in ("wq", "wk", "wv"))
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hd,hdo->...o") in out's dtype."""
    h, dh, o = wo.shape
    return out.flatten(-2) @ wo.reshape(h * dh, o)


def attention_layer(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    *, n_heads: int, rope_theta: float = 1e4,
                    window: int = 0, q_chunk: int = 1024,
                    kv_chunk: int = 1024, cross_kv=None, causal: bool = True):
    """Full-sequence self-attention (prefill).  Returns (y, (k, v))."""
    if cross_kv is not None:
        raise _not_ported("cross-attention")
    q, k, v = project_qkv(params, x, positions, rope_theta)
    out = flash.flash_attention(q, k, v, causal, window, q_chunk, kv_chunk)
    return _out_proj(out, params["wo"]), (k, v)


# --------------------------------------------------------------------------
# Decode — the aggregate path
# --------------------------------------------------------------------------


def softmax_aggregate(d_head: int, device=None) -> Aggregate:
    """Online softmax as the paper's Init/Accumulate/Merge/Terminate; the
    Merge is the log-sum-exp combine of two partials, which the split-KV
    decode kernel runs across its splits."""
    def init():
        return {"m": torch.full((), NEG_INF, dtype=F32, device=device),
                "l": torch.zeros((), dtype=F32, device=device),
                "acc": torch.zeros((d_head,), dtype=F32, device=device)}

    def accumulate(state, row):
        m_new = torch.maximum(state["m"], row["s"])
        alpha = torch.exp(state["m"] - m_new)
        p = torch.exp(row["s"] - m_new)
        return {"m": m_new, "l": state["l"] * alpha + p,
                "acc": state["acc"] * alpha + p * row["v"].to(F32)}

    def merge(a, b):
        m = torch.maximum(a["m"], b["m"])
        aa, ab = torch.exp(a["m"] - m), torch.exp(b["m"] - m)
        return {"m": m, "l": a["l"] * aa + b["l"] * ab,
                "acc": a["acc"] * aa + b["acc"] * ab}

    def terminate(state):
        return state["acc"] / torch.clamp_min(state["l"], 1e-30)

    return Aggregate("online_softmax", init, accumulate, terminate,
                     merge=merge, identity=init)


def decode_attention_jnp(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); caches (B, S, Hkv, D); kv_len (B,) → (B, H, D).

    The reference's flash-decode in plain tensor ops (float32 softmax,
    the normalised weights rounded to v's dtype before the product).  Its
    kernel twin is ``kernels.decode_attn``, reached through
    ``kernels.ops.decode_attention``."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).to(F32)
    logits = (qg @ k_cache.to(F32).permute(0, 2, 3, 1)) / math.sqrt(d)
    ok = torch.arange(s, device=q.device)[None, None, None, :] \
        < kv_len[:, None, None, None]
    logits = torch.where(ok, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    w = (p / torch.clamp_min(l, 1e-30)).to(v_cache.dtype)
    out = w.to(F32) @ v_cache.to(F32).permute(0, 2, 1, 3)
    return out.reshape(b, h, d).to(q.dtype)


def _scatter_rows(cache: torch.Tensor, slot: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """cache (B, S, H, D); slot (B,); new (B, 1, H, D) → a copy of cache
    with row ``slot[b]`` of batch b replaced: an indexed write, the same
    values as the reference's one-hot blend."""
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device), slot] = new[:, 0]
    return out


def decode_step_attention(params: dict, x: torch.Tensor, cache: dict, *,
                          n_heads: int, rope_theta: float = 1e4,
                          window: int = 0):
    """One-token decode.  x (B, 1, d); cache {"k", "v" (B, S, Hkv, D),
    "len" (B,)}.  Returns (y (B, 1, d), the new cache)."""
    if window:
        raise _not_ported("sliding-window attention")
    pos = cache["len"][:, None]
    q, k, v = project_qkv(params, x, pos, rope_theta)
    cap = cache["k"].shape[1]
    slot = torch.clamp_max(cache["len"], cap - 1).to(torch.int64)
    kc = _scatter_rows(cache["k"], slot, k)
    vc = _scatter_rows(cache["v"], slot, v)
    new_len = cache["len"] + 1
    eff = torch.clamp_max(new_len, cap)
    out = decode_attention_jnp(q[:, 0], kc, vc, eff)
    y = _out_proj(out, params["wo"])
    return y[:, None, :], {"k": kc, "v": vc, "len": new_len}
