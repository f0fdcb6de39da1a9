"""Per-family blocks (full-sequence + decode variants) — twin of the SSM
and dense families' part of ``repro/models/blocks.py``.  The other
families raise ``NotImplementedError`` (ROADMAP A10)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

from .attention import (attention_layer, decode_step_attention,
                        init_attention)
from .layers import gated_mlp, init_gated_mlp, init_rms_norm, rms_norm
from .ssm import decode_step_ssm, init_ssm, ssm_layer


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet: the port runs "
                               "the ssm and dense families only (ROADMAP "
                               "A10)")


def _norm(cfg: ArchConfig, params, x, which: str):
    if cfg.norm != "rms":
        raise _not_ported(f"norm {cfg.norm!r}")
    return rms_norm(x, params[which])


def init_norm(cfg: ArchConfig, dtype=torch.bfloat16, device=None,
              layers: int | None = None) -> torch.Tensor:
    if cfg.norm != "rms":
        raise _not_ported(f"norm {cfg.norm!r}")
    if layers is None:
        return init_rms_norm(cfg.d_model, dtype, device)
    return torch.ones((layers, cfg.d_model), dtype=dtype, device=device)


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str,
               dtype=torch.bfloat16, device=None,
               layers: int | None = None) -> dict:
    """One block's parameters, or ``layers`` blocks stacked on a leading
    axis (the reference's vmapped init)."""
    if kind == "ssm":
        return {"norm1": init_norm(cfg, dtype, device, layers),
                "ssm": init_ssm(gen, cfg.d_model, state=cfg.ssm_state,
                                headdim=cfg.ssm_headdim,
                                expand=cfg.ssm_expand,
                                conv_width=cfg.conv_width, dtype=dtype,
                                device=device, layers=layers)}
    if kind == "dense":
        return {"norm1": init_norm(cfg, dtype, device, layers),
                "norm2": init_norm(cfg, dtype, device, layers),
                "attn": init_attention(gen, cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim,
                                       cfg.qkv_bias, cfg.qk_norm, dtype,
                                       device, layers),
                "mlp": init_gated_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                      device, layers)}
    raise _not_ported(f"block kind {kind!r}")


def fwd_dense(params, x, positions, cfg: ArchConfig, *, q_chunk, kv_chunk):
    h, kv = attention_layer(params["attn"], _norm(cfg, params, x, "norm1"),
                            positions, n_heads=cfg.n_heads,
                            rope_theta=cfg.rope_theta,
                            window=cfg.sliding_window,
                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    x = x + h
    x = x + gated_mlp(params["mlp"], _norm(cfg, params, x, "norm2"))
    return x, kv


def fwd_ssm(params, x, cfg: ArchConfig, *, ssd_chunk, backend="auto"):
    h = ssm_layer(params["ssm"], _norm(cfg, params, x, "norm1"),
                  state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                  expand=cfg.ssm_expand, chunk=ssd_chunk, backend=backend)
    return x + h


def dec_ssm(params, x, cache, cfg: ArchConfig):
    h, new_cache = decode_step_ssm(
        params["ssm"], _norm(cfg, params, x, "norm1"), cache,
        state=cfg.ssm_state, headdim=cfg.ssm_headdim, expand=cfg.ssm_expand)
    return x + h, new_cache


def dec_dense(params, x, cache, cfg: ArchConfig):
    h, new_cache = decode_step_attention(
        params["attn"], _norm(cfg, params, x, "norm1"), cache,
        n_heads=cfg.n_heads, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window)
    x = x + h
    x = x + gated_mlp(params["mlp"], _norm(cfg, params, x, "norm2"))
    return x, new_cache
