"""The LM — twin of the SSM and dense families' part of
``repro/models/model.py``: embedding, the stacked SSM or dense (attention
+ gated MLP) blocks, the final norm and the unembedding, with the prefill
and decode entry points.

Parameters are a dict of tensors stacked ``(n_layers, ...)`` as the
reference's scanned layers are; ``models.convert.params_from_jax`` maps the
reference's pytree onto it.  The layers run as a Python loop over the
stack.  As in the reference, ``forward``/``prefill`` do NOT mask the
pad-vocab logits while ``decode_step`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from . import blocks as B
from .layers import F32, embed, init_embed, rms_norm, unembed
from .ssm import init_ssm_cache


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter or cache dict (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class LM:
    """The SSM- or dense-family LM.  ``device`` None means the card (raises
    without CUDA); ``ssd_backend`` goes to ``kernels.ssd_scan`` ("auto":
    the CUDA kernel on the card, the plain version on the CPU; "plain":
    the plain version on either); ``q_chunk``/``kv_chunk`` are the dense
    family's flash-attention blocks.  The entry points, not ``LM``, pin
    the backend switches of ``layers.reference_numerics``."""

    def __init__(self, cfg: ArchConfig, *, q_chunk: int = 1024,
                 kv_chunk: int = 1024, ssd_chunk: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 vocab_pad_multiple: int = 128, pad_heads_multiple: int = 0,
                 device=None, ssd_backend: str = "auto"):
        if cfg.family not in ("ssm", "dense"):
            raise NotImplementedError(
                f"LM for the {cfg.family!r} family is not ported yet: the "
                "port runs the ssm and dense families only (ROADMAP A10)")
        if cfg.sliding_window or pad_heads_multiple:
            raise NotImplementedError(
                "sliding-window attention and padded heads are not ported "
                "yet (ROADMAP A10)")
        self.cfg = cfg
        self.q_chunk, self.kv_chunk = q_chunk, kv_chunk
        self.ssd_chunk = ssd_chunk
        self.dtype = dtype
        self.vocab_pad_multiple = vocab_pad_multiple
        self.device = resolve_device(device)
        self.ssd_backend = ssd_backend

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.cfg.vocab // m) * m

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        v = self.cfg.vocab
        if self.vocab_padded == v:
            return logits
        keep = torch.arange(self.vocab_padded, device=logits.device) < v
        return torch.where(keep, logits, -1e30)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn from ``generator`` (on ``self.device``),
        float32 draws scaled as the reference's and cast to the dtype."""
        cfg = self.cfg
        return {
            "embed": init_embed(generator, self.vocab_padded, cfg.d_model,
                                cfg.tie_embeddings, self.dtype, self.device),
            "final_norm": B.init_norm(cfg, self.dtype, self.device),
            "blocks": B.init_block(generator, cfg, cfg.family, self.dtype,
                                   self.device, layers=cfg.n_layers),
        }

    # ------------------------------------------------------------------
    # forward (prefill body)
    # ------------------------------------------------------------------

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    def hidden(self, params: dict, tokens, collect_cache: bool = False):
        """tokens (B,S) → (final-normed hidden states (B,S,d), the
        per-layer (k, v) stacked (L, B, S, Hkv, D) when ``collect_cache``
        and the family has attention, else None)."""
        cfg = self.cfg
        tokens = self._tokens(tokens)
        x = embed(params["embed"], tokens).to(self.dtype)
        ks, vs = [], []
        if cfg.family == "dense":
            b, s = tokens.shape
            positions = torch.arange(s, device=self.device)[None] \
                .expand(b, s)
        for i in range(cfg.n_layers):
            lp = layer(params["blocks"], i)
            if cfg.family == "ssm":
                x = B.fwd_ssm(lp, x, cfg, ssd_chunk=self.ssd_chunk,
                              backend=self.ssd_backend)
            else:
                x, (k, v) = B.fwd_dense(lp, x, positions, cfg,
                                        q_chunk=self.q_chunk,
                                        kv_chunk=self.kv_chunk)
                if collect_cache:
                    ks.append(k)
                    vs.append(v)
        caches = (torch.stack(ks), torch.stack(vs)) if ks else None
        return rms_norm(x, params["final_norm"]), caches

    def forward(self, params: dict, tokens, *, collect_cache: bool = False):
        """tokens (B,S) → (logits (B,S,V) f32, aux, caches): caches are the
        dense family's per-layer (k, v) stacked (L, B, S, Hkv, D) when
        ``collect_cache``, else None."""
        x, caches = self.hidden(params, tokens, collect_cache)
        logits = unembed(params["embed"], x)
        return logits, torch.zeros((), dtype=F32, device=self.device), caches

    def prefill(self, params: dict, tokens):
        """Prefill: (last-position logits (B,V) f32, aux).  The same values
        as ``forward(...)[0][:, -1]``; only the last position is
        unembedded.  No cache is returned, as in the reference."""
        x, _ = self.hidden(params, tokens)
        return (unembed(params["embed"], x[:, -1]),
                torch.zeros((), dtype=F32, device=self.device))

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int, *,
                   params: Optional[dict] = None, start_len=None) -> dict:
        """Empty (or pre-aged) caches.  SSM family: per layer the conv
        window and the SSD state (``cache_len`` unused, as in the
        reference).  Dense family: per layer the attention cache {"k",
        "v" (B, cache_len, Hkv, D), "len" (B,) int32}; ``start_len`` (B,)
        or a scalar pre-ages "len"."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"layers": init_ssm_cache(
                batch, cfg.d_model, state=cfg.ssm_state,
                headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
                conv_width=cfg.conv_width, dtype=self.dtype,
                device=self.device, layers=cfg.n_layers)}
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                 cfg.head_dim)
        ln = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        if start_len is not None:
            ln = ln + torch.as_tensor(start_len, dtype=torch.int32,
                                      device=self.device)
        return {"layers": {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "len": ln[None].repeat(cfg.n_layers, 1)}}

    def decode_step(self, params: dict, cache: dict,
                    tokens) -> tuple[torch.Tensor, dict]:
        """tokens (B,1) → (logits (B,V) f32 with the pad vocab masked, new
        cache)."""
        cfg = self.cfg
        step = B.dec_ssm if cfg.family == "ssm" else B.dec_dense
        x = embed(params["embed"], self._tokens(tokens)).to(self.dtype)
        new = {k: [] for k in cache["layers"]}
        for i in range(cfg.n_layers):
            x, nc = step(layer(params["blocks"], i), x,
                         layer(cache["layers"], i), cfg)
            for k, v in nc.items():
                new[k].append(v)
        x = rms_norm(x, params["final_norm"])
        logits = self._mask_pad_logits(unembed(params["embed"], x))[:, 0]
        return logits, {"layers": {k: torch.stack(v) for k, v in
                                   new.items()}}
