"""The LM — twin of the SSM family's part of ``repro/models/model.py``:
embedding, the stacked SSM blocks, the final norm and the unembedding,
with the prefill and decode entry points.

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
    """The SSM-family LM.  ``device`` None means the card (raises without
    CUDA); ``ssd_backend`` goes to ``kernels.ssd_scan`` ("auto": the CUDA
    kernel on the card, the plain version on the CPU; "plain": the plain
    version on either).  The entry points, not ``LM``, pin the backend
    switches of ``layers.reference_numerics``."""

    def __init__(self, cfg: ArchConfig, *, ssd_chunk: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 vocab_pad_multiple: int = 128, device=None,
                 ssd_backend: str = "auto"):
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"LM for the {cfg.family!r} family is not ported yet: the "
                "port runs the ssm family only (ROADMAP A10)")
        self.cfg = cfg
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
            "blocks": B.init_block(generator, cfg, "ssm", self.dtype,
                                   self.device, layers=cfg.n_layers),
        }

    # ------------------------------------------------------------------
    # forward (prefill body)
    # ------------------------------------------------------------------

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    def hidden(self, params: dict, tokens) -> torch.Tensor:
        """tokens (B,S) → final-normed hidden states (B,S,d)."""
        x = embed(params["embed"], self._tokens(tokens)).to(self.dtype)
        for i in range(self.cfg.n_layers):
            x = B.fwd_ssm(layer(params["blocks"], i), x, self.cfg,
                          ssd_chunk=self.ssd_chunk, backend=self.ssd_backend)
        return rms_norm(x, params["final_norm"])

    def forward(self, params: dict, tokens):
        """tokens (B,S) → (logits (B,S,V) f32, aux, None)."""
        logits = unembed(params["embed"], self.hidden(params, tokens))
        return logits, torch.zeros((), dtype=F32, device=self.device), None

    def prefill(self, params: dict, tokens):
        """Prefill: (last-position logits (B,V) f32, aux).  The same values
        as ``forward(...)[0][:, -1]``; only the last position is
        unembedded.  No cache is returned, as in the reference."""
        x = self.hidden(params, tokens)
        return (unembed(params["embed"], x[:, -1]),
                torch.zeros((), dtype=F32, device=self.device))

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, cache_len: int, *,
                   params: Optional[dict] = None) -> dict:
        """Empty caches: per layer the conv window and the SSD state
        (``cache_len`` is unused by the SSM family, as in the reference)."""
        cfg = self.cfg
        return {"layers": init_ssm_cache(
            batch, cfg.d_model, state=cfg.ssm_state, headdim=cfg.ssm_headdim,
            expand=cfg.ssm_expand, conv_width=cfg.conv_width,
            dtype=self.dtype, device=self.device, layers=cfg.n_layers)}

    def decode_step(self, params: dict, cache: dict,
                    tokens) -> tuple[torch.Tensor, dict]:
        """tokens (B,1) → (logits (B,V) f32 with the pad vocab masked, new
        cache)."""
        x = embed(params["embed"], self._tokens(tokens)).to(self.dtype)
        new = {"conv": [], "h": []}
        for i in range(self.cfg.n_layers):
            x, nc = B.dec_ssm(layer(params["blocks"], i), x,
                              layer(cache["layers"], i), self.cfg)
            new["conv"].append(nc["conv"])
            new["h"].append(nc["h"])
        x = rms_norm(x, params["final_norm"])
        logits = self._mask_pad_logits(unembed(params["embed"], x))[:, 0]
        return logits, {"layers": {k: torch.stack(v) for k, v in
                                   new.items()}}
