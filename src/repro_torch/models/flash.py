"""Blockwise (flash-style) attention, forward only — twin of the forward of
``repro/models/flash.py`` (``_flash_fwd``, ``flash.py:59-105``).

An online-softmax accumulation over KV blocks (the Aggregate of the
paper's contract, on the sequence axis): per block of ``q_chunk`` query
positions, m, l and acc in float32 over blocks of ``kv_chunk`` keys, the
masked logits at ``NEG_INF = -1e30`` (finite, as the reference's), p
rounded to v's dtype before p·v.  GQA groups the H query heads over the
Hkv KV heads without expanding KV.  Plain tensor ops: the reference's
forward is XLA, not a Pallas kernel.

Under the causal mask a KV block wholly after a query block contributes
p = exp(-1e30 - m) = 0 exactly and alpha = 1, so it is skipped — the same
function.  The two-pass backward (``flash.py:108``) comes with training
(ROADMAP A10); so does sliding-window masking.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, Skv, Hkv, D) → out (B, S, H, D) in q's
    dtype."""
    if window:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet (ROADMAP A10)")
    b, s, h, d = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, s_kv)
    qg = q.reshape(b, s, hkv, g, d).permute(0, 2, 3, 1, 4)   # (B,Hkv,G,S,D)
    kt = k.permute(0, 2, 1, 3)                               # (B,Hkv,Skv,D)
    vt = v.permute(0, 2, 1, 3)
    out = torch.empty((b, hkv, g, s, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, s, q_chunk):
        qi = qg[:, :, :, q0:q0 + q_chunk].to(F32)            # (B,Hkv,G,qc,D)
        qc = qi.shape[3]
        q_pos = torch.arange(q0, q0 + qc, device=q.device)
        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((b, hkv, g, qc), dtype=F32, device=q.device)
        acc = torch.zeros((b, hkv, g, qc, d), dtype=F32, device=q.device)
        for k0 in range(0, s_kv, kv_chunk):
            if causal and k0 > q0 + qc - 1:
                break                       # every key after every query
            ki = kt[:, :, None, k0:k0 + kv_chunk]            # (B,Hkv,1,kc,D)
            vi = vt[:, :, None, k0:k0 + kv_chunk]
            logits = (qi @ ki.to(F32).transpose(-1, -2)) * scale
            if causal:
                kv_pos = torch.arange(k0, k0 + ki.shape[3], device=q.device)
                mask = q_pos[:, None] >= kv_pos[None, :]
                logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = p.to(v.dtype).to(F32) @ vi.to(F32)
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, :, :, q0:q0 + qc] = o.to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
