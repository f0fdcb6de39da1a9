"""Foundational model layers over parameter dicts of tensors (twin of the
SSM and dense families' part of ``repro/models/layers.py``).

Conventions, as in the reference: parameters are stored in the model dtype
(bf16 by default); products accumulate in float32 and round once to the
dtype the reference writes (``preferred_element_type=float32`` then
``astype``) — a bf16 ``@`` is that function (cuBLAS accumulates in float32
and rounds once), so ``dense`` multiplies in the operands' dtype and only
``matmul_f32`` widens, where the reference keeps the float32 product;
normalisation and the rotary embedding run in float32.

The backend switches that change float results on the card are set by
``reference_numerics``, which the entry points call once
(``launch/serve.py``, ``chip_smoke.py``; building an ``LM`` changes no
process-wide setting):

* ``torch.backends.cuda.matmul.allow_tf32 = False``: float32 products stay
  float32 (the reference's float32 dots are full precision).
* ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
  False``: a bf16 product accumulates in float32 end to end and rounds
  once, as ``preferred_element_type=float32`` does; with it on, cuBLAS
  may reduce split-K partial sums in bf16.
* ``torch.backends.cudnn.allow_tf32 = False``: no convolution in the port
  uses cuDNN (the causal convolution is the reference's four shifted adds),
  so this only keeps a future one honest.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def reference_numerics() -> None:
    """Pin the backend switches above (process-wide PyTorch settings)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 product of ``a @ b`` for bf16 or float32 operands: the bf16
    values widen exactly, so this is the reference's bf16 product with
    ``preferred_element_type=float32`` kept in float32."""
    return a.to(F32) @ b.to(F32)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis, in x's dtype (float32 accumulation,
    one rounding)."""
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def init_rms_norm(d: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rope_frequencies(d_head: int, theta: float = 1e4,
                     device=None) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=device)
                            / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (..., S, H, D); positions (..., S) int.  Rotates the two halves
    of D in float32 and casts back to x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (D/2,)
    ang = positions[..., None].to(F32) * freqs                   # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def gated_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP (llama family): silu in float32, cast back."""
    h = dense(x, params["w_gate"])
    g = F.silu(h.to(F32)).to(x.dtype)
    u = dense(x, params["w_up"])
    return dense(g * u, params["w_down"])


def init_gated_mlp(gen: torch.Generator, d: int, ff: int,
                   dtype=torch.bfloat16, device=None,
                   layers: int | None = None) -> dict:
    """One MLP's parameters, or ``layers`` of them stacked on a leading
    axis; the reference's names, shapes and scales."""
    lead = () if layers is None else (layers,)
    s_in, s_ff = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    return {"w_gate": normal(gen, lead + (d, ff), s_in, dtype, device),
            "w_up": normal(gen, lead + (d, ff), s_in, dtype, device),
            "w_down": normal(gen, lead + (ff, d), s_ff, dtype, device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens.to(torch.int64)]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Returns float32 logits."""
    w = params.get("unembedding", params["embedding"])
    return matmul_f32(x, w.t())


def normal(gen: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
    """Standard normal float32 draws from ``gen``, scaled, in ``dtype``."""
    return (torch.randn(shape, generator=gen, dtype=F32, device=device)
            * scale).to(dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int, tie: bool,
               dtype=torch.bfloat16, device=None) -> dict:
    p = {"embedding": normal(gen, (vocab, d), 0.01, dtype, device)}
    if not tie:
        p["unembedding"] = normal(gen, (vocab, d), 0.01, dtype, device)
    return p
