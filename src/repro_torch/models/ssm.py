"""Mamba-2 (SSD) layer — twin of ``repro/models/ssm.py``.

Layer structure (Mamba-2):
    projections -> z, x, B, C, dt
    conv1d(x), conv1d(B|C)  (causal depthwise, width 4)
    SSD scan over heads: h_t = exp(-softplus(dt_t)·A) h_{t-1} + dt·B_t⊗x_t
    y = C_t·h_t + D·x_t ;  out = out_proj(rms_norm(y * silu(z)))

``ssm_layer`` is the reference's kernel-layout branch (``ssm.py:172-191``):
batch and heads fold into one axis and the scan runs through
``kernels.ssd_scan`` — the CUDA kernel on the card, its plain version on
the CPU.  The reference's other branch, ``_ssd_chunked_4d``, is its
tensor-parallel (B, S, H, P) layout and waits for the sharded LM (ROADMAP
A10).

Numerics contract, the reference's kernel route exactly: the projections
round to the input dtype (dt stays float32); the convolution accumulates in
float32, applies silu, then casts; ``xh·dt`` is cast to x's dtype before the
scan and the scan returns that dtype; the skip term is added in float32 and
the sum cast to the input dtype.  softplus is ``logaddexp(x, 0)``, as JAX
computes it (torch's ``softplus`` switches to the identity above 20; the
two differ by under 3e-9 there).

Decode keeps (conv window, SSD state) as the cache — O(1) per token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan

from .layers import F32, matmul_f32, normal, rms_norm


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def init_ssm(gen: torch.Generator, d: int, *, state: int, headdim: int,
             expand: int, conv_width: int, dtype=torch.bfloat16, device=None,
             layers: int | None = None) -> dict:
    """Parameters of one SSM sublayer, or of ``layers`` of them stacked on
    a leading axis; the same names, shapes and scales as the reference
    (random values of the port's own generator)."""
    d_inner = expand * d
    n_heads = d_inner // headdim
    lead = () if layers is None else (layers,)
    s = 1.0 / math.sqrt(d)

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        "w_zx": normal(gen, lead + (d, 2, d_inner), s, dtype, device),
        "w_bc": normal(gen, lead + (d, 2 * state), s, dtype, device),
        "w_dt": normal(gen, lead + (d, n_heads), s, dtype, device),
        "conv_w": normal(gen, lead + (conv_width, d_inner + 2 * state), 0.2,
                         dtype, device),
        "conv_b": full((d_inner + 2 * state,), 0.0, dtype),
        "a_log": full((n_heads,), 0.0, F32),          # A = -exp(a_log)
        "dt_bias": full((n_heads,), 0.0, F32),
        "d_skip": full((n_heads,), 1.0, F32),
        "norm": full((d_inner,), 1.0, dtype),
        "w_out": normal(gen, lead + (d_inner, d), 1.0 / math.sqrt(d_inner),
                        dtype, device),
    }


def _project_in(params, x_in):
    w_zx = params["w_zx"]
    d, _, d_inner = w_zx.shape
    zx = (x_in @ w_zx.reshape(d, 2 * d_inner)).unflatten(-1, (2, d_inner))
    z, x = zx[..., 0, :], zx[..., 1, :]
    bc = x_in @ params["w_bc"]
    dt = matmul_f32(x_in, params["w_dt"])
    return z, x, bc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time: xbc (B,S,C); w (W,C).  Four
    shifted adds in float32, as the reference (no cuDNN, no TF32)."""
    width, s_len = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=F32, device=xbc.device)
    for i in range(width):
        out += pad[:, i:i + s_len, :].to(F32) * w[i].to(F32)
    return F.silu(out + b.to(F32)).to(xbc.dtype)


def ssm_layer(params: dict, x_in: torch.Tensor, *, state: int, headdim: int,
              expand: int, chunk: int = 64,
              backend: str = "auto") -> torch.Tensor:
    """Full-sequence SSD (prefill).  x_in (B,S,d).  ``backend`` goes to
    ``kernels.ssd_scan``."""
    b_sz, s_len, d = x_in.shape
    d_inner = expand * d
    n_heads = d_inner // headdim

    z, x, bc, dt = _project_in(params, x_in)
    x = _causal_conv(x, params["conv_w"][:, :d_inner],
                     params["conv_b"][:d_inner])
    bc = _causal_conv(bc, params["conv_w"][:, d_inner:],
                      params["conv_b"][d_inner:])
    bmat, cmat = bc[..., :state], bc[..., state:]

    dt = _softplus(dt + params["dt_bias"])                       # (B,S,H)
    a = -torch.exp(params["a_log"])                              # (H,)
    log_decay = dt * a                                           # (B,S,H) ≤ 0

    xh = x.reshape(b_sz, s_len, n_heads, headdim)
    xh_dt = (xh.to(F32) * dt[..., None]).to(x.dtype)

    # kernel layout: fold (B·H) into one axis; B and C stay (B, S, N),
    # shared by the H heads of each batch row (the reference broadcasts
    # them to (B·H, S, N), the same function)
    xs = xh_dt.permute(0, 2, 1, 3).reshape(b_sz * n_heads, s_len, headdim)
    las = log_decay.permute(0, 2, 1).reshape(b_sz * n_heads, s_len)
    pad = (-s_len) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        las = F.pad(las, (0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    y = ssd_scan(xs, las, bmat, cmat, chunk=chunk, backend=backend)
    y = y[:, :s_len].reshape(b_sz, n_heads, s_len, headdim) \
        .permute(0, 2, 1, 3)
    y = y.to(F32) + xh.to(F32) * params["d_skip"][None, None, :, None]
    y = y.reshape(b_sz, s_len, d_inner).to(x_in.dtype)

    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), params["norm"])
    return y @ params["w_out"]


def init_ssm_cache(batch: int, d: int, *, state: int, headdim: int,
                   expand: int, conv_width: int, dtype=torch.bfloat16,
                   device=None, layers: int | None = None) -> dict:
    d_inner = expand * d
    n_heads = d_inner // headdim
    lead = () if layers is None else (layers,)
    return {
        "conv": torch.zeros(lead + (batch, conv_width - 1,
                                    d_inner + 2 * state),
                            dtype=dtype, device=device),
        "h": torch.zeros(lead + (batch, n_heads, state, headdim), dtype=F32,
                         device=device),
    }


def decode_step_ssm(params: dict, x_in: torch.Tensor, cache: dict, *,
                    state: int, headdim: int, expand: int
                    ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x_in (B,1,d)."""
    b_sz, _, d = x_in.shape
    d_inner = expand * d
    n_heads = d_inner // headdim

    z, x, bc, dt = _project_in(params, x_in)
    xbc_new = torch.cat([x, bc], dim=-1)                         # (B,1,C)

    # conv window update
    win = torch.cat([cache["conv"], xbc_new], dim=1)             # (B,W,C)
    conv_out = torch.sum(win.to(F32) * params["conv_w"].to(F32)[None],
                         dim=1) + params["conv_b"].to(F32)       # (B,C)
    xbc = F.silu(conv_out).to(x_in.dtype)
    x1, b1, c1 = (xbc[:, :d_inner], xbc[:, d_inner:d_inner + state],
                  xbc[:, d_inner + state:])

    dt1 = _softplus(dt[:, 0] + params["dt_bias"])                # (B,H)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt1 * a)                                   # (B,H)

    xh = x1.reshape(b_sz, n_heads, headdim).to(F32)
    upd = b1.to(F32)[:, None, :, None] * (xh * dt1[..., None])[:, :, None, :]
    h = cache["h"] * decay[..., None, None] + upd                # (B,H,N,P)
    y = (c1.to(F32)[:, None, None, :] @ h)[:, :, 0]              # (B,H,P)
    y = y + xh * params["d_skip"][None, :, None]
    y = y.reshape(b_sz, d_inner)

    y = rms_norm((y * F.silu(z[:, 0].to(F32))).to(x_in.dtype),
                 params["norm"])
    out = y @ params["w_out"]
    return out[:, None, :], {"conv": win[:, 1:], "h": h}
