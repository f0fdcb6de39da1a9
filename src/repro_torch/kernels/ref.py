"""Plain oracles (twin of ``repro/kernels/ref.py``): the segment
contracts the kernels and their plain versions are held against, written
as directly as torch allows; the two SSD scans — the chunked dual form
``ssd_scan_chunked`` (the plain version of the SSD kernel) and the
sequential recurrence ``ssd_scan_ref`` (its oracle); and the two decode
attentions — ``decode_attention_chunked`` (the plain version of the
flash-decode kernel) and the float32 softmax ``decode_attention_ref`` (its
oracle)."""
from __future__ import annotations

import torch


def _segment(x, segs, num_segments, how, ident):
    out = torch.full((num_segments,), ident, dtype=x.dtype, device=x.device)
    idx = segs.to(torch.int64)
    if how == "sum":
        return out.index_add_(0, idx, x)
    return out.scatter_reduce_(0, idx, x, how)


def segment_agg_ref(vals: torch.Tensor, segs: torch.Tensor,
                    valid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[sum, count, min, max] per segment, (4, num_segments) f32."""
    v = vals.to(torch.float32)
    valid = valid.to(torch.bool)
    inf = float("inf")
    s = _segment(torch.where(valid, v, 0.0), segs, num_segments, "sum", 0.0)
    c = _segment(valid.to(torch.float32), segs, num_segments, "sum", 0.0)
    mn = _segment(torch.where(valid, v, inf), segs, num_segments, "amin", inf)
    mx = _segment(torch.where(valid, v, -inf), segs, num_segments, "amax",
                  -inf)
    return torch.stack([s, c, mn, mx])


def fused_segment_agg_ref(vals: torch.Tensor, segs: torch.Tensor,
                          valid: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Multi-column oracle: (N, C) vals, (N, C) per-column validity →
    (C, 4, num_segments) f32 with moment rows [sum, count, min, max]."""
    return torch.stack([segment_agg_ref(vals[:, c], segs, valid[:, c],
                                        num_segments)
                        for c in range(vals.shape[1])])


def segment_arg_index_ref(keys: torch.Tensor, segs: torch.Tensor,
                          valid: torch.Tensor, num_segments: int, *,
                          minimize: bool, tie_first: bool) -> torch.Tensor:
    """The row attaining each segment's key extremum, first- or
    last-attaining on ties, valid rows only — the classic hit-detection
    formulation.  Returns int64 with the empty-segment sentinel ``n`` for
    first-attaining order, ``-1`` for last-attaining."""
    n = keys.shape[0]
    k = keys.to(torch.float32)
    valid = valid.to(torch.bool)
    worst = float("inf") if minimize else float("-inf")
    masked = torch.where(valid, k, worst)
    best = _segment(masked, segs, num_segments,
                    "amin" if minimize else "amax", worst)
    hit = valid & (masked == best[segs.to(torch.int64)])
    idx = torch.arange(n, device=keys.device)
    if tie_first:
        return _segment(torch.where(hit, idx, n), segs, num_segments,
                        "amin", n)
    return _segment(torch.where(hit, idx, -1), segs, num_segments, "amax",
                    -1)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """Masked softmax attention, float32 throughout.  q (BH, G, D); k, v
    (BH, S, D); kv_len (BH,) → (BH, G, D) in q's dtype.  A row with
    kv_len = 0 is NaN (softmax over no position), as in the reference."""
    d, s = q.shape[-1], k.shape[1]
    scale = 1.0 / (d ** 0.5)
    f32 = torch.float32
    logits = (q.to(f32) @ k.to(f32).transpose(1, 2)) * scale     # (BH,G,S)
    mask = torch.arange(s, device=q.device)[None, None, :] \
        < kv_len.to(q.device)[:, None, None]
    logits = torch.where(mask, logits, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return (w @ v.to(f32)).to(q.dtype)


def decode_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_len: torch.Tensor,
                             chunk: int = 128) -> torch.Tensor:
    """The flash-decode kernel's own contract
    (``repro/kernels/decode_attn.py:38-74``) in plain torch: an online
    softmax over KV chunks of ``chunk`` with m, l and acc in float32; the
    scale applied after the product; positions at or past kv_len masked
    and the all-masked chunk guarded; the UNnormalised p rounded to v's
    dtype before p·v while l sums the unrounded p; out = acc / max(l,
    1e-30) in q's dtype, so a row with kv_len = 0 is zeros.  q (BH, G, D);
    k, v (BH, S, D); kv_len (BH,).  (The reference pads S to a multiple of
    ``chunk``; the last chunk here is shorter, the same function.)"""
    bh, g, d = q.shape
    s = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    f32, inf = torch.float32, float("inf")
    lens = kv_len.to(device=q.device, dtype=torch.int64)[:, None, None]
    qf = q.to(f32)
    m = torch.full((bh, g, 1), -inf, dtype=f32, device=q.device)
    l = torch.zeros((bh, g, 1), dtype=f32, device=q.device)
    acc = torch.zeros((bh, g, d), dtype=f32, device=q.device)
    for j0 in range(0, s, chunk):
        kc, vc = k[:, j0:j0 + chunk], v[:, j0:j0 + chunk]
        sc = (qf @ kc.to(f32).transpose(1, 2)) * scale           # (BH,G,C)
        pos = torch.arange(j0, j0 + kc.shape[1], device=q.device)
        sc = torch.where(pos[None, None, :] < lens, sc, -inf)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(torch.where(torch.isfinite(sc), sc - m_safe, -inf))
        alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -inf))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).to(f32) @ vc.to(f32)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _bc_heads(x: torch.Tensor, b: torch.Tensor) -> int:
    """Batch-heads sharing one B/C row: 1 for the (BH, T, N) layout, H
    when B and C are (BH / H, T, N) and row bh reads B[bh // H]."""
    bh, g = x.shape[0], b.shape[0]
    if g < 1 or bh % g:
        raise ValueError(f"B/C rows ({g}) must divide the batch-heads ({bh})")
    return bh // g


def ssd_scan_chunked(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Chunked SSD in plain torch: the dual form of the kernel (products
    inside a chunk, the carried state merged across chunks), all in
    float32, y returned in x's dtype.  x (BH, T, P); log_a (BH, T);
    b, c (BH, T, N), or (BH / H, T, N) shared by H consecutive
    batch-heads.  T must be a multiple of ``chunk``."""
    bh, t, p = x.shape
    n = b.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} must be a multiple of chunk={chunk}")
    heads = _bc_heads(x, b)
    g, nc = bh // heads, t // chunk
    f32 = torch.float32
    xc = x.reshape(g, heads, nc, chunk, p).to(f32)
    lac = log_a.reshape(g, heads, nc, chunk, 1).to(f32)
    bc = b.reshape(g, 1, nc, chunk, n).to(f32)
    cc = c.reshape(g, 1, nc, chunk, n).to(f32)

    la = torch.cumsum(lac, dim=3)                         # (G,H,NC,C,1)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.where(causal, torch.exp(la - la.transpose(3, 4)), 0.0)
    scores = (cc @ bc.transpose(3, 4)) * decay            # (G,H,NC,C,C)
    del decay
    y = scores @ xc                                       # intra-chunk
    del scores

    # carried state across chunks (the associative Merge)
    la_last = la[:, :, :, -1:, :]                         # (G,H,NC,1,1)
    w = torch.exp(la_last - la)                           # (G,H,NC,C,1)
    chunk_state = (bc * w).transpose(3, 4) @ xc           # (G,H,NC,N,P)
    chunk_decay = torch.exp(la_last[..., 0, 0])           # (G,H,NC)
    h = torch.zeros((g, heads, n, p), dtype=f32, device=x.device)
    for j in range(nc):
        y[:, :, j] += (cc[:, :, j] @ h) * torch.exp(la[:, :, j])
        h = chunk_decay[:, :, j, None, None] * h + chunk_state[:, :, j]
    return y.reshape(bh, t, p).to(x.dtype)


def ssd_scan_ref(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """Sequential SSD recurrence h_t = a_t h_{t-1} + B_t (x) x_t,
    y_t = C_t . h_t, one step at a time, in float32 (float64 for float64
    inputs); y in x's dtype.  Same layouts as ``ssd_scan_chunked``."""
    bh, t, p = x.shape
    n = b.shape[-1]
    heads = _bc_heads(x, b)
    acc = torch.promote_types(x.dtype, torch.float32)
    xs, la = x.to(acc), log_a.to(acc)
    bs = b.to(acc).repeat_interleave(heads, dim=0)
    cs = c.to(acc).repeat_interleave(heads, dim=0)
    h = torch.zeros((bh, n, p), dtype=acc, device=x.device)
    y = torch.empty((bh, t, p), dtype=acc, device=x.device)
    for i in range(t):
        h = torch.exp(la[:, i])[:, None, None] * h \
            + bs[:, i, :, None] * xs[:, i, None, :]
        y[:, i] = (cs[:, i, None, :] @ h)[:, 0]
    return y.to(x.dtype)
