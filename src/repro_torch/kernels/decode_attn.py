"""Flash-decode attention: one GQA decode step as an online-softmax
aggregate over the KV cache (Init / Accumulate / Merge / Terminate on the
sequence axis).  Twin of ``repro/kernels/decode_attn.py``.

A group of G query heads sharing one KV head attends an S-long cache::

    s = (q·k_j) / sqrt(D);  out = Σ_{j < kv_len} softmax(s)_j v_j

with the TPU kernel's numerics: m, l and acc in float32, the unnormalised
p rounded to v's dtype before p·v, out = acc / max(l, 1e-30) in q's dtype
(so kv_len = 0 gives zeros).

``decode_attention_cuda`` wraps the hand-written CUDA kernel
(``csrc/decode_attn.cu``), which replaces the Pallas
``_decode_attn_kernel`` (``src/repro/kernels/decode_attn.py:38``).  Bound:
bytes — K and V up to each row's kv_len, read once.  Design: split-KV
flash-decoding — a grid of (splits, BH) blocks, each walking its split of
the cache in shared-memory tiles for all G heads at once and writing a
partial (m, l, acc), then a second launch merging a row's splits by
log-sum-exp (``softmax_aggregate``'s Merge); splits past kv_len are not
read.  See the source.

``ref.decode_attention_chunked`` is the plain version with the kernel's
contract.  ``decode_attention`` takes it for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises, unless the caller names
``backend="plain"`` itself.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import decode_attention_chunked

#: threads of one block, bytes of K (and of V) one tile stages at most,
#: and dynamic shared memory one Hopper block may use (``csrc/decode_attn.cu``)
_THREADS, _TILE_BYTES, SMEM_LIMIT = 128, 16384, 232_448
#: the split-size heuristic: splits of at least this many positions, at most
#: ``_MAX_SPLIT``, aiming at this many blocks over the card's 132 SMs
_MIN_SPLIT, _MAX_SPLIT, _TARGET_BLOCKS = 128, 4096, 132 * 16

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def tile_rows(d: int, esize: int) -> int:
    """KV positions of one shared-memory tile: the largest power of two up
    to min(128, 16 KB / (D · element size))."""
    cap = min(_THREADS, _TILE_BYTES // (d * esize))
    return 1 << (cap.bit_length() - 1)


def smem_bytes(tk: int, g: int, d: int, esize: int) -> int:
    """Shared memory of one split block: the K and V tiles (rows padded by
    16 bytes per thread sharing a key), q widened to float32, the scores
    of the tile and m, l, alpha."""
    rb = d * esize + 16 * (_THREADS // tk)
    return 2 * tk * rb + 4 * (g * d + g * tk + 3 * 16)


def default_split(bh: int, s: int) -> int:
    """Positions per split: S · BH spread over about ``_TARGET_BLOCKS``
    blocks, a multiple of 128 between 128 and 4096."""
    want = -(-bh * s // _TARGET_BLOCKS)
    return min(_MAX_SPLIT, max(_MIN_SPLIT, -(-want // 128) * 128))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: torch.Tensor,
                          split: int | None = None) -> torch.Tensor:
    """CUDA kernel.  ``q`` (BH, G, D), ``k`` and ``v`` (BH, S, D) in one
    dtype, float32 or bfloat16, and ``kv_len`` (BH,) int32, all contiguous
    on the card; kv_len is clamped to [0, S].  ``split``: positions per
    split, a multiple of 128 (default ``default_split``).
    → out (BH, G, D) in q's dtype."""
    from .build import load
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_len", kv_len)):
        if not t.is_cuda:
            raise ValueError(f"decode_attention_cuda: {name} must be a CUDA "
                             "tensor")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention_cuda: {name} must be "
                             "contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention_cuda: q must be float32 or "
                         f"bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("decode_attention_cuda: q, k and v must share one "
                         "dtype")
    if kv_len.dtype != torch.int32:
        raise ValueError(f"decode_attention_cuda: kv_len must be int32, got "
                         f"{kv_len.dtype}")
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError("decode_attention_cuda: q must be (BH, G, D) and "
                         "k, v (BH, S, D)")
    bh, g, d = q.shape
    s = k.shape[1]
    if k.shape != (bh, s, d) or v.shape != k.shape or kv_len.shape != (bh,):
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)} do not match")
    esize = q.element_size()
    if not (1 <= g <= 16 and 1 <= d <= 256) or (d * esize) % 16 or s < 1:
        raise ValueError(f"decode_attention_cuda: G={g} must be in [1, 16], "
                         f"D={d} in [1, 256] with D·{esize} bytes a multiple "
                         "of 16 (the kernel loads 16 bytes at a time), S >= 1")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention_cuda: q, k and v must start on "
                         "16-byte boundaries")
    split = default_split(bh, s) if split is None else split
    if split < 128 or split % 128:
        raise ValueError(f"decode_attention_cuda: split={split} must be a "
                         "positive multiple of 128")
    n_split = -(-s // split)
    if bh >= 1 << 16 or k.numel() >= 1 << 40 or n_split >= 1 << 31:
        raise ValueError("decode_attention_cuda: input too large")
    tk = tile_rows(d, esize)
    if smem_bytes(tk, g, d, esize) > SMEM_LIMIT:
        raise ValueError("decode_attention_cuda: block does not fit shared "
                         "memory")
    out = torch.empty_like(q)
    # partial (m, l, acc) of every split, merged by the second launch
    pm = torch.empty((bh, n_split, g), dtype=torch.float32, device=q.device)
    pl = torch.empty_like(pm)
    pacc = torch.empty((bh, n_split, g, d), dtype=torch.float32,
                       device=q.device)
    fn = getattr(load("decode_attn"),
                 "decode_attn_bf16" if q.dtype == torch.bfloat16
                 else "decode_attn_f32")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), out.data_ptr(),
             bh, s, g, d, split, tk, 1.0 / (d ** 0.5),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_cuda: CUDA error {err} at "
                           "launch")
    decode_attention_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
decode_attention_cuda.launches = 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, chunk: int = 128, *,
                     backend: str = "auto") -> torch.Tensor:
    """q (BH, G, D); k, v (BH, S, D); kv_len (BH,) → out (BH, G, D) in q's
    dtype.  BH folds batch × KV heads; G is the GQA group size; S the
    cache capacity.  ``backend``: ``"auto"`` launches the CUDA kernel for
    a CUDA tensor and runs the plain version (in KV chunks of ``chunk``)
    for a CPU tensor; ``"plain"`` is the caller's own request for the
    plain version on either device."""
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown decode_attention backend {backend!r}")
    if backend == "plain" or not q.is_cuda:
        return decode_attention_chunked(q, k, v, kv_len, chunk)
    return decode_attention_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(),
                                 kv_len.to(torch.int32).contiguous())
