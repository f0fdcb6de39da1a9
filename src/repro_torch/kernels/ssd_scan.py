"""Chunked SSD (state-space duality) scan: the Mamba-2 layer's sequence
mixer, the ordered aggregate with an associative Merge.  Twin of
``repro/kernels/ssd_scan.py``.

For each batch-head and chunk, with ``la = cumsum(log_a)``::

    y      = ((C B^T) * causal e^{la_t - la_s}) x + e^{la} * (C h)
    h_new  = e^{la_last} h + (B * e^{la_last - la})^T x

with h carried in order across chunks, every intermediate in float32 and
y returned in x's dtype.

``ssd_scan_cuda`` wraps the hand-written CUDA kernel
(``csrc/ssd_scan.cu``), which replaces the Pallas ``_ssd_kernel``
(``src/repro/kernels/ssd_scan.py:39``).  Bound: operations, on the float32
cores (the numerics contract keeps every intermediate in float32).  Design:
the scores C·Bᵀ of every chunk once per B/C row (shared by the heads),
then one block per (batch-head, 32 output channels) loops over its chunks
with its slice of the state in shared memory; see the source.

``ref.ssd_scan_chunked`` is the plain version with the same arithmetic.
``ssd_scan`` takes it for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises, unless the caller names
``backend="plain"`` itself.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import _bc_heads, ssd_scan_chunked

#: output channels per block and rows per score tile (``csrc/ssd_scan.cu``)
_PT, _RT = 32, 32
#: dynamic shared memory one Hopper block may use, in bytes
SMEM_LIMIT = 232_448

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def smem_bytes(chunk: int, n: int) -> int:
    """Shared memory of one scan block: B^T and C^T (N x (chunk + 1)), x
    (chunk x 32), the state (N x 32), a score tile (min(chunk, 32) x
    (chunk + 1)) and the cumulative log-decay (chunk), all float32.  (The
    scores kernel needs less: B^T and C^T at stride chunk + 4.)"""
    ld, rt = chunk + 1, min(chunk, _RT)
    return 4 * (2 * n * ld + chunk * _PT + n * _PT + rt * ld + chunk)


def ssd_scan_cuda(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, chunk: int) -> torch.Tensor:
    """CUDA kernel.  ``x`` (BH, T, P) and ``b``, ``c`` (BH / H, T, N) in
    one dtype, float32 or bfloat16; ``log_a`` (BH, T) float32; all
    contiguous on the card.  → y (BH, T, P) in x's dtype."""
    from .build import load
    for name, t in (("x", x), ("log_a", log_a), ("b", b), ("c", c)):
        if not t.is_cuda:
            raise ValueError(f"ssd_scan_cuda: {name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_cuda: {name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_scan_cuda: x must be float32 or bfloat16, "
                         f"got {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError("ssd_scan_cuda: x, b and c must share one dtype")
    if log_a.dtype != torch.float32:
        raise ValueError(f"ssd_scan_cuda: log_a must be float32, got "
                         f"{log_a.dtype}")
    bh, t, p = x.shape
    n = b.shape[-1]
    heads = _bc_heads(x, b)
    if log_a.shape != (bh, t) or b.shape != (bh // heads, t, n) \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan_cuda: shapes x {tuple(x.shape)}, log_a "
                         f"{tuple(log_a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not match")
    if chunk < 4 or chunk % 4 or (chunk > _RT and chunk % _RT) or t % chunk:
        raise ValueError(f"ssd_scan_cuda: chunk={chunk} must be a multiple "
                         f"of 4 (of {_RT} above {_RT}) dividing T={t}")
    vec = 16 // x.element_size()        # elements per 16-byte load
    if n % vec or p % vec or any(v.data_ptr() % 16 for v in (x, b, c)):
        raise ValueError(f"ssd_scan_cuda: N={n} and P={p} must be multiples "
                         f"of {vec} and x, b, c start on 16-byte boundaries "
                         "(the kernel loads 16 bytes at a time)")
    if smem_bytes(chunk, n) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan_cuda: chunk={chunk}, N={n} do not fit "
                         f"one block's shared memory ({smem_bytes(chunk, n)} "
                         f"> {SMEM_LIMIT})")
    if x.numel() >= 1 << 40 or bh * -(-p // _PT) >= 1 << 31:
        raise ValueError("ssd_scan_cuda: input too large")
    y = torch.empty_like(x)
    # scratch for the scores C·Bᵀ of every chunk of every B/C row
    scores = torch.empty((bh // heads, t // chunk, chunk, chunk),
                         dtype=torch.float32, device=x.device)
    fn = getattr(load("ssd_scan"),
                 "ssd_scan_bf16" if x.dtype == torch.bfloat16
                 else "ssd_scan_f32")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
             scores.data_ptr(), y.data_ptr(), bh, t, p, n, chunk, heads,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_cuda: CUDA error {err} at launch")
    ssd_scan_cuda.launches += 1
    return y


#: launches of the kernel since the count was last set to 0
ssd_scan_cuda.launches = 0


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 64, *,
             backend: str = "auto") -> torch.Tensor:
    """x (BH, T, P); log_a (BH, T); b, c (BH, T, N), or (BH / H, T, N)
    shared by H consecutive batch-heads → y (BH, T, P) in x's dtype.

    T must be a multiple of ``chunk``: the caller pads, with log_a = 0
    and x = 0 so the padded steps leave the state alone.  ``backend``:
    ``"auto"`` launches the CUDA kernel for a CUDA tensor and runs the
    plain version for a CPU tensor; ``"plain"`` is the caller's own
    request for the plain version on either device."""
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown ssd_scan backend {backend!r}")
    if backend == "plain" or not x.is_cuda:
        return ssd_scan_chunked(x, log_a, b, c, chunk)
    return ssd_scan_cuda(x.contiguous(), log_a.to(torch.float32).contiguous(),
                         b.contiguous(), c.contiguous(), chunk)
