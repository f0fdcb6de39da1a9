"""The dispatching entry points over the kernels — twin of
``repro/kernels/ops.py``.

``use_pallas`` keeps the reference's name and meaning: True asks for the
hand-written kernel, False for the plain route, None for the default.  The
``REPRO_USE_PALLAS`` switch overrides it as in the reference ("0",
"false" or "False" turn the kernels off, any other value on).  The
default is the kernel for a CUDA tensor and the plain route for a CPU
tensor, as the reference defaults to Pallas only on a TPU.  A request for
the kernel on a CPU tensor raises: the CUDA kernels have no CPU mode (the
reference's ``interpret=True`` has no twin).

The plain routes are the reference's non-Pallas ones: the float32 oracle
``decode_attention_ref`` for ``decode_attention``, the chunked dual form
for ``ssd_scan``, and the plain fused path for the segment functions.
"""
from __future__ import annotations

import torch

from repro_torch.configs import flags

from . import decode_attn as _da
from . import ref as _ref
from . import segment_agg as _sa
from . import ssd_scan as _ss


def want_kernel(default: bool | None = None, *,
                tensor: torch.Tensor | None = None) -> bool:
    """The reference's ``want_pallas``: ``REPRO_USE_PALLAS`` first, then
    the caller's ``default``, then whether ``tensor`` lies on the card."""
    env = flags.value("REPRO_USE_PALLAS")
    if env is not None:
        return env not in ("0", "false", "False")
    if default is not None:
        return default
    return tensor is not None and tensor.is_cuda


def _kernel_route(use_pallas: bool | None, x: torch.Tensor,
                  what: str) -> bool:
    if not want_kernel(use_pallas, tensor=x):
        return False
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel was asked for (use_pallas "
                         "or REPRO_USE_PALLAS) but the input lies on the "
                         "CPU; the kernel has no CPU mode")
    return True


def segment_agg(vals, segs, valid, num_segments: int, *,
                use_pallas: bool | None = None, block_rows: int = 256):
    """Single-column legacy form: (4, num_segments) f32 rows [sum, count,
    min, max]."""
    vals = torch.as_tensor(vals)
    if _kernel_route(use_pallas, vals, "segment_agg"):
        return _sa.fused_segment_agg(vals, segs, valid, num_segments,
                                     block_rows=block_rows,
                                     backend="cuda")[0]
    return _ref.segment_agg_ref(vals, torch.as_tensor(segs),
                                torch.as_tensor(valid), num_segments)


def fused_segment_agg(vals, segs, valid, num_segments: int, *,
                      use_pallas: bool | None = None, block_rows: int = 256,
                      block_segs: int | None = None):
    """Multi-column fused segmented aggregation → (C, 4, num_segments):
    a CUDA kernel, or the plain fused path."""
    vals = torch.as_tensor(vals)
    backend = "cuda" if _kernel_route(use_pallas, vals,
                                      "fused_segment_agg") else "jnp"
    return _sa.fused_segment_agg(vals, segs, valid, num_segments,
                                 block_rows=block_rows, block_segs=block_segs,
                                 backend=backend)


def decode_attention(q, k, v, kv_len, *, use_pallas: bool | None = None,
                     chunk: int = 128):
    """q (BH, G, D); k, v (BH, S, D); kv_len (BH,) → (BH, G, D): the
    split-KV CUDA kernel, or the float32 oracle.  ``chunk`` is the TPU
    kernel's KV block; the CUDA kernel picks its own splits and tiles."""
    if _kernel_route(use_pallas, q, "decode_attention"):
        return _da.decode_attention(q, k, v, kv_len, chunk)
    return _ref.decode_attention_ref(q, k, v, kv_len)


def ssd_scan(x, log_a, b, c, *, use_pallas: bool | None = None,
             chunk: int = 64):
    """The chunked SSD scan: the CUDA kernel, or the chunked dual form in
    plain torch (NOT the sequential oracle)."""
    if _kernel_route(use_pallas, x, "ssd_scan"):
        return _ss.ssd_scan(x, log_a, b, c, chunk)
    return _ref.ssd_scan_chunked(x, log_a, b, c, chunk=chunk)
