"""repro_torch.kernels — the port's hand-written CUDA kernels
(``csrc/``), their wrappers with a plain PyTorch version beside each
(``segment_agg``, ``ssd_scan``, ``decode_attn``), the dispatching entry
points (``ops``, twin of ``repro/kernels/ops.py``), the build (``build``)
and the plain oracles (``ref``)."""
