"""repro_torch.kernels — the port's hand-written CUDA kernels
(``csrc/``), their wrappers with a plain PyTorch version beside each
(``segment_agg``, ``ssd_scan``), the build (``build``) and the plain
oracles (``ref``)."""
