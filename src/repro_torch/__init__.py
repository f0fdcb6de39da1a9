"""repro_torch — the PyTorch/CUDA port of ``repro``: the Aggify compiler,
the relational engine and the grouped-aggregation executors on torch
tensors, with hand-written CUDA kernels for the hot path.  It imports
neither ``jax`` nor ``repro``; the tests hold it against ``repro``."""
