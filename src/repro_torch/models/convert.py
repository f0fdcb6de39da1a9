"""Parameters of the reference's ``LM.init`` pytree in the port's layout.

The reference stores most leaves in the model dtype and keeps the SSM
decay, bias and skip vectors in float32; every leaf of the dense family
(``wq``, ``wk``, ``wv``, ``wo``, ``q_norm``, ``k_norm``, the gated-MLP
weights, ``norm1``/``norm2``) is in the model dtype.  ``params_from_jax`` takes that
pytree as nested dicts of **float32** numpy arrays (a bf16 → float32 cast
is exact, and numpy has no bf16 without ``ml_dtypes``) and returns the
same values as tensors: float32 leaves stay float32, the rest go to
``dtype`` (float32 → bf16 of a bf16 value is exact again).  The layouts
already agree: layers stacked on a leading axis, the same names and
shapes."""
from __future__ import annotations

import numpy as np
import torch

#: leaves the reference keeps in float32 whatever the model dtype
F32_LEAVES = frozenset({"a_log", "dt_bias", "d_skip"})


def params_from_jax(tree, *, dtype: torch.dtype = torch.bfloat16,
                    device="cpu", _name: str = ""):
    """Nested dicts of float32 numpy arrays → nested dicts of tensors on
    ``device``, in ``dtype`` except the leaves of ``F32_LEAVES``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype=dtype, device=device, _name=k)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype != np.float32:
        raise ValueError(f"{_name}: expected float32 numpy, got {arr.dtype}")
    want = torch.float32 if _name in F32_LEAVES else dtype
    return torch.tensor(arr, device=device).to(want)
