"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; None means the card.  Without
    CUDA, None raises instead of carrying on silently on the CPU — a
    caller that wants the CPU passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on the GPU by default and CUDA "
                           "is not available; pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")
