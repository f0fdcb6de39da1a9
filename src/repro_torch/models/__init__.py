"""repro_torch.models — the LM substrate's SSM and dense families (twin of
``repro/models``): ``layers``, ``ssm`` (through the SSD-scan kernel),
``flash`` and ``attention`` (prefill and decode attention), ``blocks``,
``model.LM`` and ``convert.params_from_jax``.  The other families wait for
ROADMAP A10."""
from .model import LM

__all__ = ["LM"]
