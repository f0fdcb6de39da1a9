"""repro_torch.models — the LM substrate's SSM family (twin of
``repro/models``): ``layers``, ``ssm`` (through the SSD-scan kernel),
``blocks``, ``model.LM`` and ``convert.params_from_jax``.  The other
families wait for ROADMAP A10."""
from .model import LM

__all__ = ["LM"]
