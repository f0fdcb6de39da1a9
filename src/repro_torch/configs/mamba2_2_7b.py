"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality),
ssm_state=128.  [arXiv:2405.21060; unverified]  Twin of
``repro/configs/mamba2_2_7b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, d_head=0,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, conv_width=4,
    source="[arXiv:2405.21060; unverified]",
)
