"""qwen3-14b [dense] — qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B; hf]  Twin of
``repro/configs/qwen3_14b.py``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, d_head=128,
    qk_norm=True, rope_theta=1e6,
    source="[hf:Qwen/Qwen3-8B; hf]",
)
