"""Architecture + shape configuration (twin of ``repro/configs/base.py``).
The dataclass keeps every field of the reference so configs compare field
for field; ``param_count`` covers the ported SSM and dense families."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 → d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0     # 0 = full attention
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # VLM (cross-attention image layers)
    cross_attn_every: int = 0
    n_img_tokens: int = 0
    # encoder-decoder (audio)
    enc_layers: int = 0
    enc_seq: int = 0
    norm: str = "rms"           # rms | ln
    tie_embeddings: bool = False
    source: str = ""            # provenance tag [source; verified-tier]

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ArchConfig":
        """Same-family smoke config: tiny widths/depths, preserved structure
        (GQA ratio, MoE routing, SSD shapes, cross-attn cadence)."""
        kv = max(1, min(self.n_kv_heads, 2))
        heads = kv * max(1, min(self.n_heads // max(self.n_kv_heads, 1), 2))
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.cross_attn_every else 2),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            d_head=16,
            d_ff=96 if self.d_ff else 0,
            vocab=128,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            cross_attn_every=self.cross_attn_every and 2,
            n_img_tokens=min(self.n_img_tokens, 8) if self.n_img_tokens else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
        )

    def param_count(self) -> int:
        """Analytic parameter count of the ported families (SSM and dense;
        the others raise: ROADMAP A10).  As in the reference, the qk-norm
        and final-norm scales are not counted."""
        d, v = self.d_model, self.vocab
        if self.family == "ssm":
            d_inner = self.ssm_expand * d
            nh = d_inner // self.ssm_headdim
            per = d * (2 * d_inner + 2 * self.ssm_state + nh) \
                + self.conv_width * (d_inner + 2 * self.ssm_state) \
                + d_inner * d + 2 * d
        elif self.family == "dense":
            h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
            attn = d * (h + 2 * kv) * dh + h * dh * d
            mlp = 3 * d * self.d_ff if self.d_ff else 0
            per = attn + mlp + 2 * d
        else:
            raise NotImplementedError(
                f"param_count of the {self.family!r} family is not ported "
                "yet (ROADMAP A10)")
        return self.n_layers * per + v * d * (1 if self.tie_embeddings else 2)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
