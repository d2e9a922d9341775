"""Architecture configuration schema (copy of ``repro.configs.base``).

The port keeps its own copy so that it never imports the JAX package.
Field names, defaults and ``reduced()`` match the reference exactly, so
a reference config converts with ``ArchConfig(**dataclasses.asdict(c))``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // n_heads
    n_experts: int = 1
    top_k: int = 1
    gated_mlp: bool = True
    attention: str = "global"      # global | local_global | sliding | none
    window: int = 4096
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    qk_norm: bool = False
    post_norms: bool = False       # gemma2-style post-layer norms
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0
    prefix_len: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    subquadratic: bool = False
    capacity_factor: float = 1.25
    moe_chunked: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def ssm_inner(self, d: Optional[int] = None) -> int:
        return 2 * (d or self.d_model)

    @property
    def ssm_heads(self) -> int:
        return max(1, self.ssm_inner() // self.ssm_head_dim)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            enc_layers=min(self.enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            window=32,
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
            prefix_len=min(self.prefix_len, 8) if self.prefix_len else 0,
            capacity_factor=float(max(2.0, min(self.n_experts, 4))),
        )
