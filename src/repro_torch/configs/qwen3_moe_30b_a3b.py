"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
(per expert) vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    gated_mlp=True,
    qk_norm=True,          # qwen3 family applies RMSNorm to q/k heads
    attention="global",
    rope_theta=1_000_000.0,
    subquadratic=False,    # pure full attention → long_500k skipped
)
