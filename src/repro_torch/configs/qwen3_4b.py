"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    gated_mlp=True,
    qk_norm=True,
    attention="global",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=False,    # pure full attention → long_500k skipped
)
