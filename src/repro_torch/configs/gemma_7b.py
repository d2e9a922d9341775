"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16, MHA) d_ff=24576
vocab=256000 — GeGLU, head_dim=256 (q/o projections are 16×256=4096 wide
on a 3072 residual stream).  [arXiv:2403.08295; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    gated_mlp=True,
    attention="global",
    tie_embeddings=True,
    subquadratic=False,
)
