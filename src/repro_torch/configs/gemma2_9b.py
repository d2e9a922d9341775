"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — alternating local(4096)/global attention, logit softcap.
[arXiv:2408.00118; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    gated_mlp=True,            # GeGLU
    attention="local_global",  # alternating sliding(4096) / global
    window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    post_norms=True,
    tie_embeddings=True,
    subquadratic=True,
)
