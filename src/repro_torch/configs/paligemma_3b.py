"""paligemma-3b [vlm] — 18L d_model=2048 8H (kv=1, MQA) d_ff=16384
vocab=257216 — SigLIP vision frontend stub (256 precomputed patch
embeddings, joined ahead of the tokens as a bidirectional prefix) + gemma
decoder.  [arXiv:2407.07726; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    gated_mlp=True,
    attention="global",
    prefix_len=256,        # stub: SigLIP patch embeddings
    tie_embeddings=True,
    subquadratic=False,
)
