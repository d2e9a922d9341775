"""mamba2-130m [ssm] — 24L d_model=768, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,             # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,                # no MLP block; SSM mixer only
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_head_dim=64,
    tie_embeddings=True,
    subquadratic=True,     # constant-size state → long_500k runs
)
