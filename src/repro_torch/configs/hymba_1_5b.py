"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer.
[arXiv:2411.13676; hf]

Adaptation: Hymba fuses attention and SSM heads in parallel within each
layer with per-branch output normalisation; attention is sliding-window
(global on a few layers in the published model; sliding on every layer
here, as in the reference's config).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    gated_mlp=True,
    attention="sliding",
    window=1024,
    ssm_state=16,
    ssm_head_dim=64,
    subquadratic=True,     # sliding attn + SSM → long_500k runs
)
