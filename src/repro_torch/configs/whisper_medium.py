"""whisper-medium [audio] — 24L d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=51865 — encoder-decoder; the conv frontend is a stub: the encoder
takes precomputed 1500-frame embeddings.  [arXiv:2212.04356; unverified]

Adaptation notes (as in the reference's config): whisper uses
learned/sinusoidal positions and GELU MLPs; this config uses RoPE
positions and non-gated GELU MLPs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,           # decoder layers
    enc_dec=True,
    enc_layers=24,
    enc_seq=1500,          # stub: precomputed audio-frame embeddings
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    gated_mlp=False,
    attention="global",
    subquadratic=False,
)
