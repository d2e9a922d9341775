"""PyTorch port, training across the served families: one train step of
``make_train_step`` (one microbatch, f32) on the ``.reduced()`` config of
every served family but the dense decoder (tests/test_torch_train.py) ≡
the JAX package's jitted step on the same numpy params and batch.

gemma2-9b trains through its softcaps and windows, qwen3-moe-30b-a3b
through the top-k routing (the reference runs inside ``R.active()``, as
its ``moe_block`` imports at trace time; in f32 the routes are equal),
mamba2-130m and hymba-1.5b through ``_ssd_chunked``, whisper-medium
through the encoder and the cross-attention (``enc_embed``),
paligemma-3b through its prefix (``prefix_embed``, logits sliced past
it).  Loss, grad_norm, lr, the new params and the moments are held to the
tolerances of tests/_train_cases.py: 1e-5 of a leaf's largest entry, but
1e-4 for hymba-1.5b, whose every grad passes through both branch norms
beside the SSD's f32 decays (its moments read up to 3.1e-5).
"""
import pytest

import _jax_reference
from _train_cases import assert_step_matches, np_batch, np_params, port_step, ref_step
from repro_torch.configs import get_config
from repro_torch.train.optimizer import AdamWConfig

FAMILIES = ("gemma2-9b", "qwen3-moe-30b-a3b", "mamba2-130m", "hymba-1.5b", "whisper-medium",
            "paligemma-3b")
LR = 1e-2
REL = {"hymba-1.5b": 1e-4}


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_train_step_matches_reference(R, arch):
    jcfg, cfg = R.configs.get_config(arch).reduced(), get_config(arch).reduced()
    params = np_params(R, jcfg, seed=3)
    # 40 tokens: past the reduced window (32) and a ragged SSM chunk
    batch = np_batch(cfg, B=2, S=40, seed=3)
    kw = dict(lr=LR, warmup_steps=1, total_steps=10)
    ref = ref_step(R, jcfg, R.optimizer.AdamWConfig(**kw), params, batch)
    port = port_step(cfg, AdamWConfig(**kw), params, batch)
    assert_step_matches(ref, port, LR, rel=REL.get(arch, 1e-5))
