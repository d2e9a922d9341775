"""The cases of tests/test_torch_distributed.py: configs and numpy-made
inputs, shared by the test (which hands them to the JAX reference) and
by each rank of its worlds (tests/_torch_dist_worker.py, torch only).

The MoE case is the reference's own (tests/test_distributed_paths.py):
qwen3-moe-30b-a3b reduced with 8 experts, top-2, capacity factor 8.0
(dropless); the window case too: hymba-1.5b at d_model 80, 5 heads of
16, window 64, B 2, S 2048.  Both run on a (data 2, model 2) mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import param_struct

MESH = (2, 2)
AXES = ("data", "model")
WORLD = 4

MOE_TOL = 2e-4          # the reference's own bound on the expert path
SWA_TOL = 2e-5          # and on the window path
GRAD_TOL = 2e-3         # its bound on the window path's gradients
LOGIT_TOL = 2e-4        # f32 logits, as tests/test_torch_models.py

FULLBLOCK = (8, 128, 0.5)   # expert masks: a block spans every rank's experts


def moe_cfg(**kw):
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), n_experts=8,
                              top_k=2, capacity_factor=8.0)
    return dataclasses.replace(cfg, **kw)


def moe_inputs(cfg, batch: int = 4, seq: int = 16, seed: int = 0) -> dict:
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    return {"w_router": f(D, E) * 0.1, "w_up": f(E, D, F) * 0.05,
            "w_gate": f(E, D, F) * 0.05, "w_down": f(E, F, D) * 0.05,
            "x": f(batch, seq, D), "cot": f(batch, seq, D)}


def swa_cfg(**kw):
    cfg = dataclasses.replace(get_config("hymba-1.5b"), d_model=80, n_heads=5,
                              n_kv_heads=5, head_dim=16, window=64)
    return dataclasses.replace(cfg, **kw)


def swa_inputs(cfg, seq: int = 2048, seed: int = 1) -> dict:
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    out = {"wq": f(D, Hq, hd) * 0.1, "wk": f(D, Hkv, hd) * 0.1, "wv": f(D, Hkv, hd) * 0.1,
           "wo": f(Hq, hd, D) * 0.1, "x": f(2, seq, D), "cot": f(2, seq, D)}
    if cfg.qk_norm:
        out["q_norm"], out["k_norm"] = f(hd) * 0.1, f(hd) * 0.1
    return out


# Entry points: (name, config, prompt length, decode steps)
def entry_cases() -> dict:
    hymba = get_config("hymba-1.5b").reduced()
    return {
        "hymba": (hymba, 48, 2),
        # 5 q heads do not divide the model axis, and S = 2048 = M·1024:
        # the prefill's attention takes the window path
        "hymba_seqpar": (dataclasses.replace(hymba, n_heads=5, n_kv_heads=5), 2048, 2),
        "qwen3_moe": (get_config("qwen3-moe-30b-a3b").reduced(), 24, 2),
    }


def np_params(cfg, seed: int) -> dict:
    """Every weight of ``cfg``'s tree (the port's and the reference's
    layout) from numpy: std 1/sqrt(fan_in) (fan_in the leaf's leading
    per-layer dims, d_model for wq/wk/wv), norm scales 0.1, SSM dynamics
    small, f32."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape, stacked):
        shp = shape[1:] if stacked else shape
        if name.startswith(("ln", "post_ln", "final_norm")) or name.endswith("_norm"):
            return rng.standard_normal(shape).astype(np.float32) * 0.1
        if name in ("A_log", "dt_bias", "D_skip"):
            return rng.standard_normal(shape).astype(np.float32) * 0.5
        fan_in = cfg.d_model if name in ("wq", "wk", "wv", "embed", "lm_head") else \
            int(np.prod(shp[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)

    def walk(tree, stacked):
        return {k: walk(v, stacked or k == "layers") if isinstance(v, dict)
                else leaf(k, tuple(v.shape), stacked) for k, v in sorted(tree.items())}

    return walk(param_struct(cfg), False)


def tokens(cfg, batch: int, seq: int, steps: int, seed: int = 2) -> tuple:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, size=(steps, batch)).astype(np.int32))
