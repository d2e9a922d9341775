"""Cases of the partitioned view's value test (tests/test_torch_mesh_dryrun.py
and the ranks of tests/_torch_partition_worker.py): configs, numpy inputs,
and the single-process run the ranks are held to.

The configs are ``.reduced()`` decoders widened so that the production
specs split them over the "model" axis (they divide by 16): 16 query
heads of 32 (split), 2 kv heads (replicated: each rank takes its query
heads' kv head), d_ff 2048 and the vocab of 512 (split).  Everything is
f32, so a rank's shards sum in another order than one process and agree
to rounding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves_with_paths, map_with_path

WORLD, MESH, AXES = 4, (2, 2), ("data", "model")
B, S, MAX_LEN = 2, 64, 96
# sharding options of each run (the dry-run's knobs)
KNOBS = {"default": {}, "fsdp": dict(fsdp=True),
         "legacy": dict(attn_kv_fallback="head_dim")}
RUNS = (("llama3-8b", "default"), ("llama3-8b", "fsdp"), ("llama3-8b", "legacy"),
        ("gemma2-9b", "default"))
# leaves whose grads and updated values are compared
LEAVES = (("embed",), ("layers", "wq"), ("layers", "wk"), ("layers", "wo"),
          ("layers", "w_down"), ("layers", "ln1"))


def cfg_of(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), d_model=512, n_heads=16,
                               head_dim=32, d_ff=2048)


def params_of(cfg, seed: int = 0):
    """f32 params drawn with numpy, laid out as ``param_struct``'s; the norm
    scales nonzero so that their grads are."""
    rng = np.random.default_rng(seed)

    def draw(path, t):
        std = 0.3 if path[-1].startswith(("ln", "post_ln")) or path[-1].endswith("norm") \
            else 1.0 / np.sqrt(t.shape[-2] if t.dim() > 1 else 1)
        return torch.from_numpy((rng.standard_normal(tuple(t.shape)) * std).astype(np.float32))

    return map_with_path(draw, TT.param_struct(cfg, dtype=torch.float32))


def tokens_of(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int64)),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int64)),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,)).astype(np.int64)))


def run(cfg, params, tokens, labels, nxt, place=None, full=lambda t: t):
    """prefill logits, the decode step's logits over the prefill's cache,
    and one train step (loss, grads and updated params of LEAVES), with
    ``place(tree, kind)`` putting each argument on the mesh (identity for
    one process) and ``full(t)`` reading a result back whole."""
    place = place or (lambda tree, kind: tree)
    out = {}
    with torch.no_grad():
        logits, cache = TT.prefill(place(params, "params"), place(tokens, "rows"), cfg)
        out["prefill"] = full(logits)
        big = TT.init_cache(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
        for key in ("k", "v"):
            big[key][:, :, :S] = full(cache[key])
        big["pos"] = torch.tensor(S, dtype=torch.int32)
        step, _ = TT.decode_step(place(params, "params"), place(nxt, "tokens"), cfg,
                                 place(big, "cache"))
        out["decode"] = full(step)
    train = make_train_step(cfg, AdamWConfig(warmup_steps=1), remat=True)
    p = place({k: v for k, v in params.items()}, "params")
    p = map_with_path(lambda _, t: t.clone(), p)
    opt = place(adamw_init(params), "opt")
    loss, grads = train.grads(p, place({"tokens": tokens, "labels": labels}, "batch"))
    flat = dict(leaves_with_paths(grads))
    out["loss"] = full(loss)
    for path in LEAVES:
        out["grad/" + "/".join(path)] = full(flat[path])
    p, _, _ = adamw_update(grads, opt, p, train.opt_cfg)
    flat = dict(leaves_with_paths(p))
    for path in LEAVES:
        out["param/" + "/".join(path)] = full(flat[path])
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
