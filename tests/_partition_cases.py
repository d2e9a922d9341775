"""Cases of the partitioned view's value test (tests/test_torch_mesh_dryrun.py
and the ranks of tests/_torch_partition_worker.py): configs, numpy inputs,
and the single-process run the ranks are held to.

The dense configs are ``.reduced()`` decoders widened so that the
production specs split them over the "model" axis (they divide by 16): 16
query heads of 32 (split), 2 kv heads (replicated: each rank takes its
query heads' kv head), d_ff 2048 and the vocab of 512 (split).
qwen3-moe-30b-a3b ``.reduced()`` runs the expert-parallel block (4
experts, 2 a rank, at its dropless capacity 4.0, so each rank's slice
routes as one process does); hymba-1.5b ``.reduced()`` with 5 query heads
and 1 kv head, at S 2048, runs the window path (5 heads do not divide 2,
2048 = 2 x 1024) and the Mamba-2 mixer on its channels, and decodes over
a cache split by sequence over both axes, the SSM state whole.
whisper-medium is widened as the dense configs, its 16 kv heads split
too, over 40 encoder frames and a vocab of 520 (16 does not divide it:
the embedding split by width, ``lm_head`` by rows); paligemma-3b
``.reduced()`` (4 query heads and 1 kv head, whole) joins 8 prefix
embeddings ahead of the tokens.  Everything is f32, so a rank's shards
sum in another order than one process and agree to rounding.
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
        ("gemma2-9b", "default"), ("qwen3-moe-30b-a3b", "default"), ("hymba-1.5b", "default"),
        ("whisper-medium", "default"), ("paligemma-3b", "default"))
# leaves whose grads and updated values are compared
LEAVES = (("embed",), ("layers", "wq"), ("layers", "wk"), ("layers", "wo"),
          ("layers", "w_down"), ("layers", "ln1"))
FAMILY_LEAVES = {"moe": (("layers", "w_router"), ("layers", "w_up")),
                 "hybrid": (("layers", "w_in"), ("layers", "conv_w"), ("layers", "A_log"),
                            ("layers", "w_out")),
                 "audio": (("enc_layers", "wq"), ("enc_cross", "wk"), ("dec_cross", "wq"),
                           ("dec_cross", "wo"))}


def cfg_of(arch: str):
    if arch in ("qwen3-moe-30b-a3b", "paligemma-3b"):
        return get_config(arch).reduced()
    if arch == "hymba-1.5b":
        return dataclasses.replace(get_config(arch).reduced(), n_heads=5, n_kv_heads=1)
    if arch == "whisper-medium":
        return dataclasses.replace(get_config(arch).reduced(), d_model=512, n_heads=16,
                                   n_kv_heads=16, head_dim=32, d_ff=2048, enc_seq=40,
                                   vocab_size=520)
    return dataclasses.replace(get_config(arch).reduced(), d_model=512, n_heads=16,
                               head_dim=32, d_ff=2048)


def seq_of(cfg):
    """(S, cache length): the window path needs S a multiple of 2 x 1024."""
    return (2048, 2080) if cfg.family == "hybrid" else (S, MAX_LEN)


def leaves_of(cfg):
    """LEAVES that ``cfg`` has, and its family's."""
    shapes = TT.param_struct(cfg)["layers"]
    return tuple(p for p in LEAVES if len(p) == 1 or p[1] in shapes) + \
        FAMILY_LEAVES.get(cfg.family, ())


def params_of(cfg, seed: int = 0):
    """f32 params drawn with numpy, laid out as ``param_struct``'s; the norm
    scales nonzero so that their grads are.  wq, wk and wv (L, d, H, hd)
    take std 1/sqrt(d), their fan-in, as the reference's init: over 1/sqrt(H)
    the scores of 16 heads of 32 have std ~30, a softmax so near argmax that
    a relative change of 1e-7 in whisper's encoder weights moves its logits
    by 2e-3 in one process."""
    rng = np.random.default_rng(seed)

    def draw(path, t):
        fan_in = t.shape[-3] if path[-1] in ("wq", "wk", "wv") else \
            t.shape[-2] if t.dim() > 1 else 1
        std = 0.3 if path[-1].startswith(("ln", "post_ln")) or path[-1].endswith("norm") \
            else 1.0 / np.sqrt(fan_in)
        return torch.from_numpy((rng.standard_normal(tuple(t.shape)) * std).astype(np.float32))

    return map_with_path(draw, TT.param_struct(cfg, dtype=torch.float32))


def tokens_of(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)
    S = seq_of(cfg)[0]
    return (torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int64)),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int64)),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B,)).astype(np.int64)))


def extra_of(cfg, seed: int = 2):
    """The stub inputs of an encoder-decoder (``enc_embed`` (B, Se, d)) or a
    prefix-LM (``prefix_embed`` (B, P, d)), f32, drawn with numpy."""
    rng = np.random.default_rng(seed)
    n = cfg.enc_seq if cfg.enc_dec else cfg.prefix_len
    if not n:
        return {}
    x = torch.from_numpy(rng.standard_normal((B, n, cfg.d_model)).astype(np.float32))
    return {"enc_embed" if cfg.enc_dec else "prefix_embed": x}


def run(cfg, params, tokens, labels, nxt, place=None, full=lambda t: t, extra=None):
    """prefill logits, the decode step's logits over the prefill's cache,
    and one train step (loss, grads and updated params of LEAVES), with
    ``place(tree, kind)`` putting each argument on the mesh (identity for
    one process) and ``full(t)`` reading a result back whole; ``extra``
    (:func:`extra_of`) joins the prefill's and the batch's inputs."""
    place = place or (lambda tree, kind: tree)
    extra = extra or {}
    out = {}
    with torch.no_grad():
        logits, cache = TT.prefill(place(params, "params"), place(tokens, "rows"), cfg,
                                   **{k: place(v, "rows") for k, v in extra.items()})
        out["prefill"] = full(logits)
        n, max_len = cache["k"].shape[2], seq_of(cfg)[1]
        big = TT.init_cache(cfg, B, max_len, dtype=torch.float32, device="cpu")
        for key in big:
            if key in ("k", "v"):
                big[key][:, :, :n] = full(cache[key])
            elif key != "pos":
                big[key].copy_(full(cache[key]))
        big["pos"] = torch.tensor(n, dtype=torch.int32)
        step, _ = TT.decode_step(place(params, "params"), place(nxt, "tokens"), cfg,
                                 place(big, "cache"))
        out["decode"] = full(step)
    train = make_train_step(cfg, AdamWConfig(warmup_steps=1), remat=True)
    p = place({k: v for k, v in params.items()}, "params")
    p = map_with_path(lambda _, t: t.clone(), p)
    opt = place(adamw_init(params), "opt")
    loss, grads = train.grads(p, place({"tokens": tokens, "labels": labels, **extra}, "batch"))
    flat = dict(leaves_with_paths(grads))
    out["loss"] = full(loss)
    for path in leaves_of(cfg):
        out["grad/" + "/".join(path)] = full(flat[path])
    p, _, _ = adamw_update(grads, opt, p, train.opt_cfg)
    flat = dict(leaves_with_paths(p))
    for path in leaves_of(cfg):
        out["param/" + "/".join(path)] = full(flat[path])
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
