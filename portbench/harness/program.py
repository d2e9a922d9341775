"""The system under test, built as its users build it: the dense weights
pruned and compressed by ``repro_torch.sparsity.apply``, then served by
``repro_torch.serve.engine.ServeEngine``."""
from __future__ import annotations

import time
from typing import Tuple

__all__ = ["prune_and_compress", "engine"]

EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _spec(pruning: dict):
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock, IntraBlock

    if pruning["pattern"] == "intrablock":
        return FlexBlockSpec((IntraBlock(pruning["m"], 1, pruning["ratio"]),))
    return FlexBlockSpec((FullBlock(pruning["bm"], pruning["bn"], pruning["ratio"]),))


def prune_and_compress(params: dict, arch: dict, pruning: dict, device) -> Tuple[dict, float]:
    """Prune the configuration's keys with its pattern and compress them;
    returns (compressed params, seconds), the seconds ended by a
    synchronise.  An MoE's expert leaves are pruned one layer at a time,
    each layer through ``prune_params`` as a one-layer leaf and written
    back in place, so that no leaf stands twice on the card (they have no
    compressed layout and stay masked-dense).  ``params`` is consumed."""
    import torch
    from repro_torch.sparsity.apply import compress_params, prune_params

    intra = pruning["pattern"] == "intrablock"
    spec = _spec(pruning)
    keys = tuple(pruning["keys"])
    layerwise = tuple(k for k in keys if k in EXPERT_KEYS) if arch.get("n_experts", 1) > 1 else ()
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    params, masks = prune_params(params, spec, keys=tuple(k for k in keys if k not in layerwise),
                                 align_cols=intra, impl="auto", device=device)
    for key in layerwise:
        leaf = params["layers"][key]
        for l in range(leaf.shape[0]):
            one, _ = prune_params({"layers": {key: leaf[l:l + 1]}}, spec, keys=(key,),
                                  align_cols=intra, impl="auto", device=device)
            leaf[l].copy_(one["layers"][key][0])
            del one
        masks["layers"][key] = None
    if intra:
        cparams = compress_params(params, masks, m=pruning["m"])
    else:
        cparams = compress_params(params, masks, pruning["bm"], pruning["bn"])
    del params, masks
    sync()
    return cparams, time.perf_counter() - t0


def engine(arch: dict, cparams: dict, mix, device):
    import torch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve.engine import ServeEngine

    return ServeEngine(ArchConfig(**arch), cparams, slots=mix.slots, max_len=mix.max_len,
                       dtype=torch.bfloat16, impl="auto", device=device)
