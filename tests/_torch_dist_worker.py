"""One rank of the 4-rank gloo world of tests/test_torch_distributed.py.

    python tests/_torch_dist_worker.py RANK WORLD STORE_FILE OUT_DIR [cuda]

Joins the world through a ``file://`` store, builds the (data 2, model 2)
mesh and runs every case of tests/_dist_cases.py through the port's mesh
paths (and, for comparison, the same calls with no mesh), then writes
``OUT_DIR/rank<RANK>.npz``.  Torch only: the test holds the arrays to the
JAX reference.  Every collective has the world's timeout, so a rank that
dies fails the others instead of leaving them waiting.

With ``cuda`` (tests/test_torch_gpu.py) the world is 2 ranks on one card
over gloo, a (data 1, model 2) mesh, and only the expert and window
cases run, every input on ``cuda:0``; the window case runs once under
autograd and once under no grad, where it launches the flash kernel.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

import _dist_cases as cases
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import mesh as lmesh
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.sparsity.apply import prune_local

OUT: dict = {}
INFO: dict = {}
DEVICE = "cpu"


def t(a, grad: bool = False) -> torch.Tensor:
    x = torch.tensor(a, device=DEVICE)
    return x.requires_grad_(True) if grad else x


def counted(fn):
    """``fn()`` with the mesh-path counts reset before; returns (result,
    counts)."""
    shd.reset_path_counts()
    out = fn()
    return out, shd.path_counts()


def moe_case(name, mesh, cfg, inp, grads: bool = False, local: bool = False):
    keys = ("w_router", "w_up", "w_gate", "w_down")
    p = {k: t(inp[k], grads) for k in keys}
    x = t(inp["x"], grads)
    if local:       # this rank's experts only, as a model too large for every rank keeps them
        p.update({k: shd.local_shard(p[k], shd.layer_spec(k, p[k].shape, fsdp=False),
                                     mesh).clone() for k in keys[1:]})
    with shd.set_mesh(mesh):
        y, n = counted(lambda: TL.moe_block(x, p, cfg))
    OUT[f"{name}/y"] = y.detach().cpu().numpy()
    INFO[name] = n
    if grads:
        (y * t(inp["cot"])).sum().backward()
        OUT[f"{name}/grad_x"] = x.grad.cpu().numpy()
        for k in keys:
            OUT[f"{name}/grad_{k}"] = p[k].grad.cpu().numpy()


def swa_case(name, mesh, cfg, inp, grads: bool = False, prefix: int = 0):
    p = {k: t(v, grads) for k, v in inp.items() if k not in ("x", "cot")}
    x = t(inp["x"], grads)
    S = x.shape[1]
    pos = torch.arange(S, device=DEVICE).expand(x.shape[0], S)
    with shd.set_mesh(mesh):
        (y, (k, v)), n = counted(lambda: TL.attention_block(
            x, p, cfg, positions=pos, causal=True, window=cfg.window, prefix=prefix))
    OUT[f"{name}/y"], OUT[f"{name}/k"], OUT[f"{name}/v"] = (
        a.detach().cpu().numpy() for a in (y, k, v))
    INFO[name] = n
    if grads:
        (y * t(inp["cot"])).sum().backward()
        OUT[f"{name}/grad_x"] = x.grad.cpu().numpy()
        for key in ("wq", "wk", "wv", "wo"):
            OUT[f"{name}/grad_{key}"] = p[key].grad.cpu().numpy()


def entry_case(name, mesh, cfg, S, steps):
    params = {k: (torch.tensor(v) if not isinstance(v, dict)
                  else {kk: torch.tensor(vv) for kk, vv in v.items()})
              for k, v in cases.np_params(cfg, 3).items()}
    prompt, feed = cases.tokens(cfg, 2, S, steps)

    def run():
        lg, cache = TT.prefill(params, torch.tensor(prompt, dtype=torch.long), cfg,
                               impl="ref")
        for key in ("k", "v"):
            if key in cache:
                cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, steps))
        out = [lg[:, -1]]
        for tok in feed:
            lg, cache = TT.decode_step(params, torch.tensor(tok, dtype=torch.long), cfg,
                                       cache, impl="ref")
            out.append(lg)
        return torch.stack(out, dim=1)

    with torch.no_grad():
        with shd.set_mesh(mesh):
            mesh_lg, n = counted(run)
        OUT[f"entry_{name}/mesh"] = mesh_lg.numpy()
        OUT[f"entry_{name}/plain"] = run().numpy()
    INFO[f"entry_{name}"] = n


def mask_case(mesh):
    cfg = cases.moe_cfg()
    spec = FlexBlockSpec((FullBlock(*cases.FULLBLOCK),))
    w = t(cases.moe_inputs(cfg)["w_up"])
    wl, ml = prune_local(w, "w_up", spec, mesh, device="cpu")
    OUT["mask/w"], OUT["mask/m"] = wl.numpy(), ml.numpy()


def helpers_case(mesh):
    try:
        lmesh.make_production_mesh()
        INFO["production_mesh"] = "built"
    except RuntimeError as e:
        INFO["production_mesh"] = str(e)
    local = lmesh.make_local_mesh()
    INFO["local_mesh"] = [list(local.mesh_dim_names), list(local.shape)]
    INFO["placements"] = {k: [repr(p) for p in v] for k, v in shd.tree_shardings(
        mesh, {"w_up": torch.empty(2, 8, 64, 128, device="meta"),
               "wq": torch.empty(2, 64, 16, 16, device="meta")}).items()}
    INFO["coordinate"] = list(mesh.get_coordinate())


def main() -> int:
    global DEVICE
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    DEVICE = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    torch.set_num_threads(1)
    lmesh.init_world(rank, world, f"file://{store}", timeout_s=90)
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = lmesh.make_mesh((1, world), cases.AXES, device_type="cuda")
        mcfg, scfg = cases.moe_cfg(), cases.swa_cfg()
        moe_case("moe_dropless", mesh, mcfg, cases.moe_inputs(mcfg), grads=True)
        moe_case("moe_decode", mesh, mcfg, cases.moe_inputs(mcfg, batch=1, seq=1, seed=4))
        swa_case("swa", mesh, scfg, cases.swa_inputs(scfg), grads=True)
        before = ops.launch_counts()["flash_attention"]
        with torch.no_grad():       # serving's route: the flash op on the rank's block
            fcfg = cases.swa_cfg(head_dim=64)       # a head dim the CUDA kernel takes
            swa_case("swa_flash", mesh, fcfg, cases.swa_inputs(fcfg))
        INFO["swa_flash_launches"] = ops.launch_counts()["flash_attention"] - before
        return finish(rank, out)
    mesh = lmesh.make_mesh(cases.MESH, cases.AXES, device_type="cpu")

    mcfg = cases.moe_cfg()
    minp = cases.moe_inputs(mcfg)
    moe_case("moe_dropless", mesh, mcfg, minp, grads=True)
    moe_case("moe_local", mesh, mcfg, minp, local=True)
    moe_case("moe_drops", mesh, cases.moe_cfg(capacity_factor=1.0), minp)
    with shd.options(fsdp=True):
        moe_case("moe_fsdp", mesh, mcfg, minp, grads=True)
    moe_case("moe_decode", mesh, mcfg, cases.moe_inputs(mcfg, batch=2, seq=1, seed=4))
    e5 = cases.moe_cfg(n_experts=5)
    moe_case("moe_fallback_experts", mesh, e5, cases.moe_inputs(e5, seed=5))
    moe_case("moe_fallback_batch", mesh, mcfg, cases.moe_inputs(mcfg, batch=3, seed=6))
    with shd.options(ep_shardmap=False):
        moe_case("moe_fallback_option", mesh, mcfg, minp)

    scfg = cases.swa_cfg()
    swa_case("swa", mesh, scfg, cases.swa_inputs(scfg), grads=True)
    with torch.no_grad():           # serving's route: the flash op (its plain version here)
        swa_case("swa_nograd", mesh, scfg, cases.swa_inputs(scfg))
    qk = cases.swa_cfg(qk_norm=True)
    swa_case("swa_fallback_qk_norm", mesh, qk, cases.swa_inputs(qk))
    swa_case("swa_fallback_prefix", mesh, scfg, cases.swa_inputs(scfg), prefix=8)
    swa_case("swa_fallback_length", mesh, scfg, cases.swa_inputs(scfg, seq=1024))
    h4 = cases.swa_cfg(n_heads=4, n_kv_heads=4)
    swa_case("swa_fallback_heads", mesh, h4, cases.swa_inputs(h4))

    for name, (cfg, S, steps) in cases.entry_cases().items():
        entry_case(name, mesh, cfg, S, steps)
    mask_case(mesh)
    helpers_case(mesh)
    return finish(rank, out)


def finish(rank: int, out: Path) -> int:
    np.savez(out / f"rank{rank}.npz", **OUT)
    (out / f"rank{rank}.json").write_text(json.dumps(INFO))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
