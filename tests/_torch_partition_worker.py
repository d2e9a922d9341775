"""One rank of the 4-rank gloo world of the partitioned view's value test.

    python tests/_torch_partition_worker.py RANK STORE_FILE OUT_DIR

Joins the world through a ``file://`` store, builds the (data 2, model 2)
mesh, and for each run of tests/_partition_cases.py places the same
numpy-made params, tokens, cache and optimizer state as DTensors holding
this rank's shards (the dry-run's placement: ``tree_specs``, the batch
rows over "data", ``cache_specs``, m/v as the params), runs the
partitioned prefill, decode step and train step, and writes every result
read back whole to ``OUT_DIR/rank<RANK>.npz``.  Every collective has the
world's timeout.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

import _partition_cases as cases
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as lmesh


def main() -> int:
    rank, store, out = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
    torch.set_num_threads(1)
    lmesh.init_world(rank, cases.WORLD, f"file://{store}", timeout_s=90)
    mesh = lmesh.make_mesh(cases.MESH, cases.AXES, device_type="cpu")
    from torch.distributed.tensor import DTensor

    def put(tree, specs):
        return shd.distribute(tree, mesh, specs)

    results = {}
    for arch, knob in cases.RUNS:
        cfg = cases.cfg_of(arch)
        cell = ShapeCell("t", cases.seq_of(cfg)[1], cases.B, "decode")

        def place(tree, kind):
            if kind == "params":
                return put(tree, shd.tree_specs(tree))
            if kind == "opt":
                return {"step": put(tree["step"], shd.P()),
                        **{k: put(tree[k], shd.tree_specs(tree[k])) for k in ("m", "v")}}
            if kind == "cache":
                specs = shd.cache_specs(cfg, cell)
                return {k: put(v, specs.get(k, shd.P())) for k, v in tree.items()}
            if kind == "batch":
                return {k: put(v, shd.P("data", None)) for k, v in tree.items()}
            if kind == "rows":
                return put(tree, shd.P("data", None))
            return put(tree, shd.P(None))                    # decode tokens: B < the data axis

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        tokens, labels, nxt = cases.tokens_of(cfg)
        with shd.options(**cases.KNOBS[knob]), shd.set_mesh(mesh):
            got = cases.run(cfg, cases.params_of(cfg), tokens, labels, nxt, place, full,
                            cases.extra_of(cfg))
        results.update({f"{arch}/{knob}/{k}": v for k, v in got.items()})
    np.savez(out / f"rank{rank}.npz", **results)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
