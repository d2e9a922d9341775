"""A cell of the benchmark cut to a size the CPU runs in seconds: the
configuration's own kinds of layers at toy widths, and a mix of short
prompts."""
from __future__ import annotations

import copy
from pathlib import Path

from portbench.harness import cell as C
from portbench.harness import traffic

ROOT = Path(__file__).resolve().parents[2]

TINY_ARCH = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                 vocab_size=512)


def tiny_cell(name: str = "qwen3-4b-intrablock.longdoc", **mix_kw) -> C.Cell:
    cell = C.find_cell(ROOT, name)
    cfg = copy.deepcopy(cell.config)
    cfg["arch"].update(TINY_ARCH)
    if cfg["arch"].get("n_experts", 1) > 1:
        cfg["arch"].update(n_experts=8, top_k=2)
        # at these widths one bf16 routing flip swaps half a token's FFN: the
        # toy reads mean gaps up to ~0.02 on sound runs, a planted fault 0.4 or more
        cfg["check"] = {"mean_logit_gap": 0.05}
    if cfg["pruning"]["pattern"] == "fullblock":
        cfg["pruning"].update(bm=8, bn=16)
    slots = min(cell.mix.slots, 4)
    mix = dict(name="tiny", clients=slots, slots=slots, max_len=64,
               prompt_len={"dist": "uniform", "min": 16, "max": 40},
               output_len={"dist": "uniform", "min": 3, "max": 8}, pool=16,
               warmup_completions=slots, check_tokens=60, check_requests=8)
    mix.update(mix_kw)
    cell.config, cell.mix = cfg, traffic.Mix(**mix)
    return cell
