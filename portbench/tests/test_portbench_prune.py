"""The reference's own pruning recomputation keeps the weights the
program's ``prune_params`` keeps, from the same dense weights."""
from __future__ import annotations

import pytest
import torch

from portbench.reference import prune


@pytest.mark.parametrize("shape", [(64, 96), (40, 24), (2560 // 16, 9728 // 64)])
def test_intrablock_rows_equal_the_programs(shape):
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
    from repro_torch.core.pruning import flexblock_mask
    g = torch.Generator().manual_seed(3)
    w = torch.randn(shape, generator=g).to(torch.bfloat16)
    want = flexblock_mask(w, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), align_cols=True)
    got = prune.intrablock_mask(w.float(), 4, 0.5)
    assert torch.equal(got, want)
    assert int(got.sum()) == shape[0] // 2 * shape[1]


@pytest.mark.parametrize("shape", [(256, 384), (8, 128 * 6)])
def test_fullblock_blocks_equal_the_programs(shape):
    from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
    from repro_torch.core.pruning import flexblock_mask
    g = torch.Generator().manual_seed(5)
    w = torch.randn(shape, generator=g).to(torch.bfloat16)
    bm = min(128, shape[0])
    want = flexblock_mask(w, FlexBlockSpec((FullBlock(bm, 128, 0.5),)), impl="ref")
    got = prune.fullblock_mask(w.float(), bm, 128, 0.5)
    assert torch.equal(got, want)


def test_mask_of_views_an_expert_leaf_as_experts_by_the_rest():
    w = torch.randn(4, 8, 16)
    m = prune.mask_of(w, {"pattern": "fullblock", "bm": 4, "bn": 16, "ratio": 0.5})
    assert m.shape == w.shape
    blocks = m.reshape(4, 8, 16).reshape(4, 8, 1, 16)
    assert torch.equal(blocks.all(dim=(0, 3)), blocks.any(dim=(0, 3)))   # whole blocks
    assert int(m.sum()) == w.numel() // 2


def test_the_programs_masks_through_prune_params():
    """The whole leaf through ``prune_params`` (IntraBlock row-aligned),
    against the reference's mask layer by layer."""
    from repro_torch.core.flexblock import FlexBlockSpec, IntraBlock
    from repro_torch.sparsity.apply import prune_params
    g = torch.Generator().manual_seed(9)
    leaf = torch.randn(3, 32, 4, 8, generator=g).to(torch.bfloat16)       # a wq (L, d, H, hd)
    _, masks = prune_params({"layers": {"wq": leaf}}, FlexBlockSpec((IntraBlock(4, 1, 0.5),)),
                            keys=("wq",), align_cols=True, device="cpu")
    for l in range(3):
        ref = prune.mask_of(leaf[l].float(), {"pattern": "intrablock", "m": 4, "ratio": 0.5})
        assert torch.equal(ref, masks["layers"]["wq"][l])
