"""The seeded weight generator: any (leaf, layer) drawn again equals the
program's stacked copy, and every (leaf, layer) is its own draw."""
from __future__ import annotations

import copy

import pytest
import torch
from _tiny import TINY_ARCH, tiny_cell

from portbench.harness import weights


def _arch(moe=False):
    arch = copy.deepcopy(tiny_cell().config["arch"])
    if moe:
        arch.update(n_experts=4, top_k=2, capacity_factor=1.25)
    return arch


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_a_layer_drawn_again_equals_the_stacked_leaf(moe, seed):
    arch, init = _arch(moe), {"norm_std": 0.1}
    params = weights.make_params(arch, init, seed, "cpu")
    for name, stacked in params["layers"].items():
        assert stacked.shape[0] == TINY_ARCH["n_layers"]
        for l in range(stacked.shape[0]):
            again = weights.draw(arch, init, seed, name, l, "cpu")
            assert torch.equal(again, stacked[l]), (name, l)
    for name in weights.global_shapes(arch):
        assert torch.equal(weights.draw_global(arch, init, seed, name, "cpu"), params[name])


def test_every_leaf_and_layer_is_its_own_draw():
    arch, init = _arch(), {"norm_std": 0.1}
    a = weights.draw(arch, init, 1, "w_up", 0, "cpu")
    assert not torch.equal(a, weights.draw(arch, init, 1, "w_up", 1, "cpu"))
    assert not torch.equal(a, weights.draw(arch, init, 2, "w_up", 0, "cpu"))
    assert not torch.equal(a, weights.draw(arch, init, 1, "w_gate", 0, "cpu"))
    keys = {weights.leaf_seed(s, n, l) for s in (0, 1) for n in ("wq", "wk") for l in (0, 1)}
    assert len(keys) == 8 and all(0 <= k < 2**63 for k in keys)


def test_stds_follow_fan_in():
    arch, init = _arch(), {"norm_std": 0.1}
    d, ff = arch["d_model"], arch["d_ff"]
    shapes = weights.layer_shapes(arch)
    assert weights.std_of(arch, init, "wq", shapes["wq"]) == pytest.approx(d ** -0.5)
    assert weights.std_of(arch, init, "wo", shapes["wo"]) == \
        pytest.approx((arch["n_heads"] * arch["head_dim"]) ** -0.5)
    assert weights.std_of(arch, init, "w_down", shapes["w_down"]) == pytest.approx(ff ** -0.5)
    assert weights.std_of(arch, init, "ln1", shapes["ln1"]) == 0.1
    moe = _arch(True)
    s = weights.layer_shapes(moe)
    assert s["w_up"] == (4, d, ff) and s["w_down"] == (4, ff, d) and s["w_router"] == (d, 4)
    assert weights.std_of(moe, init, "w_down", s["w_down"]) == pytest.approx(ff ** -0.5)
