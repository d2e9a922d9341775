"""PyTorch port, pruning: FullBlock masks ≡ the JAX package's
``prune_params``, compressed execution ≡ masked-dense, and the FlexBlock
spec copy ≡ the reference's.

Weights are drawn with numpy from a seed and handed to both packages in
f32; masks must be equal, logits are held to 2e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import pruning as TP
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock, IntraBlock
from repro_torch.models import transformer as TT
from repro_torch.models.layers import BlockSparseLinear
from repro_torch.sparsity import apply as TA

KEYS = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


@pytest.fixture(scope="module")
def model(R):
    jcfg = R.configs.get_config("llama3-8b").reduced()
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    pj = R.transformer.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    host = jax.tree.map(np.asarray, pj)
    return jcfg, cfg, pj, params_from_jax(host, "cpu")


@pytest.fixture(scope="module")
def pruned(R, model):
    jcfg, cfg, pj, pt = model
    ppj, mj = R.apply.prune_params(pj, R.flexblock.FlexBlockSpec((R.flexblock.FullBlock(16, 16, 0.5),)),
                                   keys=KEYS)
    ppt, mt = TA.prune_params(pt, FlexBlockSpec((FullBlock(16, 16, 0.5),)), keys=KEYS,
                              device="cpu")
    return ppj, mj, ppt, mt


@pytest.mark.parametrize("key", KEYS)
def test_masks_equal_reference(pruned, key):
    ppj, mj, ppt, mt = pruned
    want = np.asarray(mj["layers"][key]).astype(bool)
    assert mt["layers"][key].dtype == torch.bool
    np.testing.assert_array_equal(mt["layers"][key].numpy(), want)
    np.testing.assert_array_equal(ppt["layers"][key].numpy(), np.asarray(ppj["layers"][key]))


def test_untouched_keys_and_report_match(pruned):
    ppj, mj, ppt, mt = pruned
    assert {k for k, m in mt["layers"].items() if m is None} == \
        {k for k, m in mj["layers"].items() if m is None}
    assert TA.sparsity_report(ppt, mt) == pytest.approx(
        _reference_report(mj), abs=1e-12)


def _reference_report(mj):
    rep = {f"layers/{k}": float(np.asarray(m).mean()) for k, m in mj["layers"].items()
           if m is not None}
    ms = [np.asarray(m) for m in mj["layers"].values() if m is not None]
    rep["overall_density"] = sum(float(m.sum()) for m in ms) / sum(m.size for m in ms)
    return rep


def test_prune_leaves_input_untouched(model):
    _, _, _, pt = model
    spec = FlexBlockSpec((FullBlock(16, 16, 0.5),))
    src = {"layers": {k: v.clone() for k, v in pt["layers"].items()}}
    out, masks = TA.prune_params(src, spec, keys=("wq",), device="cpu")
    assert torch.equal(src["layers"]["wq"], pt["layers"]["wq"])
    assert out["layers"]["wq"] is not src["layers"]["wq"]
    assert out["layers"]["wk"] is src["layers"]["wk"]
    assert torch.equal(out["layers"]["wq"], src["layers"]["wq"] * masks["layers"]["wq"])


def test_compressed_forward_matches_masked_dense_and_reference(R, model, pruned):
    jcfg, cfg, _, _ = model
    ppj, _, ppt, mt = pruned
    cp = TA.compress_params(ppt, mt, 16, 16)
    for key in KEYS:
        assert isinstance(cp["layers"][key], BlockSparseLinear)
    assert torch.is_tensor(cp["layers"]["wo"])
    wq = cp["layers"]["wq"]
    assert wq.w_comp.shape[:2] == (cfg.n_layers, 4) and wq.w_comp.shape[3:] == (16, 16)
    assert wq.out_shape == (cfg.n_heads, 16) and wq.in_features == cfg.d_model
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    lc = TT.forward(cp, tt, cfg)
    torch.testing.assert_close(lc, TT.forward(ppt, tt, cfg), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lc.numpy(), np.asarray(R.transformer.forward(ppj, jnp.asarray(toks),
                                                                            jcfg)), atol=2e-4)


def test_compress_rejects_non_block_masks(model):
    _, _, _, pt = model
    mask = torch.ones_like(pt["layers"]["wq"], dtype=torch.bool)
    mask[0, 0, 0, 0] = False
    with pytest.raises(ValueError, match="whole"):
        TA.compress_params(pt, {"layers": {"wq": mask}}, 16, 16)
    with pytest.raises(ValueError, match="input-major"):
        TA.compress_params(pt, {"layers": {"wo": torch.ones_like(pt["layers"]["wo"],
                                                                  dtype=torch.bool)}}, 16, 16)


def test_wo_with_large_blocks_is_rejected_as_in_reference(R, model):
    """wo collapses to (Hq, hd*d): a block taller than Hq does not fit."""
    _, _, pj, pt = model
    with pytest.raises(ValueError, match="exceeds"):
        R.apply.prune_params(pj, R.flexblock.FlexBlockSpec((R.flexblock.FullBlock(16, 16, 0.5),)),
                             keys=("wo",))
    with pytest.raises(ValueError, match="exceeds"):
        TA.prune_params(pt, FlexBlockSpec((FullBlock(16, 16, 0.5),)), keys=("wo",), device="cpu")


@pytest.mark.parametrize("shape,m,n,ratio", [
    ((64, 64), 16, 16, 0.5), ((60, 50), 16, 8, 0.3), ((32, 48), -1, 4, 0.75),
    ((48, 32), 8, -1, 0.5),
])
@pytest.mark.parametrize("crit", ["l1", "l2"])
def test_fullblock_mask_matches_numpy_reference(R, shape, m, n, ratio, crit):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = R.pruning.fullblock_mask(w, R.flexblock.FullBlock(m, n, ratio), crit)
    got = TP.fullblock_mask(torch.from_numpy(w), FullBlock(m, n, ratio), crit)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    bm, bn = (m if m > 0 else shape[0]), (n if n > 0 else shape[1])
    np.testing.assert_allclose(TP.block_losses(torch.from_numpy(w), bm, bn, crit).numpy(),
                               R.pruning.block_losses(w, bm, bn, crit), rtol=1e-5)


def test_ties_break_by_block_index():
    losses = torch.tensor([[1.0, 2.0, 2.0], [2.0, 0.5, 2.0]])
    keep = TP.keep_from_losses(losses, 3)
    assert keep.tolist() == [[False, True, True], [True, False, False]]
    elig = torch.tensor([[True, False, True], [True, True, True]])
    assert TP.keep_from_losses(losses, 2, elig).tolist() == \
        [[False, False, True], [True, False, False]]


def test_flexblock_spec_copy_matches_reference(R):
    for args in [(16, 16, 0.5), (-1, 4, 0.25), (128, 128, 0.9)]:
        a, b = FullBlock(*args), R.flexblock.FullBlock(*args)
        for shape in [(256, 512), (4096, 14336), (300, 77)]:
            assert a.grid(shape) == b.grid(shape)
            assert a.nonzero_blocks(shape) == b.nonzero_blocks(shape)
            assert dataclasses.astuple(a.bind(shape)) == dataclasses.astuple(b.bind(shape))
    with pytest.raises(ValueError):
        FullBlock(1, 1, 0.5)
    with pytest.raises(ValueError):
        FullBlock(4, 4, 1.0)
    spec = FlexBlockSpec((FullBlock(128, 128, 0.5),))
    with pytest.raises(ValueError, match="exceeds"):
        spec.validate_for((32, 524288))          # wo collapsed the reference's way
    assert FlexBlockSpec().is_dense and spec.full == FullBlock(128, 128, 0.5)


def test_intrablock_is_not_ported():
    with pytest.raises(NotImplementedError):
        IntraBlock(2, 1, 0.5)


def test_prune_params_without_device_raises_on_cpu_host(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.prune_params(model[3], FlexBlockSpec((FullBlock(16, 16, 0.5),)), keys=("wq",))
