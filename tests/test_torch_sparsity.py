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
from repro_torch.models.layers import BlockSparseLinear, IntraBlockLinear
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


@pytest.mark.parametrize("args", [(2, 1, 0.5), (4, 1, 0.5), (4, 1, 0.75), (8, 1, 0.6),
                                  (4, 1, 0.5, ((1, 1, 0, 0), (0, 0, 1, 1), (1, 0, 1, 0)))])
def test_intrablock_spec_copy_matches_reference(R, args):
    a, b = IntraBlock(*args), R.flexblock.IntraBlock(*args)
    assert a.phi == b.phi and a.kind == b.kind == "intra"
    assert a.patterns() == b.patterns() and a.default_patterns() == b.default_patterns()
    assert a.bind((64, 64)) is a
    for full in [FullBlock(8, 16, 0.5), FullBlock(-1, 4, 0.25)]:
        ours = FlexBlockSpec((a, full))
        theirs = R.flexblock.FlexBlockSpec((b, R.flexblock.FullBlock(full.m, full.n, full.ratio)))
        for shape in [(64, 64), (256, 96)]:
            assert ours.overall_density(shape) == theirs.overall_density(shape)
        assert ours.describe() == theirs.describe() and ours.intra == a and ours.full == full
    assert FlexBlockSpec((a,)).describe() == R.flexblock.FlexBlockSpec((b,)).describe()


@pytest.mark.parametrize("args", [
    (2, 2, 0.5),                               # n != 1
    (4, 1, 0.9),                               # phi = 0
    (4, 1, 1.0), (1, 1, 0.5),                  # ratio / block size
    (4, 1, 0.5, ((1, 1, 0),)),                 # pattern of the wrong size
    (4, 1, 0.5, ((1, 1, 1, 0),)),              # pattern keeping 3, not phi = 2
])
def test_intrablock_spec_errors_match_reference(R, args):
    with pytest.raises(ValueError) as theirs:
        R.flexblock.IntraBlock(*args)
    with pytest.raises(ValueError) as ours:
        IntraBlock(*args)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("pats", [
    ("full", "full"), ("full", "intra"), ("intra", "intra"),
    ("intra4", "full6"), ("intra4", "full8", "full8"),
])
def test_spec_composition_checks_match_reference(R, pats):
    def make(mod, name):
        return {"full": mod.FullBlock(4, 4, 0.5), "intra": mod.IntraBlock(2, 1, 0.5),
                "intra4": mod.IntraBlock(4, 1, 0.5), "full6": mod.FullBlock(6, 4, 0.5),
                "full8": mod.FullBlock(8, 4, 0.5)}[name]
    import repro_torch.core.flexblock as ours_mod
    with pytest.raises(ValueError) as theirs:
        R.flexblock.FlexBlockSpec(tuple(make(R.flexblock, p) for p in pats))
    with pytest.raises(ValueError) as ours:
        FlexBlockSpec(tuple(make(ours_mod, p) for p in pats))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("shape,m,ratio,pattern_set", [
    ((64, 48), 4, 0.5, None), ((30, 20), 4, 0.5, None), ((64, 16), 8, 0.75, None),
    ((32, 24), 2, 0.5, None),
    ((64, 48), 4, 0.5, ((1, 1, 0, 0), (0, 0, 1, 1), (1, 0, 0, 1))),
    ((40, 12), 4, 0.75, ((1, 0, 0, 0), (0, 0, 0, 1))),
])
@pytest.mark.parametrize("align_cols", [False, True])
@pytest.mark.parametrize("crit", ["l1", "l2"])
def test_intrablock_mask_matches_reference(R, shape, m, ratio, pattern_set, align_cols, crit):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = R.pruning.intrablock_mask(w, R.flexblock.IntraBlock(m, 1, ratio, pattern_set), crit,
                                     align_cols=align_cols)
    got = TP.intrablock_mask(torch.from_numpy(w), IntraBlock(m, 1, ratio, pattern_set), crit,
                             align_cols=align_cols)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))


def test_intrablock_mask_ties_keep_the_first_rows(R):
    """Equal importances: stable top-φ keeps the lowest rows of each block,
    and a restricted pattern set takes its first best pattern."""
    w = np.ones((8, 4), np.float32)
    for ps in (None, ((0, 1, 1, 0), (1, 1, 0, 0))):
        want = R.pruning.intrablock_mask(w, R.flexblock.IntraBlock(4, 1, 0.5, ps))
        got = TP.intrablock_mask(torch.from_numpy(w), IntraBlock(4, 1, 0.5, ps))
        np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    assert got[:4, 0].tolist() == [False, True, True, False]


@pytest.mark.parametrize("align_cols", [False, True])
@pytest.mark.parametrize("spec_args", [
    ((2, 1, 0.5), (4, 16, 0.5)), ((4, 1, 0.5), (8, -1, 0.25)), ((4, 1, 0.5), None),
])
def test_composed_flexblock_mask_matches_reference(R, spec_args, align_cols):
    intra, full = spec_args
    w = np.random.default_rng(3).normal(size=(64, 48)).astype(np.float32)
    theirs = (R.flexblock.IntraBlock(*intra),) + (
        (R.flexblock.FullBlock(*full),) if full else ())
    ours = (IntraBlock(*intra),) + ((FullBlock(*full),) if full else ())
    want = R.pruning.flexblock_mask(w, R.flexblock.FlexBlockSpec(theirs), align_cols=align_cols)
    got = TP.flexblock_mask(torch.from_numpy(w), FlexBlockSpec(ours), align_cols=align_cols)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    assert abs(got.float().mean().item() - FlexBlockSpec(ours).overall_density(w.shape)) < 1e-9


def test_compress_params_intrablock_layout_and_errors(model):
    _, cfg, _, pt = model
    spec = FlexBlockSpec((IntraBlock(4, 1, 0.5),))
    pp, masks = TA.prune_params(pt, spec, keys=("wq", "w_down"), align_cols=True, device="cpu")
    cp = TA.compress_params(pp, masks, m=4)
    wq, wd = cp["layers"]["wq"], cp["layers"]["w_down"]
    assert isinstance(wq, IntraBlockLinear) and isinstance(wd, IntraBlockLinear)
    assert tuple(wq.w_comp.shape) == (cfg.n_layers, cfg.d_model // 2, cfg.n_heads * 16)
    assert tuple(wd.row_idx.shape) == (cfg.n_layers, cfg.d_ff // 2)
    assert wq.row_idx.dtype == torch.int32 and wq.out_shape == (cfg.n_heads, 16)
    l1 = wq.layer(1)
    mat = pp["layers"]["wq"][1].reshape(cfg.d_model, -1)
    assert torch.equal(l1.w_comp, mat[l1.row_idx.long()])
    x = torch.randn(3, cfg.d_model)
    torch.testing.assert_close(l1(x), x @ mat, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="either"):
        TA.compress_params(pp, masks, 16, 16, m=4)
    with pytest.raises(ValueError, match="either"):
        TA.compress_params(pp, masks)
    unaligned = TA.prune_params(pt, spec, keys=("wq",), device="cpu")[1]["layers"]["wq"]
    with pytest.raises(ValueError, match="wq: mask is not row-aligned"):
        TA.compress_params(pp, {"layers": {"wq": unaligned}}, m=4)
    with pytest.raises(ValueError, match="row_idx"):
        IntraBlockLinear(wq.w_comp, wq.row_idx + cfg.d_model, cfg.d_model, wq.out_shape)
    with pytest.raises(ValueError, match="whole"):
        TA.compress_params(pp, masks, 16, 16)


def test_prune_params_without_device_raises_on_cpu_host(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TA.prune_params(model[3], FlexBlockSpec((FullBlock(16, 16, 0.5),)), keys=("wq",))


def test_bf16_block_losses_sum_in_f32_as_the_oracle_does(R):
    """A stated difference from the JAX package's own pruning path.

    On a seeded bf16 matrix the port's Eq. 1 losses equal the JAX oracle
    ``block_importance_ref`` (rho in bf16, sums in f32), as the Pallas
    kernel sums too.  The JAX numpy ``core.pruning.block_losses``, which
    the JAX ``prune_params`` calls, sums in the array's dtype: in bf16 each
    128 x 128 block's sum stalls near 1024, far below the f32 sum (about
    13000), so its bf16 masks rest on saturated, nearly tied sums.  The
    port does not copy that; at f32 the two packages' masks agree.
    """
    rng = np.random.default_rng(7)
    w32 = rng.standard_normal((256, 384)).astype(np.float32)
    wb = np.asarray(jnp.asarray(w32, dtype=jnp.bfloat16))
    port = TP.block_losses(torch.from_numpy(w32).to(torch.bfloat16), 128, 128, "l1",
                           impl="ref")
    oracle = np.asarray(R.kref.block_importance_ref(jnp.asarray(wb), 128, 128, "l1"))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), oracle, rtol=1e-6)
    numpy_sums = R.pruning.block_losses(wb, 128, 128, "l1")
    assert numpy_sums.dtype == wb.dtype                      # summed in bf16
    assert np.all(numpy_sums.astype(np.float32) < 0.1 * oracle)
    assert np.all(oracle > 12000)
    spec_t, spec_j = FullBlock(128, 128, 0.5), R.flexblock.FullBlock(128, 128, 0.5)
    np.testing.assert_array_equal(
        TP.fullblock_mask(torch.from_numpy(w32), spec_t, "l1", impl="ref").numpy(),
        R.pruning.fullblock_mask(w32, spec_j, "l1").astype(bool))
