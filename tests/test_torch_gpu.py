"""PyTorch port on the card: each CUDA kernel ≡ its plain version, and the
model's kernel path ≡ its plain path.  Marked ``gpu``; without a CUDA
device every test skips.  Run on a GPU host with
``python -m pytest -m gpu tests/test_torch_gpu.py`` (this file does not
import jax, so it runs where only PyTorch is installed).
"""
import ctypes
import dataclasses
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock, IntraBlock
from repro_torch.core.input_sparsity import profile_activations
from repro_torch.core.pruning import intrablock_mask
from repro_torch.kernels import ops, plans, ref
from repro_torch.models import transformer as TT
from repro_torch.models.layers import BlockSparseLinear, IntraBlockLinear
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sparsity.apply import compress_params, prune_params

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("S,hd,window,Hq,Hkv", [(128, 64, None, 4, 2), (256, 128, 64, 8, 2),
                                                (256, 256, None, 2, 1), (384, 128, None, 4, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(gen, S, hd, window, Hq, Hkv, dtype):
    q = _randn(gen, 2, S, Hq, hd, dtype=dtype)
    k, v = _randn(gen, 2, S, Hkv, hd, dtype=dtype), _randn(gen, 2, S, Hkv, hd, dtype=dtype)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, window=window)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, window=window, impl="ref")
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("S", [128, 256, 384, 512, 2048])
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (8, 2), (32, 32)])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_wgmma_variant_matches_plain(gen, S, Hq, Hkv, window):
    """The wgmma variant (bf16, hd 128, causal) at the plan's levers: within
    3e-2 of plain, two calls bitwise equal, only its counter moving."""
    q = _randn(gen, 1, S, Hq, 128, dtype=torch.bfloat16)
    k = _randn(gen, 1, S, Hkv, 128, dtype=torch.bfloat16)
    v = _randn(gen, 1, S, Hkv, 128, dtype=torch.bfloat16)
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    assert _variant_delta(before) == {"flash_attention": {"wgmma": 2}}
    assert torch.equal(out, again)
    want = ops.flash_attention(q, k, v, window=window, impl="ref")
    torch.testing.assert_close(out.float(), want.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_attention_other_head_dims_take_the_general_variant(gen, hd):
    """Off the wgmma variant's contract at hd 64 and 256, a q whose storage
    starts 2 bytes off a 16-byte boundary takes the general variant, which
    loads such rows element by element, within 3e-2 of plain."""
    buf = _randn(gen, 256 * 8 * hd + 1, dtype=torch.bfloat16)
    q = buf[1:].view(1, 256, 8, hd)
    k, v = (_randn(gen, 1, 256, 2, hd, dtype=torch.bfloat16) for _ in range(2))
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v)
    assert _variant_delta(before) == {"flash_attention": {"general": 1}}
    torch.testing.assert_close(out.float(), ops.flash_attention(q, k, v, impl="ref").float(),
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("S", [128, 512, 1664, 2048])
@pytest.mark.parametrize("Hq,Hkv", [(25, 5), (16, 16)])
@pytest.mark.parametrize("window", [None, 1024])
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_attention_wgmma_at_hd_64_and_256_matches_plain(gen, hd, window, Hq, Hkv, S):
    """The wgmma variant at hd 64 (hymba-1.5b) and 256 (gemma-7b), GQA
    25 / 5 and MHA 16 / 16, with and without a 1024-token window: within
    3e-2 of plain, two calls bitwise equal, only its counter moving."""
    q = _randn(gen, 1, S, Hq, hd, dtype=torch.bfloat16)
    k = _randn(gen, 1, S, Hkv, hd, dtype=torch.bfloat16)
    v = _randn(gen, 1, S, Hkv, hd, dtype=torch.bfloat16)
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    assert _variant_delta(before) == {"flash_attention": {"wgmma": 2}}
    assert torch.equal(out, again)
    want = ops.flash_attention(q, k, v, window=window, impl="ref")
    torch.testing.assert_close(out.float(), want.float(), atol=3e-2, rtol=0)


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_attention_wgmma_every_built_setting_matches_plain(gen, hd):
    """Every (rows, keys, pack) setting built at the head dim, through the
    C entry point, within 3e-2 of plain (window 100 on a 384-token input,
    4 q heads per kv head so that pack 4 runs too)."""
    import math
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    q = _randn(gen, 2, 384, 8, hd, dtype=torch.bfloat16)
    k, v = (_randn(gen, 2, 384, 2, hd, dtype=torch.bfloat16) for _ in range(2))
    want = ops.flash_attention(q, k, v, window=100, impl="ref")
    settings = plans.fa_settings(hd, 4)
    assert len(settings) == (2 if hd == 256 else 8)
    for rows, keys, pack in settings:
        o = torch.empty_like(q)
        _build.check(lib.fa_fwd_bf16_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           o.data_ptr(), 2, 384, 8, 2, hd, 100,
                                           1.0 / math.sqrt(hd), rows, keys, pack,
                                           _build.stream_ptr(q.device)), "wgmma")
        torch.testing.assert_close(o.float(), want.float(), atol=3e-2, rtol=0)
    o = torch.empty_like(q)
    assert lib.fa_fwd_bf16_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 2, 384,
                                 8, 2, hd, 100, 1.0, 128, 128 if hd == 256 else 96, 1,
                                 _build.stream_ptr(q.device)) != 0


def test_flash_attention_wgmma_launch_failure_raises(gen, monkeypatch):
    """No fallback: a plan the kernel was not built for (128-key tiles at
    hd 256) makes the C entry refuse the launch, and the wrapper raises
    instead of running general or the plain version."""
    from repro_torch.kernels import flash_attention as fa_mod
    monkeypatch.setattr(fa_mod, "fa_plan", lambda *a: plans.FaPlan("wgmma", 128, 128, 1))
    q, k, v = (_randn(gen, 1, 256, 4, 256, dtype=torch.bfloat16) for _ in range(3))
    before = ops.variant_counts()
    with pytest.raises(RuntimeError, match="fa_fwd_bf16_wgmma"):
        ops.flash_attention(q, k, v)
    assert _variant_delta(before) == {}


def test_kernel_build_failure_raises(gen, monkeypatch, tmp_path):
    """No fallback: a kernel library that fails to build raises from the
    wrapper's first call, for flash attention and the gather-matmul."""
    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    for name in ("flash_attention", "intrablock_matmul"):
        monkeypatch.delitem(_build._LIBS, name, raising=False)
    q, k, v = (_randn(gen, 1, 128, 2, 64, dtype=torch.bfloat16) for _ in range(3))
    before = ops.variant_counts()
    with pytest.raises(RuntimeError, match="nvcc failed for flash_attention"):
        ops.flash_attention(q, k, v)
    x, w = _randn(gen, 4, 64, dtype=torch.bfloat16), _randn(gen, 32, 6482, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc failed for intrablock_matmul"):
        ops.intrablock_gather_matmul(x, ops.aligned_rows(w[None])[0],
                                     torch.arange(32, dtype=torch.int32, device="cuda"))
    assert _variant_delta(before) == {}


@pytest.mark.parametrize("M,N", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)])
@pytest.mark.parametrize("crit", ["l1", "l2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_importance_strip_variant_matches_plain(gen, M, N, crit, dtype):
    """The llama3-8b projection shapes in 128 x 128 blocks: the strip
    variant within rtol 1e-5 of plain, two calls bitwise equal, only its
    counter moving."""
    w = _randn(gen, M, N, dtype=dtype)
    before = ops.variant_counts()
    out = ops.block_importance(w, 128, 128, crit)
    again = ops.block_importance(w, 128, 128, crit)
    assert _variant_delta(before) == {"block_importance": {"strip": 2}}
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref.block_importance_ref(w, 128, 128, crit),
                               rtol=1e-5, atol=0)


def test_block_importance_other_blocks_take_the_general_variant(gen):
    w = _randn(gen, 256, 384, dtype=torch.bfloat16)
    before = ops.variant_counts()
    out = ops.block_importance(w, 64, 128, "l1")
    assert _variant_delta(before) == {"block_importance": {"general": 1}}
    torch.testing.assert_close(out, ref.block_importance_ref(w, 64, 128, "l1"),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("K,N,bm,bn,B", [(512, 256, 128, 128, 4), (384, 128, 128, 64, 5),
                                         (256, 256, 64, 64, 70), (128, 64, 32, 32, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_matmul_kernel_matches_plain(gen, K, N, bm, bn, B, dtype):
    keep = torch.rand(K // bm, N // bn, generator=gen, device="cuda") < 0.5
    keep[0, 0] = False
    w_comp, idx = ops.compress_fullblock_torch(_randn(gen, K, N, dtype=dtype), keep, bm, bn)
    idx[:, -1] = -1                                   # a padding slot in every group
    x = _randn(gen, B, K, dtype=dtype)
    out = ops.block_sparse_matmul(x, w_comp, idx)
    want = ref.block_sparse_matmul_ref(x, w_comp, idx)
    scale = max(want.float().abs().max().item(), 1.0)
    torch.testing.assert_close(out.float() / scale, want.float() / scale,
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-5, rtol=0)


def _variant_delta(before):
    """Launches per variant since ``before``, for the ops that launched."""
    after = ops.variant_counts()
    delta = {op: {v: after[op][v] - before[op][v] for v in after[op]
                  if after[op][v] != before[op][v]} for op in after}
    return {op: d for op, d in delta.items() if d}


@pytest.mark.parametrize("B", [1, 4, 16, 17, 64, 512])
@pytest.mark.parametrize("Gn,K", [(8, 1024), (3, 2048), (2, 8192)])
def test_block_sparse_matmul_main_variants_match_plain(gen, B, Gn, K):
    """128 x 128 blocks at decode (B <= 16) and prefill sizes, wk-sized
    Gn = 8, -1 slots in mid-list and a column group that holds only
    padding (its output must be zero); at K = 8192 each CTA of a cluster
    walks more slots than its ring has stages.  Two calls are bitwise
    equal and only the chosen variant's counter moves."""
    gk = K // 128
    keep = torch.rand(gk, Gn, generator=gen, device="cuda") < 0.6
    keep[:, 1] = False                                # column group 1: padding only
    w_comp, idx = ops.compress_fullblock_torch(_randn(gen, K, Gn * 128, dtype=torch.bfloat16),
                                               keep, 128, 128, L=gk)
    for j in range(Gn):                               # move a -1 into mid-list
        live = int((idx[j] >= 0).sum())
        if 2 <= live < gk:
            perm = torch.cat([idx[j, :1], idx[j, live:live + 1], idx[j, 1:live],
                              idx[j, live + 1:]])
            wperm = torch.cat([w_comp[j, :1], w_comp[j, live:live + 1], w_comp[j, 1:live],
                               w_comp[j, live + 1:]])
            idx[j], w_comp[j] = perm, wperm
    x = _randn(gen, B, K, dtype=torch.bfloat16)
    want = ref.block_sparse_matmul_ref(x, w_comp, idx)
    before = ops.variant_counts()
    out = ops.block_sparse_matmul(x, w_comp, idx)
    again = ops.block_sparse_matmul(x, w_comp, idx)
    variant = "decode" if B <= 16 else "prefill"
    assert _variant_delta(before) == {"block_sparse_matmul": {variant: 2}}
    assert torch.equal(out, again)
    assert not out[:, 128:256].any()
    scale = max(want.float().abs().max().item(), 1.0)
    torch.testing.assert_close(out.float() / scale, want.float() / scale, atol=1e-2, rtol=0)


def test_block_sparse_matmul_unaligned_takes_the_general_variant(gen):
    keep = torch.rand(4, 2, generator=gen, device="cuda") < 0.5
    w_comp, idx = ops.compress_fullblock_torch(_randn(gen, 512, 256, dtype=torch.bfloat16),
                                               keep, 128, 128)
    buf = _randn(gen, 4 * 512 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(4, 512)
    before = ops.variant_counts()
    out = ops.block_sparse_matmul(x, w_comp, idx)
    assert _variant_delta(before) == {"block_sparse_matmul": {"general": 1}}
    want = ref.block_sparse_matmul_ref(x, w_comp, idx)
    scale = max(want.float().abs().max().item(), 1.0)
    torch.testing.assert_close(out.float() / scale, want.float() / scale, atol=1e-2, rtol=0)


@pytest.mark.parametrize("B", [1, 4, 16, 17, 64, 512])
@pytest.mark.parametrize("K,N,m", [(1000, 1024, 4), (2560, 256, 2), (8192, 256, 2)])
def test_intrablock_gather_matmul_main_variants_match_plain(gen, B, K, N, m):
    """Kc = 500 (not a multiple of the 64-row chunk) at N = 1024 (split-K
    over 8 CTAs a tile at decode), Kc = 1280 at N = 256, and Kc = 4096,
    where each CTA walks more chunks than its ring has stages; two calls
    are bitwise equal and only the chosen variant's counter moves."""
    w = _randn(gen, K, N, dtype=torch.bfloat16)
    mask = intrablock_mask(w.float(), IntraBlock(m, 1, 0.5), align_cols=True)
    w_comp, row_idx = ops.compress_intrablock_torch(w, mask, m)
    x = _randn(gen, B, K, dtype=torch.bfloat16)
    want = ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
    before = ops.variant_counts()
    out = ops.intrablock_gather_matmul(x, w_comp, row_idx)
    again = ops.intrablock_gather_matmul(x, w_comp, row_idx)
    variant = "decode" if B <= 16 else "prefill"
    assert _variant_delta(before) == {"intrablock_gather_matmul": {variant: 2}}
    assert torch.equal(out, again)
    scale = max(want.float().abs().max().item(), 1.0)
    torch.testing.assert_close(out.float() / scale, want.float() / scale, atol=1e-2, rtol=0)


@pytest.mark.parametrize("M,N,bm,bn", [(64, 64, 8, 8), (128, 256, 32, 16), (256, 384, 128, 128)])
@pytest.mark.parametrize("crit", ["l1", "l2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_importance_kernel_matches_plain(gen, M, N, bm, bn, crit, dtype):
    w = _randn(gen, M, N, dtype=dtype)
    torch.testing.assert_close(ops.block_importance(w, bm, bn, crit),
                               ref.block_importance_ref(w, bm, bn, crit), rtol=1e-5, atol=0)


def test_pruned_model_kernel_path_matches_plain_path(gen):
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), d_model=256, head_dim=64,
                              n_heads=4, n_kv_heads=2, d_ff=512)
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    params, masks = prune_params(params, FlexBlockSpec((FullBlock(64, 64, 0.5),)),
                                 keys=("wq", "wk", "wv", "w_gate", "w_up", "w_down"))
    cp = compress_params(params, masks, 64, 64)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=gen, device="cuda")
    la = TT.forward(cp, toks, cfg)
    lr = TT.forward(cp, toks, cfg, impl="ref")
    assert (la - lr).abs().max().item() < 0.1
    engine = ServeEngine(cfg, cp, slots=2, max_len=128, dtype=torch.bfloat16)
    reqs = [Request(prompt=toks[0, :n].cpu().numpy(), max_new_tokens=4) for n in (40, 17, 9)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done and len(r.output) == 4 for r in reqs)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("flash_attention", "block_sparse_matmul",
                                       "block_importance"))


@pytest.mark.parametrize("B,K,N,m", [(4, 256, 384, 4), (5, 200, 130, 4), (70, 512, 1000, 4),
                                     (129, 96, 64, 2), (1, 64, 8, 2), (16, 328, 136, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_intrablock_gather_matmul_kernel_matches_plain(gen, B, K, N, m, dtype):
    """Ragged B (row tiles of 16/64), N (tiles of 128, the last one ragged
    in decode and prefill; N 130, rows of 260 bytes, takes general and its
    scalar weight loads) and Kc (chunks of 64)."""
    w = _randn(gen, K, N, dtype=dtype)
    mask = intrablock_mask(w.float(), IntraBlock(m, 1, 0.5), align_cols=True)
    w_comp, row_idx = ops.compress_intrablock_torch(w, mask, m)
    x = _randn(gen, B, K, dtype=dtype)
    before = ops.launch_counts()["intrablock_gather_matmul"]
    out = ops.intrablock_gather_matmul(x, w_comp, row_idx)
    assert ops.launch_counts()["intrablock_gather_matmul"] == before + 1
    want = ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
    assert out.shape == (B, N) and out.dtype == dtype
    scale = max(want.float().abs().max().item(), 1.0)
    torch.testing.assert_close(out.float() / scale, want.float() / scale,
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_intrablock_gather_matmul_any_indices_and_unaligned_weights(gen, dtype):
    """Repeated, unordered indices, and a w_comp whose storage starts off
    a 16-byte boundary (N % 8 == 0, so only the pointer forces the scalar
    weight loads)."""
    B, K, Kc, N = 33, 300, 150, 256
    row_idx = torch.randint(0, K, (Kc,), generator=gen, device="cuda", dtype=torch.int32)
    buf = _randn(gen, Kc * N + 1, dtype=dtype)
    w_comp = buf[1:].view(Kc, N)
    x = _randn(gen, B, K, dtype=dtype)
    want = ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
    scale = max(want.float().abs().max().item(), 1.0)
    torch.testing.assert_close(ops.intrablock_gather_matmul(x, w_comp, row_idx).float() / scale,
                               want.float() / scale,
                               atol=1e-2 if dtype == torch.bfloat16 else 1e-5, rtol=0)


@pytest.mark.parametrize("B", [4, 40])
def test_intrablock_gather_matmul_odd_row_stride_takes_general_in_place(gen, B):
    """A row-strided view whose stride (130 elements, 260 bytes) no tensor
    map can describe: the general variant reads it through its stride,
    within 1e-2 of max |plain| on the same view."""
    K, Kc, N = 300, 150, 129
    row_idx = torch.randint(0, K, (Kc,), generator=gen, device="cuda", dtype=torch.int32)
    w_comp = _randn(gen, Kc, 130, dtype=torch.bfloat16)[:, :N]
    x = _randn(gen, B, K, dtype=torch.bfloat16)
    before = ops.variant_counts()
    out = ops.intrablock_gather_matmul(x, w_comp, row_idx)
    assert _variant_delta(before) == {"intrablock_gather_matmul": {"general": 1}}
    want = ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
    scale = max(want.float().abs().max().item(), 1.0)
    torch.testing.assert_close(out.float() / scale, want.float() / scale, atol=1e-2, rtol=0)


def test_intrablock_gather_matmul_launch_failure_raises(gen, monkeypatch):
    """No fallback: a decode plan forced onto hymba's w_in stored
    contiguously (N 6482: rows of 12,964 bytes, no tensor map) makes the C
    entry refuse the launch, and the wrapper raises."""
    from repro_torch.kernels import intrablock_matmul as igm_mod
    monkeypatch.setattr(igm_mod, "igm_plan", lambda *a: plans.Plan("decode", 1))
    x, w = _randn(gen, 4, 1600, dtype=torch.bfloat16), _randn(gen, 800, 6482, dtype=torch.bfloat16)
    before = ops.variant_counts()
    with pytest.raises(RuntimeError, match="igm_bf16_decode"):
        ops.intrablock_gather_matmul(x, w, torch.arange(800, dtype=torch.int32, device="cuda"))
    assert _variant_delta(before) == {}


def test_intrablock_gather_matmul_rejects_bad_indices(gen):
    x, w_comp = _randn(gen, 4, 64), _randn(gen, 32, 16)
    for bad in (64, -1):
        row_idx = torch.arange(32, dtype=torch.int32, device="cuda")
        row_idx[5] = bad
        with pytest.raises(ValueError, match="row_idx"):
            ops.intrablock_gather_matmul(x, w_comp, row_idx)
    with pytest.raises(TypeError, match="int32"):
        ops.intrablock_gather_matmul(x, w_comp, torch.arange(32, device="cuda"))
    with pytest.raises(TypeError, match="share"):
        ops.intrablock_gather_matmul(x.bfloat16(), w_comp, row_idx.clamp(0, 63))


@pytest.mark.parametrize("V,K,g,n_bits,lim", [
    (16, 64, 16, 8, 40), (100, 96, 32, 8, 40), (128, 256, 64, 8, 40),   # tests/test_kernels.py
    (100, 100, 32, 8, 128), (100, 100, 32, 8, 6), (7, 45, 4, 5, 128), (3, 33, 32, 3, 9),
    (2048, 2560, 32, 8, 128), (2048, 9728, 32, 8, 12), (5, 64, 16, 32, 128),
    (100, 96, 64, 8, 128), (4, 1024, 512, 8, 128), (1916, 9728, 32, 8, 128),
])
def test_bitserial_zero_profile_kernel_equals_plain(gen, V, K, g, n_bits, lim):
    """Exact equality, over ragged K (zero-padded, skippable), −128, small
    magnitudes (many zero planes) and n_bits below and above 8, in the
    variant the plan names (strip where K and g are whole 16-byte chunks)."""
    q = torch.randint(-lim, lim, (V, K), generator=gen, device="cuda").to(torch.int8)
    q[0, : min(K, 3)] = -128
    variant = plans.bsp_plan(V, K, g, torch.int8, 256).variant
    before, vbefore = ops.launch_counts()["bitserial_zero_profile"], ops.variant_counts()
    out = ops.bitserial_zero_profile(q, g, n_bits)
    assert ops.launch_counts()["bitserial_zero_profile"] == before + 1
    assert _variant_delta(vbefore) == {"bitserial_zero_profile": {variant: 1}}
    want = ref.bitserial_zero_profile_ref(q, g, n_bits)
    assert out.dtype == torch.int32 and out.tolist() == want.tolist()
    # a misaligned start takes the first kernel's byte-by-byte loads
    buf = torch.empty(V * K + 1, dtype=torch.int8, device="cuda")
    qm = buf[1:].view(V, K)
    qm.copy_(q)
    vbefore = ops.variant_counts()
    assert ops.bitserial_zero_profile(qm, g, n_bits).tolist() == want.tolist()
    assert _variant_delta(vbefore) == {"bitserial_zero_profile": {"general": 1}}


def _tie_input(gen, V, K, dtype):
    """Every element on a half-integer multiple of 0.25 and the largest
    |x| = 127 * 0.25, so that quantize_int8's scale is 0.25 and every
    other element is a rounding tie."""
    k = torch.randint(-127, 127, (V, K), generator=gen, device="cuda")
    x = ((k.float() + 0.5) * 0.25).to(dtype)
    x[0, 0] = 127 * 0.25
    return x


@pytest.mark.parametrize("V,K,g,n_bits", [(1916, 2560, 32, 8), (1916, 9728, 32, 8),
                                          (37, 96, 16, 5), (7, 40, 16, 8), (64, 512, 128, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["normal", "ties", "ties_given", "clamp"])
def test_quantized_zero_profile_fused_equals_plain(gen, V, K, g, n_bits, dtype, case):
    """The fused variant counts exactly what quantize_int8 + the plain
    count give, on the card and on the CPU: ties (round half to even), a
    given scale, and a scale so small that both int8 bounds are hit."""
    scale = {"ties_given": 0.25, "clamp": 0.01}.get(case)
    if case.startswith("ties"):
        x = _tie_input(gen, V, K, dtype)
    else:
        x = _randn(gen, V, K, dtype=dtype) * (2.0 if case == "clamp" else 1.0)
        x[:, ::7] = 0
    assert plans.bsp_plan(V, K, g, dtype, 256).variant == "fused"
    vbefore = ops.variant_counts()
    out = ops.quantized_zero_profile(x, g, n_bits, per_tensor_scale=scale)
    assert _variant_delta(vbefore) == {"bitserial_zero_profile": {"fused": 1}}
    want = ref.quantized_zero_profile_ref(x, g, n_bits, per_tensor_scale=scale)
    assert out.dtype == torch.int32 and out.tolist() == want.tolist()
    assert want.tolist() == ref.quantized_zero_profile_ref(
        x.cpu(), g, n_bits, per_tensor_scale=scale).tolist()
    if case == "clamp":
        q = ref.quantize_int8(x, per_tensor_scale=scale)
        assert q.min().item() == -128 and q.max().item() == 127


def test_quantized_zero_profile_other_inputs_quantise_then_count(gen):
    """A float input the fused variant does not take (f16, ragged K, a
    misaligned start) is quantised on the card and counted as int8."""
    x = _randn(gen, 33, 100, dtype=torch.bfloat16)
    buf = torch.empty(64 * 96 + 1, dtype=torch.float32, device="cuda")
    xm = buf[1:].view(64, 96)
    xm.copy_(_randn(gen, 64, 96))
    for a, variant in ((x, "general"), (xm.half(), "strip"), (xm, "strip")):
        vbefore = ops.variant_counts()
        out = ops.quantized_zero_profile(a, 32)
        assert _variant_delta(vbefore) == {"bitserial_zero_profile": {variant: 1}}
        assert out.tolist() == ref.quantized_zero_profile_ref(a, 32).tolist()


def test_fused_division_equals_ieee_division(gen, tmp_path):
    """The fused variant's division with the reciprocal taken once per
    thread (the scale from the tensor's own max) against __fdiv_rn, by
    tests/csrc/bsp_division_check.cu built against the kernel's source:
    every finite bf16 x, random f32 x and every tie, for amax from 2^-40
    to the f32 maximum.  |q| never differs, and the quotient itself only
    below 2^-24 (tiny x whose remainder leaves the normal range), where it
    rounds to 0 either way."""
    from repro_torch.kernels import _build
    so = tmp_path / "bsp_division_check.so"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(_build._CSRC), "-o",
                    str(so), str(Path(__file__).parent / "csrc" / "bsp_division_check.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.bsp_division_check.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    rng = np.random.default_rng(0)
    amax = np.concatenate([
        2.0 ** np.arange(-40, 128), [0.0, 5e-9, 1e-8, 1.0 - 2**-24, 2.0 - 2**-23,
                                     float(np.finfo(np.float32).max)],
        np.exp(rng.uniform(np.log(1e-12), np.log(3e38), 3000)),
        np.abs(rng.normal(size=2000) * 8)]).astype(np.float32)
    amax = torch.from_numpy(amax[np.isfinite(amax)])
    amax = torch.cat([amax, amax[-2000:].bfloat16().float()]).cuda()   # bf16 activations' too
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    assert lib.bsp_division_check(amax.data_ptr(), amax.numel(), counts.data_ptr()) == 0
    tested, differ, differ_large, mag_differ = counts.tolist()
    assert tested > 5e8 and differ_large == 0 and mag_differ == 0, (tested, differ)


@pytest.mark.parametrize("op", ["strip", "fused"])
def test_one_launch_variants_replay_from_a_cuda_graph(gen, op):
    """One launch that leaves its ticket at 0: captured in a CUDA graph
    and replayed 3 times, it gives the plain count every time, also after
    the input changes under the graph."""
    if op == "strip":
        x = torch.randint(-128, 128, (1916, 2560), generator=gen, device="cuda").to(torch.int8)
        fn, plain = (lambda: ops.bitserial_zero_profile(x, 32)), ref.bitserial_zero_profile_ref
    else:
        x = _randn(gen, 1916, 2560, dtype=torch.bfloat16)
        fn, plain = (lambda: ops.quantized_zero_profile(x, 32)), ref.quantized_zero_profile_ref
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for i in range(3):
        if i == 2:
            x.copy_(torch.div(x, 3, rounding_mode="floor") if op == "strip" else x * 0.01)
        graph.replay()
        torch.cuda.synchronize()
        assert out.tolist() == plain(x, 32).tolist(), i


def test_bitserial_zero_profile_guards(gen):
    big = torch.zeros(1, 1, dtype=torch.int8, device="cuda").expand(2**16, 2**13)
    with pytest.raises(ValueError, match="overflow"):
        ops.bitserial_zero_profile(big, 1)                 # 2**32 slots
    q = torch.zeros(4, 32, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="n_bits"):
        ops.bitserial_zero_profile(q, 8, 33)
    assert ops.bitserial_zero_profile(q, 8).tolist() == [4 * 4 * 8] * 2


def test_intrablock_model_kernel_path_matches_plain_path(gen):
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), d_model=256, head_dim=64,
                              n_heads=4, n_kv_heads=2, d_ff=512)
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    params, masks = prune_params(params, FlexBlockSpec((IntraBlock(4, 1, 0.5),)),
                                 align_cols=True,
                                 keys=("wq", "wk", "wv", "w_gate", "w_up", "w_down"))
    cp = compress_params(params, masks, m=4)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=gen, device="cuda")
    la = TT.forward(cp, toks, cfg)
    lr = TT.forward(cp, toks, cfg, impl="ref")
    assert (la - lr).abs().max().item() < 0.1
    engine = ServeEngine(cfg, cp, slots=2, max_len=128, dtype=torch.bfloat16)
    reqs = [Request(prompt=toks[0, :n].cpu().numpy(), max_new_tokens=4) for n in (40, 17, 9)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done and len(r.output) == 4 for r in reqs)
    assert ops.launch_counts()["intrablock_gather_matmul"] > 0
    acts = {}
    TT._run(cp, toks, cfg, "auto", False,
            tap=lambda l, kind, a: acts.__setitem__(f"{l}/{kind}", a))
    assert len(acts) == 3 * cfg.n_layers
    ops.reset_launch_counts()
    assert profile_activations(acts, 32) == profile_activations(acts, 32, impl="ref")
    # one launch per activation, all through the fused quantise-and-count
    assert ops.launch_counts()["bitserial_zero_profile"] == len(acts)
    assert ops.variant_counts()["bitserial_zero_profile"] == {"strip": 0, "fused": len(acts),
                                                              "general": 0}


@pytest.mark.parametrize("kind", ["IntraBlock", "FullBlock"])
def test_default_key_prune_runs_wo_masked_dense_and_the_six_through_kernels(gen, kind):
    """Every prunable key, wo included, on the card: compress_params keeps
    wo the masked dense weight and runs the six input-major projections
    through their kernel, one launch per projection and layer of a
    prefill; the logits stay within 0.1 of the masked-dense plain path."""
    arch = "qwen3-4b" if kind == "IntraBlock" else "llama3-8b"
    cfg = dataclasses.replace(get_config(arch).reduced(), d_model=256, head_dim=64,
                              n_heads=16, n_kv_heads=4, d_ff=512)
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    if kind == "IntraBlock":
        spec, op, lin = FlexBlockSpec((IntraBlock(4, 1, 0.5),)), "intrablock_gather_matmul", \
            IntraBlockLinear
        pp, masks = prune_params(params, spec, align_cols=True)
        cp = compress_params(pp, masks, m=4)
    else:
        # wo collapses to (Hq, hd * d) = (16, 16384): the block is at most Hq rows
        spec, op, lin = FlexBlockSpec((FullBlock(16, 64, 0.5),)), "block_sparse_matmul", \
            BlockSparseLinear
        pp, masks = prune_params(params, spec)
        cp = compress_params(pp, masks, 16, 64)
    six = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")
    assert masks["layers"]["wo"] is not None and not bool(masks["layers"]["wo"].all())
    assert cp["layers"]["wo"] is pp["layers"]["wo"] and cp["layers"]["wo"].is_cuda
    assert all(isinstance(cp["layers"][k], lin) for k in six)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=gen, device="cuda")
    ops.reset_launch_counts()
    la = TT.forward(cp, toks, cfg)
    assert ops.launch_counts()[op] == len(six) * cfg.n_layers
    lr = TT.forward(pp, toks, cfg, impl="ref")
    assert (la.float() - lr.float()).abs().max().item() < 0.1


# ---------------------------------------------------------------------------
# The gemma family
# ---------------------------------------------------------------------------

def test_flash_attention_at_gemma7b_prefill_shape_takes_the_wgmma_variant(gen):
    """gemma-7b's prefill attention: q/k/v (1, 512, 16, 256) bf16, MHA,
    causal: head dim 256 runs the wgmma variant, within 3e-2 of plain."""
    q, k, v = (_randn(gen, 1, 512, 16, 256, dtype=torch.bfloat16) for _ in range(3))
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v)
    assert _variant_delta(before) == {"flash_attention": {"wgmma": 1}}
    torch.testing.assert_close(out.float(), ops.flash_attention(q, k, v, impl="ref").float(),
                               atol=3e-2, rtol=0)


def test_gemma2_shaped_attention_on_the_card(gen):
    """gemma2-9b's attention shape (16 q / 8 kv heads of 256) past a
    window, with scores pushed past the softcap: chunked_attention on the
    card equals the CPU's (f32, no TF32; 1e-4 for the order of the sums
    and tanh's last bits at the cap), the window changes nothing before
    its length and every row after it, and no kernel runs."""
    from repro_torch.models.layers import chunked_attention
    S, W = 600, 256
    q = _randn(gen, 1, S, 16, 256) * 30.0
    k, v = _randn(gen, 1, S, 8, 256), _randn(gen, 1, S, 8, 256)
    assert (torch.einsum("bqhd,bkhd->bhqk", q[:, :, ::2], k) / 16).abs().max() > 100
    before = ops.launch_counts()
    win = chunked_attention(q, k, v, window=W, attn_cap=50.0, chunk=256)
    glob = chunked_attention(q, k, v, window=None, attn_cap=50.0, chunk=256)
    assert ops.launch_counts() == before
    cpu = chunked_attention(q.cpu(), k.cpu(), v.cpu(), window=W, attn_cap=50.0, chunk=256)
    torch.testing.assert_close(win.cpu(), cpu, atol=1e-4, rtol=0)
    assert torch.equal(win[:, :W], glob[:, :W])
    assert bool((win[:, W:] != glob[:, W:]).flatten(2).any(dim=2).all())


def test_gemma2_model_on_the_card_takes_no_flash_launch(gen):
    """A small gemma2-9b (2 layers: local window 64, then global; softcaps,
    post-norms; head dim 256) pruned with FullBlock(128, 128, 0.5): forward
    and serving past the window run the six projections through the
    block-sparse kernel and attention through chunked_attention, no flash
    launch; logits within 0.1 of the plain path."""
    cfg = dataclasses.replace(get_config("gemma2-9b").reduced(), d_model=256, head_dim=256,
                              n_heads=4, n_kv_heads=2, d_ff=512, window=64)
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    pp, masks = prune_params(params, FlexBlockSpec((FullBlock(128, 128, 0.5),)),
                             keys=("wq", "wk", "wv", "w_gate", "w_up", "w_down"))
    cp = compress_params(pp, masks, 128, 128)
    toks = torch.randint(0, cfg.vocab_size, (1, 200), generator=gen, device="cuda")
    ops.reset_launch_counts()
    la = TT.forward(cp, toks, cfg)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0 and counts["block_sparse_matmul"] == 6 * cfg.n_layers
    lr = TT.forward(cp, toks, cfg, impl="ref")
    assert (la - lr).abs().max().item() < 0.1
    engine = ServeEngine(cfg, cp, slots=2, max_len=256, dtype=torch.bfloat16)
    reqs = [Request(prompt=toks[0, :n].cpu().numpy(), max_new_tokens=4) for n in (200, 70, 9)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done and len(r.output) == 4 for r in reqs)
    assert ops.launch_counts()["flash_attention"] == 0


def test_gemma7b_model_on_the_card_runs_flash_wgmma(gen):
    """A small gemma-7b (MHA, head dim 256) pruned with row-aligned
    IntraBlock(4, 1, 0.5): prefill attention (130 tokens, padded to 256)
    runs flash's wgmma variant, one launch per layer, logits within 0.1 of
    the plain path."""
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), d_model=256, head_dim=256,
                              n_heads=4, n_kv_heads=4, d_ff=512)
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    pp, masks = prune_params(params, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), align_cols=True,
                             keys=("wq", "wk", "wv", "w_gate", "w_up", "w_down"))
    cp = compress_params(pp, masks, m=4)
    toks = torch.randint(0, cfg.vocab_size, (1, 130), generator=gen, device="cuda")
    before = ops.variant_counts()
    la = TT.forward(cp, toks, cfg)
    delta = _variant_delta(before)
    assert delta["flash_attention"] == {"wgmma": cfg.n_layers}
    assert sum(delta["intrablock_gather_matmul"].values()) == 6 * cfg.n_layers
    lr = TT.forward(cp, toks, cfg, impl="ref")
    assert (la - lr).abs().max().item() < 0.1


# ---------------------------------------------------------------------------
# The MoE family (qwen3-moe-30b-a3b's shapes)
# ---------------------------------------------------------------------------

def test_flash_attention_wgmma_at_qwen3_moe_prefill_shape(gen):
    """qwen3-moe-30b-a3b's prefill attention: q (1, 512, 32, 128), k/v
    (1, 512, 4, 128), 8 q heads per kv head: the wgmma variant, within
    3e-2 of plain, two calls bitwise equal."""
    q = _randn(gen, 1, 512, 32, 128, dtype=torch.bfloat16)
    k, v = (_randn(gen, 1, 512, 4, 128, dtype=torch.bfloat16) for _ in range(2))
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v)
    again = ops.flash_attention(q, k, v)
    assert _variant_delta(before) == {"flash_attention": {"wgmma": 2}}
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ops.flash_attention(q, k, v, impl="ref").float(),
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("N", [512, 4096])
@pytest.mark.parametrize("B", [4, 451])
def test_block_sparse_matmul_at_qwen3_moe_attention_shapes(gen, B, N):
    """wk/wv (2048 → 512) and wq (2048 → 4096) at 50% FullBlock(128, 128):
    decode (4 slots) and prefill (the longest smoke prompt) variants
    within 1e-2 of max |plain|, two calls bitwise equal."""
    K = 2048
    keep = torch.zeros(K // 128 * (N // 128), dtype=torch.bool, device="cuda")
    keep[torch.randperm(keep.numel(), generator=gen, device="cuda")[: keep.numel() // 2]] = True
    w_comp, idx = ops.compress_fullblock_torch(_randn(gen, K, N, dtype=torch.bfloat16) / 45.0,
                                               keep.reshape(K // 128, N // 128), 128, 128)
    x = _randn(gen, B, K, dtype=torch.bfloat16)
    before = ops.variant_counts()
    out = ops.block_sparse_matmul(x, w_comp, idx)
    again = ops.block_sparse_matmul(x, w_comp, idx)
    assert _variant_delta(before) == {"block_sparse_matmul": {"decode" if B <= 16 else "prefill": 2}}
    assert torch.equal(out, again)
    want = ref.block_sparse_matmul_ref(x, w_comp, idx)
    scale = max(want.float().abs().max().item(), 1.0)
    torch.testing.assert_close(out.float() / scale, want.float() / scale, atol=1e-2, rtol=0)


def test_block_importance_strip_over_an_expert_view(gen):
    """One layer of an expert leaf (128, 2048, 768) bf16 in the (E, d·ff)
    view prune_params masks: (128, 1,572,864), one row of 12,288 blocks,
    through the strip variant within rtol 1e-5 of plain."""
    w = _randn(gen, 128, 2048 * 768, dtype=torch.bfloat16)
    before = ops.variant_counts()
    out = ops.block_importance(w, 128, 128, "l1")
    again = ops.block_importance(w, 128, 128, "l1")
    assert _variant_delta(before) == {"block_importance": {"strip": 2}}
    assert out.shape == (1, 12288) and torch.equal(out, again)
    torch.testing.assert_close(out, ref.block_importance_ref(w, 128, 128, "l1"),
                               rtol=1e-5, atol=0)


def test_moe_model_on_the_card_matches_the_cpu_with_drops(gen):
    """A small qwen3-moe (2 layers, d_model 256, 128 experts top-8,
    capacity factor 1.0) in f32 on the card equals the same model on the
    CPU: the dispatch (keep, destinations; drops asserted) exactly, the
    block, forward and a 4-slot decode step to 1e-4 (sums in other orders,
    no TF32).  Pruned with FullBlock(128, 128, 0.5) (an expert block spans
    all 128 experts) and served in bf16, wq/wk/wv run through the
    block-sparse kernel and the expert leaves stay dense."""
    from repro_torch.models import layers as TL
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), d_model=256,
                              head_dim=128, n_heads=4, n_kv_heads=2, d_ff=256, n_experts=128,
                              top_k=8, capacity_factor=1.0)
    params = TT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    on_card = {k: v.cuda() if torch.is_tensor(v) else {kk: vv.cuda() for kk, vv in v.items()}
               for k, v in params.items()}
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    args = (cfg.n_experts, cfg.top_k, cfg.capacity_factor, torch.float32)
    dc = TL._moe_dispatch(x.reshape(80, -1), lp["w_router"], *args)
    dg = TL._moe_dispatch(x.reshape(80, -1).cuda(), lp["w_router"].cuda(), *args)
    assert torch.equal(dg[2].cpu(), dc[2]) and torch.equal(dg[3].cpu(), dc[3])
    assert not bool(dc[2].all())
    lpg = {k: v.cuda() for k, v in lp.items()}
    torch.testing.assert_close(TL.moe_block(x.cuda(), lpg, cfg).cpu(), TL.moe_block(x, lp, cfg),
                               atol=1e-4, rtol=0)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(TT.forward(on_card, toks.cuda(), cfg).cpu(),
                               TT.forward(params, toks, cfg), atol=1e-4, rtol=0)
    caches = [TT.prefill(p, t[:, :32], cfg)[1] for p, t in ((params, toks), (on_card, toks.cuda()))]
    for c in caches:
        for key in ("k", "v"):
            c[key] = torch.nn.functional.pad(c[key], (0, 0, 0, 0, 0, 1))
    steps = [TT.decode_step(p, t[:, 32], cfg, c)[0]
             for p, t, c in ((params, toks, caches[0]), (on_card, toks.cuda(), caches[1]))]
    torch.testing.assert_close(steps[1].cpu(), steps[0], atol=1e-4, rtol=0)

    pb = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    pp, masks = prune_params(pb, FlexBlockSpec((FullBlock(128, 128, 0.5),)),
                             keys=("wq", "wk", "wv", "w_gate", "w_up", "w_down"))
    assert masks["layers"]["w_up"].device.type == "cpu" and masks["layers"]["wq"].is_cuda
    cp = compress_params(pp, masks, 128, 128)
    assert all(isinstance(cp["layers"][k], BlockSparseLinear) for k in ("wq", "wk", "wv"))
    assert all(cp["layers"][k] is pp["layers"][k] for k in ("w_gate", "w_up", "w_down"))
    assert ops.variant_counts()["block_importance"]["strip"] == 6 * cfg.n_layers
    engine = ServeEngine(cfg, cp, slots=4, max_len=128, dtype=torch.bfloat16)
    reqs = [Request(prompt=toks[i, :n].numpy(), max_new_tokens=5)
            for i, n in enumerate((33, 20, 9))]
    for r in reqs:
        engine.submit(r)
    ops.reset_launch_counts()
    engine.run()
    assert all(r.done and len(r.output) == 5 for r in reqs)
    counts = ops.launch_counts()
    assert counts["block_sparse_matmul"] == 3 * cfg.n_layers * (len(reqs) + engine.last_stats["steps"])
    assert counts["intrablock_gather_matmul"] == 0


# ---------------------------------------------------------------------------
# The SSM family (mamba2-130m and hymba-1.5b's shapes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,N", [(768, 3352), (1600, 6482), (1600, 1600), (3200, 1600),
                                 (1600, 320)])
@pytest.mark.parametrize("B", [1, 4, 16, 17, 451, 512])
def test_intrablock_gather_matmul_main_variants_at_ssm_shapes(gen, B, K, N):
    """The projections of mamba2-130m (w_in (768, 3352)) and hymba-1.5b
    (w_in (1600, 6482), wq and w_down/w_out to 1600, wk/wv (1600, 320))
    at row-aligned 2:4, stored as compress_params stores them (hymba's
    w_in in rows padded to 6488): N % 128 != 0 takes the decode variant at
    B <= 16 and prefill above, the last 128-column tile ragged, within
    1e-2 of max |plain| (tighter than tests/test_kernels.py's 3e-2 for
    bf16); two calls bitwise equal."""
    w = _randn(gen, K, N, dtype=torch.bfloat16) * (K ** -0.5)
    mask = intrablock_mask(w.float(), IntraBlock(4, 1, 0.5), align_cols=True)
    w_comp, row_idx = ops.compress_intrablock_torch(w, mask, 4)
    w_comp = ops.aligned_rows(w_comp)
    assert w_comp.stride(0) == -(-N // 8) * 8
    x = _randn(gen, B, K, dtype=torch.bfloat16)
    before = ops.variant_counts()
    shapes = ops.gather_matmul_shape_counts()
    out = ops.intrablock_gather_matmul(x, w_comp, row_idx)
    again = ops.intrablock_gather_matmul(x, w_comp, row_idx)
    variant = "decode" if B <= 16 else "prefill"
    assert _variant_delta(before) == {"intrablock_gather_matmul": {variant: 2}}
    Kc = w_comp.shape[0]
    assert ops.gather_matmul_shape_counts()[variant, Kc, N] == \
        shapes.get((variant, Kc, N), 0) + 2
    assert torch.equal(out, again) and out.shape == (B, N) and out.is_contiguous()
    want = ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(out.float() / scale, want.float() / scale, atol=1e-2, rtol=0)


def test_flash_attention_wgmma_at_hymba_prefill_shape(gen):
    """hymba-1.5b's long prefill: q (1, 1664, 25, 64), k/v (1, 1664, 5, 64)
    (a 1600-token prompt padded to tiles of 128), causal with window 1024:
    head dim 64 runs the wgmma variant, within 3e-2 of plain; the window
    changes every row from 1024 on."""
    q = _randn(gen, 1, 1664, 25, 64, dtype=torch.bfloat16)
    k, v = (_randn(gen, 1, 1664, 5, 64, dtype=torch.bfloat16) for _ in range(2))
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v, window=1024)
    assert _variant_delta(before) == {"flash_attention": {"wgmma": 1}}
    want = ops.flash_attention(q, k, v, window=1024, impl="ref")
    torch.testing.assert_close(out.float(), want.float(), atol=3e-2, rtol=0)
    glob = ops.flash_attention(q, k, v)
    assert torch.equal(out[:, :1024], glob[:, :1024])
    assert bool((out[:, 1024:] != glob[:, 1024:]).flatten(2).any(dim=2).all())


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_layer_at_published_width_kernel_path_matches_plain(gen, arch):
    """One layer at the published widths (vocab cut to 4096), pruned with
    row-aligned IntraBlock(4, 1, 0.5) on its projections and compressed:
    a 300-token forward runs each compressed projection once through the
    prefill variant, whatever its N (hymba: flash wgmma at hd 64 once),
    logits within 0.1 of the plain path; served through the engine on two
    slots (prompts longer than 16 rows, so every prefill takes the prefill
    variant), decode runs the decode variant, and nothing runs general."""
    cfg = dataclasses.replace(get_config(arch), n_layers=1, vocab_size=4096)
    keys = tuple(k for k in ("wq", "wk", "wv", "w_gate", "w_up", "w_down", "w_in", "w_out")
                 if k in TT._layer_shapes(cfg))
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    pp, masks = prune_params(params, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), align_cols=True,
                             keys=keys)
    cp = compress_params(pp, masks, m=4)
    ragged = sum(1 for k in keys if cp["layers"][k].w_comp.shape[-1] % 128)
    assert isinstance(cp["layers"]["w_in"], IntraBlockLinear) and ragged == \
        {"mamba2-130m": 1, "hymba-1.5b": 6}[arch]
    toks = torch.randint(0, cfg.vocab_size, (1, 300), generator=gen, device="cuda")
    before = ops.variant_counts()
    la = TT.forward(cp, toks, cfg)
    delta = _variant_delta(before)
    assert delta["intrablock_gather_matmul"] == {"prefill": len(keys)}
    assert delta.get("flash_attention", {}) == ({"wgmma": 1} if cfg.attention != "none" else {})
    lr = TT.forward(cp, toks, cfg, impl="ref")
    assert (la - lr).abs().max().item() < 0.1
    engine = ServeEngine(cfg, cp, slots=2, max_len=512, dtype=torch.bfloat16)
    reqs = [Request(prompt=toks[0, :n].cpu().numpy(), max_new_tokens=4) for n in (300, 40, 20)]
    for r in reqs:
        engine.submit(r)
    before = ops.variant_counts()
    engine.run()
    assert all(r.done and len(r.output) == 4 for r in reqs)
    steps = engine.last_stats["steps"]
    delta = _variant_delta(before)["intrablock_gather_matmul"]
    assert delta == {"decode": len(keys) * steps, "prefill": len(keys) * len(reqs)}
    assert engine.cache["ssm"].dtype == torch.float32 and engine.cache["ssm"].is_cuda


# ---------------------------------------------------------------------------
# The encoder-decoder and the prefix-LM (whisper-medium and paligemma-3b's
# shapes), and the cache write past the end
# ---------------------------------------------------------------------------

def test_flash_attention_wgmma_at_whisper_prefill_shape(gen):
    """whisper-medium's decoder prefill of 4 prompts of 416 tokens: q/k/v
    (4, 512, 16, 64) bf16, MHA, causal: the wgmma variant, within 3e-2 of
    plain, two calls bitwise equal."""
    q, k, v = (_randn(gen, 4, 512, 16, 64, dtype=torch.bfloat16) for _ in range(3))
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v)
    again = ops.flash_attention(q, k, v)
    assert _variant_delta(before) == {"flash_attention": {"wgmma": 2}}
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ops.flash_attention(q, k, v, impl="ref").float(),
                               atol=3e-2, rtol=0)


@pytest.mark.parametrize("N", [256, 16384])
@pytest.mark.parametrize("B", [4, 1536])
def test_intrablock_gather_matmul_at_paligemma_shapes(gen, B, N):
    """paligemma-3b's wk (2048 → 256) and w_gate (2048 → 16384) at
    row-aligned 2:4, at decode (4 rows) and at its prefill (4 × (256 + 128)
    rows): the decode and prefill variants, within 1e-2 of max |plain|."""
    K = 2048
    w = _randn(gen, K, N, dtype=torch.bfloat16) * (K ** -0.5)
    mask = intrablock_mask(w.float(), IntraBlock(4, 1, 0.5), align_cols=True)
    w_comp, row_idx = ops.compress_intrablock_torch(w, mask, 4)
    w_comp = ops.aligned_rows(w_comp)
    x = _randn(gen, B, K, dtype=torch.bfloat16)
    before = ops.variant_counts()
    out = ops.intrablock_gather_matmul(x, w_comp, row_idx)
    variant = "decode" if B <= 16 else "prefill"
    assert _variant_delta(before) == {"intrablock_gather_matmul": {variant: 1}}
    want = ref.intrablock_gather_matmul_ref(x, w_comp, row_idx)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(out.float() / scale, want.float() / scale, atol=1e-2, rtol=0)


def test_whisper_model_on_the_card_matches_plain(gen):
    """A small whisper-medium (head dim 64, 200 frames) pruned with
    FullBlock(128, 128, 0.5): forward runs the decoder's five projections
    through the block-sparse kernel and its self-attention through flash
    wgmma, one launch per layer, the encoder and the cross step through
    neither; logits within 0.1 of the plain path, and decode after prefill
    within 0.1 of the plain decode."""
    cfg = dataclasses.replace(get_config("whisper-medium").reduced(), d_model=256, head_dim=64,
                              n_heads=4, n_kv_heads=4, d_ff=512, enc_seq=200)
    keys = ("wq", "wk", "wv", "w_up", "w_down")
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    pp, masks = prune_params(params, FlexBlockSpec((FullBlock(128, 128, 0.5),)), keys=keys)
    cp = compress_params(pp, masks, 128, 128)
    toks = torch.randint(0, cfg.vocab_size, (2, 130), generator=gen, device="cuda")
    enc = _randn(gen, 2, 200, 256, dtype=torch.bfloat16) / 16
    before = ops.variant_counts()
    la = TT.forward(cp, toks, cfg, enc_embed=enc)
    delta = _variant_delta(before)
    assert delta == {"flash_attention": {"wgmma": cfg.n_layers},
                     "block_sparse_matmul": {"prefill": len(keys) * cfg.n_layers}}
    lr = TT.forward(cp, toks, cfg, enc_embed=enc, impl="ref")
    assert (la - lr).abs().max().item() < 0.1
    steps = {}
    for impl in ("auto", "ref"):
        _, cache = TT.prefill(cp, toks[:, :129], cfg, enc_embed=enc, impl=impl)
        for key in ("k", "v"):
            cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 1))
        steps[impl], _ = TT.decode_step(cp, toks[:, 129], cfg, cache, impl=impl)
    assert (steps["auto"] - steps["ref"]).abs().max().item() < 0.1


def test_paligemma_model_on_the_card_takes_no_flash_with_a_prefix(gen):
    """A small paligemma-3b (MQA, head dim 256, a prefix of 16) pruned with
    row-aligned IntraBlock(4, 1, 0.5): forward with the prefix runs the six
    projections through the gather-matmul and attention through
    chunked_attention (no flash launch), logits within 0.1 of the plain
    path; without a prefix (text alone, as the engine serves it) prefill
    takes flash wgmma."""
    cfg = dataclasses.replace(get_config("paligemma-3b").reduced(), d_model=256, head_dim=256,
                              n_heads=4, n_kv_heads=1, d_ff=512, prefix_len=16)
    keys = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    pp, masks = prune_params(params, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), align_cols=True,
                             keys=keys)
    cp = compress_params(pp, masks, m=4)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen, device="cuda")
    pre = _randn(gen, 2, 16, 256, dtype=torch.bfloat16) / 16
    before = ops.variant_counts()
    la = TT.forward(cp, toks, cfg, prefix_embed=pre)
    assert _variant_delta(before) == {"intrablock_gather_matmul":
                                      {"prefill": len(keys) * cfg.n_layers}}
    lr = TT.forward(cp, toks, cfg, prefix_embed=pre, impl="ref")
    assert la.shape == (2, 116, cfg.vocab_size) and (la - lr).abs().max().item() < 0.1
    before = ops.variant_counts()
    TT.prefill(cp, toks, cfg)
    assert _variant_delta(before)["flash_attention"] == {"wgmma": cfg.n_layers}


def test_decode_past_the_end_of_the_cache_on_the_card(gen):
    """decode_step on the cache prefill returned (no headroom): the scalar
    write clamps to the last slot, a per-slot write past the end is
    dropped with no device-side assert; both as on the CPU."""
    cfg = get_config("llama3-8b").reduced()
    params = TT.init_params(cfg, 0, dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 10), generator=gen, device="cuda")
    out = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else {k: (v.cpu() if torch.is_tensor(v) else
                                              {n: t.cpu() for n, t in v.items()})
                                          for k, v in params.items()}
        t = toks.to(dev)
        _, cache = TT.prefill(p, t[:, :8], cfg, impl="ref")
        l1, cache = TT.decode_step(p, t[:, 8], cfg, cache, impl="ref")
        cache["pos"] = torch.tensor([5, 9], device=dev)
        l2, cache = TT.decode_step(p, t[:, 9], cfg, cache, impl="ref")
        out[dev] = (l1, l2, cache["k"])
    torch.cuda.synchronize()
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------

def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return None if tree is None else tree.to(dev, copy=True)   # the step writes in place


def _train_batch(gen, cfg, B=4, S=40):
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda")
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_on_the_card_matches_the_cpu(gen, dtype):
    """One qwen3-4b .reduced() train step (2 microbatches, IntraBlock masks,
    remat "minimal") on the card ≡ the same step on the CPU.  f32: loss and
    grad_norm to 1e-4, moments to 1e-4 of a leaf's largest entry, params
    to 1e-4 of it plus 1e-3 of lr where |g| > 1e-6 (AdamW's direction is
    ill-conditioned where |g| nears eps) and to one update (2.2 lr)
    elsewhere.  bf16: loss to 1e-2, grad_norm to 5e-2, moments to 5e-2,
    params to one update plus a bf16 ulp.  No kernel runs in the step,
    every weight gets a grad, pruned entries are exactly zero after it."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves_with_paths

    cfg = get_config("qwen3-4b").reduced()
    keys = ("wq", "wk", "wv", "w_gate", "w_up", "w_down")
    params = TT.init_params(cfg, 0, dtype=dtype)
    _, masks = prune_params(params, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), align_cols=True,
                            keys=keys)
    batch = _train_batch(gen, cfg)
    lr = 1e-2
    out, grads = {}, {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        o = adamw_init(p)
        step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=1, total_steps=4),
                               microbatches=2, masks=_to(masks, dev), remat=True)
        step.on_stage = lambda stage, g, dev=dev: stage == "grads" and grads.setdefault(dev, {
            k: float(v[0].float().norm()) for k, v in g["layers"].items()})
        ops.reset_launch_counts()
        p, o, met = step(p, o, _to(batch, dev))
        assert not any(ops.launch_counts().values())
        out[dev] = (p, o, {k: float(v) for k, v in met.items()})
    assert all(v > 0 for v in grads["cuda"].values()), grads["cuda"]
    (pc, oc, mc), (pp, op, mp) = out["cuda"], out["cpu"]
    f32 = dtype == torch.float32
    for k, tol in (("loss", 1e-4 if f32 else 1e-2), ("grad_norm", 1e-4 if f32 else 5e-2),
                   ("lr", 1e-6)):
        assert abs(mc[k] - mp[k]) <= tol * abs(mp[k]), (k, mc[k], mp[k])
    for name in ("m", "v"):
        for (path, a), (_, b) in zip(leaves_with_paths(oc[name]), leaves_with_paths(op[name])):
            err = (a.cpu() - b).abs().max().item()
            assert err <= (1e-4 if f32 else 5e-2) * b.abs().max().item(), (name, path, err)
    for (path, a), (_, b), (_, v) in zip(leaves_with_paths(pc), leaves_with_paths(pp),
                                         leaves_with_paths(op["v"])):
        err = (a.cpu().float() - b.float()).abs()
        top = b.float().abs().max().item()
        if f32:
            well = (v / (1 - 0.95)).sqrt() > 1e-6
            assert (err[well] <= 1e-4 * top + 1e-3 * lr).all(), path
            assert (err <= 1e-4 * top + 2.2 * lr).all(), path
        else:
            assert (err <= 2.2 * lr + b.float().abs() * 2.0 ** -7).all(), path
    for k in keys:
        assert not pc["layers"][k][~masks["layers"][k]].any(), k


def test_remat_policies_equal_on_the_card(gen):
    """Loss and grads of qwen3-4b .reduced() (bf16) with each remat policy ≡
    without remat, on the card: 1e-6 relative (the embedding's grad sums
    with atomics, in any order)."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    cfg = get_config("qwen3-4b").reduced()
    params = TT.init_params(cfg, 1, dtype=torch.bfloat16)
    batch = _train_batch(gen, cfg, B=2, S=200)
    loss0, g0 = make_train_step(cfg, AdamWConfig()).grads(params, batch)
    for policy in TT.REMAT_POLICIES:
        loss, g = make_train_step(cfg, AdamWConfig(), remat=True,
                                  remat_policy=policy).grads(params, batch)
        assert abs(loss.item() - loss0.item()) <= 1e-6 * abs(loss0.item()), policy
        for a, b in zip(leaves(g), leaves(g0)):
            assert (a.float() - b.float()).abs().max().item() <= \
                1e-6 * b.float().abs().max().item() + 1e-30, policy


def _grad_inputs(gen, op):
    """Arguments of ``op`` on the card with a float input that requires grad."""
    x = _randn(gen, 4, 256, dtype=torch.bfloat16).requires_grad_()
    if op == "flash_attention":
        q = _randn(gen, 1, 128, 4, 128, dtype=torch.bfloat16).requires_grad_()
        return (q, q.detach(), q.detach()), {}
    if op == "block_sparse_matmul":
        w, idx = ops.compress_fullblock_torch(_randn(gen, 256, 256, dtype=torch.bfloat16),
                                              torch.ones(2, 2, dtype=torch.bool, device="cuda"),
                                              128, 128)
        return (x, w, idx), {}
    if op == "intrablock_gather_matmul":
        row_idx = torch.arange(0, 256, 2, dtype=torch.int32, device="cuda")
        return (x, _randn(gen, 128, 256, dtype=torch.bfloat16), row_idx), {}
    if op == "block_importance":
        return (_randn(gen, 256, 256).requires_grad_(), 128, 128), {}
    if op == "bitserial_zero_profile":
        return (torch.zeros(4, 256, dtype=torch.int8, device="cuda"), 32), {}
    return (x, 32), {}


@pytest.mark.parametrize("op", ["flash_attention", "block_sparse_matmul",
                                "intrablock_gather_matmul", "block_importance",
                                "bitserial_zero_profile", "quantized_zero_profile"])
def test_cuda_wrapper_refuses_an_input_that_requires_grad(gen, op):
    """No CUDA kernel has a backward: with grad mode on, an input that
    requires grad raises rather than return an output with no graph; under
    no_grad the kernel runs.  (The int8 bit-serial count cannot take such
    an input: its q is integer.)"""
    args, kw = _grad_inputs(gen, op)
    fn = getattr(ops, op)
    if op == "bitserial_zero_profile":
        fn(*args, **kw)
        return
    with pytest.raises(RuntimeError, match=f"{op}: the CUDA kernel has no backward"):
        fn(*args, **kw)
    with torch.no_grad():
        out = fn(*args, **kw)
    assert out.device.type == "cuda"
    out = fn(*[a.detach() if torch.is_tensor(a) else a for a in args], **kw)
    assert not out.requires_grad


def test_compressed_model_under_grad_raises_on_the_card(gen):
    """A forward through compressed weights with an input that needs grad
    reaches the gather-matmul's refusal; the training route (dense weights)
    takes no kernel at all."""
    cfg = get_config("qwen3-4b").reduced()
    params = TT.init_params(cfg, 0, dtype=torch.bfloat16)
    pp, masks = prune_params(params, FlexBlockSpec((IntraBlock(4, 1, 0.5),)), align_cols=True,
                             keys=("wq", "wk", "wv", "w_gate", "w_up", "w_down"))
    cp = compress_params(pp, masks, m=4)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=gen, device="cuda")
    train = dict(cp, embed=cp["embed"].detach().requires_grad_())
    with pytest.raises(RuntimeError, match="intrablock_gather_matmul: the CUDA kernel has no"):
        TT.forward(train, toks, cfg)
    dense = dict(params, layers={k: v.detach().requires_grad_()
                                 for k, v in params["layers"].items()})
    ops.reset_launch_counts()
    TT.forward(dense, toks, cfg).float().sum().backward()
    assert not any(ops.launch_counts().values())
    assert dense["layers"]["wq"].grad[0].float().norm().item() > 0


def test_flash_attention_wgmma_at_32k_matches_plain_rows(gen):
    """prefill_32k's flash launch (qwen3-4b heads, S = 32768): 128-row query
    tiles at the start, middle and end of two heads within 3e-2 of plain
    attention over all keys (the whole plain matrix would not fit)."""
    S, Hq, Hkv, hd = 32768, 32, 8, 128
    q = _randn(gen, 1, S, Hq, hd, dtype=torch.bfloat16)
    k, v = (_randn(gen, 1, S, Hkv, hd, dtype=torch.bfloat16) for _ in range(2))
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v)
    assert _variant_delta(before) == {"flash_attention": {"wgmma": 1}}
    for r0 in (0, S // 2, S - 128):
        for h in (0, Hq - 1):
            qs, ks, vs = q[0, r0:r0 + 128, h].float(), k[0, :, h // 4].float(), v[0, :, h // 4].float()
            s = (qs @ ks.T) / hd ** 0.5
            pos = r0 + torch.arange(128, device="cuda")[:, None]
            s = s.masked_fill(torch.arange(S, device="cuda")[None, :] > pos, float("-inf"))
            want = torch.softmax(s, dim=-1) @ vs
            torch.testing.assert_close(out[0, r0:r0 + 128, h].float(), want, atol=3e-2, rtol=0)


def test_dryrun_counts_the_cards_route_and_executes_on_the_card(gen):
    """A prefill counted on CUDA tensors (the kernels launch inside the
    count) gives the flops and peak of the same count on ``meta``; executed
    on the card, the record's fields come from the card."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.counting import count
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), head_dim=128)
    cell = ShapeCell("t", 256, 2, "prefill")
    meta = dryrun.count_cell(cfg, cell)
    step, structs = dryrun._cell_step(cfg, cell)
    args = dryrun._zeros_like_structs(structs, torch.device("cuda"))
    ops.reset_launch_counts()
    with count(args) as c:
        c.returned(step(*args))
    assert ops.variant_counts()["flash_attention"]["wgmma"] == cfg.n_layers
    assert {k: (v, meta.oplog.get(k)) for k, v in c.oplog.items() if meta.oplog.get(k) != v} == {}
    assert c.flops_by_kind == meta.flops_by_kind
    assert (c.argument_bytes, c.peak_bytes) == (meta.argument_bytes, meta.peak_bytes)
    timing = dryrun._execute_cell(step, structs, "prefill", 2, torch.device("cuda"))
    assert timing["execute_repeats"] == 2 and timing["time_s"] > 0
    assert timing["device"] == torch.cuda.get_device_name(0)
    assert timing["measured_peak_bytes"] >= meta.argument_bytes
