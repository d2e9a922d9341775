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
    q = _randn(gen, 1, 256, 8, hd, dtype=torch.bfloat16)
    k, v = (_randn(gen, 1, 256, 2, hd, dtype=torch.bfloat16) for _ in range(2))
    before = ops.variant_counts()
    out = ops.flash_attention(q, k, v)
    assert _variant_delta(before) == {"flash_attention": {"general": 1}}
    torch.testing.assert_close(out.float(), ops.flash_attention(q, k, v, impl="ref").float(),
                               atol=3e-2, rtol=0)


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
    """Ragged B (row tiles of 16/64), N (tiles of 128; N % 8 != 0 takes the
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
