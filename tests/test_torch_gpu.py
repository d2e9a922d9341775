"""PyTorch port on the card: each CUDA kernel ≡ its plain version, and the
model's kernel path ≡ its plain path.  Marked ``gpu``; without a CUDA
device every test skips.  Run on a GPU host with
``python -m pytest -m gpu tests/test_torch_gpu.py`` (this file does not
import jax, so it runs where only PyTorch is installed).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock, IntraBlock
from repro_torch.core.input_sparsity import profile_activations
from repro_torch.core.pruning import intrablock_mask
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as TT
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
])
def test_bitserial_zero_profile_kernel_equals_plain(gen, V, K, g, n_bits, lim):
    """Exact equality, over ragged K (zero-padded, skippable), −128, small
    magnitudes (many zero planes) and n_bits below and above 8."""
    q = torch.randint(-lim, lim, (V, K), generator=gen, device="cuda").to(torch.int8)
    q[0, : min(K, 3)] = -128
    before = ops.launch_counts()["bitserial_zero_profile"]
    out = ops.bitserial_zero_profile(q, g, n_bits)
    assert ops.launch_counts()["bitserial_zero_profile"] == before + 1
    want = ref.bitserial_zero_profile_ref(q, g, n_bits)
    assert out.dtype == torch.int32 and out.tolist() == want.tolist()
    # a misaligned start takes the byte-by-byte loads
    buf = torch.empty(V * K + 1, dtype=torch.int8, device="cuda")
    qm = buf[1:].view(V, K)
    qm.copy_(q)
    assert ops.bitserial_zero_profile(qm, g, n_bits).tolist() == want.tolist()


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
    assert profile_activations(acts, 32) == profile_activations(acts, 32, impl="ref")
