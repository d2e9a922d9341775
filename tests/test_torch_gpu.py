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
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
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
    assert all(n > 0 for n in ops.launch_counts().values())
