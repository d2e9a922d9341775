"""PyTorch port, kernels: plain versions ≡ the JAX package's jnp oracles,
layout builders byte-equal to the reference, the ``impl`` dispatch and
its errors, and the port's import boundary.

The CUDA kernels themselves run only on a card (tests/test_torch_gpu.py
and chip_smoke.py).  Inputs are made with numpy from a seed and handed
to both packages.  Tolerances are those of tests/test_kernels.py.
"""
import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _jax_reference
from repro_torch.kernels import ops, plans

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(11)
TOL = {np.float32: 3e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


def _both(a: np.ndarray, dtype):
    """The same values as a jax array and a torch CPU tensor."""
    if dtype == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
        return j, t
    return jnp.asarray(a, jnp.float32), torch.from_numpy(a.astype(np.float32))


# ---------------------------------------------------------------------------
# Plain versions against the jnp oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Skv,hd,causal,window", [
    (128, 128, 32, True, None),
    (256, 256, 64, True, 64),
    (128, 256, 32, False, None),
    (256, 256, 16, True, None),
    (128, 128, 32, False, 64),
    (128, 128, 32, True, 64),
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flash_attention_plain_matches_oracle(R, Sq, Skv, hd, causal, window, dtype):
    B, Hq, Hkv = 2, 4, 2
    qj, qt = _both(RNG.normal(size=(B, Sq, Hq, hd)), dtype)
    kj, kt = _both(RNG.normal(size=(B, Skv, Hkv, hd)), dtype)
    vj, vt = _both(RNG.normal(size=(B, Skv, Hkv, hd)), dtype)
    want = R.ops.flash_attention(qj, kj, vj, causal=causal, window=window, impl="ref")
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window, impl="auto")
    assert got.shape == (B, Sq, Hq, hd) and got.dtype == qt.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype])



@pytest.mark.parametrize("Sq,Skv,hd,causal,window", [
    (128, 128, 32, True, None),
    (256, 256, 64, True, 64),
    (128, 256, 32, False, None),
    (128, 128, 32, False, 64),
    (200, 136, 16, True, 40),
])
def test_flash_attention_plain_in_row_blocks_matches_oracle(R, monkeypatch, Sq, Skv, hd,
                                                             causal, window):
    """Past its score budget the plain version takes query rows in blocks,
    each against the keys its mask leaves: the same attention as the
    oracle's whole matrix."""
    from repro_torch.kernels import ref
    B, Hq, Hkv = 2, 4, 2
    monkeypatch.setattr(ref, "_SCORE_BYTES", 4 * B * Hq * Skv * 24)      # 24 rows a block
    qj, qt = _both(RNG.normal(size=(B, Sq, Hq, hd)), np.float32)
    kj, kt = _both(RNG.normal(size=(B, Skv, Hkv, hd)), np.float32)
    vj, vt = _both(RNG.normal(size=(B, Skv, Hkv, hd)), np.float32)
    want = R.ops.flash_attention(qj, kj, vj, causal=causal, window=window, impl="ref")
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window, impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL[np.float32])


@pytest.mark.parametrize("K,N,bm,bn,B", [
    (128, 64, 32, 32, 8),
    (256, 128, 64, 64, 32),
    (512, 256, 128, 128, 16),
    (384, 128, 128, 64, 5),
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_block_sparse_matmul_plain_matches_oracle(R, K, N, bm, bn, B, dtype):
    w = RNG.normal(size=(K, N)).astype(np.float32)
    keep = RNG.random((K // bm, N // bn)) < 0.5
    keep[0, :] = True
    wj, wt = _both(w, dtype)
    wc_np, idx_np = R.ops.compress_fullblock(np.asarray(wj), keep, bm, bn)
    wc_t, idx_t = ops.compress_fullblock_torch(wt, torch.from_numpy(keep), bm, bn)
    xj, xt = _both(RNG.normal(size=(B, K)), dtype)
    want = np.asarray(R.kref.block_sparse_matmul_ref(xj, jnp.asarray(wc_np), jnp.asarray(idx_np)),
                      np.float32)
    got = ops.block_sparse_matmul(xt, wc_t, idx_t).float().numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL[dtype])


def test_block_sparse_matmul_padding_slot_mid_list():
    """A -1 slot adds nothing wherever it sits, and later slots still count."""
    x = torch.from_numpy(RNG.normal(size=(3, 64)).astype(np.float32))
    wc = torch.from_numpy(RNG.normal(size=(2, 3, 16, 8)).astype(np.float32))
    idx = torch.tensor([[0, -1, 3], [-1, 2, -1]], dtype=torch.int32)
    y = ops.block_sparse_matmul(x, wc, idx)
    want0 = x[:, 0:16] @ wc[0, 0] + x[:, 48:64] @ wc[0, 2]
    want1 = x[:, 32:48] @ wc[1, 1]
    torch.testing.assert_close(y, torch.cat([want0, want1], dim=1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M,N,bm,bn", [(64, 64, 8, 8), (128, 256, 32, 16), (256, 128, 64, 128)])
@pytest.mark.parametrize("crit", ["l1", "l2"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_block_importance_plain_matches_oracle(R, M, N, bm, bn, crit, dtype):
    wj, wt = _both(RNG.normal(size=(M, N)), dtype)
    want = np.asarray(R.kref.block_importance_ref(wj, bm, bn, crit))
    got = ops.block_importance(wt, bm, bn, crit)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("K,N,m,B", [(64, 32, 2, 8), (128, 64, 4, 16), (256, 128, 8, 7)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_intrablock_gather_matmul_plain_matches_pallas_and_oracle(R, K, N, m, B, dtype):
    """The shapes of tests/test_kernels.py; tolerance TOL of max |y| (the
    bf16 outputs may differ by one rounding of the f32 sum)."""
    w = RNG.normal(size=(K, N)).astype(np.float32)
    mask = R.pruning.intrablock_mask(w, R.flexblock.IntraBlock(m, 1, (m - 1) / m),
                                     align_cols=True)
    wc, ridx = R.ops.compress_intrablock(w, mask, m)
    wcj, wct = _both(wc, dtype)
    xj, xt = _both(RNG.normal(size=(B, K)), dtype)
    got = ops.intrablock_gather_matmul(xt, wct, torch.from_numpy(ridx))
    assert got.shape == (B, N) and got.dtype == xt.dtype
    got = got.float().numpy()
    want_ref = np.asarray(R.kref.intrablock_gather_matmul_ref(xj, wcj, jnp.asarray(ridx)),
                          np.float32)
    want_pal = np.asarray(R.ops.intrablock_gather_matmul(
        xj, wcj, jnp.asarray(ridx), impl="pallas_interpret", tile_b=8, tile_n=32), np.float32)
    scale = max(np.abs(want_ref).max(), 1.0)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(got / scale, want / scale, atol=TOL[dtype])


@pytest.mark.parametrize("V,K,g,n_bits,lim", [
    (16, 64, 16, 8, 40), (100, 96, 32, 8, 40), (128, 256, 64, 8, 40),   # tests/test_kernels.py
    (100, 100, 32, 8, 129), (37, 70, 32, 5, 129), (20, 64, 8, 3, 9), (8, 32, 8, 8, 1),
])
def test_bitserial_zero_profile_plain_equals_pallas(R, V, K, g, n_bits, lim):
    """Exact: ragged K, −128 (|−128| = 128 sets bit 7), n_bits < 8, and an
    all-zero input (lim 1) where every slot is skippable."""
    qn = RNG.integers(-lim + 1, lim, size=(V, K)).clip(-128, 127).astype(np.int8)
    if lim > 128:
        qn[0, :3] = -128
    want_pal = np.asarray(R.ops.bitserial_zero_profile(jnp.asarray(qn), g, n_bits,
                                                       impl="pallas_interpret"))
    want_ref = np.asarray(R.kref.bitserial_zero_profile_ref(jnp.asarray(qn), g, n_bits))
    got = ops.bitserial_zero_profile(torch.from_numpy(qn), g, n_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_pal)
    np.testing.assert_array_equal(got.numpy(), want_ref)
    if lim == 1:
        assert got[0] == got[1]


def _vabs4(w: np.ndarray) -> np.ndarray:
    """Per-byte two's-complement |b| of uint32 words, modulo 256 (0x80
    stays 0x80, so |-128| = 128 keeps bit 7), as CUDA's ``__vabs4``."""
    out = np.zeros_like(w)
    for k in range(4):
        b = (w >> np.uint32(8 * k)) & np.uint32(0xFF)
        a = np.where(b & np.uint32(0x80), (np.uint32(0x100) - b) & np.uint32(0xFF), b)
        out |= a << np.uint32(8 * k)
    return out


def emulate_strip(q: np.ndarray, g: int, n_bits: int):
    """The strip kernel's word-wise count: each lane's 16-byte chunk as 4
    little-endian uint32 words, per-byte |q| of each word, the words ORed,
    the group's g/16 lanes ORed, the 4 bytes folded, then n_bits minus the
    set bits under the mask.  Chunks past K read as zero."""
    V, K = q.shape
    G, lanes = -(-K // g), g // 16
    padded = np.zeros((V, G * g), np.int8)
    padded[:, :K] = q
    words = padded.view(np.uint32).reshape(V, G, lanes, 4)
    lane_or = np.bitwise_or.reduce(_vabs4(words), axis=-1)
    group_or = np.bitwise_or.reduce(lane_or, axis=-1)
    folded = group_or | (group_or >> np.uint32(16))
    folded = (folded | (folded >> np.uint32(8))) & np.uint32(0xFF)
    mask = np.uint32((1 << n_bits) - 1 if n_bits < 32 else 0xFFFFFFFF)
    pop = sum(((folded & mask) >> np.uint32(b)) & np.uint32(1) for b in range(8))
    return [int((n_bits - pop.astype(np.int64)).sum()), V * G * n_bits]


@pytest.mark.parametrize("V,K,g,n_bits,lim", [
    (16, 64, 16, 8, 40), (100, 96, 32, 8, 40), (128, 256, 64, 8, 40),   # tests/test_kernels.py
    (100, 96, 64, 8, 129), (37, 80, 32, 5, 129), (20, 64, 16, 3, 9), (8, 32, 16, 8, 1),
    (5, 64, 16, 32, 129), (4, 1024, 512, 8, 129), (9, 48, 32, 8, 3),
])
def test_strip_emulation_equals_plain_and_reference(R, V, K, g, n_bits, lim):
    """Exact, over the sweep with an all-(-128) row and an all-zero row:
    the word-wise algorithm of the strip variant counts what both plain
    versions count."""
    assert plans.bsp_plan(V, K, g, torch.int8, 256).variant == "strip"
    qn = RNG.integers(-lim + 1, lim, size=(V, K)).clip(-128, 127).astype(np.int8)
    qn[0] = -128
    qn[-1] = 0
    got = emulate_strip(qn, g, n_bits)
    assert got == ops.bitserial_zero_profile(torch.from_numpy(qn), g, n_bits).tolist()
    assert got == np.asarray(R.kref.bitserial_zero_profile_ref(jnp.asarray(qn), g,
                                                               n_bits)).tolist()


def test_bitserial_zero_profile_refuses_an_int32_overflow():
    """2**16 x 2**13 int8 in groups of 1 has 2**32 slots: the int32 result
    would wrap, so both paths raise before counting (an expanded view, so
    nothing that size is allocated)."""
    big = torch.zeros(1, 1, dtype=torch.int8).expand(2**16, 2**13)
    with pytest.raises(ValueError, match="overflow"):
        ops.bitserial_zero_profile(big, 1)
    with pytest.raises(ValueError, match="overflow"):
        ops.bitserial_zero_profile(big, 1, impl="cuda")


# ---------------------------------------------------------------------------
# Layout builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,N,bm,bn,frac", [
    (64, 64, 16, 16, 0.5), (128, 96, 32, 16, 0.3), (256, 256, 128, 128, 0.7),
    (64, 32, 16, 16, 0.0),
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_compress_fullblock_byte_equal(R, K, N, bm, bn, frac, dtype):
    w = RNG.normal(size=(K, N)).astype(np.float32)
    keep = RNG.random((K // bm, N // bn)) < frac
    wj, wt = _both(w, dtype)
    w_np = np.asarray(wj)
    want_wc, want_idx = R.ops.compress_fullblock(w_np, keep, bm, bn)
    np_wc, np_idx = ops.compress_fullblock(w_np, keep, bm, bn)
    assert np_wc.dtype == want_wc.dtype and np_wc.tobytes() == want_wc.tobytes()
    assert np_idx.tobytes() == want_idx.tobytes()
    t_wc, t_idx = ops.compress_fullblock_torch(wt, torch.from_numpy(keep), bm, bn)
    assert t_idx.dtype == torch.int32 and t_idx.numpy().tobytes() == want_idx.tobytes()
    bits = t_wc.view(torch.int16) if t_wc.dtype == torch.bfloat16 else t_wc
    want_bits = want_wc.view(np.int16) if dtype == "bfloat16" else want_wc
    assert bits.numpy().tobytes() == want_bits.tobytes()


def test_compress_fullblock_torch_padded_slots():
    w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    keep = torch.tensor([[True, False], [False, False], [True, True], [False, False]])
    wc, idx = ops.compress_fullblock_torch(w, keep, 16, 16, L=3)
    assert idx.tolist() == [[0, 2, -1], [2, -1, -1]]
    assert torch.equal(wc[0, 1], w[32:48, 0:16]) and not wc[1, 1:].any()
    with pytest.raises(ValueError, match="outside"):
        ops.compress_fullblock_torch(w, keep, 16, 16, L=1)
    with pytest.raises(ValueError, match="mismatches"):
        ops.compress_fullblock_torch(w, keep, 8, 16)


@pytest.mark.parametrize("K,N,m,ratio", [(64, 32, 2, 0.5), (128, 48, 4, 0.5), (96, 16, 4, 0.75),
                                         (64, 8, 8, 0.5)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_compress_intrablock_byte_equal(R, K, N, m, ratio, dtype):
    w = RNG.normal(size=(K, N)).astype(np.float32)
    mask = R.pruning.intrablock_mask(w, R.flexblock.IntraBlock(m, 1, ratio), align_cols=True)
    wj, wt = _both(w, dtype)
    w_np = np.asarray(wj)
    want_wc, want_idx = R.ops.compress_intrablock(w_np, mask, m)
    np_wc, np_idx = ops.compress_intrablock(w_np, mask, m)
    assert np_wc.dtype == want_wc.dtype and np_wc.tobytes() == want_wc.tobytes()
    assert np_idx.dtype == want_idx.dtype and np_idx.tobytes() == want_idx.tobytes()
    t_wc, t_idx = ops.compress_intrablock_torch(wt, torch.from_numpy(mask), m)
    assert t_idx.dtype == torch.int32 and t_idx.numpy().tobytes() == want_idx.tobytes()
    bits = t_wc.view(torch.int16) if t_wc.dtype == torch.bfloat16 else t_wc
    want_bits = want_wc.view(np.int16) if dtype == "bfloat16" else want_wc
    assert bits.numpy().tobytes() == want_bits.tobytes()
    np.testing.assert_array_equal(ops.decompress_intrablock(w_np, mask),
                                  R.ops.decompress_intrablock(w_np, mask))


def test_compress_intrablock_rejects_what_the_reference_rejects(R):
    w = RNG.normal(size=(16, 8)).astype(np.float32)
    unaligned = R.pruning.intrablock_mask(w, R.flexblock.IntraBlock(2, 1, 0.5))
    assert not np.all(unaligned.reshape(8, 2, 8) == unaligned.reshape(8, 2, 8)[:, :, :1])
    uneven = np.ones((16, 8), np.uint8)
    uneven[0] = 0                                     # block 0 keeps 1 of 2, the rest 2
    cases = [(unaligned, 2, "row-aligned"), (uneven, 2, "non-uniform"),
             (np.zeros((16, 8), np.uint8), 2, "keeps nothing"), (uneven, 3, "multiple")]
    for mask, m, msg in cases:
        with pytest.raises(ValueError):
            R.ops.compress_intrablock(w, mask, m)
        with pytest.raises(ValueError, match=msg):
            ops.compress_intrablock(w, mask, m)
        with pytest.raises(ValueError, match=msg):
            ops.compress_intrablock_torch(torch.from_numpy(w), torch.from_numpy(mask), m)


# ---------------------------------------------------------------------------
# Dispatch, errors, counters
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    ops.reset_launch_counts()
    x = torch.randn(4, 64)
    ops.block_importance(torch.randn(32, 64), 16, 16)
    ops.block_sparse_matmul(x, torch.randn(2, 1, 16, 8), torch.zeros(2, 1, dtype=torch.int32))
    q = torch.randn(1, 128, 2, 64)
    ops.flash_attention(q, q, q)
    ops.intrablock_gather_matmul(x, torch.randn(32, 8), torch.arange(32, dtype=torch.int32))
    ops.bitserial_zero_profile(torch.ones(4, 64, dtype=torch.int8), 16)
    ops.quantized_zero_profile(torch.randn(4, 64), 16)
    assert ops.launch_counts() == {"flash_attention": 0, "block_sparse_matmul": 0,
                                   "block_importance": 0, "intrablock_gather_matmul": 0,
                                   "bitserial_zero_profile": 0}
    variants = ops.variant_counts()
    assert variants["bitserial_zero_profile"] == {"strip": 0, "fused": 0, "general": 0}
    assert all(n == 0 for v in variants.values() for n in v.values())
    assert ops.gather_matmul_shape_counts() == {}


def test_cuda_impl_refuses_cpu_tensors():
    q = torch.randn(1, 128, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.block_importance(torch.randn(32, 32), 16, 16, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.block_sparse_matmul(torch.randn(2, 32), torch.randn(1, 1, 16, 16),
                                torch.zeros(1, 1, dtype=torch.int32), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.intrablock_gather_matmul(torch.randn(2, 32), torch.randn(16, 8),
                                     torch.arange(16, dtype=torch.int32), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.bitserial_zero_profile(torch.ones(2, 32, dtype=torch.int8), 8, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.quantized_zero_profile(torch.randn(2, 32), 8, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.block_importance(torch.randn(32, 32), 16, 16, impl="pallas")


def test_kernel_path_keeps_reference_errors():
    q = torch.randn(1, 96, 2, 64)
    with pytest.raises(ValueError, match="must tile"):
        ops.flash_attention(q, q, q, impl="cuda")                      # flash_attention.py:107
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(torch.randn(1, 128, 2, 48), torch.randn(1, 128, 2, 48),
                            torch.randn(1, 128, 2, 48), impl="cuda")
    with pytest.raises(ValueError, match="not a multiple of block rows"):   # block_sparse_matmul.py:59
        ops.block_sparse_matmul(torch.randn(2, 40), torch.randn(1, 1, 16, 16),
                                torch.zeros(1, 1, dtype=torch.int32), impl="cuda")
    with pytest.raises(ValueError, match="not divisible by block"):    # block_importance.py:44
        ops.block_importance(torch.randn(40, 32), 16, 16, impl="cuda")
    with pytest.raises(ValueError, match="tile_n"):                     # block_importance.py:47
        ops.block_importance(torch.randn(32, 64), 16, 16, impl="cuda", tile_n=24)
    with pytest.raises(ValueError, match="criterion"):
        ops.block_importance(torch.randn(32, 32), 16, 16, "l3")


def _tile_case(R, op):
    """(positional args for the port, for the reference, tile keywords to
    try) of one wrapper whose reference takes tile arguments."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(7, 64)).astype(np.float32)
    if op == "bitserial_zero_profile":
        q = rng.integers(-40, 40, size=(37, 70)).astype(np.int8)
        return ((torch.from_numpy(q), 32), (jnp.asarray(q), 32),
                [{"tile_v": v} for v in (1, 5, 128, 1000)])
    w = rng.normal(size=(64, 48)).astype(np.float32)
    if op == "block_sparse_matmul":
        keep = rng.random((4, 3)) < 0.5
        keep[0] = True
        wc, idx = R.ops.compress_fullblock(w, keep, 16, 16)
        return ((torch.from_numpy(x), torch.from_numpy(wc), torch.from_numpy(idx)),
                (jnp.asarray(x), jnp.asarray(wc), jnp.asarray(idx)),
                [{"tile_b": v} for v in (1, 3, 128, 1000)])
    mask = R.pruning.intrablock_mask(w, R.flexblock.IntraBlock(4, 1, 0.5), align_cols=True)
    wc, ridx = R.ops.compress_intrablock(w, mask, 4)
    return ((torch.from_numpy(x), torch.from_numpy(wc), torch.from_numpy(ridx)),
            (jnp.asarray(x), jnp.asarray(wc), jnp.asarray(ridx)),
            [{"tile_b": b, "tile_n": n} for b, n in ((1, 1), (3, 5), (128, 128), (1000, 7))])


@pytest.mark.parametrize("op", ["block_sparse_matmul", "intrablock_gather_matmul",
                                "bitserial_zero_profile"])
def test_wrappers_take_the_reference_tile_keywords(R, op):
    """A call written for ``repro.kernels.ops`` runs in the port; the tile
    arguments only pad in the reference, so no result depends on them."""
    ours_args, theirs_args, tiles = _tile_case(R, op)
    want = np.asarray(getattr(R.ops, op)(*theirs_args, impl="ref"))
    first = getattr(ops, op)(*ours_args, impl="auto", **tiles[0])
    for kw in tiles:
        got = getattr(ops, op)(*ours_args, impl="auto", **kw)
        assert torch.equal(got, first), kw
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for bad in (0, -128, 2.0, True):
        for name in tiles[0]:
            with pytest.raises(ValueError, match="positive int"):
                getattr(ops, op)(*ours_args, impl="auto", **{name: bad})


# ---------------------------------------------------------------------------
# Import boundary and the reference loader
# ---------------------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_import_boundary_covers_the_training_modules():
    """The boundary check above walks every file of the port: the training
    slice's and the launch layer's modules among them, the pipeline and
    the roofline copies, not imports."""
    port = ROOT / "src" / "repro_torch"
    covered = {str(p.relative_to(port)) for p in port.rglob("*.py")}
    assert {"train/optimizer.py", "train/step.py", "train/checkpoint.py", "train/trainer.py",
            "distributed/compress.py", "data/pipeline.py", "tree.py", "launch/counting.py",
            "launch/dryrun.py", "launch/roofline.py", "launch/hlo_histogram.py",
            "kernels/work.py", "kernels/hook.py"} <= covered


def test_reference_loader_leaves_sys_modules_as_found():
    before = {n for n in sys.modules if n == "repro" or n.startswith("repro.")}
    R = _jax_reference.load()
    assert R.transformer.__name__ == "repro.models.transformer"
    after = {n for n in sys.modules if n == "repro" or n.startswith("repro.")}
    assert after == before
    compat = sys.modules.get("repro.runtime.compat")
    assert compat is None or hasattr(compat, "_SUPPORTED")      # absent, or the real module
    pkg = sys.modules.get("repro.models")
    assert pkg is None or not hasattr(pkg, "transformer")
