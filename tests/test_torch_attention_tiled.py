"""The statically tiled path of ``chunked_attention`` (the reference's
``repro/models/layers.py:209-273``) against the reference's own.

Where the reference tiles (causal, no cache length, queries from position
0, as many queries as keys and more than one chunk) the port tiles too:
queries in chunk-row tiles, the last padded, each against the kv tiles its
mask does not hide whole.  The chunk is small (16) so that every case runs
on the CPU in seconds.

* f32 values equal the reference's tiled path within ``LAYER_TOL``: causal
  at S 40 and S 37 (a padded last tile), a static window, a prefix that
  crosses a tile boundary, a softcap; bf16 score tiles equal the
  reference's run op by op (``jax.disable_jit``) within a bf16 ulp;
* on ``meta`` the matmul flops are the reference's tile pairs (S 4096,
  chunk 1024: 10 of 16), and the tiled path is taken exactly under the
  reference's condition;
* ``set_tiled_attn(False)`` gives back the generic loop, bit for bit.

Both packages' switches are module globals, and xdist reuses a worker: the
fixture puts both back on, and both scores dtypes to f32, even when a test
fails.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _jax_reference
from repro_torch.launch import counting
from repro_torch.models import layers as TL

R = _jax_reference.load()

LAYER_TOL = 2e-5
BF16_TOL = 2.0 ** -8
B, HQ, HKV, HD = 2, 4, 2, 16


@pytest.fixture(autouse=True)
def switches_back():
    try:
        yield
    finally:
        TL.set_tiled_attn(True)
        R.layers.set_tiled_attn(True)
        TL.set_scores_dtype(torch.float32)
        R.layers.set_scores_dtype(jnp.float32)


CASES = {
    # S, window, prefix, attn_cap
    "causal": (40, None, 0, 0.0),
    "causal-ragged": (37, None, 0, 0.0),
    "window": (40, 20, 0, 0.0),
    "window-ragged": (37, 9, 0, 0.0),
    "prefix": (40, None, 20, 0.0),
    "prefix-in-the-last-tile": (37, None, 35, 0.0),
    "softcap": (40, None, 0, 50.0),
    "softcap-window": (40, 16, 0, 50.0),
}


def _inputs(S, cap):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, S, HQ, HD)).astype(np.float32) * np.float32(30.0 if cap else 3.0)
    k = rng.normal(size=(B, S, HKV, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, HD)).astype(np.float32)
    return q, k, v


def _both(name, dtype=None, chunk=16):
    """(port, reference) on the case's inputs as f32 numpy; in ``dtype``
    (bf16 inputs and score tiles) the reference runs op by op."""
    S, window, prefix, cap = CASES[name]
    arrays = _inputs(S, cap)
    kw = dict(causal=True, window=window, prefix=prefix, attn_cap=cap, chunk=chunk)
    if dtype is None:
        want = R.layers.chunked_attention(*(jnp.asarray(a) for a in arrays), **kw)
        got = TL.chunked_attention(*(torch.from_numpy(a) for a in arrays), **kw)
    else:
        TL.set_scores_dtype(torch.bfloat16)
        R.layers.set_scores_dtype(jnp.bfloat16)
        with R.active(), jax.disable_jit():
            want = R.layers.chunked_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                                              **kw)
        got = TL.chunked_attention(*(torch.from_numpy(a).bfloat16() for a in arrays), **kw)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("name", list(CASES))
def test_the_tiled_path_matches_the_references_in_f32(name):
    got, want = _both(name)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LAYER_TOL
    # the window and the prefix change the rows they reach: the cases are not
    # the plain causal case again
    S, window, prefix, cap = CASES[name]
    if window or prefix:
        plain = TL.chunked_attention(*(torch.from_numpy(a) for a in _inputs(S, cap)),
                                     causal=True, attn_cap=cap, chunk=16).numpy()
        assert np.abs(got - plain).max() > 1e-3


@pytest.mark.parametrize("name", ["causal-ragged", "window", "prefix", "softcap"])
def test_bf16_score_tiles_match_the_references_tiled_path(name):
    got, want = _both(name, "bfloat16")
    assert np.abs(got - want).max() <= BF16_TOL


def _matmul_flops(S, *, chunk=1024, **kw):
    args = [torch.empty(1, S, h, HD, device="meta") for h in (2, 1, 1)]
    with counting.count(args) as c:
        TL.chunked_attention(*args, chunk=chunk, **kw)
    return c.flops_by_kind["matmul"]


def test_on_meta_a_causal_call_counts_the_references_tile_pairs():
    """S 4096 at chunk 1024: query tile i against kv tiles 0..i, 10 tile
    pairs of 1024 x 1024 (the generic loop: 16); 4·hd flops a pair and
    query head (the score and P·V products)."""
    pair = 1024 * 1024 * 4 * HD * 2
    assert _matmul_flops(4096) == 10 * pair
    TL.set_tiled_attn(False)
    assert _matmul_flops(4096) == 16 * pair
    TL.set_tiled_attn(True)
    # a window of one chunk: each tile against itself and the one before
    assert _matmul_flops(4096, window=1024) == 7 * pair
    # a prefix that ends in tile 1: tile 0 sees tiles 0..1
    assert _matmul_flops(4096, prefix=1500) == 11 * pair


@pytest.mark.parametrize("kw", [
    dict(causal=False),                                   # bidirectional
    dict(q_offset=torch.zeros((), dtype=torch.int32)),    # an offset that is not a static 0
    dict(kv_len=torch.full((1,), 2048, dtype=torch.int32)),
    dict(chunk=2048),                                     # one chunk
])
def test_the_generic_loop_runs_where_the_reference_does_not_tile(kw):
    kw = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in kw.items()}
    chunk = kw.pop("chunk", 1024)
    on = _matmul_flops(2048, chunk=chunk, **kw)
    TL.set_tiled_attn(False)
    assert _matmul_flops(2048, chunk=chunk, **kw) == on
    keys = max(chunk, 2048)
    assert on == 2048 * keys * 4 * HD * 2


@pytest.mark.parametrize("name", ["causal-ragged", "window", "prefix", "softcap-window"])
def test_switched_off_it_is_the_generic_loop_bit_for_bit(name):
    S, window, prefix, cap = CASES[name]
    q, k, v = (torch.from_numpy(a) for a in _inputs(S, cap))
    kw = dict(causal=True, window=window, prefix=prefix, attn_cap=cap, chunk=16)
    assert TL.set_tiled_attn(False) is True
    off = TL.chunked_attention(q, k, v, **kw)
    m, l, acc = TL._attention_stats(q, k, v, q_offset=0, kv_len=None, **kw)
    assert torch.equal(off, TL._attention_out(acc, l, q))
    assert TL.set_tiled_attn(True) is False
    on = TL.chunked_attention(q, k, v, **kw)
    assert float((on - off).abs().max()) <= LAYER_TOL
