"""Shared inputs and checks of the port's training tests
(tests/test_torch_train*.py): numpy params and batches handed to both
packages, one train step in each, and the comparison of what they give.

Params start from the reference's init of the ``.reduced()`` config
(pulled to numpy) with every norm scale redrawn from numpy (std 0.1), so
that ``1 + scale`` and the scales' grads are exercised.  Batches are numpy
draws: tokens, labels and, where the config takes one, a stub
``enc_embed`` or ``prefix_embed`` (std 1/sqrt(d)).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro_torch.convert import params_from_jax
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import make_train_step

# f32, one step: the loss, grad_norm and lr, and the moments m/v (linear
# in the grads), to 1e-5 of each leaf's largest entry.  The params take
# the AdamW direction mhat / (sqrt(vhat) + eps), eps = 1e-8, which is
# ill-conditioned where |g| is near eps: there a last-bit difference in a
# gradient sum can move one entry's update by a share of the learning
# rate.  So an entry whose |g| (sqrt(vhat) of the reference) is above
# 100 eps is held to 1e-5 of the leaf's largest entry plus 1e-3 of lr (its
# update moves by at most eps/|g| = 1% of the gradient's relative error);
# any other entry only to one update's reach, 2.2 lr.
REL = 1e-5
WELL = 100 * 1e-8


def is_norm(name: str) -> bool:
    return name.startswith(("ln", "post_ln")) or name.endswith("norm")


def np_params(R, jcfg, seed: int):
    ref = R.transformer.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if is_norm(path[-1].key):
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, ref)


def np_batch(cfg, B: int, S: int, seed: int):
    rng = np.random.default_rng(seed + 1000)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    std = 1.0 / np.sqrt(cfg.d_model)
    if cfg.enc_dec:
        batch["enc_embed"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model)) * std
                              ).astype(np.float32)
    if cfg.prefix_len:
        batch["prefix_embed"] = (rng.normal(size=(B, cfg.prefix_len, cfg.d_model)) * std
                                 ).astype(np.float32)
    return batch


def np_masks(masks):
    """The port's masks as the reference takes them (numpy, None kept)."""
    if isinstance(masks, dict):
        return {k: np_masks(v) for k, v in masks.items()}
    return None if masks is None else masks.numpy()


def ref_step(R, jcfg, ocfg, params, batch, **kw):
    """One jitted reference train step (as its Trainer jits it); numpy out."""
    with R.active():
        step = jax.jit(R.step.make_train_step(jcfg, ocfg, **kw))
        jp = jax.tree.map(jnp.asarray, params)
        new_p, new_o, met = step(jp, R.optimizer.adamw_init(jp),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        return (jax.tree.map(np.asarray, new_p), jax.tree.map(np.asarray, new_o),
                {k: float(v) for k, v in met.items()})


def port_step(cfg, ocfg, params, batch, **kw):
    """One port train step on the CPU from the same numpy params and batch."""
    p = params_from_jax(params, "cpu")
    o = adamw_init(p)
    step = make_train_step(cfg, ocfg, **kw)
    p, o, met = step(p, o, {k: torch.as_tensor(v) for k, v in batch.items()})
    return p, o, {k: float(v) for k, v in met.items()}


def pairs(ref_tree, port_tree, path=()):
    """(path, reference array, port tensor) of every leaf of the reference tree."""
    if isinstance(ref_tree, dict):
        for k in sorted(ref_tree):
            yield from pairs(ref_tree[k], port_tree[k], path + (k,))
    elif ref_tree is not None:
        yield path, np.asarray(ref_tree), port_tree


def assert_params_close(want_p, got_p, v, step: int, lr: float, b2: float = 0.95,
                        rel: float = REL):
    """The params after ``step`` AdamW steps, with the reference's second
    moment ``v``, to the tolerance above (``rel`` in place of 1e-5)."""
    for (path, want, got), (_, vv, _) in zip(pairs(want_p, got_p), pairs(v, v)):
        got = got.detach().float().numpy()
        want = want.astype(np.float32)
        assert got.shape == want.shape, path
        err = np.abs(got - want)
        well = np.sqrt(vv / (1 - b2 ** step)) > WELL
        base = rel * np.abs(want).max()
        assert (err[well] <= base + 1e-3 * lr).all(), (path, err[well].max())
        assert (err <= base + 2.2 * lr).all(), (path, err.max())


def assert_step_matches(ref, port, lr: float, rel: float = REL, flips: float = 0.0):
    """One step's metrics, moments and params to the tolerances above
    (``rel`` in place of 1e-5).  ``flips`` (int8-compressed grads) is the
    share of moment entries that may instead be off by one int8 level of
    the grad (1/127 of the leaf's largest entry in m, 2/127 in v): a
    last-bit difference before the stochastic rounding can move an entry to
    the neighbouring level."""
    (rp, ro, rm), (pp, po, pm) = ref, port
    for key in ("loss", "grad_norm", "lr"):
        assert abs(pm[key] - rm[key]) <= rel * abs(rm[key]), (key, pm[key], rm[key])
    assert int(po["step"]) == int(ro["step"])
    for name, level in (("m", 1 / 127), ("v", 2 / 127 + 1 / 127 ** 2)):
        for path, want, got in pairs(ro[name], po[name]):
            got = got.detach().numpy()
            assert got.shape == want.shape, (name, path)
            err, top = np.abs(got - want), np.abs(want).max()
            off = err > rel * top
            assert off.mean() <= flips, f"{name} {path}: {off.sum()} entries, max {err.max()}"
            assert (err[off] <= (level * 1.01 + rel) * top).all(), (name, path, err.max())
    assert_params_close(rp, pp, ro["v"], int(ro["step"]), lr, rel=rel)
