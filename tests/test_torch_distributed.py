"""PyTorch port, the mesh layer: ``repro_torch/distributed/sharding.py``,
``launch/mesh.py`` and the two mesh paths of ``models/layers.py`` (the
expert-parallel MoE block and the sequence-parallel window attention)
≡ the JAX package.

The specs are held to the reference's ``spec_for_param`` /
``cache_specs`` / ``filter_spec`` entry by entry, on every config.  The
paths run in one 4-rank gloo world on the CPU, a (data 2, model 2) mesh
(tests/_torch_dist_worker.py; rendezvous through a ``file://`` store in
the test's temporary directory, every collective with a 90 s timeout,
the ranks joined with a time limit), on the cases of
tests/_dist_cases.py, and are held here to the reference computed in
this process on one device: the expert path to the reference's global
dispatch at dropless capacity (2e-4, the reference's own bound) and to
the reference's own expert-parallel block at a dropping capacity (run on
4 virtual devices in a subprocess, tests/_jax_ep_reference.py); the
window path to the reference's fallback attention (2e-5; gradients
2e-3).  Every rank must return the same global tensors.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _dist_cases as cases
import _jax_reference
from repro_torch.configs import SHAPE_CELLS, all_configs, get_config
from repro_torch.core.flexblock import FlexBlockSpec, FullBlock
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.dryrun import param_struct
from repro_torch.models import layers as TL
from repro_torch.sparsity.apply import prune_params

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
WORLD_TIMEOUT_S = 150
ARCHS = sorted(all_configs())


@pytest.fixture(scope="module")
def R():
    return _jax_reference.load()


@pytest.fixture(scope="module")
def RS(R):
    """The reference's ``repro.distributed.sharding`` (imported lazily by
    the reference, so taken from the loader's modules)."""
    with R.active():
        import repro.distributed.sharding as mod
    return mod


def jcfg_of(R, cfg):
    return R.configs.ArchConfig(**dataclasses.asdict(cfg))


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def _run_world(out: Path) -> None:
    """Start the 4 ranks, wait for all of them within WORLD_TIMEOUT_S, kill
    every one left on a timeout; fail unless each exits 0."""
    store = out / "store"
    procs = [subprocess.Popen([sys.executable, str(TESTS / "_torch_dist_worker.py"), str(r),
                               str(cases.WORLD), str(store), str(out)],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(cases.WORLD)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"ranks failed: {bad}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4 ranks' outputs: ``out[r]`` (arrays) and ``info[r]`` (path
    counts and helper results) for r in 0..3."""
    out = tmp_path_factory.mktemp("world")
    _run_world(out)
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(cases.WORLD)]
    info = [json.loads((out / f"rank{r}.json").read_text()) for r in range(cases.WORLD)]
    return types.SimpleNamespace(out=arrays, info=info)


@pytest.fixture(scope="module")
def ref_ep(tmp_path_factory):
    """The reference's ``_moe_block_ep`` at capacity 1.0 on 4 virtual
    devices (its own interpreter: jax fixes the device count at start)."""
    path = tmp_path_factory.mktemp("ref_ep") / "ref.npz"
    env = dict(_env(), XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, str(TESTS / "_jax_ep_reference.py"), str(path)],
                       env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(path))


def amax(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _leaves(tree, prefix="", is_leaf: bool = False):
    """(path, key, shape) of every tensor of a params tree; with
    ``is_leaf``, (path, key, leaf) of a spec tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/", is_leaf)
        else:
            yield f"{prefix}{k}", k, (v if is_leaf else tuple(v.shape))


@pytest.mark.parametrize("fallback", ["replicate", "head_dim"])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_param_matches_reference(RS, arch, fsdp, fallback):
    struct = param_struct(get_config(arch))
    specs = {}
    with shd.options(attn_kv_fallback=fallback), RS.options(attn_kv_fallback=fallback):
        for path, key, shape in _leaves(struct):
            specs[path] = shd.spec_for_param(key, shape, fsdp=fsdp)
            ref = RS.spec_for_param(key, shape, fsdp=fsdp)
            assert tuple(specs[path]) == tuple(ref), (path, shape, specs[path], ref)
        tree = shd.tree_specs(struct, fsdp=fsdp)
    assert len(specs) > 5
    assert {path: spec for path, _, spec in _leaves(tree, is_leaf=True)} == specs


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("cell", sorted(SHAPE_CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(R, RS, arch, cell, multi_pod):
    cfg = get_config(arch)
    rcell = R.configs.SHAPE_CELLS[cell]
    ours = shd.cache_specs(cfg, SHAPE_CELLS[cell], multi_pod=multi_pod)
    ref = RS.cache_specs(jcfg_of(R, cfg), rcell, multi_pod=multi_pod)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert tuple(ours[k]) == tuple(ref[k]), (k, ours[k], ref[k])
    assert tuple(shd.batch_spec(multi_pod=multi_pod)) == tuple(RS.batch_spec(multi_pod=multi_pod))
    assert tuple(shd.logits_spec(multi_pod=multi_pod)) == \
        tuple(RS.logits_spec(multi_pod=multi_pod))


class _StandInMesh:
    """The surface of a ``DeviceMesh`` that the spec helpers read."""

    def __init__(self, axes, coord=None):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(1 for _ in axes)
        self._coord = coord or [0] * len(axes)

    def get_coordinate(self):
        return self._coord


SPECS = [("model", None), (("pod", "data"), None, "model"), (None, ("data", "model")),
         (("pod",), None), ()]


@pytest.mark.parametrize("axes", [("data", "model"), ("model",), ("data",),
                                  ("pod", "data", "model"), ("pod", "model")])
def test_filter_spec_and_batch_axes_match_reference(R, RS, axes):
    from jax.sharding import PartitionSpec

    jmesh = jax.make_mesh((1,) * len(axes), axes)
    with R.active(), jax.set_mesh(jmesh), shd.set_mesh(_StandInMesh(axes)):
        for spec in SPECS:
            ours, ref = shd.filter_spec(shd.P(*spec)), RS.filter_spec(PartitionSpec(*spec))
            assert tuple(ours) == tuple(ref), (spec, ours, ref)
        ref_b = RS.batch_axes()
        assert shd.batch_axes() == (tuple(ref_b) if isinstance(ref_b, tuple) else ref_b)
        x = torch.arange(6.0)
        assert shd.maybe_shard(x, shd.P("data")) is x


def test_no_mesh_filters_nothing():
    assert shd.active_mesh() is None
    assert shd.filter_spec(shd.P("data", "model")) is None
    assert shd.batch_axes() is None


def test_options_restore_on_exit(RS):
    before = shd.get_options()
    with shd.options(fsdp=True, ep_shardmap=False) as o:
        assert o.fsdp and not o.ep_shardmap and shd.get_options() is o
        with pytest.raises(KeyError):
            with shd.options(attn_kv_fallback="head_dim"):
                raise KeyError("inside")
        assert shd.get_options() is o
    assert shd.get_options() is before
    ref = RS.ShardOpts()
    assert {f: getattr(ref, f) for f in dataclasses.asdict(before)} == dataclasses.asdict(before)


def test_spec_entries_normalise_as_partition_spec():
    from jax.sharding import PartitionSpec

    for spec in [(("data",), None), ((), "model"), (("pod", "data"),), ("model",)]:
        assert tuple(shd.P(*spec)) == tuple(PartitionSpec(*spec))


def test_local_shard_cuts_by_coordinate():
    class Mesh2(_StandInMesh):
        def __init__(self, coord):
            super().__init__(("data", "model"), coord)
            self.shape = (2, 3)

    t = torch.arange(2 * 6 * 4).reshape(2, 6, 4)
    for d in range(2):
        for m in range(3):
            mesh = Mesh2([d, m])
            got = shd.local_shard(t, shd.P(None, "model"), mesh)
            assert torch.equal(got, t[:, 2 * m:2 * m + 2])
            got = shd.local_shard(t, shd.P(None, ("data", "model")), mesh)
            assert torch.equal(got, t[:, d * 3 + m:d * 3 + m + 1])
            assert torch.equal(shd.local_shard(t, shd.P("pod", None), mesh), t)
    with pytest.raises(ValueError, match="does not split"):
        shd.local_shard(torch.zeros(5, 2), shd.P("model"), Mesh2([0, 0]))


def test_production_mesh_raises_without_its_world():
    with pytest.raises(RuntimeError, match="256 ranks"):
        lmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        lmesh.make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# The world: every rank returns the same global tensors
# ---------------------------------------------------------------------------

def test_every_rank_returns_the_same_global_tensors(world):
    for k, a in world.out[0].items():
        if k.startswith("mask/"):
            continue                 # a rank's own slice
        for r in range(1, cases.WORLD):
            assert np.array_equal(a, world.out[r][k]), (k, r)


def test_mesh_helpers_in_the_world(world):
    for r, info in enumerate(world.info):
        assert "needs a world of 256 ranks; this one has 4" in info["production_mesh"]
        assert info["local_mesh"] == [["data", "model"], [4, 1]]
        assert info["coordinate"] == [r // 2, r % 2]
        # experts on "model"; wq's 16 heads divide the production axis
        assert info["placements"] == {"w_up": ["Replicate()", "Shard(dim=1)"],
                                      "wq": ["Replicate()", "Shard(dim=2)"]}


# ---------------------------------------------------------------------------
# The expert path
# ---------------------------------------------------------------------------

def _ref_moe_global(R, cfg, inp, grads: bool = False):
    jcfg = jcfg_of(R, cfg)
    p = {k: jnp.asarray(inp[k]) for k in ("w_router", "w_up", "w_gate", "w_down")}
    x = jnp.asarray(inp["x"])
    with R.active():
        y = R.layers._moe_block_global(x, p, jcfg)
        if not grads:
            return np.asarray(y), None
        cot = jnp.asarray(inp["cot"])
        gp, gx = jax.grad(lambda p, x: (R.layers._moe_block_global(x, p, jcfg) * cot).sum(),
                          argnums=(0, 1))(p, x)
    return np.asarray(y), dict({f"grad_{k}": np.asarray(v) for k, v in gp.items()},
                               grad_x=np.asarray(gx))


def _port_moe_global(cfg, inp):
    p = {k: torch.tensor(inp[k], requires_grad=True)
         for k in ("w_router", "w_up", "w_gate", "w_down")}
    x = torch.tensor(inp["x"], requires_grad=True)
    y = TL._moe_block_global(x, p, cfg)
    (y * torch.tensor(inp["cot"])).sum().backward()
    return dict({f"grad_{k}": v.grad.numpy() for k, v in p.items()}, grad_x=x.grad.numpy())


@pytest.mark.parametrize("case", ["moe_dropless", "moe_local", "moe_fsdp"])
def test_expert_path_matches_reference_global_dispatch_dropless(R, world, case):
    cfg = cases.moe_cfg()
    y_ref, _ = _ref_moe_global(R, cfg, cases.moe_inputs(cfg))
    assert world.info[0][case] == {"moe_ep": 1, "swa_seqpar": 0}
    assert amax(world.out[0][f"{case}/y"], y_ref) <= cases.MOE_TOL


@pytest.mark.parametrize("case", ["moe_dropless", "moe_fsdp"])
def test_expert_path_gradients_match_the_global_path(R, world, case):
    cfg = cases.moe_cfg()
    inp = cases.moe_inputs(cfg)
    _, g_ref = _ref_moe_global(R, cfg, inp, grads=True)
    g_port = _port_moe_global(cfg, inp)
    for k, g in g_ref.items():
        got = world.out[0][f"{case}/{k}"]
        assert np.isfinite(got).all(), k
        scale = float(np.abs(g).max())
        assert amax(got, g) <= cases.MOE_TOL * max(1.0, scale), (k, amax(got, g), scale)
        assert amax(got, g_port[k]) <= 1e-5 * max(1.0, scale), (k, amax(got, g_port[k]))


def test_expert_path_matches_reference_ep_with_drops(world, ref_ep):
    cfg = cases.moe_cfg(capacity_factor=1.0)
    inp = cases.moe_inputs(cfg)
    # the slots each rank's routing drops, from its own slice of the tokens
    x = torch.tensor(inp["x"])
    dropped = 0
    for b in range(2):
        xt = x[2 * b:2 * b + 2].reshape(-1, cfg.d_model)
        for m in range(2):
            keep = TL._moe_dispatch(xt[16 * m:16 * m + 16], torch.tensor(inp["w_router"]),
                                    cfg.n_experts, cfg.top_k, 1.0, x.dtype)[2]
            dropped += int((~keep).sum())
    assert dropped > 0
    assert world.info[0]["moe_drops"] == {"moe_ep": 1, "swa_seqpar": 0}
    assert amax(world.out[0]["moe_drops/y"], ref_ep["moe_drops"]) <= cases.MOE_TOL
    # per-slice drops differ from the global path's, by design
    y_global = TL._moe_block_global(x, {k: torch.tensor(inp[k]) for k in
                                        ("w_router", "w_up", "w_gate", "w_down")}, cfg)
    assert amax(world.out[0]["moe_drops/y"], y_global.numpy()) > cases.MOE_TOL


def test_expert_path_decode_batch_below_the_model_axis(R, world):
    cfg = cases.moe_cfg()
    inp = cases.moe_inputs(cfg, batch=2, seq=1, seed=4)     # T_loc = 1 < M = 2
    y_ref, _ = _ref_moe_global(R, cfg, inp)
    assert world.info[0]["moe_decode"] == {"moe_ep": 1, "swa_seqpar": 0}
    assert amax(world.out[0]["moe_decode/y"], y_ref) <= cases.MOE_TOL


@pytest.mark.parametrize("case,cfg_kw,inp_kw", [
    ("moe_fallback_experts", {"n_experts": 5}, {"seed": 5}),      # E % M != 0
    ("moe_fallback_batch", {}, {"batch": 3, "seed": 6}),          # B % data != 0
    ("moe_fallback_option", {}, {}),                              # ep_shardmap=False
])
def test_expert_path_falls_back_to_global_dispatch(R, world, case, cfg_kw, inp_kw):
    cfg = cases.moe_cfg(**cfg_kw)
    y_ref, _ = _ref_moe_global(R, cfg, cases.moe_inputs(cfg, **inp_kw))
    assert world.info[0][case] == {"moe_ep": 0, "swa_seqpar": 0}
    assert amax(world.out[0][f"{case}/y"], y_ref) <= cases.MOE_TOL


def test_local_expert_masks_are_slices_of_the_single_process_mask(world):
    cfg = cases.moe_cfg()
    w = torch.tensor(cases.moe_inputs(cfg)["w_up"])
    spec = FlexBlockSpec((FullBlock(*cases.FULLBLOCK),))
    pruned, masks = prune_params({"layers": {"w_up": w[None]}}, spec, keys=("w_up",),
                                 device="cpu")
    E_loc = cfg.n_experts // 2
    m_full, w_full = masks["layers"]["w_up"][0], pruned["layers"]["w_up"][0]
    assert 0 < m_full.float().mean() < 1
    for r in range(cases.WORLD):
        m = r % 2
        assert np.array_equal(world.out[r]["mask/m"], m_full[m * E_loc:(m + 1) * E_loc].numpy())
        assert np.array_equal(world.out[r]["mask/w"], w_full[m * E_loc:(m + 1) * E_loc].numpy())


# ---------------------------------------------------------------------------
# The window path
# ---------------------------------------------------------------------------

def _ref_attention(R, cfg, inp, *, prefix: int = 0, grads: bool = False):
    jcfg = jcfg_of(R, cfg)
    p = {k: jnp.asarray(v) for k, v in inp.items() if k not in ("x", "cot")}
    x = jnp.asarray(inp["x"])
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    f = jax.jit(lambda x, p: R.layers.attention_block(x, p, jcfg, positions=pos, causal=True,
                                                      window=jcfg.window, prefix=prefix))
    y, (k, v) = f(x, p)
    out = {"y": np.asarray(y), "k": np.asarray(k), "v": np.asarray(v)}
    if grads:
        cot = jnp.asarray(inp["cot"])
        gp, gx = jax.jit(jax.grad(lambda p, x: (f(x, p)[0] * cot).sum(), argnums=(0, 1)))(p, x)
        out.update({f"grad_{k}": np.asarray(g) for k, g in gp.items()}, grad_x=np.asarray(gx))
    return out


def test_window_path_matches_reference_fallback(R, world):
    cfg = cases.swa_cfg()
    ref = _ref_attention(R, cfg, cases.swa_inputs(cfg), grads=True)
    assert world.info[0]["swa"] == {"moe_ep": 0, "swa_seqpar": 1}
    for k in ("y", "k", "v"):
        assert amax(world.out[0][f"swa/{k}"], ref[k]) <= cases.SWA_TOL, k
    for k in ("grad_wq", "grad_wk", "grad_wv", "grad_wo", "grad_x"):
        assert amax(world.out[0][f"swa/{k}"], ref[k]) <= cases.GRAD_TOL, k


def test_window_path_without_grad_matches_reference_fallback(R, world):
    """Under no grad the path takes serving's route, the flash op over each
    rank's block (its plain version on the CPU)."""
    cfg = cases.swa_cfg()
    ref = _ref_attention(R, cfg, cases.swa_inputs(cfg))
    assert world.info[0]["swa_nograd"] == {"moe_ep": 0, "swa_seqpar": 1}
    for k in ("y", "k", "v"):
        assert amax(world.out[0][f"swa_nograd/{k}"], ref[k]) <= cases.SWA_TOL, k


@pytest.mark.parametrize("case,cfg_kw,inp_kw,prefix", [
    ("swa_fallback_qk_norm", {"qk_norm": True}, {}, 0),
    ("swa_fallback_prefix", {}, {}, 8),
    ("swa_fallback_length", {}, {"seq": 1024}, 0),               # S % (M·1024) != 0
    ("swa_fallback_heads", {"n_heads": 4, "n_kv_heads": 4}, {}, 0),   # Hq % M == 0
])
def test_window_path_falls_back(R, world, case, cfg_kw, inp_kw, prefix):
    cfg = cases.swa_cfg(**cfg_kw)
    ref = _ref_attention(R, cfg, cases.swa_inputs(cfg, **inp_kw), prefix=prefix)
    assert world.info[0][case] == {"moe_ep": 0, "swa_seqpar": 0}
    for k in ("y", "k", "v"):
        assert amax(world.out[0][f"{case}/{k}"], ref[k]) <= cases.SWA_TOL, k


# ---------------------------------------------------------------------------
# Entry points under a mesh
# ---------------------------------------------------------------------------

def _ref_entry(R, cfg, S, steps):
    jcfg = jcfg_of(R, cfg)
    p = jax.tree.map(jnp.asarray, cases.np_params(cfg, 3))
    prompt, feed = cases.tokens(cfg, 2, S, steps)
    with R.active():
        lg, cache = jax.jit(lambda p, t: R.transformer.prefill(p, t, jcfg))(p, jnp.asarray(prompt))
        for key in ("k", "v"):
            if key in cache:
                cache[key] = jnp.pad(cache[key], ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
        out = [lg[:, -1]]
        step = jax.jit(lambda p, t, c: R.transformer.decode_step(p, t, jcfg, c))
        for tok in feed:
            lg, cache = step(p, jnp.asarray(tok), cache)
            out.append(lg)
    return np.stack([np.asarray(o) for o in out], axis=1)


@pytest.mark.parametrize("name", sorted(cases.entry_cases()))
def test_entry_points_under_a_mesh_match_no_mesh_and_reference(R, world, name):
    cfg, S, steps = cases.entry_cases()[name]
    mesh_lg, plain = world.out[0][f"entry_{name}/mesh"], world.out[0][f"entry_{name}/plain"]
    ref = _ref_entry(R, cfg, S, steps)
    assert mesh_lg.shape == ref.shape == (2, steps + 1, cfg.vocab_size)
    assert amax(mesh_lg, plain) <= cases.LOGIT_TOL
    assert amax(mesh_lg, ref) <= cases.LOGIT_TOL
    want = {"hymba": (0, 0), "hymba_seqpar": (0, cfg.n_layers),
            "qwen3_moe": (cfg.n_layers * (1 + steps), 0)}[name]
    assert world.info[0][f"entry_{name}"] == {"moe_ep": want[0], "swa_seqpar": want[1]}


def test_mesh_modules_are_in_the_import_boundary():
    port = ROOT / "src" / "repro_torch"
    covered = {str(p.relative_to(port)) for p in port.rglob("*.py")}
    assert {"distributed/sharding.py", "distributed/collectives.py",
            "launch/mesh.py"} <= covered
