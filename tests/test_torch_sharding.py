"""The port's sharding rules against the JAX package's, with no process
group: stub meshes (any object with a ``shape``) over the ten archs.

The reference's parameter trees come from ``jax.eval_shape`` of its
``init_params`` (as ``tests/test_multidevice.py`` builds them), the
port's from ``lm.init_params(..., device="meta")``.  The reference stacks
the layers of a pattern group, so a stacked leaf's spec has one more
leading entry, always None; the port's spec of layer ``g * period + i``
is the reference's ``blocks/pos{i}`` spec without it, and a layer past
the last whole group reads ``tail/{t}``.  Specs are compared entry by
entry, exactly.  Also: the divisibility test, ``tp_plan`` and
``serve_param_specs``, and ``local_shard`` blocks concatenating back to
the full tensor.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.launch import sharding as jsharding
from repro.models import lm as jlm
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding
from repro_torch.models import lm as tlm

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "2x2": {"data": 2, "model": 2},
    "1x2": {"data": 1, "model": 2},
}


def _stub(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


@functools.lru_cache(maxsize=None)
def _ref_tree(name: str):
    cfg = jax_config(name)
    return jax.eval_shape(lambda k: jlm.init_params(k, cfg),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_tree(name: str):
    return tlm.init_params(0, get_config(name), device="meta")


def _ref_by_path(spec_tree, params_s) -> dict:
    flat_p = jax.tree_util.tree_flatten_with_path(params_s)[0]
    flat_s = jax.tree.leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat_p) == len(flat_s)
    return {jsharding._path_str(path): tuple(spec)
            for (path, _), spec in zip(flat_p, flat_s, strict=True)}


def _ref_path(cfg, path: tuple) -> tuple[str, bool]:
    """The reference's path of the port's leaf ``path``, and whether the
    reference's leaf carries the stacked group dim."""
    rest = "/".join(str(p) for p in path[2:])
    if path[0] != "layers":
        return "/".join(str(p) for p in path), False
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    layer = path[1]
    if layer < n_groups * period:
        return f"blocks/pos{layer % period}/{rest}", True
    return f"tail/{layer - n_groups * period}/{rest}", False


def _assert_same(name, port_specs, ref_specs, port_params):
    cfg = get_config(name)
    ref = _ref_by_path(ref_specs, _ref_tree(name))
    flat = tree.with_paths(port_params)
    specs = sharding.spec_leaves(port_specs)
    assert len(flat) == len(specs)
    seen = set()
    for (path, leaf), spec in zip(flat, specs, strict=True):
        rpath, stacked = _ref_path(cfg, path)
        want = ref[rpath]
        if stacked:
            assert want[:1] in ((), (None,)), (name, rpath, want)
            want = want[1:]
        assert spec == want, (name, path, spec, want)
        assert len(spec) in (0, leaf.dim()), (name, path, spec)
        seen.add(rpath)
    assert seen == set(ref), (name, set(ref) ^ seen)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_and_opt_specs_match_reference(name, mesh_name):
    """``param_specs`` plain, with 'data' dropped and with the MoE ff2d
    rules, and ``opt_specs``, equal the reference's on this mesh."""
    shape = MESHES[mesh_name]
    port, ref = _port_tree(name), _ref_tree(name)
    for kw in ({}, {"drop_axes": ("data",)}, {"moe_ff2d": True}):
        ps = sharding.param_specs(port, _stub(shape), **kw)
        _assert_same(name, ps, jsharding.param_specs(ref, _stub(shape),
                                                     **kw), port)
    ps = sharding.param_specs(port, _stub(shape))
    jos = jsharding.opt_specs(jsharding.param_specs(ref, _stub(shape)),
                              master=True)
    tos = sharding.opt_specs(ps, master=True)
    assert tuple(jos["step"]) == tos["step"] == ()
    for k in ("m", "v", "master"):
        _assert_same(name, tos[k], jos[k], port)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_cache_specs_match_reference(name, mesh_name):
    """``cache_specs`` (with and without ``seq_over_model``, batches that
    divide the data axes and ones that do not) and ``paged_cache_specs``."""
    shape = MESHES[mesh_name]
    tcfg, jcfg = get_config(name), jax_config(name)

    def same(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b, strict=True):
            if y is None:
                assert x is None
                continue
            assert set(x) == set(y)
            for k in y:
                assert x[k] == tuple(y[k]), (name, k, x[k], y[k])

    for batch, length in ((1, 32768), (3, 4096), (32, 4096), (256, 2048)):
        for som in (False, True):
            same(sharding.cache_specs(tcfg, _stub(shape), batch, length,
                                      seq_over_model=som),
                 jsharding.cache_specs(jcfg, _stub(shape), batch, length,
                                       seq_over_model=som))
        same(sharding.paged_cache_specs(tcfg, _stub(shape), batch, length),
             jsharding.paged_cache_specs(jcfg, _stub(shape), batch, length))


@pytest.mark.parametrize("batch", [1, 3, 8, 256])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_match_reference(mesh_name, batch):
    shape = MESHES[mesh_name]
    for name in ("qwen3-0.6b", "llama-3.2-vision-11b"):
        got = sharding.batch_specs(get_config(name), _stub(shape), batch)
        want = jsharding.batch_specs(jax_config(name), _stub(shape), batch)
        assert set(got) == set(want)
        assert all(got[k] == tuple(want[k]) for k in want), (name, got)
    assert tmesh.batch_axes(_stub(shape)) == \
        __import__("repro.launch.mesh", fromlist=["x"]).batch_axes(
            _stub(shape))
    assert tmesh.n_data_replicas(_stub(shape)) == \
        shape.get("pod", 1) * shape["data"]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_sharding_rules_divisibility(name):
    """Every spec axis divides its dim on the production mesh (the
    ``_fit`` fallback guarantees it): the reference's test on the port's
    trees."""
    mesh = _stub({"data": 16, "model": 16})
    params = _port_tree(name)
    specs = sharding.param_specs(params, mesh)
    flat_p = tree.leaves(params)
    flat_s = sharding.spec_leaves(specs)
    assert len(flat_p) == len(flat_s)
    for leaf, spec in zip(flat_p, flat_s, strict=True):
        for dim, ax in zip(leaf.shape, spec, strict=False):
            if ax is not None:
                size = np.prod([mesh.shape[a] for a in
                                (ax if isinstance(ax, tuple) else (ax,))])
                assert dim % size == 0, (name, spec, tuple(leaf.shape))


class _Rank:
    """A stub mesh that also answers ``coord``: rank ``coords``."""

    def __init__(self, shape, coords):
        self.shape = dict(shape)
        self._coords = dict(coords)

    def coord(self, axis):
        return self._coords[axis]


@pytest.mark.parametrize("spec", [
    ("data", None), (None, "model"), ("model", "data"),
    (("data", "model"), None), (None, None, ("data", "model")), ()])
def test_local_shard_blocks_concatenate_to_full(spec):
    """Every rank's ``local_shard`` block, laid out by mesh coordinate,
    is the full tensor again."""
    shape = {"data": 2, "model": 4}
    t = torch.arange(8 * 16 * 8, dtype=torch.float32).reshape(8, 16, 8)
    t = t if len(spec) != 2 else t[:, :, 0]
    blocks = {}
    for d in range(2):
        for m in range(4):
            blocks[d, m] = sharding.local_shard(
                t, spec, _Rank(shape, {"data": d, "model": m}))
    rebuilt = t.clone().zero_()
    for (d, m), blk in blocks.items():
        idx = []
        for dim, ax in enumerate(spec):
            if ax is None:
                idx.append(slice(None))
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            n, i = 1, 0
            for a in axes:
                i = i * shape[a] + {"data": d, "model": m}[a]
                n *= shape[a]
            w = t.shape[dim] // n
            idx.append(slice(i * w, (i + 1) * w))
        rebuilt[tuple(idx)] = blk
    torch.testing.assert_close(rebuilt, t, rtol=0, atol=0)
    if not spec:
        assert all(b.data_ptr() == t.data_ptr() for b in blocks.values())


def test_local_tree_and_serve_specs():
    """``local_tree`` slices a reduced qwen3 tree by
    ``serve_param_specs`` (heads, hidden and vocab over 'model', nothing
    over 'data'); the slices of the two model ranks rebuild every leaf."""
    cfg = get_config("qwen3-0.6b").reduced()
    params = tlm.init_params(0, cfg, device="cpu")
    shape = {"data": 2, "model": 2}
    specs = sharding.serve_param_specs(cfg, params, _stub(shape))
    plan = sharding.tp_plan(cfg, _stub(shape))
    assert (plan.size, plan.attn, plan.ffn, plan.vocab) == (2, "split",
                                                            True, True)
    assert all("data" not in str(s) for s in sharding.spec_leaves(specs))
    halves = [sharding.local_tree(params, specs,
                                  _Rank(shape, {"data": 1, "model": m}))
              for m in range(2)]
    a0 = halves[0]["layers"][0]["attn"]
    assert a0["wq"]["w"].shape == (cfg.d_model, cfg.n_heads * 16 // 2)
    assert a0["wo"]["w"].shape == (cfg.n_heads * 16 // 2, cfg.d_model)
    assert halves[0]["embed"]["table"].shape == (cfg.vocab_size // 2,
                                                 cfg.d_model)
    for (path, full), spec, l0, l1 in zip(
            tree.with_paths(params), sharding.spec_leaves(specs),
            tree.leaves(halves[0]), tree.leaves(halves[1]), strict=True):
        dims = [i for i, a in enumerate(spec) if a is not None]
        if not dims:
            assert torch.equal(l0, full) and torch.equal(l1, full), path
        else:
            assert torch.equal(torch.cat([l0, l1], dim=dims[0]), full), path


def test_tp_plan_keeps_unsplittable_heads_whole_and_refuses_other_blocks():
    """Heads that split by no rule keep their attention block whole on
    every rank (the reduced qwen3's 4 q and 2 kv heads over 8: the q
    heads do not divide 8, and q/k-norm bars the head_dim split); no
    block kind is refused any more: the recurrent and cross-attention
    families split at a model extent of 2 and, where their heads or
    channels do not divide 16, run whole there; MoE splits its
    experts."""
    cfg = get_config("qwen3-0.6b").reduced()     # 4 q heads, 2 kv heads
    params = tlm.init_params(0, cfg, device="meta")
    mesh = _stub({"data": 1, "model": 8})
    plan = sharding.tp_plan(cfg, mesh)
    assert plan.attn == "whole" and plan.ffn and plan.vocab
    specs = sharding.serve_param_specs(cfg, params, mesh)
    for (path, _), spec in zip(tree.with_paths(params),
                               sharding.spec_leaves(specs), strict=True):
        if "attn" in path:
            assert all(a is None for a in spec), (path, spec)
    families = ("attn", "mamba", "mlstm", "slstm", "xattn")
    # (arch, model extent): the families that split; every other runs
    # whole (or the arch has none).
    splits = {
        ("zamba2-1.2b", 2): {"attn", "mamba"},
        ("zamba2-1.2b", 16): {"attn", "mamba"},       # 64 heads, 32 attn
        # xlstm-350m: 4 heads of 512 in d_inner 2048, no attention block.
        ("xlstm-350m", 2): {"mlstm", "slstm"},
        ("xlstm-350m", 16): {"slstm"},
        # llama-3.2-vision-11b: 32 q heads, 8 kv heads ("kv_shared" at 16).
        ("llama-3.2-vision-11b", 2): {"attn", "xattn"},
        ("llama-3.2-vision-11b", 16): {"attn", "xattn"},
    }
    for (name, m), split in splits.items():
        plan = sharding.tp_plan(get_config(name),
                                _stub({"data": 16 // m, "model": m}))
        assert plan.size == m
        assert {f for f in families if plan.splits(f)} == split, \
            (name, m, plan)
        assert sharding.tp_plan(get_config(name),
                                _stub({"data": 4, "model": 1})).size == 1
    # MoE splits its experts' hidden dim; grok's 48 q and 8 kv heads do
    # not both divide 16, so its attention shares each kv head between
    # the two ranks whose q heads read it.
    grok = sharding.tp_plan(get_config("grok-1-314b"),
                            _stub({"data": 16, "model": 16}))
    assert (grok.size, grok.attn, grok.moe, grok.vocab) == (
        16, "kv_shared", True, True)
    assert sharding.tp_plan(get_config("grok-1-314b"),
                            _stub({"data": 4, "model": 1})).size == 1


_PRODUCTION_MESHES = """
import json
from repro_torch.launch import mesh
mesh.init_fake(512)
out = {}
for multi in (False, True):
    m = mesh.make_production_mesh(multi_pod=multi)
    out[str(multi)] = [m.shape, m.size, str(m.device)]
print(json.dumps(out))
"""


def test_production_mesh_waits_for_the_dry_run():
    """The dry run's meshes on a fake group of 512 ranks: (16, 16)
    ("data", "model") over 256, (2, 16, 16) ("pod", "data", "model")
    over 512, on the meta device; with no process group it raises."""
    import json
    import os
    import subprocess
    import sys

    with pytest.raises(RuntimeError, match="init_fake"):
        tmesh.make_production_mesh()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _PRODUCTION_MESHES], capture_output=True,
        text=True, timeout=120, cwd=root,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["False"] == [{"data": 16, "model": 16}, 256, "meta"]
    assert got["True"] == [{"pod": 2, "data": 16, "model": 16}, 512,
                           "meta"]


@pytest.mark.parametrize("shape,trailing", [
    ((1024, 2048), ("data", "model")), ((3, 1024), ("data", "model")),
    ((8, 16, 4), (None, "model")), ((16,), ("model",)),
    ((2, 16, 16), ("pod", "data", "model")), ((5,), ("data",))])
def test_fit_matches_reference(shape, trailing):
    """``_fit`` pads the trailing spec and drops what does not divide,
    as the reference's does, on every mesh."""
    for axes in MESHES.values():
        assert sharding._fit(shape, trailing, axes) == \
            tuple(jsharding._fit(shape, trailing, axes))


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2", "1x2"])
def test_serve_shardings_match_reference(mesh_name):
    """``serve_shardings``: weights with 'data' dropped (the reduced
    qwen3's heads split over 'model'), the slot pool's cache specs; the
    reference's ``NamedSharding`` specs entry by entry."""
    shape = MESHES[mesh_name]
    tcfg = get_config("qwen3-0.6b").reduced()
    jcfg = jax_config("qwen3-0.6b").reduced()
    port = tlm.init_params(0, tcfg, device="meta")
    ref = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    pspecs, cspecs = sharding.serve_shardings(tcfg, _stub(shape), port, 4,
                                              48)
    _assert_same_reduced(port, pspecs, ref, jsharding.param_specs(
        ref, _stub(shape), drop_axes=("data",)), tcfg)
    want = jsharding.cache_specs(jcfg, _stub(shape), 4, 48)
    for got, w in zip(cspecs, want, strict=True):
        assert {k: tuple(v) for k, v in w.items()} == got


def _assert_same_reduced(port, port_specs, ref, ref_specs, cfg):
    """``_assert_same`` for a reduced config's trees."""
    refs = _ref_by_path(ref_specs, ref)
    for (path, _), spec in zip(tree.with_paths(port),
                               sharding.spec_leaves(port_specs),
                               strict=True):
        rpath, stacked = _ref_path(cfg, path)
        want = refs[rpath][1:] if stacked else refs[rpath]
        assert spec == want, (path, spec, want)
