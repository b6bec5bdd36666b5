"""Tensor parallelism of the recurrent and cross-attention blocks on gloo
CPU ranks, held against the JAX package on one device.

Harness: ``test_torch_fsdp.spawn`` (one ``torch.multiprocessing`` spawn
of four gloo ranks, a ``file://`` rendezvous under ``tmp_path``, the
children importing nothing of JAX; the references computed in the
parent).  One spawn runs every scenario:

* serving — the reduced zamba2-1.2b (its per-head Mamba2 parameters and
  conv bias perturbed, as ``test_torch_hybrid.py`` does, so that heads
  differ) and the reduced xlstm-350m through ``ServeScheduler`` on
  meshes (1, 2) and (2, 2), contiguous and paged: greedy tokens (f32)
  equal to the JAX package's single-device scheduler's on every rank;
* training — the reduced zamba2-1.2b, xlstm-350m and
  llama-3.2-vision-11b on (2, 2) ("data", "model"): two
  ``make_sharded_train_step`` steps at ``accum`` 2 against
  ``jax.jit(make_train_step)`` on one device, with
  ``test_torch_fsdp.py``'s tolerances (loss 1e-5, every parameter 2e-5,
  AdamW eps 1e-6 on both sides: see that file);
* the engine — the reduced llama-3.2-vision-11b's lock-step prefill and
  decode on (1, 2) (heads split) and (1, 4) (its 2 kv heads do not
  split: the attention and cross-attention blocks run whole) within
  1e-5 of the no-mesh engine, and its greedy tokens equal to the JAX
  engine's.

Without a spawn: the segment layouts of the concatenated projections
and the local states.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.launch import sharding
from repro_torch.models import lm as tlm

from test_torch_fsdp import EPS, LR, STEPS, _ref_leaf, spawn

ZAMBA, XLSTM, VISION = "zamba2-1.2b", "xlstm-350m", "llama-3.2-vision-11b"
SERVE_ARCHS = (ZAMBA, XLSTM)
SERVE_MESHES = [(1, 2), (2, 2)]
SERVE_KW = dict(n_slots=2, max_len=48, chunk_buckets=(8,), dispatch_depth=2)
TRAIN_ARCHS = (ZAMBA, XLSTM, VISION)
ENGINE_MESHES = [(1, 2), (1, 4)]


def _trace():
    """4 requests, prompts 8-17 tokens, 5 new tokens each."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 256, n), 5) for n in (12, 17, 9, 8)]


class _At:
    """A mesh's shape and one rank's coordinates (what ``local_shard``
    reads)."""

    def __init__(self, shape: dict, coords: dict):
        self.shape, self._coords = dict(shape), coords

    def coord(self, axis):
        return self._coords[axis]


# ---------------------------------------------------------------------------
# the children's side
# ---------------------------------------------------------------------------

def _serve(rank, arrays, trace) -> dict:
    from repro_torch import bridge
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import ServeScheduler

    out = {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).reduced()
        params = bridge.from_reference(arrays[arch], cfg, device="cpu")
        for shape in SERVE_MESHES:
            mesh = make_serve_mesh(*shape)
            if not mesh.contains:
                continue
            for paged in (False, True):
                kw = dict(SERVE_KW, paged=True, page_size=8) if paged \
                    else SERVE_KW
                sched = ServeScheduler(cfg, params,
                                       acc=StaticCoreChunk(cores=2),
                                       mesh=mesh, device="cpu", **kw)
                sched.warmup()
                rids = [sched.submit(p, m) for p, m in trace]
                outs = sched.run_until_idle()
                out[arch, shape, paged] = {
                    "tokens": [outs[r] for r in rids],
                    "tp": dataclasses.asdict(
                        dataclasses.replace(sched.tp, group=None)),
                    "states": sorted({tuple(t.shape) for c, kind in zip(
                        sched.pool.caches, cfg.layer_kinds(), strict=True)
                        if kind not in tlm.ATTN_KINDS for t in c.values()})}
    return out


def _train(rank, arrays) -> dict:
    from repro_torch import bridge
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw
    from repro_torch.train import sharded

    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
    opt_cfg = adamw.AdamWConfig(lr=LR, eps=EPS)
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        params = bridge.from_reference(arrays[arch], cfg, device="cpu",
                                       dtype=torch.float32)
        lp, lo = sharded.shard_train_state(
            params, adamw.init_state(params, opt_cfg), mesh, cfg=cfg)
        batch = sharded.shard_batch(
            make_batch(cfg, 8, 16, seed=0, device="cpu"), mesh, 2)
        step = sharded.make_sharded_train_step(cfg, opt_cfg, mesh, accum=2)
        metrics = []
        for _ in range(STEPS):
            lp, lo, m = step(lp, lo, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[arch] = {"metrics": metrics,
                     "coords": {a: mesh.coord(a) for a in mesh.axis_names},
                     "blocks": [t.numpy() for t in tree.leaves(lp)]}
    return out


def _engine(rank, arrays, tokens, feats) -> dict:
    from repro_torch import bridge
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import ServeEngine

    cfg = get_config(VISION).reduced()
    params = bridge.from_reference(arrays[VISION], cfg, device="cpu")
    tokens, feats = torch.from_numpy(tokens), torch.from_numpy(feats)
    kw = dict(batch=tokens.shape[0], max_len=40, device="cpu")
    whole = ServeEngine(cfg, params, **kw)
    want = [whole.prefill(tokens, feats)]
    want.append(whole.decode(want[0].argmax(-1), feats))
    out = {}
    for shape in ENGINE_MESHES:
        mesh = make_serve_mesh(*shape)
        if not mesh.contains:
            continue
        eng = ServeEngine(cfg, params, mesh=mesh, **kw)
        got = [eng.prefill(tokens, feats)]
        got.append(eng.decode(want[0].argmax(-1), feats))
        tp = eng._lockstep()[1]
        out[shape] = {
            "diffs": [float((g - w).abs().max())
                      for g, w in zip(got, want, strict=True)],
            "split": (tp.attn, tp.xattn, tp.ffn, tp.vocab),
            "tokens": ServeEngine(cfg, params, mesh=mesh, **kw).generate(
                tokens, 6, frontend_feats=feats).tolist()}
    return out


def tp_at_one(rank, arrays) -> dict:
    """One rank, mesh (1, 1): the sharded step's tensor-parallel context
    (size 1), the collectives its split paths issue, and whether its
    loss, norm and every parameter after a step equal
    ``make_train_step``'s bit for bit."""
    from repro_torch import bridge, collectives
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, sharded

    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
    opt_cfg = adamw.AdamWConfig(lr=LR, eps=EPS)
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        batch = make_batch(cfg, 4, 16, seed=0, device="cpu")
        runs = []
        for step_of in (
                lambda: sharded.make_sharded_train_step(
                    cfg, opt_cfg, mesh, split_at_one=True),
                lambda: make_train_step(cfg, opt_cfg)):
            params = bridge.from_reference(arrays[arch], cfg, device="cpu",
                                           dtype=torch.float32)
            opt = adamw.init_state(params, opt_cfg)
            calls = []
            collectives.collective_sinks.append(
                lambda *c, calls=calls: calls.append(c))
            try:
                params, opt, m = step_of()(params, opt, batch)
            finally:
                collectives.collective_sinks.clear()
            runs.append((params, m, len(calls)))
        (sp, sm, n_calls), (up, um, _) = runs
        tp = sharded.contexts(cfg, mesh, None, split_at_one=True)[0]
        out[arch] = {
            "default_tp": sharded.contexts(cfg, mesh, None)[0],
            "tp": dataclasses.asdict(dataclasses.replace(tp, group=None)),
            "collectives": n_calls,
            "loss_equal": torch.equal(sm["loss"], um["loss"]),
            "norm_equal": torch.equal(sm["grad_norm"], um["grad_norm"]),
            "params_equal": all(torch.equal(a, b) for a, b in zip(
                tree.leaves(sp), tree.leaves(up), strict=True))}
    return out


def tp_blocks(rank, arrays, trace, tokens, feats):
    torch.manual_seed(0)
    return {"serve": _serve(rank, arrays, trace),
            "train": _train(rank, arrays),
            "engine": _engine(rank, arrays, tokens, feats)}


# ---------------------------------------------------------------------------
# the parent's side: the JAX references
# ---------------------------------------------------------------------------

def _jax_params(arch: str):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import lm as jlm

    jcfg = jax_config(arch).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        if path[-1].key in ("a_log", "dt_bias", "d_skip", "conv_b"):
            return leaf + jnp.asarray(
                0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jcfg, jax.tree_util.tree_map_with_path(perturb, jparams)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax

    from repro.core.acc import StaticCoreChunk as JStatic
    from repro.data import make_batch as jmake_batch
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.serve import ServeEngine as JEngine
    from repro.serve import ServeScheduler as JScheduler

    from test_torch_fsdp import _jax_train

    ref = {arch: _jax_params(arch) for arch in set(SERVE_ARCHS + TRAIN_ARCHS)}
    arrays = {arch: jax.tree.map(np.asarray, jp)
              for arch, (_, jp) in ref.items()}
    vcfg, vparams = ref[VISION]
    vb = jmake_batch(vcfg, 3, 11, kind="prefill", seed=1)
    tokens = np.asarray(vb["tokens"])
    feats = np.asarray(vb["frontend_feats"], np.float32)
    res = spawn(tmp_path_factory.mktemp("tp-blocks"),
                "test_torch_tp_blocks:tp_blocks", 4, arrays, _trace(),
                tokens, feats)
    jserve = {}
    for arch in SERVE_ARCHS:
        jcfg, jparams = ref[arch]
        sched = JScheduler(jcfg, jparams, acc=JStatic(cores=2), **SERVE_KW)
        rids = [sched.submit(p, m) for p, m in _trace()]
        outs = sched.run_until_idle()
        jserve[arch] = [outs[r] for r in rids]
    jtrain = {arch: _jax_train(ref[arch][0], ref[arch][1],
                               JAdamWConfig(lr=LR, eps=EPS))
              for arch in TRAIN_ARCHS}
    jtokens = np.asarray(JEngine(vcfg, vparams, batch=3, max_len=40).generate(
        vb["tokens"], 6, frontend_feats=vb["frontend_feats"])).tolist()
    return res, ref, jserve, jtrain, jtokens


def gather_blocks(cfg, mesh_shape: dict, blocks_of: dict) -> dict:
    """Every parameter rebuilt from the ranks' blocks ({rank: (coords,
    blocks)}) by the training specs, segments included: each rank's
    block is placed where ``local_shard`` cut it from (read off an
    index tensor cut the same way); ranks holding an element must agree
    on it."""
    meta = tlm.init_params(0, cfg, device="meta")
    specs = sharding.spec_leaves(sharding.train_param_specs(
        cfg, meta, _At(mesh_shape, {})))
    out = {}
    for i, ((path, leaf), spec) in enumerate(zip(tree.with_paths(meta),
                                                 specs, strict=True)):
        full = np.full(leaf.numel(), np.nan, np.float32)
        index = torch.arange(leaf.numel()).reshape(leaf.shape)
        for coords, blocks in blocks_of.values():
            at = sharding.local_shard(index, spec,
                                      _At(mesh_shape, coords)).reshape(-1)
            block = blocks[i].reshape(-1)
            seen = ~np.isnan(full[at.numpy()])
            np.testing.assert_array_equal(full[at.numpy()][seen],
                                          block[seen], err_msg=str(path))
            full[at.numpy()] = block
        assert not np.isnan(full).any(), path
        out[path] = full.reshape(tuple(leaf.shape))
    return out


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("shape", SERVE_MESHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_recurrent_blocks_served_on_a_mesh_match_jax(run, arch, shape,
                                                     paged):
    """Tokens of the reduced zamba2 / xlstm served on the mesh equal the
    JAX package's single-device scheduler's on every rank; the recurrent
    blocks split over 'model' and the states hold the local heads or
    channels (zamba2's conv carry: this rank's x channels plus B and C)."""
    res, ref, jserve, *_ = run
    cfg = get_config(arch).reduced()
    m = shape[1]
    ranks = range(shape[0] * m)
    for r in ranks:
        got = res[r]["serve"][arch, shape, paged]
        assert got["tokens"] == jserve[arch]
    tp = res[0]["serve"][arch, shape, paged]["tp"]
    states = res[0]["serve"][arch, shape, paged]["states"]
    local = 2 // shape[0]
    h, hd, n = cfg.ssm_heads // m, cfg.ssm_head_dim, cfg.ssm_state
    if arch == ZAMBA:
        assert tp["mamba"] and tp["attn"] and not tp["mlstm"]
        assert states == sorted({(local, h, n, hd),
                                 (local, cfg.conv_width - 1, h * hd + 2 * n)})
    else:
        assert tp["mlstm"] and tp["slstm"] and not tp["mamba"]
        assert states == sorted({(local, h, hd, hd + 1),
                                 (local, cfg.d_inner // m)})
    assert [len(o) for o in jserve[arch]] == [k for _, k in _trace()]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_step_of_tp_blocks_matches_the_jax_step(run, arch):
    """Two sharded steps on (2, 2) equal the reference's single-device
    step: every rank's loss and norm the same, the loss within 1e-5, the
    norm within 1e-5 relative, every parameter (rebuilt from the ranks'
    blocks, segments in place) within 2e-5."""
    res, ref, _, jtrain, _ = run
    metrics, jtree = jtrain[arch]
    runs = {r: res[r]["train"][arch] for r in res}
    for one in runs.values():
        assert one["metrics"] == runs[0]["metrics"]
    for (loss, norm), (jloss, jnorm) in zip(runs[0]["metrics"], metrics,
                                            strict=True):
        assert abs(loss - jloss) <= 1e-5, (loss, jloss)
        assert abs(norm - jnorm) <= 1e-5 * jnorm, (norm, jnorm)
    cfg = get_config(arch).reduced()
    full = gather_blocks(cfg, {"data": 2, "model": 2},
                         {r: (one["coords"], one["blocks"])
                          for r, one in runs.items()})
    for path, arr in full.items():
        np.testing.assert_allclose(arr, _ref_leaf(jtree, ref[arch][0], path),
                                   rtol=0, atol=2e-5, err_msg=str(path))


@pytest.mark.parametrize("shape", ENGINE_MESHES)
def test_vision_engine_on_a_mesh(run, shape):
    """The lock-step engine of the reduced llama-vision on the mesh: its
    prefill and decode logits within 1e-5 of the no-mesh engine's, its
    greedy tokens the JAX engine's; at (1, 2) the attention and
    cross-attention heads split, at (1, 4) the 2 kv heads do not and
    both blocks share each kv head between the two ranks whose q heads
    read it ("kv_shared"), while the feed-forward and the vocabulary
    split."""
    res, *_, jtokens = run
    for r in range(shape[0] * shape[1]):
        got = res[r]["engine"][shape]
        assert max(got["diffs"]) <= 1e-5, got["diffs"]
        assert got["tokens"] == jtokens
    rule = "kv_shared" if shape[1] == 4 else "split"
    assert res[0]["engine"][shape]["split"] == (rule, rule, True, True)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    arrays = {arch: __import__("jax").tree.map(np.asarray,
                                               _jax_params(arch)[1])
              for arch in TRAIN_ARCHS}
    return spawn(tmp_path_factory.mktemp("tp-one"),
                 "test_torch_tp_blocks:tp_at_one", 1, arrays)[0]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_step_at_one_model_rank_runs_split_blocks(one_rank, arch):
    """On a (1, 1) mesh with ``split_at_one`` the sharded step runs
    every block family of the arch on its tensor-parallel path (a
    context of size 1, its row-parallel all-reduces and *f* issued), and
    equals the unsharded step bit for bit: zamba2's shared block too,
    whose input is read through *f* (q, k, v) and by the residual
    (``column_input`` sums its readers' gradients first with or without
    a split).  Without it the step builds no context at that extent."""
    got = one_rank[arch]
    tp = got["tp"]
    assert got["default_tp"] is None
    assert tp["size"] == 1 and tp["index"] == 0
    kinds = set(get_config(arch).layer_kinds())
    want = {"mamba": "mamba2" in kinds, "mlstm": "mlstm" in kinds,
            "slstm": "slstm" in kinds, "xattn": "cross_attn" in kinds}
    assert {k: tp[k] not in (False, "whole") for k in want} == want
    assert got["collectives"] > 0
    assert got["loss_equal"] and got["norm_equal"] and got["params_equal"]


# ---------------------------------------------------------------------------
# no spawn: the layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_segments_cut_each_part_of_a_concatenated_projection(m):
    """Rank r's block of zamba2's ``in_proj`` is its z, x and Δ columns
    and B, C whole; of the conv weight its x channels and B, C whole; of
    xlstm's ``w_if`` its heads' i and f columns and of ``w_zifo`` its
    block of each gate.  The blocks of the split parts tile them."""
    zcfg, xcfg = get_config(ZAMBA).reduced(), get_config(XLSTM).reduced()
    mesh_shape = {"data": 1, "model": m}
    for cfg, leaves in ((zcfg, {"mamba": ("in_proj", "conv_w")}),
                        (xcfg, {"mlstm": ("w_if",), "slstm": ("w_zifo",)})):
        params = tlm.init_params(0, cfg, device="cpu")
        specs = sharding.serve_param_specs(cfg, params, _At(mesh_shape, {}))
        layer = next(i for i, k in enumerate(cfg.layer_kinds())
                     if k in ("mamba2", "mlstm"))
        for family, names in leaves.items():
            li = layer if family != "slstm" else \
                cfg.layer_kinds().index("slstm")
            for name in names:
                p = params["layers"][li][family][name]
                full = p["w"] if isinstance(p, dict) else p
                spec = specs["layers"][li][family][name]
                spec = spec["w"] if isinstance(spec, dict) else spec
                seg = spec[-1]
                assert isinstance(seg, sharding.Segments)
                parts = full.split(list(seg.sizes), dim=-1)
                for r in range(m):
                    got = sharding.local_shard(
                        full, spec, _At(mesh_shape, {"model": r}))
                    want = torch.cat([pt.chunk(m, -1)[r] if sp else pt
                                      for pt, sp in zip(parts, seg.split,
                                                        strict=True)], -1)
                    assert torch.equal(got, want), (family, name, r)
    # The per-head vectors split by heads; zamba2's proj stays whole.
    specs = sharding.train_param_specs(
        zcfg, tlm.init_params(0, zcfg, device="meta"),
        _At({"data": 2, "model": m}, {}))
    assert specs["layers"][0]["mamba"]["a_log"] == ("model",)
    shared = zcfg.layer_kinds().index("shared_attn")
    assert specs["layers"][shared]["proj"]["w"] == ("data", None)


def test_split_parts_count_a_replicated_segment_once():
    """``split_parts`` gives a segmented block's split columns with the
    model axis and its replicated ones without, so the global norm sums
    the replicated columns' squares once."""
    cfg = get_config(ZAMBA).reduced()
    mesh = _At({"data": 2, "model": 2}, {"data": 0, "model": 1})
    spec = sharding.train_param_specs(
        cfg, tlm.init_params(0, cfg, device="meta"),
        mesh)["layers"][0]["mamba"]["in_proj"]["w"]
    block = torch.zeros(cfg.d_model // 2,
                        cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads // 2)
    parts = sharding.split_parts(block, spec, mesh)
    assert [p.shape[1] for p, _ in parts] == [
        cfg.d_inner // 2, cfg.d_inner // 2, cfg.ssm_state, cfg.ssm_state,
        cfg.ssm_heads // 2]
    assert [axes for _, axes in parts] == [("data", "model")] * 2 + [
        ("data",)] * 2 + [("data", "model")]


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_every_arch_has_a_plan_at_every_model_extent(m):
    """``tp_plan`` refuses no arch at any model extent, and the serving
    and training specs of every arch cut a block for every rank."""
    from repro_torch.configs import ARCH_NAMES

    for name in ARCH_NAMES:
        cfg = get_config(name)
        mesh = _At({"data": 16 // m, "model": m}, {"data": 0, "model": 0})
        plan = sharding.tp_plan(cfg, mesh)
        assert plan.size == m
        meta = tlm.init_params(0, cfg, device="meta")
        for specs in (sharding.serve_param_specs(cfg, meta, mesh),
                      sharding.train_param_specs(cfg, meta, mesh)):
            sharding.local_tree(meta, specs, mesh)
