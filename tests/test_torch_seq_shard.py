"""Sequence parallelism (Megatron-SP, ``seq_shard``) and the
weight-stationary experts (``moe_ff2d``) in the sharded train step, held
against the JAX package's single-device step on gloo CPU ranks.

Harness: ``test_torch_fsdp.spawn`` (four gloo ranks, the children
importing nothing of JAX; the references computed in the parent), its
batch (8 × 16, ``accum`` 2), lr 1e-3 and AdamW eps 1e-6:

* the reduced qwen3-0.6b and the drop-free reduced mixtral-8x22b with
  ``seq_shard`` on (2, 2) ("split" attention) and (1, 4) ("kv_shared"):
  two steps, the loss within 1e-5 and every parameter within 2e-5 of
  the reference's step;
* the mixtral at capacity factor 1.0 (choices drop) on (2, 2) with and
  without ``seq_shard``: the same drops, both within 2e-5 of the
  reference's step and of each other (the MoE block gathers its tokens,
  so capacity comes from the same count);
* ``moe_ff2d`` on (2, 2) under global and group-local dispatch (4
  groups), against the reference's step;
* one rank, (1, 1) with ``split_at_one``: the qwen3 step with
  ``seq_shard`` and the mixtral step with ``moe_ff2d`` (and with both)
  bit-equal to ``make_train_step``'s;
* SP on the other block families (zamba2, xlstm and llama-vision on
  (2, 2), a 6-head reduced qwen1.5 on (1, 4) whose attention trains
  whole) against the same step without it;
* the dry run's qwen3-0.6b ``train_4k`` with ``--seq-shard``: a lower
  per-rank peak than without it, its record carrying the flag.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_fsdp import (EPS, LR, STEPS, _jax_init, _jax_train,
                             _ref_leaf, spawn)

QWEN3, MIXTRAL = "qwen3-0.6b", "mixtral-8x22b"
SP_MESHES = [(2, 2), (1, 4)]
# (name, arch, mesh, capacity factor (None: the config's), dispatch
# groups, step keywords)
RUNS = ([(f"sp {arch} {shape}", arch, shape, None, None,
          {"seq_shard": True})
         for arch in (QWEN3, MIXTRAL) for shape in SP_MESHES]
        + [("drop", MIXTRAL, (2, 2), 1.0, None, {}),
           ("drop sp", MIXTRAL, (2, 2), 1.0, None, {"seq_shard": True}),
           ("ff2d", MIXTRAL, (2, 2), 1.0, None, {"moe_ff2d": True}),
           ("ff2d groups4", MIXTRAL, (2, 2), 1.0, 4, {"moe_ff2d": True})])
# SP on the other block families, against the same step without it:
# (arch, mesh); qwen1.5 with 6 q and 6 kv heads on (1, 4) trains its
# attention whole (no rule splits 6 heads 4 ways without a cache).
FAMILIES = [("zamba2-1.2b", (2, 2)), ("xlstm-350m", (2, 2)),
            ("llama-3.2-vision-11b", (2, 2)), ("qwen1.5-32b", (1, 4))]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the children's side
# ---------------------------------------------------------------------------

def train_run(rank, mesh, cfg, arrays, opt_cfg, groups=None, **step_kw
              ) -> dict:
    """Two sharded steps (``step_kw``: ``make_sharded_train_step``'s
    levers) from the reference's weights: every step's loss and norm,
    this rank's blocks and coordinates, the collectives and drops."""
    from repro_torch import bridge, collectives, tree
    from repro_torch.data import make_batch
    from repro_torch.models import flags
    from repro_torch.optim import adamw
    from repro_torch.train import sharded

    from test_torch_fsdp import _DROPS

    params = bridge.from_reference(arrays, cfg, device="cpu",
                                   dtype=torch.float32)
    opt = adamw.init_state(params, opt_cfg)
    lp, lo = sharded.shard_train_state(
        params, opt, mesh, cfg=cfg, moe_ff2d=step_kw.get("moe_ff2d", False))
    batch = sharded.shard_batch(
        make_batch(cfg, 8, 16, seed=0, device="cpu"), mesh, 2)
    step = sharded.make_sharded_train_step(cfg, opt_cfg, mesh, accum=2,
                                           **step_kw)
    calls: list = []
    collectives.collective_sinks.append(lambda *c: calls.append(c))
    before = _DROPS[0]
    metrics = []
    try:
        with flags.moe_dispatch_groups(groups):
            for _ in range(STEPS):
                lp, lo, m = step(lp, lo, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        collectives.collective_sinks.clear()
    return {"metrics": metrics, "drops": _DROPS[0] - before,
            "kinds": sorted({c[0] for c in calls}),
            "coords": {a: mesh.coord(a) for a in mesh.axis_names},
            "blocks": [t.numpy() for t in tree.leaves(lp)]}


def _cfg(arch: str, capacity_factor=None):
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    if arch == "qwen1.5-32b":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=6)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def sp_steps(rank, arrays) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw

    from test_torch_fsdp import _count_drops

    _count_drops()
    meshes = {shape: mesh_lib.make_mesh(shape, ("data", "model"))
              for shape in SP_MESHES}
    opt_cfg = adamw.AdamWConfig(lr=LR, eps=EPS)
    out = {name: train_run(rank, meshes[shape], _cfg(arch, cf),
                           arrays[arch], opt_cfg, groups, **kw)
           for name, arch, shape, cf, groups, kw in RUNS}
    for arch, shape in FAMILIES:
        runs = [train_run(rank, meshes[shape], _cfg(arch), arrays[arch],
                          opt_cfg, seq_shard=sp) for sp in (False, True)]
        out[arch] = {"metrics": [r["metrics"] for r in runs],
                     "kinds": runs[1]["kinds"],
                     "diff": max(float(np.abs(a - b).max()) for a, b in
                                 zip(runs[0]["blocks"], runs[1]["blocks"],
                                     strict=True))}
    return out


def at_one(rank, arrays) -> dict:
    """(1, 1) with ``split_at_one``: each lever's step against
    ``make_train_step``, bit for bit."""
    from repro_torch import bridge, tree
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, sharded

    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
    opt_cfg = adamw.AdamWConfig(lr=LR, eps=EPS)
    out = {}
    for arch, kw in ((QWEN3, {"seq_shard": True}),
                     (MIXTRAL, {"moe_ff2d": True}),
                     (MIXTRAL, {"seq_shard": True, "moe_ff2d": True})):
        cfg = _cfg(arch, 1.0 if arch == MIXTRAL else None)
        params = bridge.from_reference(arrays[arch], cfg, device="cpu",
                                       dtype=torch.float32)
        batch = make_batch(cfg, 4, 16, seed=0, device="cpu")
        runs = []
        for sharded_step in (False, True):
            p = tree.map_leaves(lambda t: t.clone(), params)
            opt = adamw.init_state(p, opt_cfg)
            if sharded_step:
                p, opt = sharded.shard_train_state(
                    p, opt, mesh, cfg=cfg,
                    moe_ff2d=kw.get("moe_ff2d", False))
                step = sharded.make_sharded_train_step(
                    cfg, opt_cfg, mesh, split_at_one=True, **kw)
            else:
                step = make_train_step(cfg, opt_cfg)
            p, opt, m = step(p, opt, batch)
            runs.append((m["loss"], m["grad_norm"], tree.leaves(p)))
        (l0, n0, p0), (l1, n1, p1) = runs
        out[arch, tuple(sorted(kw))] = {
            "loss": torch.equal(l0, l1), "norm": torch.equal(n0, n1),
            "params": all(torch.equal(a, b)
                          for a, b in zip(p0, p1, strict=True))}
    return out


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def gather_blocks(cfg, mesh_shape: dict, run: dict, ranks: list,
                  moe_ff2d: bool = False) -> dict:
    """Every parameter rebuilt from the ranks' blocks by the training
    specs (an entry may be a tuple of axes, the ff2d experts'), checking
    that ranks holding one block hold the same."""
    from repro_torch import tree
    from repro_torch.launch import sharding
    from repro_torch.models import lm

    class _Shape:
        shape = dict(mesh_shape)

    meta = lm.init_params(0, cfg, device="meta")
    specs = sharding.spec_leaves(sharding.train_param_specs(
        cfg, meta, _Shape(), moe_ff2d=moe_ff2d))
    out = {}
    for i, ((path, leaf), spec) in enumerate(zip(tree.with_paths(meta),
                                                 specs, strict=True)):
        full = np.full(tuple(leaf.shape), np.nan, np.float32)
        for r in ranks:
            coords = run[r]["coords"]
            block = run[r]["blocks"][i]
            idx = []
            for dim, ax in enumerate(tuple(spec) + (None,) * (
                    leaf.dim() - len(spec))):
                if ax is None:
                    idx.append(slice(None))
                    continue
                n, c = 1, 0
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    n, c = n * mesh_shape[a], c * mesh_shape[a] + coords[a]
                w = leaf.shape[dim] // n
                idx.append(slice(c * w, (c + 1) * w))
            where = full[tuple(idx)]
            seen = ~np.isnan(where)
            np.testing.assert_array_equal(where[seen], block[seen],
                                          err_msg=str(path))
            full[tuple(idx)] = block
        assert not np.isnan(full).any(), path
        out[path] = full
    return out


def check_step(cfg, jcfg, mesh_shape: dict, runs: dict, ref,
               moe_ff2d: bool = False) -> dict:
    """Every rank's losses the same and within 1e-5 of the reference's,
    every parameter within 2e-5; returns the rebuilt parameters."""
    metrics, jtree = ref
    ranks = sorted(runs)
    for r in ranks:
        assert runs[r]["metrics"] == runs[ranks[0]]["metrics"]
    for (loss, _), (jloss, _) in zip(runs[ranks[0]]["metrics"], metrics,
                                     strict=True):
        assert abs(loss - jloss) <= 1e-5, (loss, jloss)
    full = gather_blocks(cfg, mesh_shape, runs, ranks, moe_ff2d)
    for path, arr in full.items():
        np.testing.assert_allclose(arr, _ref_leaf(jtree, jcfg, path),
                                   rtol=0, atol=2e-5, err_msg=str(path))
    return full


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from repro.optim import AdamWConfig as JAdamWConfig

    tmp = tmp_path_factory.mktemp("seq-shard")
    dry = {tag: subprocess.Popen(
        [sys.executable, "-c", DRY, str(tmp / "dry"), tag], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag in ("", "sp")}
    init = {arch: _jax_init(arch) for arch in (QWEN3, MIXTRAL)}
    arrays = {arch: init[arch][2] for arch in init}
    arrays.update({arch: _jax_arrays(arch) for arch, _ in FAMILIES})
    res = spawn(tmp, "test_torch_seq_shard:sp_steps", 4, arrays)
    one = spawn(tmp, "test_torch_seq_shard:at_one", 1, arrays)[0]
    opt = JAdamWConfig(lr=LR, eps=EPS)
    refs = {}
    for name, arch, _, cf, groups, _ in RUNS:
        jcfg, jparams, _ = init[arch]
        if cf is not None:
            jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        key = (arch, cf, groups)
        if key not in refs:
            refs[key] = (jcfg, _jax_train(jcfg, jparams, opt, groups))
    recs = {}
    for tag, proc in dry.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        recs[tag] = json.loads(out.strip().splitlines()[-1])
    return res, one, refs, recs


def _jax_arrays(arch: str) -> dict:
    """The JAX package's weights of ``arch``'s reduced config (``_cfg``'s
    heads), as numpy."""
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import lm as jlm

    cfg = jax_config(arch).reduced()
    if arch == "qwen1.5-32b":
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=6)
    return jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0),
                                                    cfg))


# One dry-run train cell of qwen3-0.6b on the production mesh (16, 16):
# with "sp", under --seq-shard.
DRY = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    out, tag = sys.argv[1], sys.argv[2]
    rec = dryrun.run_cell("qwen3-0.6b", "train_4k", False, out_dir=out,
                          accum=2, seq_shard=tag == "sp", tag=tag,
                          verbose=False)
    print(json.dumps(rec, default=str))
""")


def _spec(name):
    return next(r for r in RUNS if r[0] == name)


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_sharded_step_with_the_levers_matches_the_jax_step(run, name):
    """Each lever's two steps on four gloo ranks equal the reference's
    single-device step: the loss within 1e-5, every parameter within
    2e-5, every rank's loss the same; SP runs its sequence collectives
    (reduce-scatter and all-gather), ff2d its buffer's."""
    from repro_torch.configs import get_config

    res, _, refs, _ = run
    _, arch, shape, cf, groups, kw = _spec(name)
    cfg = get_config(arch).reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jcfg, ref = refs[arch, cf, groups]
    runs = {r: res[r][name] for r in res}
    check_step(cfg, jcfg, {"data": shape[0], "model": shape[1]}, runs, ref,
               moe_ff2d=kw.get("moe_ff2d", False))
    kinds = runs[0]["kinds"]
    if kw:
        assert {"reduce-scatter", "all-gather"} <= set(kinds), kinds


def test_a_moe_step_that_drops_tokens_equals_the_step_without_sp(run):
    """At capacity factor 1.0 the MoE block under SP gathers its tokens,
    so its capacity and drops are the step's without SP: the same drops
    on every rank, choices dropped, and the parameters of both runs
    within 2e-5 of each other."""
    from repro_torch.configs import get_config

    res, *_ = run
    cfg = dataclasses.replace(get_config(MIXTRAL).reduced(),
                              capacity_factor=1.0)
    for r in res:
        assert res[r]["drop sp"]["drops"] == res[r]["drop"]["drops"]
    assert sum(res[r]["drop"]["drops"] for r in res) > 0
    shape = {"data": 2, "model": 2}
    a = gather_blocks(cfg, shape, {r: res[r]["drop"] for r in res},
                      sorted(res))
    b = gather_blocks(cfg, shape, {r: res[r]["drop sp"] for r in res},
                      sorted(res))
    for path in a:
        np.testing.assert_allclose(a[path], b[path], rtol=0, atol=2e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("lever", ["seq_shard", "moe_ff2d", "both"])
def test_levers_at_one_rank_are_bit_equal_to_the_unsharded_step(run,
                                                                lever):
    """On (1, 1) with ``split_at_one`` (every split path at size 1) the
    step with the lever equals ``make_train_step``'s bit for bit: loss,
    norm and every parameter."""
    _, one, *_ = run
    arch, kw = {"seq_shard": (QWEN3, ("seq_shard",)),
                "moe_ff2d": (MIXTRAL, ("moe_ff2d",)),
                "both": (MIXTRAL, ("moe_ff2d", "seq_shard"))}[lever]
    assert one[arch, kw] == {"loss": True, "norm": True, "params": True}


def test_dry_run_seq_shard_lowers_the_peak(run):
    """qwen3-0.6b ``train_4k`` on (16, 16): with ``--seq-shard`` the
    residual stream and its norms hold a sixteenth of the sequence, so
    rank 0's peak is lower; the record carries the lever, and the wire
    bytes count its reduce-scatters."""
    *_, recs = run
    plain, sp = recs[""], recs["sp"]
    for rec in (plain, sp):
        assert rec["status"] == "ok", rec.get("error")
    assert sp["seq_shard"] is True and plain["seq_shard"] is False
    assert sp["moe_ff2d"] is False
    assert sp["peak_memory_bytes"] < plain["peak_memory_bytes"]
    assert sp["collective_detail"]["counts"]["reduce-scatter"] > \
        plain["collective_detail"]["counts"].get("reduce-scatter", 0)
    assert sp["argument_bytes"] == plain["argument_bytes"]


@pytest.mark.parametrize("arch,shape", FAMILIES)
def test_sp_on_every_block_family_equals_the_step_without_it(run, arch,
                                                              shape):
    """SP on the Mamba2 and zamba2's shared block, the xLSTM blocks, the
    cross-attention blocks and a self-attention block that trains whole
    (each gathering its input's rows and keeping or reduce-scattering
    its output's): two steps within 2e-5 of the same step without SP
    (itself held against the JAX step by the tests of PRs 25 and 26),
    the losses within 1e-5, the sequence collectives issued."""
    res, *_ = run
    for r in res:
        got = res[r][arch]
        plain, sp = got["metrics"]
        for (a, _), (b, _) in zip(plain, sp, strict=True):
            assert abs(a - b) <= 1e-5, (a, b)
        assert got["diff"] <= 2e-5, got["diff"]
        assert {"reduce-scatter", "all-gather"} <= set(got["kinds"])


def test_sequence_must_divide_over_the_model_ranks():
    """SP splits the sequence into equal blocks: a sequence the model
    ranks do not divide raises ``ValueError``."""
    from repro_torch.configs import get_config
    from repro_torch.models import flags, lm

    cfg = get_config(QWEN3).reduced()
    params = lm.init_params(0, cfg, device="cpu")
    with flags.sequence_parallel(flags.SeqParallel(None, 4, 0)), \
            pytest.raises(ValueError, match="divide"):
        lm.forward(params, {"tokens": torch.zeros(1, 6, dtype=torch.long)},
                   cfg)
