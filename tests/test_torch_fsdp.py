"""The FSDP × TP training step on gloo CPU ranks, held against the JAX
package's single-device step, and the MoE dispatch groups.

Harness (``test_torch_mesh.py``'s): one ``torch.multiprocessing`` spawn
per scenario, its rendezvous a ``file://`` path under ``tmp_path``, a
spawn timeout and a 120 s timeout on every collective; the children
import nothing of JAX, the references are computed in the parent.

* (4, 2) ("data", "model"), the reference's ``DRYRUN_SMALL``
  (``tests/test_multidevice.py``): the reduced mixtral-8x22b, batch 8 ×
  16, ``accum`` 2, lr 1e-3, two ``make_sharded_train_step`` steps against
  ``jax.jit(make_train_step(...))`` on one device from the same weights
  (what GSPMD's step equals up to summation order), with the config's
  capacity (no drop), with ``capacity_factor=1.0`` (choices drop: both
  sides count drops) and under ``moe_dispatch_groups(4)``: the loss of
  each step within 1e-5, every parameter (gathered from the ranks'
  blocks) within 2e-5, every rank's loss the same, collectives counted.
  AdamW's eps is 1e-6 on both sides (not its default 1e-8): the first
  steps move an element by lr·g/(|g| + eps), so an element whose
  gradient is rounding noise (|g| ≈ 1e-8 where the median is 1.6e-3, at
  capacity factor 1.0) moves by a few percent of lr on one side and not
  the other; at 1e-8 the port's own unsharded step is 2.45e-5 from the
  reference's there, whatever the mesh;
* (2, 2, 2) ("pod", "data", "model"): the reduced qwen3-0.6b, the same
  for two steps with a clip that bites (the global norm over shards),
  and a prefill chunk and one decode step of ``forward_cached`` over the
  FSDP × TP blocks against the no-mesh forward (1e-5);
* with no mesh: ``moe.apply`` under ``moe_dispatch_groups(g)`` against
  the reference's for g 1, 2, 4 at a dropping capacity, and a count of
  groups the tokens do not fit raising ``ValueError``.
"""
import contextlib
import dataclasses
import importlib
import pickle
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 240
# Eight ranks start side by side with the suite's other workers: every
# collective (the rendezvous too) waits at most this long.
COLLECTIVE_S = 120
STEPS = 2
LR = 1e-3
EPS = 1e-6


def _worker(rank, world, init, scenario, args, out):
    try:
        from repro_torch.launch import mesh as mesh_lib

        mesh_lib.init_distributed("cpu", init_method=init, rank=rank,
                                  world_size=world, timeout_s=COLLECTIVE_S)
        torch.set_num_threads(1)
        module, _, name = scenario.rpartition(":")
        fn = vars(importlib.import_module(module))[name] if module \
            else globals()[name]
        result = fn(rank, *args)
        out.put((rank, "ok", pickle.dumps(result)))
    except Exception:                        # reported to the parent
        out.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(tmp_path, scenario: str, world: int, *args) -> dict:
    """``scenario(rank, *args)`` on ``world`` gloo ranks: {rank: result}.
    ``scenario`` names a function of this module, or of another test
    module as "module:function"."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = f"file://{tmp_path}/rendezvous-{scenario.replace(':', '-')}"
    procs = [ctx.Process(target=_worker,
                         args=(r, world, init, scenario, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(world):
            rank, status, payload = out.get(timeout=SPAWN_TIMEOUT_S)
            if status == "ok":
                results[rank] = pickle.loads(payload)
            else:
                errors[rank] = payload
    except queue.Empty:
        errors["timeout"] = f"no answer within {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    if errors:
        raise AssertionError("\n".join(f"rank {r}:\n{e}"
                                       for r, e in errors.items()))
    return results


# ---------------------------------------------------------------------------
# the children's side
# ---------------------------------------------------------------------------

def _cfg(arch: str, capacity_factor: float | None):
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


# Dropped choices of this spawned rank's ``moe.placement`` calls.
_DROPS = [0]


def _count_drops() -> None:
    """Count the dropped choices of every ``moe.placement`` call of this
    spawned rank in ``_DROPS`` (its module is patched for good)."""
    from repro_torch.models import moe

    place = moe.placement

    def spy(*a, **k):
        dest, keep = place(*a, **k)
        _DROPS[0] += int((~keep).sum())
        return dest, keep

    moe.placement = spy


def _train(rank, mesh, cfg, arrays, opt_cfg, groups=None) -> dict:
    """Two sharded steps from the reference's weights: every step's loss
    and norm, this rank's blocks and coordinates, the collectives and
    the drops."""
    from repro_torch import bridge, collectives, tree
    from repro_torch.data import make_batch
    from repro_torch.models import flags
    from repro_torch.optim import adamw
    from repro_torch.train import sharded

    params = bridge.from_reference(arrays, cfg, device="cpu",
                                   dtype=torch.float32)
    opt = adamw.init_state(params, opt_cfg)
    lp, lo = sharded.shard_train_state(params, opt, mesh, cfg=cfg)
    batch = sharded.shard_batch(
        make_batch(cfg, 8, 16, seed=0, device="cpu"), mesh, 2)
    step = sharded.make_sharded_train_step(cfg, opt_cfg, mesh, accum=2)
    calls = []
    collectives.collective_sinks.append(lambda *c: calls.append(c))
    before = _DROPS[0]
    metrics = []
    groups_ctx = flags.moe_dispatch_groups(groups) if groups \
        else contextlib.nullcontext()
    try:
        with groups_ctx:
            for _ in range(STEPS):
                lp, lo, m = step(lp, lo, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        collectives.collective_sinks.clear()
    return {"metrics": metrics, "drops": _DROPS[0] - before,
            "collectives": len(calls),
            "coords": {a: mesh.coord(a) for a in mesh.axis_names},
            "blocks": [t.numpy() for t in tree.leaves(lp)]}


def fsdp_moe(rank, arrays):
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw

    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"))
    _count_drops()
    opt_cfg = adamw.AdamWConfig(lr=LR, eps=EPS)
    out = {}
    for name, cf, groups in RUNS_MOE:
        out[name] = _train(rank, mesh, _cfg("mixtral-8x22b", cf), arrays,
                           opt_cfg, groups)
    return out


def fsdp_dense(rank, arrays):
    from repro_torch import bridge
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import flags, lm
    from repro_torch.optim import adamw
    from repro_torch.train import sharded

    mesh = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = _cfg("qwen3-0.6b", None)
    # prefill and decode over the FSDP × TP blocks, before training
    params = bridge.from_reference(arrays, cfg, device="cpu",
                                   dtype=torch.float32)
    pspec, _ = sharded.train_specs(cfg, mesh)
    tp, fsdp = sharded.contexts(cfg, mesh, pspec)
    lp = sharding.local_tree(params, pspec, mesh)
    tokens = make_batch(cfg, 8, 12, kind="prefill", seed=3,
                        device="cpu")["tokens"]
    mine = sharded.shard_batch({"tokens": tokens}, mesh)["tokens"]
    plan = sharding.tp_plan(cfg, mesh)
    local_cfg = dataclasses.replace(
        cfg, n_kv_heads=cfg.n_kv_heads // plan.size, head_dim=cfg.head_dim_)
    caches = lm.init_caches(local_cfg, mine.shape[0], 16, device="cpu")
    whole = lm.init_caches(cfg, mine.shape[0], 16, device="cpu")
    diffs = []
    with torch.no_grad():
        for chunk, pos in ((mine[:, :8], 0), (mine[:, 8:9], 8)):
            with flags.tensor_parallel(tp), flags.fsdp(fsdp):
                got, _ = lm.forward_cached(lp, chunk, caches, pos, cfg)
            want, _ = lm.forward_cached(params, chunk, whole, pos, cfg)
            assert got.shape == want.shape
            diffs.append(float((got - want).abs().max()))
    opt_cfg = adamw.AdamWConfig(lr=LR, eps=EPS, grad_clip=CLIP)
    out = _train(rank, mesh, cfg, arrays, opt_cfg)
    out["forward"] = diffs
    return out


# ---------------------------------------------------------------------------
# the parent's side: the JAX references
# ---------------------------------------------------------------------------

# (name, capacity factor (None: the config's 8.0), dispatch groups)
RUNS_MOE = [("config", None, None), ("drop", 1.0, None),
            ("groups4", 1.0, 4)]
CLIP = 0.5


def _jax_init(arch: str):
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import lm as jlm

    jcfg = jax_config(arch).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


def _jax_train(jcfg, jparams, opt_cfg, groups=None) -> tuple[list, dict]:
    """Two steps of the reference's jitted single-device step."""
    import jax

    from repro.data import make_batch as jmake_batch
    from repro.models import flags as jflags
    from repro.optim import adamw as jadamw
    from repro.train import make_train_step as jmake_train_step

    batch = jmake_batch(jcfg, 8, 16, kind="train", seed=0)
    with jflags.moe_dispatch_groups(groups):
        step = jax.jit(jmake_train_step(jcfg, opt_cfg, accum=2))
        params, opt = jparams, jadamw.init_state(jparams, opt_cfg)
        metrics = []
        for _ in range(STEPS):
            params, opt, m = step(params, opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, jax.tree.map(np.asarray, params)


def _jax_drops(jcfg, jparams) -> int:
    """Dropped choices of the reference's forward of the first
    microbatch, counted by running it eagerly (``jax.disable_jit``) with
    its dispatch function wrapped."""
    import jax

    from repro.data import make_batch as jmake_batch
    from repro.models import lm as jlm
    from repro.models import moe as jmoe

    batch = jmake_batch(jcfg, 8, 16, kind="train", seed=0)
    micro = {k: v[:4] for k, v in batch.items()}
    drops = [0]
    inner = jmoe._dispatch_compute_combine

    def spy(tokens, gate_idx, gate_w, p, cfg, capacity):
        idx = np.asarray(gate_idx).reshape(-1)
        oh = np.eye(cfg.n_experts, dtype=np.int64)[idx]
        pos = (np.cumsum(oh, 0) - oh)[np.arange(idx.size), idx]
        drops[0] += int((pos >= capacity).sum())
        return inner(tokens, gate_idx, gate_w, p, cfg, capacity)

    jmoe._dispatch_compute_combine = spy
    try:
        with jax.disable_jit():
            jlm.loss_fn(jparams, micro, jcfg, remat=False)
    finally:
        jmoe._dispatch_compute_combine = inner
    return drops[0]


def _ref_leaf(jtree, cfg, path) -> np.ndarray:
    """The reference's leaf at a port path (layer i of the port is slice
    i // period of ``blocks/pos{i % period}``)."""
    node, index = jtree, None
    if path[0] == "layers":
        period = len(cfg.block_pattern)
        node, index = jtree["blocks"][f"pos{path[1] % period}"], \
            path[1] // period
        path = path[2:]
    for key in path:
        node = node[key]
    arr = np.asarray(node, np.float32)
    return arr if index is None else arr[index]


def _gather_blocks(cfg, mesh_shape: dict, res: dict, name: str | None):
    """Every parameter of the port rebuilt from the ranks' blocks:
    {path: full array}, checking that every rank holding a block holds
    the same one."""
    from repro_torch import tree
    from repro_torch.launch import sharding
    from repro_torch.models import lm

    class _Shape:
        shape = dict(mesh_shape)

    meta = lm.init_params(0, cfg, device="meta")
    specs = sharding.spec_leaves(
        sharding.train_param_specs(cfg, meta, _Shape()))
    out = {}
    for i, ((path, leaf), spec) in enumerate(zip(tree.with_paths(meta),
                                                 specs, strict=True)):
        full = np.full(tuple(leaf.shape), np.nan, np.float32)
        for r in res.values():
            run = r[name] if name else r
            block = run["blocks"][i]
            idx = []
            for dim, ax in enumerate(tuple(spec) + (None,) * (
                    leaf.dim() - len(spec))):
                if ax is None:
                    idx.append(slice(None))
                    continue
                n = mesh_shape[ax]
                w = leaf.shape[dim] // n
                c = run["coords"][ax]
                idx.append(slice(c * w, (c + 1) * w))
            where = full[tuple(idx)]
            seen = ~np.isnan(where)
            np.testing.assert_array_equal(where[seen], block[seen],
                                          err_msg=str(path))
            full[tuple(idx)] = block
        assert not np.isnan(full).any(), path
        out[path] = full
    return out


@pytest.fixture(scope="module")
def moe_run(tmp_path_factory):
    from repro.optim import AdamWConfig as JAdamWConfig

    jcfg, jparams, arrays = _jax_init("mixtral-8x22b")
    res = spawn(tmp_path_factory.mktemp("fsdp-moe"), "fsdp_moe", 8, arrays)
    ref = {}
    for name, cf, groups in RUNS_MOE:
        cfg = jcfg if cf is None else dataclasses.replace(
            jcfg, capacity_factor=cf)
        ref[name] = _jax_train(cfg, jparams, JAdamWConfig(lr=LR, eps=EPS),
                               groups)
    drops = _jax_drops(dataclasses.replace(jcfg, capacity_factor=1.0),
                       jparams)
    return jcfg, res, ref, drops


@pytest.fixture(scope="module")
def dense_run(tmp_path_factory):
    from repro.optim import AdamWConfig as JAdamWConfig

    jcfg, jparams, arrays = _jax_init("qwen3-0.6b")
    res = spawn(tmp_path_factory.mktemp("fsdp-dense"), "fsdp_dense", 8,
                arrays)
    ref = _jax_train(jcfg, jparams, JAdamWConfig(lr=LR, eps=EPS,
                                                 grad_clip=CLIP))
    return jcfg, res, ref


def _check_against_reference(cfg, jcfg, mesh_shape, res, name, ref):
    metrics, jtree = ref
    runs = [r[name] if name else r for r in res.values()]
    for run in runs:
        assert run["metrics"] == runs[0]["metrics"]
        assert run["collectives"] > 0
    for (loss, _), (jloss, _) in zip(runs[0]["metrics"], metrics,
                                     strict=True):
        assert abs(loss - jloss) <= 1e-5, (loss, jloss)
    full = _gather_blocks(cfg, mesh_shape, res, name)
    for path, arr in full.items():
        np.testing.assert_allclose(arr, _ref_leaf(jtree, jcfg, path),
                                   rtol=0, atol=2e-5, err_msg=str(path))


@pytest.mark.parametrize("name", [n for n, _, _ in RUNS_MOE])
def test_sharded_moe_step_matches_the_jax_step(moe_run, name):
    """The reduced mixtral-8x22b on (4, 2): two sharded steps equal the
    reference's single-device step (loss 1e-5, every parameter 2e-5),
    every rank's loss the same, collectives counted."""
    from repro_torch.configs import get_config

    jcfg, res, ref, _ = moe_run
    cf = dict((n, c) for n, c, _ in RUNS_MOE)[name]
    cfg = get_config("mixtral-8x22b").reduced()
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    _check_against_reference(cfg, jcfg, {"data": 4, "model": 2}, res, name,
                             ref[name])


def test_choices_drop_on_both_sides_at_capacity_factor_one(moe_run):
    """At capacity factor 1.0 the global dispatch drops choices in the
    port's step and in the reference's forward: in the port, on the data
    ranks whose tokens come last in the global order (the lower ranks'
    choices take the first places), the two model ranks of a data rank
    alike; at the config's 8.0 and in groups of 16 tokens (the ``min(t,
    16)`` floor) none."""
    *_, res, _, jdrops = moe_run
    assert jdrops > 0
    drops = [res[r]["drop"]["drops"] for r in sorted(res)]
    assert sum(drops) > 0 and drops[0] == 0
    assert drops[0::2] == drops[1::2]
    for r in res.values():
        assert r["config"]["drops"] == 0 and r["groups4"]["drops"] == 0


def test_sharded_dense_step_on_pods_matches_with_the_clip(dense_run):
    """The reduced qwen3-0.6b on (2, 2, 2): two sharded steps equal the
    reference's, the gradient norm over the shards equals the
    reference's and is above the clip, so the clip bites."""
    from repro_torch.configs import get_config

    jcfg, res, ref = dense_run
    _check_against_reference(get_config("qwen3-0.6b").reduced(), jcfg,
                             {"pod": 2, "data": 2, "model": 2}, res, None,
                             ref)
    for (_, norm), (_, jnorm) in zip(res[0]["metrics"], ref[0],
                                     strict=True):
        assert norm > CLIP and jnorm > CLIP
        assert abs(norm - jnorm) <= 1e-5 * jnorm


def test_prefill_and_decode_over_fsdp_tp_blocks_match_the_forward(
        dense_run):
    """A prefill chunk of 8 and one decode step of ``forward_cached`` over
    the (2, 2, 2) blocks, on each rank's rows, equal the no-mesh forward
    within 1e-5."""
    *_, res, _ = dense_run
    for r in res.values():
        assert max(r["forward"]) <= 1e-5, r["forward"]


# ---------------------------------------------------------------------------
# no mesh: the dispatch groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_dispatch_groups_match_the_reference(groups):
    """``moe.apply`` under ``moe_dispatch_groups(g)`` equals the
    reference's at capacity factor 1.0 (choices drop in the global
    dispatch), output and aux loss, for 2 × 32 tokens."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import flags as jflags
    from repro.models import moe as jmoe
    from repro_torch.configs import get_config
    from repro_torch.models import flags, moe

    jcfg = dataclasses.replace(jax_config("mixtral-8x22b").reduced(),
                               capacity_factor=1.0)
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                              capacity_factor=1.0)
    jp = jmoe.init(jax.random.PRNGKey(1), jcfg)
    p = {k: ({"w": torch.from_numpy(np.array(v["w"]))}
             if isinstance(v, dict) else torch.from_numpy(np.array(v)))
         for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((2, 32, 64)).astype(
        np.float32)
    with jflags.moe_dispatch_groups(groups):
        jout, jaux = jmoe.apply(jp, jnp.asarray(x), jcfg)
    with flags.moe_dispatch_groups(groups):
        out, aux = moe.apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    # Choices drop in groups of 64 and 32 tokens; 16 never do (the floor).
    _, gate_idx, _ = moe.route(p, torch.from_numpy(x).reshape(64, -1), cfg)
    tl = 64 // groups
    dropped = sum(int((~moe.placement(gate_idx[i * tl:(i + 1) * tl], cfg,
                                      moe.capacity(tl, cfg))[1]).sum())
                  for i in range(groups))
    assert (dropped > 0) == (groups < 4)


def test_moe_dispatch_groups_that_do_not_fit_raise():
    """The reference falls back to global dispatch when the groups do
    not divide the call's tokens; the port raises."""
    from repro_torch.configs import get_config
    from repro_torch.models import flags, lm, moe

    cfg = get_config("mixtral-8x22b").reduced()
    p = lm.init_params(0, cfg, device="cpu")["layers"][0]["moe"]
    with flags.moe_dispatch_groups(3), pytest.raises(ValueError,
                                                     match="groups"):
        moe.apply(p, torch.zeros(2, 4, cfg.d_model), cfg)

