"""The port's multi-rank paths on the CPU: gloo process groups of up to
four spawned ranks, held against the JAX package.

Harness: one ``torch.multiprocessing`` spawn per scenario (each making
several checks), its rendezvous a ``file://`` path under the test's
``tmp_path`` (so xdist workers never share a port), every rank's
outcome sent back to the parent, which asserts; each spawn has a
timeout, and every collective one of 60 s (``init_distributed``).  The
worker functions import nothing of JAX (the children never load it);
the JAX references are computed in the parent.

Scenarios:
* algorithms and elastic — the mesh algorithms on (4,) under
  ``StaticCoreChunk(cores=4)`` and ``AdaptiveCoreChunk`` against
  ``repro.algorithms`` on the same inputs (the tolerances of
  ``test_torch_algorithms.py``), every rank's cores the same;
  ``surviving_mesh`` 4 → 2, ``reshard`` blocks, ``elastic_plan`` against
  the reference's decision for one profile and hardware spec;
* serving — the reduced qwen3-0.6b (f32) on meshes (2, 2), (1, 2) and
  (2, 1), depths 1 and 4, contiguous and paged, with the reference's
  request spec (``tests/test_multidevice.py``): tokens equal to the JAX
  package's single-device ``ServeScheduler``, the same on every rank,
  ``serve_mesh_batch`` entries keyed ``mesh=DxM`` with ``batch_width ==
  cores · n_replicas``, the same decisions in every rank's trace; the
  reduced mixtral-8x22b (MoE, its experts' hidden dim split) served on
  (1, 2) giving the JAX package's single-device tokens;
* compressed data parallelism — two steps of the reduced qwen3 on (4,)
  against the reference's ``make_compressed_dp_train_step`` (run in a
  subprocess with 4 forced host devices): parameters within 2e-5 and
  error-feedback buffers within one int8 quantum of their leaf (a
  rounding tie may go the other way in a different summation order).
"""
import os
import pickle
import queue
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 240


def _worker(rank, world, init, scenario, args, out):
    try:
        from repro_torch.launch import mesh as mesh_lib

        mesh_lib.init_distributed("cpu", init_method=init, rank=rank,
                                  world_size=world, timeout_s=60)
        torch.set_num_threads(1)
        result = globals()[scenario](rank, *args)
        out.put((rank, "ok", pickle.dumps(result)))
    except Exception:                        # reported to the parent
        out.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(tmp_path, scenario: str, world: int, *args) -> dict:
    """Run ``scenario(rank, *args)`` on ``world`` gloo ranks; returns
    {rank: result}.  Raises with every failing rank's traceback."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = f"file://{tmp_path}/rendezvous-{scenario}"
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
# scenario: the mesh algorithms and elastic resharding
# ---------------------------------------------------------------------------

# The kernel wrappers of kernels 4-7 and the mesh functions of detail
# that the entries' mesh branches call them through.
_MESH_FNS = ("mesh_reduce", "mesh_scan", "mesh_map_with_left_halo",
             "mesh_map")
_KERNEL_WRAPPERS = ("reduce_sum", "inclusive_scan", "adjacent_difference",
                    "artificial_work")


def _spy_mesh_kernels() -> dict:
    """Count each ``kernels.ops`` wrapper call of kernels 4-7 made inside
    a ``detail.mesh_*`` function, keyed "mesh_fn:wrapper" (this spawned
    rank's modules are patched for good)."""
    from repro_torch.algorithms import detail
    from repro_torch.kernels import ops

    calls, inside = {}, []

    def wrap_mesh(name, fn):
        def spy(*a, **k):
            inside.append(name)
            try:
                return fn(*a, **k)
            finally:
                inside.pop()
        return spy

    def wrap_op(name, fn):
        def spy(*a, **k):
            if inside:
                key = f"{inside[-1]}:{name}"
                calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        return spy

    for name in _MESH_FNS:
        setattr(detail, name, wrap_mesh(name, getattr(detail, name)))
    for name in _KERNEL_WRAPPERS:
        setattr(ops, name, wrap_op(name, getattr(ops, name)))
    return calls


def algorithms_and_elastic(rank, x_np, prof, hw):
    from repro_torch import algorithms as alg
    from repro_torch.core import (AdaptiveCoreChunk, MeshExecutor,
                                  StaticCoreChunk, par)
    from repro_torch.core.cost_model import WorkloadProfile
    from repro_torch.core.hardware import HardwareSpec
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import elastic_plan, reshard, surviving_mesh

    mesh = mesh_lib.make_mesh((4,), ("data",))
    mexec = MeshExecutor(mesh)
    x = torch.from_numpy(x_np)
    out = {"kernel_calls": {}}
    calls = _spy_mesh_kernels()
    for tag, pol in (
            ("static", par.on(mexec).with_(StaticCoreChunk(cores=4))),
            ("acc", par.on(mexec).with_(AdaptiveCoreChunk()))):
        calls.clear()
        r = {
            "transform": alg.transform(pol, x, lambda c: c * 3 - 1),
            "transform2": alg.transform(pol, x, lambda a, b: a * b + a,
                                        x.flip(0)),
            "for_each": alg.for_each(pol, x, lambda c: c - 3),
            "reduce": alg.reduce(pol, x),
            "reduce_max": alg.reduce(pol, x, torch.maximum),
            "count_if": alg.count_if(pol, x, lambda c: c > 0),
            "inclusive_scan": alg.inclusive_scan(pol, x),
            "exclusive_scan": alg.exclusive_scan(pol, x, 0.0),
            "adjacent_difference": alg.adjacent_difference(pol, x),
            "stencil3": alg.stencil3(pol, x),
            "artificial_work": alg.artificial_work(pol, x, iters=8),
        }
        out[tag] = {k: np.asarray(v) for k, v in r.items()}
        out["kernel_calls"][tag] = dict(calls)
        pol_acc = pol.params if tag == "acc" else None
        if pol_acc is not None:
            out["acc_cores"] = [e.decision.cores for e in
                                pol_acc.model.trace.entries()]
    # elastic: lose half the ranks, re-mesh over the first two
    m4 = surviving_mesh(4)
    m2 = surviving_mesh(2)
    spec = HardwareSpec(**hw)
    d4 = elastic_plan(WorkloadProfile(**prof), 10 ** 6, m4,
                      AdaptiveCoreChunk(hardware=spec))
    d2 = elastic_plan(WorkloadProfile(**prof), 10 ** 6, m2,
                      AdaptiveCoreChunk(hardware=spec))
    w = torch.arange(32.0).reshape(8, 4)
    blk = reshard({"w": w}, m2, {"w": ("data", None)})["w"] \
        if m2.contains else None
    out["elastic"] = {
        "m4": m4.shape, "m2": m2.shape, "d4": d4.n_cores, "d2": d2.n_cores,
        "d4_chunk": d4.chunk_elems, "d2_chunk": d2.chunk_elems,
        "block": None if blk is None else blk.numpy(),
        "m2_coord": m2.coord("data") if m2.contains else None}
    return out


@pytest.fixture(scope="module")
def algorithms_run(tmp_path_factory):
    import dataclasses

    from repro_torch.core.hardware import H100_SXM

    x = np.random.RandomState(1).randn(1003).astype(np.float32)
    prof = {"flops_per_elem": 1e6, "bytes_per_elem": 100}
    hw = dataclasses.asdict(H100_SXM)
    res = spawn(tmp_path_factory.mktemp("alg"), "algorithms_and_elastic", 4,
                x, prof, hw)
    return x, prof, hw, res


def _jax_algorithms(x):
    import jax.numpy as jnp

    from repro import algorithms as jalg
    from repro.core import seq as jseq

    jx = jnp.asarray(x)
    return {
        "transform": jalg.transform(jseq, jx, lambda c: c * 3 - 1),
        "transform2": jalg.transform(jseq, jx, lambda a, b: a * b + a,
                                     jx[::-1]),
        "for_each": jalg.for_each(jseq, jx, lambda c: c - 3),
        "reduce": jalg.reduce(jseq, jx),
        "reduce_max": jalg.reduce(jseq, jx, jnp.maximum),
        "count_if": jalg.count_if(jseq, jx, lambda c: c > 0),
        "inclusive_scan": jalg.inclusive_scan(jseq, jx),
        "exclusive_scan": jalg.exclusive_scan(jseq, jx, 0.0),
        "adjacent_difference": jalg.adjacent_difference(jseq, jx),
        "stencil3": jalg.stencil3(jseq, jx),
        "artificial_work": jalg.artificial_work(jseq, jx, iters=8),
    }


@pytest.mark.parametrize("tag", ["static", "acc"])
def test_mesh_algorithms_match_reference(algorithms_run, tag):
    """Every algorithm's mesh path on (4,) against the JAX package on the
    same input, on every rank."""
    x, _, _, res = algorithms_run
    ref = {k: np.asarray(v) for k, v in _jax_algorithms(x).items()}
    run = np.cumsum(np.abs(x.astype(np.float64)))
    total = float(np.abs(x.astype(np.float64)).sum())
    for rank in range(4):
        got = res[rank][tag]
        for name in ("transform", "transform2", "for_each",
                     "adjacent_difference", "artificial_work"):
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got["stencil3"], ref["stencil3"],
                                   rtol=1e-5, atol=1e-5)
        assert abs(float(got["reduce"]) - float(ref["reduce"])) \
            <= 1e-6 * total + 1e-6
        assert float(got["reduce_max"]) == float(ref["reduce_max"])
        assert int(got["count_if"]) == int(ref["count_if"])
        assert np.all(np.abs(got["inclusive_scan"] - ref["inclusive_scan"])
                      <= 1e-6 * run + 1e-5)
        exc = got["exclusive_scan"]
        assert exc.shape == x.shape and float(exc[0]) == 0.0
        assert np.all(np.abs(exc[1:] - ref["exclusive_scan"][1:])
                      <= 1e-6 * run[:-1] + 1e-5)
        for name in got:
            np.testing.assert_array_equal(got[name], res[0][tag][name])


def test_mesh_branches_call_the_kernel_wrappers(algorithms_run):
    """Under ``StaticCoreChunk(cores=4)`` each entry's mesh branch runs
    its rank's block through the ``kernels.ops`` wrapper of its kernel
    (kernels 4-7, the card's kernels on a CUDA tensor): reduce and both
    scans through reduce_sum, the scans through inclusive_scan,
    adjacent_difference and artificial_work through theirs, on every
    rank."""
    *_, res = algorithms_run
    need = ("mesh_reduce:reduce_sum", "mesh_scan:inclusive_scan",
            "mesh_scan:reduce_sum",
            "mesh_map_with_left_halo:adjacent_difference",
            "mesh_map:artificial_work")
    for rank in range(4):
        calls = res[rank]["kernel_calls"]["static"]
        for key in need:
            assert calls.get(key, 0) >= 1, (rank, key, calls)
        # reduce (add) and both scans, one block each
        assert calls["mesh_scan:inclusive_scan"] == 2, (rank, calls)
        assert calls["mesh_reduce:reduce_sum"] == 1, (rank, calls)


def test_mesh_acc_decisions_agree_on_every_rank(algorithms_run):
    """The acc decisions of a mesh run are rank 0's, broadcast: every
    rank's trace holds the same cores, in the same order."""
    *_, res = algorithms_run
    cores = [res[r]["acc_cores"] for r in range(4)]
    assert cores[0] and all(c == cores[0] for c in cores)
    assert all(1 <= c <= 4 for c in cores[0])


def test_elastic_matches_reference(algorithms_run):
    """``surviving_mesh`` 4 → 2 gives the reference's shapes, ``reshard``
    gives each rank its slice, ``elastic_plan`` the reference's decision
    for the same profile and hardware spec."""
    from repro.core.acc import AdaptiveCoreChunk as JAcc
    from repro.core.adaptive import adaptive as jadaptive
    from repro.core.cost_model import WorkloadProfile as JProfile
    from repro.core.executor import MeshExecutor as JMeshExecutor
    from repro.core.hardware import HardwareSpec as JHardware

    _, prof, hw, res = algorithms_run

    class Stub:
        def __init__(self, data):
            self.shape = {"data": data, "model": 1}

    for n, key in ((4, "d4"), (2, "d2")):
        jm = jadaptive(JMeshExecutor(Stub(n), data_axes=("data",)),
                       JAcc(hardware=JHardware(**hw)))
        jd = jm.params.decide_for_profile(jm, JProfile(**prof), 10 ** 6)
        for rank in range(4):
            e = res[rank]["elastic"]
            assert e[key] == jd.n_cores
            assert e[key + "_chunk"] == jd.chunk_elems
    full = np.arange(32.0).reshape(8, 4)
    for rank in range(4):
        e = res[rank]["elastic"]
        assert e["m4"] == {"data": 4, "model": 1}
        assert e["m2"] == {"data": 2, "model": 1}
        if rank < 2:
            assert e["m2_coord"] == rank
            np.testing.assert_array_equal(e["block"],
                                          full[rank * 4:(rank + 1) * 4])
        else:
            assert e["block"] is None


# ---------------------------------------------------------------------------
# scenario: mesh serving
# ---------------------------------------------------------------------------

SERVE_SPEC = [(14, 9), (9, 3), (6, 7)]     # (prompt_len, new_tokens)
SERVE_MESHES = [(2, 2), (1, 2), (2, 1)]
SERVE_RUNS = [(depth, paged) for depth in (1, 4) for paged in (False, True)]


# The MoE run on (1, 2): mixtral's ring at prefill chunks of 1, where
# the reference's ring is exact (tests/test_torch_moe.py).
MOE_SERVE = dict(n_slots=2, max_len=64, dispatch_depth=2, chunk_buckets=(1,))


def _moe_trace():
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 256, n), 6) for n in (20, 33, 9, 40)]


def mesh_serving(rank, arrays, tokens, moe_arrays):
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core.acc import AdaptiveCoreChunk, StaticCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.launch.mesh import make_serve_mesh, n_data_replicas
    from repro_torch.serve import ServeScheduler

    cfg = get_config("qwen3-0.6b").reduced()
    params = bridge.from_reference(arrays, cfg, device="cpu")
    out = {}
    for shape in SERVE_MESHES:
        mesh = make_serve_mesh(*shape)
        if not mesh.contains:
            continue
        assert n_data_replicas(mesh) == shape[0]
        for depth, paged in SERVE_RUNS:
            sched = ServeScheduler(
                cfg, params, n_slots=4, max_len=48,
                executor=adaptive(SequentialExecutor(), AdaptiveCoreChunk()),
                dispatch_depth=depth, mesh=mesh, paged=paged, device="cpu")
            sched.warmup()
            rids = [sched.submit(tokens[i][:p], max_new_tokens=n)
                    for i, (p, n) in enumerate(SERVE_SPEC)]
            outs = sched.run_until_idle()
            assert sched.pool.allocations == 1
            trace = sched.decision_model().trace
            out[shape, depth, paged] = {
                "tokens": [outs[r] for r in rids],
                "mesh_batch": [(e.decision.key.hardware, e.decision.cores,
                                e.decision.batch_width)
                               for e in trace.entries("serve_mesh_batch")],
                "decisions": [(e.decision.key.kind, e.decision.cores,
                               e.decision.chunk, e.decision.batch_width)
                              for e in trace.entries()],
                "page_size": [e.decision.chunk for e in
                              trace.entries("serve_page_size")]}
    moe_tokens = None
    mesh = make_serve_mesh(1, 2)
    if mesh.contains:
        mcfg = get_config("mixtral-8x22b").reduced()
        sched = ServeScheduler(
            mcfg, bridge.from_reference(moe_arrays, mcfg, device="cpu"),
            acc=StaticCoreChunk(cores=2), mesh=mesh, device="cpu",
            **MOE_SERVE)
        assert sched.tp.moe and sched.tp.size == 2
        rids = [sched.submit(p, m) for p, m in _moe_trace()]
        outs = sched.run_until_idle()
        moe_tokens = [outs[r] for r in rids]
    return {"runs": out, "moe": moe_tokens}


@pytest.fixture(scope="module")
def serving_run(tmp_path_factory):
    import jax

    from repro.configs import get_config as jax_config
    from repro.data import make_batch as jmake_batch
    from repro.models import lm as jlm

    jcfg = jax_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    arrays = jax.tree.map(np.asarray, jparams)
    tokens = np.asarray(jmake_batch(jcfg, 3, 14, kind="prefill",
                                    seed=11)["tokens"])
    mcfg = jax_config("mixtral-8x22b").reduced()
    mparams = jlm.init_params(jax.random.PRNGKey(0), mcfg)
    res = spawn(tmp_path_factory.mktemp("serve"), "mesh_serving", 4,
                arrays, tokens, jax.tree.map(np.asarray, mparams))
    return jcfg, jparams, tokens, res, (mcfg, mparams)


@pytest.fixture(scope="module")
def jax_serve_tokens(serving_run):
    """The JAX package's single-device scheduler tokens, per depth."""
    from repro.core.acc import AdaptiveCoreChunk as JAcc
    from repro.core.adaptive import adaptive as jadaptive
    from repro.core.executor import SequentialExecutor as JSeq
    from repro.serve import ServeScheduler as JScheduler

    jcfg, jparams, tokens, *_ = serving_run
    ref = {}
    for depth in (1, 4):
        sched = JScheduler(jcfg, jparams, n_slots=2, max_len=48,
                           executor=jadaptive(JSeq(), JAcc()),
                           dispatch_depth=depth)
        sched.warmup()
        rids = [sched.submit(tokens[i][:p], max_new_tokens=n)
                for i, (p, n) in enumerate(SERVE_SPEC)]
        outs = sched.run_until_idle()
        ref[depth] = [outs[r] for r in rids]
    return ref


@pytest.mark.parametrize("depth,paged", SERVE_RUNS)
@pytest.mark.parametrize("shape", SERVE_MESHES)
def test_mesh_serving_matches_jax_single_device(serving_run, jax_serve_tokens,
                                                shape, depth, paged):
    """Tokens on the mesh equal the JAX package's single-device
    scheduler's, on every rank of the mesh; every rank's trace holds the
    same decisions."""
    res = serving_run[3]
    ranks = range(shape[0] * shape[1])
    runs = [res[r]["runs"][shape, depth, paged] for r in ranks]
    assert runs[0]["tokens"] == jax_serve_tokens[depth]
    for run in runs[1:]:
        assert run["tokens"] == runs[0]["tokens"]
        assert run["decisions"] == runs[0]["decisions"]
    if paged:
        assert runs[0]["page_size"], "paged mesh run made no page decision"


@pytest.mark.parametrize("shape", SERVE_MESHES)
def test_mesh_batch_decisions_carry_the_mesh(serving_run, shape):
    """``serve_mesh_batch`` entries key the mesh shape into the hardware
    field and cap the lanes at ``cores * n_replicas``."""
    res = serving_run[3]
    desc = f"mesh={shape[0]}x{shape[1]}"
    for depth, paged in SERVE_RUNS:
        entries = res[0]["runs"][shape, depth, paged]["mesh_batch"]
        assert entries, "mesh run made no serve_mesh_batch decisions"
        for hardware, cores, width in entries:
            assert desc in hardware
            assert width == cores * shape[0]


def test_moe_refused_on_a_model_extent_of_two(serving_run):
    """The reduced mixtral-8x22b served on (1, 2), its experts' hidden dim
    split over 'model', gives the JAX package's single-device tokens on
    both ranks; the ranks outside the mesh serve nothing."""
    from repro.core.acc import StaticCoreChunk as JStatic
    from repro.serve import ServeScheduler as JScheduler

    res = serving_run[3]
    mcfg, mparams = serving_run[4]
    sched = JScheduler(mcfg, mparams, acc=JStatic(cores=2), **MOE_SERVE)
    rids = [sched.submit(p, m) for p, m in _moe_trace()]
    outs = sched.run_until_idle()
    ref = [outs[r] for r in rids]
    assert [len(o) for o in ref] == [m for _, m in _moe_trace()]
    for rank in (0, 1):
        assert res[rank]["moe"] == ref
    assert res[2]["moe"] is None and res[3]["moe"] is None


# ---------------------------------------------------------------------------
# scenario: int8-compressed data parallelism
# ---------------------------------------------------------------------------

DP_STEPS = 2
DP_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle, sys
import numpy as np, jax
from repro.configs import get_config
from repro.models import init_params
from repro.optim import AdamWConfig, adamw
from repro.train import make_compressed_dp_train_step, init_error_feedback
from repro.data import make_batch
from repro.launch.mesh import make_mesh

cfg = get_config("qwen3-0.6b").reduced()
params = init_params(jax.random.PRNGKey(0), cfg)
opt = adamw.init_state(params)
mesh = make_mesh((4,), ("data",))
batch = make_batch(cfg, 8, 32, kind="train", seed=0)
step = make_compressed_dp_train_step(cfg, AdamWConfig(lr=1e-3), mesh)
ef = init_error_feedback(params, 4)
p, o = params, opt
losses = []
for _ in range(STEPS):
    p, o, ef, m = step(p, o, ef, batch)
    losses.append(float(m["loss"]))
with open(sys.argv[1] if len(sys.argv) > 1 else OUT, "wb") as f:
    pickle.dump({"init": jax.tree.map(np.asarray, params),
                 "batch": {k: np.asarray(v) for k, v in batch.items()},
                 "params": jax.tree.map(np.asarray, p),
                 "ef": jax.tree.map(np.asarray, ef), "losses": losses}, f)
print("DP_REFERENCE_OK")
"""


def compressed_dp(rank, arrays, batch_np, steps):
    from repro_torch import bridge, tree
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.sharding import local_tree
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import (init_error_feedback,
                                   make_compressed_dp_train_step)

    cfg = get_config("qwen3-0.6b").reduced()
    mesh = mesh_lib.make_mesh((4,), ("data",))
    params = bridge.from_reference(arrays, cfg, device="cpu",
                                   dtype=torch.float32)
    opt = adamw.init_state(params)
    ef = local_tree(init_error_feedback(params, 4), ("data",), mesh)
    rows = slice(2 * rank, 2 * rank + 2)
    batch = {k: torch.from_numpy(v[rows]).long() for k, v in batch_np.items()}
    step = make_compressed_dp_train_step(cfg, AdamWConfig(lr=1e-3), mesh)
    losses = []
    for _ in range(steps):
        params, opt, ef, m = step(params, opt, ef, batch)
        losses.append(float(m["loss"]))
    return {"params": [t.numpy() for t in tree.leaves(params)],
            "ef": [t[0].numpy() for t in tree.leaves(ef)],
            "losses": losses}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The reference in a subprocess (4 forced host devices, through the
    ``subproc`` harness's ``run_with_devices``), on a thread while the
    port's 4 ranks run on the same initial parameters and batch (made
    here the way the subprocess makes them)."""
    import sys
    import threading

    import jax

    from repro.configs import get_config as jax_config
    from repro.data import make_batch as jmake_batch
    from repro.models import lm as jlm

    sys.path.insert(0, os.path.dirname(__file__))
    from conftest import run_with_devices

    jcfg = jax_config("qwen3-0.6b").reduced()
    init = jax.tree.map(np.asarray,
                        jlm.init_params(jax.random.PRNGKey(0), jcfg))
    batch = {k: np.asarray(v) for k, v in
             jmake_batch(jcfg, 8, 32, kind="train", seed=0).items()}
    tmp = tmp_path_factory.mktemp("dp")
    out = tmp / "reference.pkl"
    code = DP_REFERENCE.replace("STEPS", str(DP_STEPS)).replace(
        "OUT", repr(str(out)))
    box = {}
    ref_thread = threading.Thread(
        target=lambda: box.setdefault("r", run_with_devices(code, 4)))
    ref_thread.start()
    res = spawn(tmp, "compressed_dp", 4, init, batch, DP_STEPS)
    ref_thread.join()
    r = box["r"]
    assert r.returncode == 0 and "DP_REFERENCE_OK" in r.stdout, \
        r.stderr[-3000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    for a, b in zip(jax.tree.leaves(ref["init"]), jax.tree.leaves(init),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    return ref, res


def _port_layout(arrays):
    from repro_torch import bridge, tree
    from repro_torch.configs import get_config

    return [t.numpy() for t in tree.leaves(bridge.from_reference(
        arrays, get_config("qwen3-0.6b").reduced(), device="cpu",
        dtype=torch.float32))]


def test_compressed_dp_params_match_reference(dp_run):
    """After two int8-compressed steps every rank holds the same
    parameters, within 2e-5 of the reference's (AdamW moves each by
    about lr = 1e-3 a step; a quantisation tie resolved the other way
    moves one element's synced gradient by one quantum)."""
    ref, res = dp_run
    want = _port_layout(ref["params"])
    for rank in range(4):
        got = res[rank]["params"]
        assert len(got) == len(want)
        for g, w, g0 in zip(got, want, res[0]["params"], strict=True):
            np.testing.assert_array_equal(g, g0)
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)
        np.testing.assert_allclose(res[rank]["losses"], ref["losses"],
                                   rtol=1e-5)


def test_compressed_dp_error_feedback_matches_reference(dp_run):
    """Each rank's error-feedback buffer against the reference device's:
    within one int8 quantum (max |g| / 127) of its leaf, the size of a
    rounding tie resolved the other way; nearly every element closer
    than 1e-6."""
    import jax

    ref, res = dp_run
    for rank in range(4):
        want = _port_layout(jax.tree.map(lambda e, r=rank: e[r], ref["ef"]))
        close = total = 0
        for g, w in zip(res[rank]["ef"], want, strict=True):
            quantum = 2.0 * max(float(np.abs(w).max()), 1e-12) + 1e-7
            assert np.all(np.abs(g - w) <= quantum)
            close += int(np.sum(np.abs(g - w) <= 1e-6))
            total += w.size
        assert close >= 0.999 * total, (rank, close, total)


# ---------------------------------------------------------------------------
# no process group: the package surface and the mesh launch audit
# ---------------------------------------------------------------------------

# Reference exports the port leaves out on purpose (ROADMAP.md A.12):
# the TPU preset; the kernel functions, whose names are the port's kernel
# modules.
DELIBERATE = {
    "core": {"TPU_V5E"},
    "kernels": {"adjacent_difference", "artificial_work", "flash_attention",
                "inclusive_scan", "reduce_sum", "ref", "rmsnorm"},
}


@pytest.mark.parametrize("package", [
    "core", "serve", "models", "train", "runtime", "kernels", "launch",
    "algorithms", "optim", "data", "configs", "checkpoint", "analysis"])
def test_package_exports_match_reference(package):
    """Every name of the reference package's ``__all__`` is in the
    port's, but for the deliberate differences; every port name
    resolves."""
    import importlib

    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = set(getattr(ref, "__all__", ())) - \
        set(getattr(port, "__all__", ()))
    assert missing <= DELIBERATE.get(package, set()), sorted(missing)
    for name in getattr(port, "__all__", ()):
        getattr(port, name)


def test_launch_audit_counts_a_mesh_steps_collectives():
    """One card's policy fails an NCCL kernel; a mesh step's policy
    counts it, and still fails a host copy above the threshold and a
    window with no graph launch."""
    from repro_torch.analysis import launch_audit as la

    events = [
        {"name": "cudaGraphLaunch", "cat": "cuda_runtime"},
        {"name": "ncclDevKernel_AllReduce_Sum_bf16_RING_LL", "cat": "kernel"},
        {"name": "void norm_rows<8>", "cat": "kernel"},
        {"name": "Memcpy HtoD (Pageable -> Device)", "cat": "gpu_memcpy",
         "args": {"bytes": 64}}]
    assert not la.audit_events(events).ok
    mesh = la.audit_events(events, la.AuditPolicy(small_copy_max=64,
                                                  mesh=True))
    assert mesh.ok and mesh.kernels["nccl"] == 1
    assert mesh.graph_launches == 1
    big = events + [{"name": "Memcpy DtoH (Device -> Pinned)",
                     "cat": "gpu_memcpy", "args": {"bytes": 4096}}]
    assert not la.audit_events(big, la.AuditPolicy(mesh=True)).ok
    assert not la.audit_events(events[1:], la.AuditPolicy(mesh=True)).ok


def test_meshes_need_a_process_group_and_a_card_unless_asked_for_the_cpu():
    """``make_mesh`` raises with no process group; ``init_distributed``
    asks for the card by default and raises without one (no gloo
    fallback); a scheduler or pool takes only a ``launch.mesh.Mesh``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve import SlotKVCachePool

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh_lib.make_mesh((1,), ("data",))
    with pytest.raises(TypeError, match="make_serve_mesh"):
        SlotKVCachePool(get_config("qwen3-0.6b").reduced(), 2, 16,
                        mesh=mesh_lib.make_host_mesh("cpu"), device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_lib.init_distributed()
    assert not dist.is_initialized()
