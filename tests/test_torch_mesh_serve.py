"""Mesh serving's configurations beyond the plain tick loop, on gloo CPU
ranks, held against the JAX package on one device.

Harness: ``test_torch_fsdp.spawn`` (one ``torch.multiprocessing`` spawn
of four gloo ranks, a ``file://`` rendezvous under ``tmp_path``, the
children importing nothing of JAX; the references computed in the
parent).  One spawn runs every scenario, each mesh shape built once:

* speculation over data replicas — the reduced qwen3-0.6b with the
  prompts and budgets of the reference's ``tests/test_serve_spec.py``
  mesh test, ``speculate`` 2, 4 and "auto", on (2, 1) and (2, 2),
  through both pools: the JAX package's single-device greedy tokens on
  every rank, verifies drained, ``serve_spec_depth`` in every rank's
  trace;
* a fork across replicas — the reduced zamba2-1.2b's paged pool on
  (2, 1) and (2, 2): slot 0 (replica 0) prefilled and forked into slot
  1 (replica 1), the forked state rows bit-equal to the source's, and
  both slots' fused decode the tokens of the JAX pool's fork;
* ``decode_cost_analysis`` on (1, 2) and (2, 2): the reference's keys on
  every rank, the all-reduce bytes those of the plan's row-parallel
  products, and on (1, 1) the count off a mesh with no collective bytes;
* the front end on (2, 1): a seeded ``--frontend`` trace
  (``launch/serve.serve_frontend``) on both ranks, the same records and
  tokens on each, the JAX scheduler's tokens for every completed
  request;
* the paged "head_dim" pool over 2 data replicas — the 6-head reduced
  qwen1.5 on (2, 2) with the rule forced, with and without speculation:
  each replica's rows of D / 2 dims exchanged over 'data', the JAX
  scheduler's tokens on every rank;
* a cross-attention arch on (1, 2): the reduced llama-3.2-vision-11b
  through the CLI's ``serve_cross_attention`` with the JAX package's
  weights (the JAX engine's lock-step tokens), then through ``main``
  with ``--mesh 1,2`` (its tokens those of the CLI off a mesh).
"""
import argparse
import asyncio
import concurrent.futures
import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config

from test_torch_fsdp import spawn

QWEN3, ZAMBA, VISION = "qwen3-0.6b", "zamba2-1.2b", "llama-3.2-vision-11b"
QWEN15 = "qwen1.5-32b"
SPEC_MESHES = [(2, 1), (2, 2)]
SPECS = [2, 4, "auto"]
BUDGETS = (9, 3, 7)
FORK_MESHES = [(2, 1), (2, 2)]
FORK_PROMPT, FORK_NEW = 11, 6
COST_MESHES = [(1, 2), (2, 2)]
IDLE_S = 0.5
CLI = ["--arch", VISION, "--reduced", "--device", "cpu", "--requests", "2",
       "--prompt-len", "8", "--new-tokens", "4", "--no-cal-cache"]


def _spec_prompts(vocab: int) -> list:
    """The reference's mesh-speculation prompts: a repeated motif, noise,
    a short motif tail."""
    rng = np.random.RandomState(0)
    motif = [7, 3, 11, 5]
    return [(motif * 5)[:14],
            [int(t) for t in rng.randint(0, vocab, 9)],
            (motif * 3)[:6]]


def _fork_prompt() -> np.ndarray:
    return np.random.default_rng(3).integers(0, 256, FORK_PROMPT)


def _frontend_args() -> argparse.Namespace:
    return argparse.Namespace(requests=6, rate_rps=40.0, prompt_len=12,
                              new_tokens=6, seed=2, max_queue=16)


def _vision_args() -> argparse.Namespace:
    return argparse.Namespace(requests=2, prompt_len=8, new_tokens=4,
                              seed=0)


# ---------------------------------------------------------------------------
# the children's side
# ---------------------------------------------------------------------------

def _spec(meshes, params, cfg) -> dict:
    from repro_torch.core.acc import AdaptiveCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.serve import ServeScheduler

    out = {}
    for shape in SPEC_MESHES:
        mesh = meshes[shape]
        if not mesh.contains:
            continue
        for paged in (False, True):
            for spec in SPECS:
                acc = AdaptiveCoreChunk(cache=CalibrationCache())
                sched = ServeScheduler(
                    cfg, params, n_slots=4, max_len=64,
                    executor=adaptive(SequentialExecutor(), acc),
                    dispatch_depth=4, mesh=mesh, speculate=spec,
                    paged=paged, page_size=8, device="cpu")
                sched.warmup()
                rids = [sched.submit(p, max_new_tokens=n) for p, n in
                        zip(_spec_prompts(cfg.vocab_size), BUDGETS,
                            strict=True)]
                outs = sched.run_until_idle()
                out[shape, paged, spec] = {
                    "tokens": [outs[r] for r in rids],
                    "stats": sched.spec_stats(),
                    "decided": len(sched.decision_model().trace.entries(
                        "serve_spec_depth")),
                    "allocations": sched.pool.allocations}
    return out


def _fork(meshes, params, cfg) -> dict:
    from repro_torch.collectives import all_reduce
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.models import flags, lm
    from repro_torch.serve import ServeScheduler

    out = {}
    prompt = torch.from_numpy(_fork_prompt()).long()[None]
    for shape in FORK_MESHES:
        mesh = meshes[shape]
        if not mesh.contains:
            continue
        sched = ServeScheduler(cfg, params, n_slots=2, max_len=32,
                               acc=StaticCoreChunk(cores=2), mesh=mesh,
                               paged=True, page_size=8, dispatch_depth=4,
                               device="cpu")
        pool = sched.pool
        src = pool.acquire("a")
        with flags.tensor_parallel(sched.tp):
            pool.ensure_writable(src, 0, FORK_PROMPT)
            pt = pool.page_table_array()
            first = torch.zeros(1, dtype=torch.long)
            if pool.holds(src):
                logits = sched._prefill_forward(src, prompt, 0,
                                                FORK_PROMPT - 1,
                                                pt[src:src + 1])
                first[0] = torch.argmax(logits[0, 0])
            sched._exchange([(src, 0, FORK_PROMPT)])
            all_reduce(first, mesh.groups["data"])
            pool.positions[src] = FORK_PROMPT
            dst = pool.fork(src, "b")
            rows = [sched._gather_lanes(t)
                    for kind, c in zip(pool.kinds, pool.caches, strict=True)
                    if kind not in lm.ATTN_KINDS for t in c.values()]
            for s in (src, dst):
                pool.ensure_writable(s, FORK_PROMPT, FORK_PROMPT + FORK_NEW)
            lanes = pool.lanes
            toks = first.expand(pool.n_slots).contiguous()
            _, buf, _ = sched._fused_step()(
                sched.params, pool.caches, pool.page_table_array()[lanes],
                toks[lanes], pool.positions_array()[lanes],
                [FORK_NEW] * (lanes.stop - lanes.start))
            buf = sched._gather_lanes(buf, dim=1)
        out[shape] = {
            "slots": (src, dst), "first": int(first[0]),
            "equal_rows": all(torch.equal(r[src], r[dst]) for r in rows),
            "nonzero_rows": all(bool(r[src].abs().sum() > 0) for r in rows),
            "tokens": buf[:FORK_NEW].t().tolist()}
    return out


def _costs(meshes, params, cfg) -> dict:
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.serve import ServeScheduler

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 14)]

    def count(mesh):
        sched = ServeScheduler(cfg, params, n_slots=2, max_len=64,
                               acc=StaticCoreChunk(cores=2),
                               dispatch_depth=2, mesh=mesh, device="cpu")
        for p in prompts:
            sched.submit(p, max_new_tokens=8)
        for _ in range(3):
            sched.tick()
        report = sched.decode_cost_analysis()
        sched.run_until_idle()
        return report

    out = {}
    for shape in COST_MESHES + [(1, 1)]:
        if meshes[shape].contains:
            out[shape] = count(meshes[shape])
    if meshes[(1, 1)].contains:
        out[None] = count(None)
    return out


def _frontend(meshes, params, cfg) -> dict:
    from repro_torch.core.acc import AdaptiveCoreChunk
    from repro_torch.core.adaptive import adaptive
    from repro_torch.core.calibration import CalibrationCache
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import ServeScheduler

    mesh = meshes[(2, 1)]
    if not mesh.contains:
        return {}
    acc = AdaptiveCoreChunk(cache=CalibrationCache())
    sched = ServeScheduler(cfg, params, n_slots=2, max_len=64,
                           executor=adaptive(SequentialExecutor(), acc),
                           dispatch_depth="auto", admission="adaptive",
                           mesh=mesh, device="cpu")
    sched.warmup()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        fe = launch_serve.serve_frontend(sched, _frontend_args())
    reqs = sched.requests
    return {"records": {rid: (r.status, r.tokens, r.submitted_at)
                        for rid, r in fe.records.items()},
            "requests": {rid: (tuple(q.tokens.tolist()), q.state.value,
                               list(q.out)) for rid, q in reqs.items()},
            "ticks": len(sched.trace), "printed": printed.getvalue(),
            "verdicts": asyncio.run(_verdicts(sched)),
            "idle": asyncio.run(_idle_too_long(sched))}


async def _verdicts(sched) -> list:
    """A front end with a queue of one: a prompt too long for a slot, a
    request taken, one refused for the full queue, the taken one
    cancelled while it waits; every outcome as this rank saw it."""
    from repro_torch.serve import (PromptTooLongError, QueueFullError,
                                   ServeFrontend)

    out = []
    async with ServeFrontend(sched, max_queue=1) as fe:
        try:
            await fe.submit(np.zeros(sched.max_len + 2, np.int64), 2)
        except PromptTooLongError as e:
            out.append(("too_long", e.prompt_len))
        first = await fe.submit(_fork_prompt(), 3)
        try:
            await fe.submit(_fork_prompt(), 3)
        except QueueFullError:
            out.append("full")
        out.append(("cancelled", await fe.cancel(first.rid)))
        out.append([t async for t in first])
        out.append(first.record.status)
    out.append(fe.rejected)
    return out


async def _idle_too_long(sched) -> tuple:
    """A request served to its end, so that every serve loop is idle;
    then a prompt too long for a slot as the last submission, and rank 0
    idles for ``IDLE_S`` before it stops.  Whether this rank's front end
    had rank 0's close when the verdict reached it: rank 1's must not,
    else it waited for rank 0's ``stop``."""
    from repro_torch.serve import PromptTooLongError, ServeFrontend

    async with ServeFrontend(sched, max_queue=4) as fe:
        served = [t async for t in await fe.submit(_fork_prompt(), 2)]
        await asyncio.sleep(0.05)
        try:
            await fe.submit(np.zeros(sched.max_len + 1, np.int64), 2)
        except PromptTooLongError as e:
            told = (e.prompt_len, fe._closed)
        if sched.mesh.rank == 0:
            await asyncio.sleep(IDLE_S)
    return served, told


def _head_dim_replicas(meshes, arrays) -> dict:
    from repro_torch import bridge
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.serve import ServeScheduler

    from test_torch_head_split import SERVE, SERVE_SPEC, _prompts, _qwen15_6

    cfg = _qwen15_6(get_config(QWEN15))
    params = bridge.from_reference(arrays[QWEN15], cfg, device="cpu")
    out = {}
    for spec in (None, 2):
        sched = ServeScheduler(cfg, params, acc=StaticCoreChunk(cores=2),
                               mesh=meshes[(2, 2)], device="cpu",
                               force_attn="head_dim",
                               **dict(SERVE, paged=True, page_size=8,
                                      speculate=spec))
        sched.warmup()
        rids = [sched.submit(p, n) for p, (_, n) in
                zip(_prompts(), SERVE_SPEC, strict=True)]
        outs = sched.run_until_idle()
        out[spec] = {"tokens": [outs[r] for r in rids],
                     "attn": sched.tp.attn,
                     "store": tuple(sched.pool.caches[0]["k"].shape[1:])}
    return out


def _vision(meshes, arrays) -> dict:
    from repro_torch import bridge
    from repro_torch.core.executor import SequentialExecutor
    from repro_torch.launch import serve as launch_serve

    mesh = meshes[(1, 2)]
    out = {}
    if mesh.contains:
        cfg = get_config(VISION).reduced()
        params = bridge.from_reference(arrays[VISION], cfg, device="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            out["tokens"] = launch_serve.serve_cross_attention(
                cfg, params, _vision_args(), SequentialExecutor(),
                torch.device("cpu"), mesh=mesh).tolist()
    # Last: the CLI leaves the process group when it is done.
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        launch_serve.main(CLI + ["--mesh", "1,2"])
    out["printed"] = printed.getvalue()
    return out


def mesh_serve(rank, arrays):
    from repro_torch import bridge
    from repro_torch.launch.mesh import make_serve_mesh

    torch.manual_seed(0)
    meshes = {s: make_serve_mesh(*s)
              for s in [(2, 1), (2, 2), (1, 2), (1, 1)]}
    qcfg = get_config(QWEN3).reduced()
    qparams = bridge.from_reference(arrays[QWEN3], qcfg, device="cpu")
    zcfg = get_config(ZAMBA).reduced()
    zparams = bridge.from_reference(arrays[ZAMBA], zcfg, device="cpu")
    return {"spec": _spec(meshes, qparams, qcfg),
            "fork": _fork(meshes, zparams, zcfg),
            "costs": _costs(meshes, qparams, qcfg),
            "frontend": _frontend(meshes, qparams, qcfg),
            "head_dim": _head_dim_replicas(meshes, arrays),
            "vision": _vision(meshes, arrays)}


# ---------------------------------------------------------------------------
# the parent's side: the JAX references
# ---------------------------------------------------------------------------

def _jax_fork_tokens(jcfg, jparams) -> tuple[int, list]:
    """The JAX paged pool: the prompt prefilled into a slot, the slot
    forked, both lanes through the paged fused step."""
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.serve.decode_loop import make_paged_decode_step
    from repro.serve.kv_cache import PagedKVCachePool

    pool = PagedKVCachePool(jcfg, 2, 32, page_size=8)
    src = pool.acquire("a")
    pool.ensure_writable(src, 0, FORK_PROMPT)
    row = pool.read_slot(src)
    logits, row = jlm.forward_cached(
        jparams, jnp.asarray(_fork_prompt())[None], row, 0, jcfg)
    pool.write_slot(src, row, 0, FORK_PROMPT)
    pool.positions[src] = FORK_PROMPT
    first = int(jnp.argmax(logits[0, -1]))
    dst = pool.fork(src, "b")
    for s in (src, dst):
        pool.ensure_writable(s, FORK_PROMPT, FORK_PROMPT + FORK_NEW)
    step = make_paged_decode_step(jcfg, page_size=8, max_len=32, max_depth=8)
    _, buf, _ = step(jparams, pool.caches, pool.page_table_array(),
                     jnp.full((2,), first, jnp.int32),
                     pool.positions_array(),
                     jnp.full((2,), FORK_NEW, jnp.int32))
    return first, np.asarray(buf)[:FORK_NEW].T.tolist()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax

    from repro.configs import get_config as jax_config
    from repro.core.acc import StaticCoreChunk as JStatic
    from repro.data import make_batch as jmake_batch
    from repro.models import lm as jlm
    from repro.serve import ServeEngine as JEngine
    from repro.serve import ServeScheduler as JScheduler
    from repro_torch.serve import heavy_tailed_trace, materialize

    from test_torch_head_split import _jax_tokens, _qwen15_6
    from test_torch_tp_blocks import _jax_params

    jq_cfg = jax_config(QWEN3).reduced()
    jq = jlm.init_params(jax.random.PRNGKey(0), jq_cfg)
    jz_cfg, jz = _jax_params(ZAMBA)
    jv_cfg, jv = _jax_params(VISION)
    jh_cfg = _qwen15_6(jax_config(QWEN15))
    jh = jlm.init_params(jax.random.PRNGKey(0), jh_cfg)
    arrays = {QWEN3: jax.tree.map(np.asarray, jq),
              ZAMBA: jax.tree.map(np.asarray, jz),
              VISION: jax.tree.map(np.asarray, jv),
              QWEN15: jax.tree.map(np.asarray, jh)}
    # The ranks run while the parent computes the references.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, tmp_path_factory.mktemp("mesh-serve"),
                            "test_torch_mesh_serve:mesh_serve", 4, arrays)
        # One JAX scheduler gives every prompt's greedy tokens: the
        # speculation prompts', then the front-end trace's.
        sched = JScheduler(jq_cfg, jq, n_slots=3, max_len=64,
                           acc=JStatic(cores=2), dispatch_depth=4)
        rids = [sched.submit(p, max_new_tokens=n) for p, n in
                zip(_spec_prompts(jq_cfg.vocab_size), BUDGETS, strict=True)]
        outs = sched.run_until_idle()
        spec = [outs[r] for r in rids]
        fa = _frontend_args()
        mat = materialize(heavy_tailed_trace(
            fa.requests, rate_rps=fa.rate_rps,
            max_prompt=max(fa.prompt_len, 8), max_new=fa.new_tokens,
            seed=fa.seed), jq_cfg.vocab_size, seed=fa.seed)
        rids = [sched.submit(p, max_new_tokens=tr.new_tokens)
                for tr, p in mat]
        outs = sched.run_until_idle()
        frontend = {tuple(int(t) for t in p): outs[r]
                    for (_, p), r in zip(mat, rids, strict=True)}
        va = _vision_args()
        vb = jmake_batch(jv_cfg, va.requests, va.prompt_len, kind="prefill",
                         seed=va.seed)
        vision = np.asarray(JEngine(
            jv_cfg, jv, batch=va.requests,
            max_len=va.prompt_len + va.new_tokens + 1).generate(
                vb["tokens"], va.new_tokens,
                frontend_feats=vb["frontend_feats"])).tolist()
        fork = _jax_fork_tokens(jz_cfg, jz)
        head_dim = _jax_tokens(jh_cfg, jh)
        res = ranks.result()
    return res, {"spec": spec, "fork": fork, "frontend": frontend,
                 "vision": vision, "head_dim": head_dim}


@pytest.mark.parametrize("shape", SPEC_MESHES)
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("spec", SPECS)
def test_speculation_over_data_replicas_matches_jax(run, shape, paged, spec):
    """Speculation with 2 data replicas (each running the verify rounds
    its own lanes need): every rank's tokens are the JAX package's
    single-device greedy tokens, verifies were drained, the pool was
    allocated once, and every rank's trace holds the same
    ``serve_spec_depth`` decisions and the same gathered telemetry."""
    res, ref = run
    ranks = range(shape[0] * shape[1])
    for r in ranks:
        got = res[r]["spec"][shape, paged, spec]
        assert got["tokens"] == ref["spec"], (r, got["tokens"])
        assert got["stats"]["verifies"] > 0
        assert got["decided"] > 0 and got["allocations"] == 1
        assert got["stats"] == res[0]["spec"][shape, paged, spec]["stats"]
        assert got["decided"] == res[0]["spec"][shape, paged, spec]["decided"]


@pytest.mark.parametrize("shape", FORK_MESHES)
def test_fork_across_replicas_takes_the_state_rows(run, shape):
    """zamba2's slot 0 (replica 0) forked into slot 1 (replica 1): the
    forked slot's Mamba2 state rows are bit-equal to its source's (and
    not zero), and both slots then decode the tokens the JAX paged pool's
    fork gives, on every rank."""
    res, ref = run
    jfirst, jtokens = ref["fork"]
    for r in range(shape[0] * shape[1]):
        got = res[r]["fork"][shape]
        assert got["slots"] == (0, 1)
        assert got["equal_rows"] and got["nonzero_rows"]
        assert got["first"] == jfirst
        assert got["tokens"] == jtokens


def _all_reduces(cfg, lanes: int) -> tuple[int, int]:
    """(calls, bytes) of the all-reduces of one decode step at a 'model'
    extent > 1 with the reduced qwen3's heads, feed-forward and
    vocabulary split: the vocabulary-parallel embedding's rows, and per
    layer the attention's ``wo`` and the feed-forward's ``w2``, each
    summing (lanes, 1, d_model) f32 rows over 'model'."""
    calls = 2 * cfg.n_layers + 1
    return calls, calls * lanes * cfg.d_model * 4


@pytest.mark.parametrize("shape", COST_MESHES)
def test_decode_cost_analysis_on_a_mesh(run, shape):
    """Every rank returns the reference's keys for its own step over its
    replica's lanes; the all-reduces are the embedding's and the
    row-parallel products' (``_all_reduces``) and the wire bytes twice
    theirs plus the vocabulary gather's; ranks of one replica count the
    same."""
    res, _ = run
    cfg = get_config(QWEN3).reduced()
    lanes = 2 // shape[0]
    for r in range(shape[0] * shape[1]):
        got = res[r]["costs"][shape]
        for key in ("flops_per_device", "hbm_bytes_per_device",
                    "collective_wire_bytes_per_device", "n_devices"):
            assert key in got
        assert got["n_devices"] == shape[0] * shape[1]
        assert got["flops_per_device"] > 0
        coll = got["collective_bytes"]
        assert (coll["counts"]["all-reduce"], coll["bytes"]["all-reduce"]) \
            == _all_reduces(cfg, lanes)
        gathered = coll["bytes"].get("all-gather", 0.0)
        assert got["collective_wire_bytes_per_device"] == \
            2 * coll["bytes"]["all-reduce"] + gathered
        assert got == res[r - r % shape[1]]["costs"][shape]


def test_decode_cost_analysis_on_one_rank_is_the_count_off_a_mesh(run):
    """On a (1, 1) mesh the count is the one off a mesh: the same flops,
    bytes, bound and kernels, and collectives of one rank, counted as
    calls, with no bytes."""
    res, _ = run
    got, alone = dict(res[0]["costs"][(1, 1)]), res[0]["costs"][None]
    coll = got.pop("collective_bytes")
    assert coll["counts"]["all-reduce"] > 0
    assert coll["bytes"]["total"] == 0 == alone["collective_bytes"][
        "bytes"]["total"]
    assert got == {k: v for k, v in alone.items()
                   if k != "collective_bytes"}


def test_frontend_on_a_mesh_follows_rank_zero(run):
    """The seeded front-end trace on (2, 1): both ranks hold the same
    records (status, tokens, submission stamps: rank 0's) and the same
    requests with the same tokens; every completed request's tokens are
    the JAX scheduler's for its prompt; only rank 0 printed.  Rank 0's
    verdicts reach rank 1's callers: the same ``PromptTooLongError``, the
    same ``QueueFullError`` and the same cancellation."""
    res, ref = run
    lead, other = res[0]["frontend"], res[1]["frontend"]
    assert lead["records"] == other["records"]
    assert lead["requests"] == other["requests"]
    assert lead["ticks"] == other["ticks"]
    done = [(p, out) for p, state, out in lead["requests"].values()
            if state == "done"]
    assert len(done) >= 1
    for prompt, out in done:
        assert out == ref["frontend"][prompt]
    assert "SLO-goodput" in lead["printed"] and not other["printed"]
    want = [("too_long", 66), "full", ("cancelled", True), [], "cancelled",
            1]
    assert lead["verdicts"] == other["verdicts"] == want


def test_frontend_on_a_mesh_tells_an_idle_rank_at_once(run):
    """On (2, 1), with every serve loop idle, a prompt too long for a
    slot as the last submission: rank 1's caller has its
    ``PromptTooLongError`` while rank 0 idles, before rank 0's close."""
    res, _ = run
    lead, other = res[0]["frontend"]["idle"], res[1]["frontend"]["idle"]
    assert lead[0] == other[0] and len(lead[0]) == 2
    assert lead[1] == other[1] == (65, False)


@pytest.mark.parametrize("spec", [None, 2])
def test_paged_head_dim_over_data_replicas_matches_jax(run, spec):
    """The 6-head qwen1.5 on (2, 2) with "head_dim" forced, paged (and
    speculating): a rank's stores hold 6 kv heads of 8 of their 16 dims,
    each replica's rows exchanged over 'data'; every rank's tokens are
    the JAX scheduler's."""
    res, ref = run
    for r in range(4):
        got = res[r]["head_dim"][spec]
        assert got["attn"] == "head_dim" and got["store"] == (6, 8)
        assert got["tokens"] == ref["head_dim"]


def test_cross_attention_on_a_mesh_through_the_cli(run, capsys):
    """The reduced llama-vision through the CLI's lock-step path on (1,
    2): with the JAX package's weights, the JAX engine's tokens on both
    ranks; ``main`` with ``--mesh 1,2`` serves (rank 0 prints) and its
    tokens are those of ``main`` off a mesh."""
    from repro_torch.launch import serve as launch_serve

    res, ref = run
    for r in (0, 1):
        assert res[r]["vision"]["tokens"] == ref["vision"]
    launch_serve.main(CLI)
    alone = capsys.readouterr().out
    printed = res[0]["vision"]["printed"]
    assert "lock-step batch path" in printed
    assert "generated 8 tokens" in printed
    sample = [line for line in printed.splitlines()
              if line.startswith("sample:")]
    assert sample and sample[0] in alone.splitlines()
    assert not res[1]["vision"]["printed"].strip()
