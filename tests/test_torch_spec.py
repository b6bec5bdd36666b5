"""The port's self-speculative decoding on the CPU against the JAX
package's: the drafter and the accept/emit/history/out-buffer steps on
random inputs (exact), speculative tokens against plain decoding at every
width and under ``"auto"``, paged speculative tokens against the JAX
paged speculative scheduler, K/V rollback, the ``serve_spec_depth``
decision's values against the reference's, and the architecture guard."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.core.calibration import CalibrationCache as JaxCache
from repro.core.model import ExecutionModel as JaxModel
from repro.models import lm as jlm
from repro.serve import ServeScheduler as JaxScheduler
from repro.serve import decode_loop as jdl
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.acc import AdaptiveCoreChunk, StaticCoreChunk
from repro_torch.core.adaptive import adaptive
from repro_torch.core.calibration import CalibrationCache
from repro_torch.core.executor import SequentialExecutor
from repro_torch.core.model import ANALYTIC, ONLINE, ExecutionModel
from repro_torch.serve import ServeScheduler
from repro_torch.serve import decode_loop as tdl


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams),
                                    tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _histories(seed, n=6, h=24, vocab=9):
    """-1-padded histories over a tiny vocabulary (so bigrams repeat and
    the drafter hits), with some lanes too short to match at all."""
    rng = np.random.RandomState(seed)
    hist = rng.randint(0, vocab, size=(n, h)).astype(np.int64)
    for lane in range(n):
        hist[lane, :rng.randint(0, h - 1)] = -1
    return hist


# ---------------------------------------------------------------------------
# the drafter and the round's bookkeeping, exact against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draft_batch_matches_reference(depth, seed):
    hist = _histories(seed)
    ref = np.asarray(jdl._draft_batch(jnp.asarray(hist, jnp.int32), depth))
    out = tdl._draft_batch(torch.from_numpy(hist), depth)
    np.testing.assert_array_equal(out.numpy(), ref)
    for lane in range(hist.shape[0]):
        one_ref = np.asarray(jdl.draft_from_history(
            jnp.asarray(hist[lane], jnp.int32), depth))
        one = tdl.draft_from_history(torch.from_numpy(hist[lane]), depth)
        np.testing.assert_array_equal(one.numpy(), one_ref)
        np.testing.assert_array_equal(one.numpy(), out[lane].numpy())


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_round_bookkeeping_matches_reference(seed):
    """_spec_emit, _shift_history and _spec_write_out on random drafts,
    verifies, budgets and cursors."""
    rng = np.random.RandomState(seed)
    n, d, h, max_depth = 5, 4, 16, 12
    drafts = rng.randint(0, 3, (n, d - 1))
    verified = rng.randint(0, 3, (n, d))
    rem = rng.randint(0, 6, n)
    hist = rng.randint(-1, 5, (n, h))
    out_buf = rng.randint(0, 9, (max_depth, n))
    cursor = rng.randint(0, 6, n)
    j = {k: jnp.asarray(v, jnp.int32) for k, v in dict(
        drafts=drafts, verified=verified, rem=rem, hist=hist,
        out_buf=out_buf, cursor=cursor).items()}
    t = {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in dict(
        drafts=drafts, verified=verified, rem=rem, hist=hist,
        out_buf=out_buf, cursor=cursor).items()}
    jn, jtok = jdl._spec_emit(j["drafts"], j["verified"], j["rem"])
    tn, ttok = tdl._spec_emit(t["drafts"], t["verified"], t["rem"])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(
        tdl._shift_history(t["hist"], t["verified"], tn).numpy(),
        np.asarray(jdl._shift_history(j["hist"], j["verified"], jn)))
    np.testing.assert_array_equal(
        tdl._spec_write_out(t["out_buf"], t["verified"], t["cursor"],
                            tn).numpy(),
        np.asarray(jdl._spec_write_out(j["out_buf"], j["verified"],
                                       j["cursor"], jn)))


# ---------------------------------------------------------------------------
# speculative tokens are greedy decoding's
# ---------------------------------------------------------------------------

BUDGETS = (9, 3, 7)


def _mixed_prompts(vocab, seed=0):
    """A repeated motif (the drafter's best case), noise (its worst) and
    a short motif tail: full accepts, full rejects and partial accepts."""
    rng = np.random.RandomState(seed)
    motif = [7, 3, 11, 5]
    return [(motif * 5)[:14],
            [int(t) for t in rng.randint(0, vocab, 9)],
            (motif * 3)[:6]]


def _sched(tcfg, tparams, *, speculate=None, paged=False, depth=4,
           n_slots=3, max_len=64, **kw):
    if paged:
        kw.setdefault("page_size", 8)
    return ServeScheduler(
        tcfg, tparams, n_slots=n_slots, max_len=max_len,
        executor=adaptive(SequentialExecutor(), AdaptiveCoreChunk()),
        dispatch_depth=depth, paged=paged, speculate=speculate,
        device="cpu", **kw)


def _run(sched, prompts, budgets=BUDGETS):
    sched.warmup()
    rids = [sched.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, budgets, strict=True)]
    outs = sched.run_until_idle()
    return [outs[r] for r in rids]


@pytest.mark.parametrize("d", [2, 4, 8, "auto"])
@pytest.mark.parametrize("paged", [False, True])
def test_spec_tokens_identical_to_nonspec(models, d, paged):
    _, _, tcfg, tparams = models
    prompts = _mixed_prompts(tcfg.vocab_size)
    ref = _run(_sched(tcfg, tparams), prompts)
    sched = _sched(tcfg, tparams, speculate=d, paged=paged)
    got = _run(sched, prompts)
    assert got == ref, f"width {d} moved a token"
    assert sched.pool.allocations == 1
    stats = sched.spec_stats()
    assert stats["enabled"] and stats["verifies"] > 0
    if d != "auto":
        assert stats["depth"] == d
        # Prefill emits each first token; every later one rides a verify.
        assert stats["emitted"] == sum(BUDGETS) - len(BUDGETS)
    else:
        assert sched.decision_model().trace.entries("serve_spec_depth")


@pytest.mark.parametrize("d", [2, 4])
def test_paged_spec_tokens_match_jax(models, d):
    """f32, fixed chunk decisions: the port's paged speculative tokens
    equal the JAX paged speculative scheduler's, including a resubmitted
    prompt that maps its registered prefix read-only."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _mixed_prompts(tcfg.vocab_size)
    ref = JaxScheduler(jcfg, jparams, n_slots=3, max_len=64,
                       acc=JaxStatic(cores=2), dispatch_depth=4,
                       paged=True, page_size=8, speculate=d)
    port = ServeScheduler(tcfg, tparams, n_slots=3, max_len=64,
                          acc=StaticCoreChunk(cores=2), dispatch_depth=4,
                          paged=True, page_size=8, speculate=d,
                          device="cpu")
    for sched in (ref, port):
        sched.warmup()
    outs = []
    for sched in (ref, port):
        rids = [sched.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, BUDGETS, strict=True)]
        res = sched.run_until_idle()
        sched.clear_finished()
        again = sched.submit(prompts[0], max_new_tokens=BUDGETS[0])
        res2 = sched.run_until_idle()
        outs.append(([res[r] for r in rids], res2[again],
                     sched.pool.prefix_stats()["prefix_hits"]))
    assert outs[1] == outs[0]
    assert outs[1][1] == outs[1][0][0]
    assert outs[1][2] >= 1
    assert port.pool.allocations == 1


@pytest.mark.parametrize("d", [2, 4])
def test_spec_round_count_reads(models, d):
    """The first ceil(max_take / d) rounds run without a read; after them
    the host reads the remaining budget once per round, so a dispatch
    that ran R rounds made R - ceil(max_take / d) + 1 reads, each a
    counted host round trip in the scheduler."""
    _, _, tcfg, tparams = models
    sched = _sched(tcfg, tparams, depth=8, speculate=d)
    sched.warmup()
    rid = sched.submit(_mixed_prompts(tcfg.vocab_size)[0], max_new_tokens=2)
    sched.run_until_idle()
    assert sched.requests[rid].out
    step = tdl.make_spec_decode_step(tcfg, depth=d, max_depth=8)
    n = sched.pool.n_slots
    budgets = [7, 0, 3]
    hist = torch.full((n, 16), -1, dtype=torch.long)
    hist[:, -4:] = torch.tensor([7, 3, 11, 5])
    before = [c["k"].clone() for c in sched.pool.caches]
    caches, _, out_buf, _, stats, reads = step(
        tparams, sched.pool.caches, hist, torch.tensor([5, 5, 5]),
        torch.tensor([20, 30, 40]), budgets)
    rounds, verifies, emitted = stats.tolist()
    blind = -(-max(budgets) // d)
    assert rounds >= blind
    assert reads == rounds - blind + 1
    assert emitted == sum(budgets)
    assert verifies >= rounds
    # The lane with no budget wrote nothing and emitted nothing.
    for b, c in zip(before, caches, strict=True):
        assert torch.equal(b[1], c["k"][1])
    assert out_buf.shape == (8, n)


def _random_prompts(vocab, seed):
    rng = np.random.RandomState(seed)
    prompts = []
    for _ in range(3):
        toks = []
        motif = [int(t) for t in rng.randint(0, vocab, rng.randint(2, 5))]
        while len(toks) < 6 + rng.randint(0, 10):
            if rng.rand() < 0.6:
                toks.extend(motif)
            else:
                toks.extend(int(t) for t in rng.randint(0, vocab, 2))
        prompts.append(toks[:15])
    return prompts


@pytest.mark.parametrize("seed,depth", [(0, 4), (13, 8), (91, 2)])
def test_kv_rollback_invariants(models, seed, depth):
    """Speculative and plain pools run tick-aligned and stop mid-decode:
    positions and the live K/V region [:pos] of every slot agree — a
    rejected draft's write never survives where the mask can read it."""
    _, _, tcfg, tparams = models
    prompts = _random_prompts(tcfg.vocab_size, seed)

    def run(spec):
        # Fixed prefill chunks (StaticCoreChunk): both pools compute their
        # K/V through the same shapes, so the rows compare bit for bit.
        sched = ServeScheduler(tcfg, tparams, n_slots=3, max_len=64,
                               acc=StaticCoreChunk(cores=2),
                               dispatch_depth=4, speculate=spec,
                               device="cpu")
        sched.warmup()
        for p in prompts:
            sched.submit(p, max_new_tokens=40)
        for _ in range(8):
            sched.tick()
        sched.flush()
        return sched

    ref, got = run(None), run(depth)
    assert got.pool.positions == ref.pool.positions
    for rc, sc in zip(ref.pool.caches, got.pool.caches, strict=True):
        for key in ("k", "v"):
            for slot in range(rc[key].shape[0]):
                p = ref.pool.positions[slot]
                assert torch.equal(rc[key][slot][:, :p],
                                   sc[key][slot][:, :p]), (seed, slot)


def test_paged_rollback_refuses_a_shared_page(models):
    _, _, tcfg, tparams = models
    sched = _sched(tcfg, tparams, speculate=2, paged=True)
    pool = sched.pool
    slot = pool.acquire("a")
    pool.ensure_writable(slot, 0, 12)
    pool.positions[slot] = 12
    assert pool.rollback(slot, 2) == 10
    pool.fork(slot, "b")                   # every page now shared
    with pytest.raises(ValueError, match="shared page"):
        pool.rollback(slot, 2)


# ---------------------------------------------------------------------------
# the serve_spec_depth decision, against the reference's values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accept,current", [
    (0.5, None),        # the analytic prior: speculation turns on at d=2
    (0.01, 8),          # collapse: backoff to 1, no ladder on the way down
    (0.94, 2),          # saturated: one rung up, not the argmax
    (0.3, 8),           # one rung down from 8
    (0.5, 2),           # stay
])
def test_spec_depth_decision_matches_reference(accept, current):
    kw = dict(candidates=(1, 2, 4, 8), accept_rate=accept)
    if current is not None:
        kw["current"] = current
    ref = JaxModel(JaxCache(), hardware="test").spec_depth("k", **kw)
    got = ExecutionModel(CalibrationCache(), hardware="test").spec_depth(
        "k", **kw)
    assert got.chunk == ref.chunk
    assert dict(got.inputs).get("backoff") == dict(ref.inputs).get("backoff")
    assert dict(got.inputs).get("unclamped") == \
        dict(ref.inputs).get("unclamped")
    assert got.provenance == ANALYTIC
    expected = {(0.5, None): 2, (0.01, 8): 1, (0.94, 2): 4, (0.3, 8): 4,
                (0.5, 2): 2}[(accept, current)]
    assert got.chunk == expected


def test_spec_depth_online_backoff_and_climb(models):
    """Collapsed acceptance parks the decision at depth 1; recovered
    acceptance climbs back one rung at a time (1 -> 2 -> 4)."""
    _, _, tcfg, tparams = models
    sched = _sched(tcfg, tparams, speculate="auto", n_slots=2)
    sched.warmup()
    model = sched.decision_model()
    for _ in range(30):
        model.observe(sched.spec_accept_key, 10, 0.01 * 10)
    assert sched._decide_spec_depth() == 1
    sched._spec_depth = 1
    for _ in range(200):
        model.observe(sched.spec_accept_key, 10, 0.9 * 10)
    assert sched._decide_spec_depth() == 2
    sched._spec_depth = 2
    assert sched._decide_spec_depth() == 4


def test_spec_depth_provenance_analytic_to_online(models):
    _, _, tcfg, tparams = models
    sched = _sched(tcfg, tparams, speculate="auto", n_slots=2)
    sched.warmup()
    motif = [7, 3, 11, 5] * 4
    ticks = []
    for _ in range(4):
        for _ in range(2):
            sched.submit(motif[:12], max_new_tokens=12)
        sched.run_until_idle()
        ticks.extend(sched.trace)
        sched.clear_finished()
    entries = sched.decision_model().trace.entries("serve_spec_depth")
    prov = [e.decision.provenance for e in entries]
    assert prov[0] == ANALYTIC
    assert ONLINE in prov, prov
    stats = sched.spec_stats()
    assert stats["acceptance_rate"] > 0.0
    spec_ticks = [r for r in ticks if r.spec_depth >= 2]
    assert spec_ticks, "no tick dispatched speculatively"
    assert sum(r.dispatched_tokens for r in spec_ticks) == stats["emitted"]


# ---------------------------------------------------------------------------
# the architecture guard
# ---------------------------------------------------------------------------

def test_spec_requires_attention_only(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="full attention"):
        tdl.make_spec_decode_step(tcfg, depth=2, window=8)
    rec = dataclasses.replace(tcfg, block_pattern=("mamba2",))
    with pytest.raises(ValueError, match="attention-only"):
        tdl.make_spec_decode_step(rec, depth=2)
    with pytest.raises(ValueError, match="fused"):
        ServeScheduler(tcfg, tparams, n_slots=2, max_len=32, speculate=2,
                       device="cpu")
    with pytest.raises(ValueError, match="speculate"):
        ServeScheduler(tcfg, tparams, n_slots=2, max_len=32, speculate="x",
                       dispatch_depth=2, device="cpu")
