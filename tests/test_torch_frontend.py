"""The port's serving front end on the CPU: streaming against the batch
path (and the JAX package's tokens), cancellation while waiting,
mid-prefill and mid-dispatch, deadline shedding and late-completion
accounting, backpressure, adaptive admission in the decision trace, and
the port's load generators against the reference's for the same seeds."""
import asyncio
import dataclasses
import re

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.models import lm as jlm
from repro.serve import ServeScheduler as JaxScheduler
from repro.serve import loadgen as jlg
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.acc import AdaptiveCoreChunk, StaticCoreChunk
from repro_torch.core.adaptive import adaptive
from repro_torch.core.executor import SequentialExecutor
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (PromptTooLongError, QueueFullError,
                               RequestState, ServeFrontend, ServeScheduler)
from repro_torch.serve import loadgen as tlg


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams),
                                    tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def make_sched(models, *, n_slots=2, max_len=48, acc=None, clock=None,
               **kw):
    _, _, tcfg, tparams = models
    if clock is not None:
        kw["clock"] = clock
    return ServeScheduler(
        tcfg, tparams, n_slots=n_slots, max_len=max_len,
        executor=adaptive(SequentialExecutor(), acc or AdaptiveCoreChunk()),
        device="cpu", **kw)


class FakeClock:
    """Deterministic scheduler clock for deadline tests."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n)


# ---------------------------------------------------------------------------
# typed submit errors
# ---------------------------------------------------------------------------

def test_frontend_rejects_long_prompt_without_dying(models):
    sched = make_sched(models, n_slots=1, max_len=16)

    async def go():
        async with ServeFrontend(sched) as fe:
            with pytest.raises(PromptTooLongError):
                await fe.submit(_prompt(20), 2)
            stream = await fe.submit(_prompt(6), 3)
            toks = [t async for t in stream]
            return toks, stream.record.status

    toks, status = asyncio.run(go())
    assert len(toks) == 3 and status == "completed"


# ---------------------------------------------------------------------------
# cancellation and the slot lifecycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_cancel_waiting_request(models, paged):
    kw = dict(dispatch_depth=2, paged=True) if paged else {}
    sched = make_sched(models, n_slots=1, **kw)
    r_run = sched.submit(_prompt(6), max_new_tokens=2)
    r_wait = sched.submit(_prompt(6), max_new_tokens=2)
    sched.tick()
    assert sched.requests[r_wait].state is RequestState.WAITING
    assert sched.cancel(r_wait)
    assert sched.requests[r_wait].state is RequestState.CANCELLED
    assert not sched.cancel(r_wait)          # idempotent
    outs = sched.run_until_idle()
    assert len(outs[r_run]) == 2 and r_wait not in outs
    assert sched.pool.free_slots() == 1
    assert sched.cancelled == 1


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_mid_prefill_releases_slot(models, paged):
    """Cancel while the prompt is partially prefilled: the slot returns
    to the pool and its next occupant decodes like a solo run."""
    kw = dict(dispatch_depth=2, paged=True, page_size=8) if paged else {}
    acc = StaticCoreChunk(cores=1, chunks_per_core=8)
    sched = make_sched(models, n_slots=1, max_len=32, acc=acc, **kw)
    r_victim = sched.submit(_prompt(16, 23), max_new_tokens=4)
    sched.tick()
    victim = sched.requests[r_victim]
    assert victim.state is RequestState.PREFILL
    assert victim.remaining_prefill > 0
    assert sched.cancel(r_victim)
    assert victim.slot is None and sched.pool.free_slots() == 1
    r_next = sched.submit(_prompt(10, 24), max_new_tokens=4)
    outs = sched.run_until_idle()
    assert sched.pool.allocations == 1
    solo = make_sched(models, n_slots=1, max_len=32,
                      acc=StaticCoreChunk(cores=1, chunks_per_core=8))
    r_ref = solo.submit(_prompt(10, 24), max_new_tokens=4)
    assert outs[r_next] == solo.run_until_idle()[r_ref]


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, page_size=8),
                                dict(paged=True, speculate=2)])
def test_cancel_mid_fused_dispatch(models, kw):
    """Cancel with tokens already dispatched: the dispatch drains without
    emitting them, the slot is back in the pool, and the surviving
    request's tokens equal an uncancelled run's."""
    spec = [(10, 8), (7, 12)]
    prompts = [_prompt(10, 29), _prompt(7, 30)]

    def submit_pair(sched):
        return [sched.submit(prompts[i][:p], max_new_tokens=n)
                for i, (p, n) in enumerate(spec)]

    ref_sched = make_sched(models, max_len=32, dispatch_depth=4)
    ref_sched.warmup()
    ref_ids = submit_pair(ref_sched)
    ref = ref_sched.run_until_idle()

    sched = make_sched(models, max_len=32, dispatch_depth=4, **kw)
    sched.warmup()
    r_keep, r_cancel = submit_pair(sched)
    victim = sched.requests[r_cancel]
    for _ in range(200):
        sched.tick()
        if victim.state is RequestState.DECODE and victim.pending_out > 0:
            break
    assert victim.pending_out > 0, "no in-flight dispatch to cancel into"
    frozen = list(victim.out)
    assert sched.cancel(r_cancel)
    outs = sched.run_until_idle()
    assert victim.out == frozen           # dispatched tokens dropped
    assert victim.pending_out == 0        # ...but the drain balanced
    assert victim.state is RequestState.CANCELLED
    assert outs[r_keep] == ref[ref_ids[0]]
    assert sched.pool.allocations == 1
    assert sched.pool.free_slots() == 2


def test_frontend_cancel_stream(models):
    sched = make_sched(models, n_slots=1, max_len=48)

    async def go():
        async with ServeFrontend(sched) as fe:
            stream = await fe.submit(_prompt(8), 24)
            got = []
            async for tok in stream:
                got.append(tok)
                if len(got) == 2:
                    await stream.cancel()
            return got, stream.record

    got, rec = asyncio.run(go())
    assert rec.status == "cancelled" and rec.missed is False
    assert len(got) < 24
    assert sched.pool.free_slots() == 1
    assert sched.requests[rec.rid].state is RequestState.CANCELLED


# ---------------------------------------------------------------------------
# deadline enforcement
# ---------------------------------------------------------------------------

def test_shed_expired_before_prefill(models):
    clock = FakeClock()
    sched = make_sched(models, n_slots=1, clock=clock, shed_expired=True)
    r_ok = sched.submit(_prompt(6), max_new_tokens=2, deadline=100.0)
    r_dead = sched.submit(_prompt(6), max_new_tokens=2, deadline=5.0)
    r_queued = sched.submit(_prompt(6), max_new_tokens=2, deadline=50.0)
    clock.t = 10.0                        # r_dead's deadline passed
    rec = sched.tick()
    dead = sched.requests[r_dead]
    assert dead.state is RequestState.SHED
    assert dead.finished_at == 10.0
    assert rec.deadline_misses == 1
    assert rec.admitted == (r_queued,)    # EDF among the survivors
    assert rec.queue_depth == 1
    assert sched.shed == 1 and sched.deadline_misses == 1
    outs = sched.run_until_idle()
    assert sorted(outs) == sorted([r_ok, r_queued])


def test_frontend_sheds_expired_request(models):
    clock = FakeClock()
    sched = make_sched(models, n_slots=1, clock=clock)

    async def go():
        async with ServeFrontend(sched) as fe:
            first = await fe.submit(_prompt(6), 2, deadline=100.0)
            late = await fe.submit(_prompt(6), 2, deadline=5.0)
            clock.t = 10.0
            toks = [[t async for t in s] for s in (first, late)]
            return toks, late.record, fe.stats()

    toks, rec, stats = asyncio.run(go())
    assert len(toks[0]) == 2 and toks[1] == []
    assert rec.status == "shed" and rec.missed is True
    assert stats["shed"] == 1 and stats["missed"] == 1


def test_late_completion_counts_as_miss(models):
    clock = FakeClock()
    sched = make_sched(models, n_slots=1, clock=clock)
    rid = sched.submit(_prompt(6), max_new_tokens=2, deadline=5.0)
    clock.t = 10.0                        # already late, but admitted
    sched.run_until_idle()
    assert sched.requests[rid].state is RequestState.DONE
    assert sched.deadline_misses == 1
    assert sum(rec.deadline_misses for rec in sched.trace) == 1


def test_frontend_marks_late_completion_missed(models):
    clock = FakeClock()
    sched = make_sched(models, n_slots=1, clock=clock)

    async def go():
        async with ServeFrontend(sched, enforce_deadlines=False) as fe:
            stream = await fe.submit(_prompt(6), 2, deadline=5.0)
            clock.t = 10.0
            async for _ in stream:
                pass
            return stream.record, fe.stats()

    rec, stats = asyncio.run(go())
    assert rec.status == "completed" and rec.missed is True
    assert stats["completed"] == 1 and stats["completed_in_slo"] == 0
    assert stats["missed"] == 1


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------

def test_frontend_backpressure(models):
    sched = make_sched(models, n_slots=1, max_len=48)
    prompt = _prompt(6)

    async def go():
        fe = ServeFrontend(sched, max_queue=1)
        async with fe:
            streams = [await fe.submit(prompt, 2)]
            while fe.queue_depth() > 0:     # let the serve loop admit it
                await asyncio.sleep(0)
            streams.append(await fe.submit(prompt, 2))
            with pytest.raises(QueueFullError):
                await fe.submit(prompt, 2)
            assert fe.rejected == 1
            streams.append(await fe.submit(prompt, 2, wait=True))
            for s in streams:
                async for _ in s:
                    pass
            return fe.stats()

    stats = asyncio.run(go())
    assert stats["completed"] == 3 and stats["rejected"] == 1


# ---------------------------------------------------------------------------
# streaming identity + adaptive admission
# ---------------------------------------------------------------------------

def _stream(sched, prompts, new):
    async def go():
        async with ServeFrontend(sched) as fe:
            streams = [await fe.submit(p, new) for p in prompts]
            return [[t async for t in s] for s in streams]

    return asyncio.run(go())


@pytest.mark.parametrize("kw", [
    dict(), dict(dispatch_depth=3),
    dict(dispatch_depth=3, paged=True, page_size=8, admission="adaptive"),
    dict(dispatch_depth=3, paged=True, speculate=2, admission="adaptive"),
])
def test_streaming_tokens_match_batch_and_jax(models, kw):
    """Streamed tokens are the batch path's and the JAX scheduler's:
    streaming changes delivery, never content."""
    jcfg, jparams, _, _ = models
    prompts = [_prompt(12, 31), _prompt(8, 32), _prompt(15, 33)]
    ref = JaxScheduler(jcfg, jparams, n_slots=2, max_len=32,
                       acc=JaxStatic(cores=2))
    ref_ids = [ref.submit(p, max_new_tokens=5) for p in prompts]
    jax_out = ref.run_until_idle()
    batch_sched = make_sched(models, max_len=32, **kw)
    ids = [batch_sched.submit(p, max_new_tokens=5) for p in prompts]
    batch = batch_sched.run_until_idle()
    got = _stream(make_sched(models, max_len=32, **kw), prompts, 5)
    assert got == [batch[i] for i in ids] == [jax_out[i] for i in ref_ids]


def test_burst_drain_spreads_inter_token_times(models):
    sched = make_sched(models, n_slots=1, max_len=32, dispatch_depth=4)

    async def go():
        async with ServeFrontend(sched) as fe:
            stream = await fe.submit(_prompt(10, 33), 8)
            return [t async for t in stream], stream.record

    out, rec = asyncio.run(go())
    assert len(out) == 8 and len(rec.token_times) == 8
    gaps = [b - a for a, b in zip(rec.token_times, rec.token_times[1:],
                                  strict=False)]
    assert all(g > 0 for g in gaps), gaps
    assert rec.token_times[0] >= rec.first_token_at


@pytest.mark.parametrize("paged", [False, True])
def test_adaptive_admission_decisions_in_trace(models, paged):
    kw = dict(dispatch_depth="auto", paged=True) if paged else {}
    sched = make_sched(models, n_slots=2, max_len=48, admission="adaptive",
                       **kw)
    sched.warmup()
    for _ in range(5):
        sched.submit(_prompt(8), max_new_tokens=2)
    outs = sched.run_until_idle()
    assert len(outs) == 5                 # throttling never starves
    entries = sched.decision_model().trace.entries("serve_admission")
    assert entries, "adaptive admission must go through the engine"
    for e in entries:
        inputs = dict(e.decision.inputs)
        assert "queue_depth" in inputs and "free_slots" in inputs
        assert 1 <= e.decision.cores <= 2
    assert "serve_admission" in sched.decision_model().explain()


def test_adaptive_admission_urgency_override(models):
    clock = FakeClock(t=100.0)
    sched = make_sched(models, n_slots=2, max_len=48, admission="adaptive",
                       clock=clock)
    sched.warmup()
    sched.submit(_prompt(8), max_new_tokens=2, deadline=100.0)
    sched.submit(_prompt(8), max_new_tokens=2, deadline=100.0)
    rec = sched.tick()
    assert len(rec.admitted) == 2
    e = sched.decision_model().trace.entries("serve_admission")[-1]
    assert dict(e.decision.inputs)["urgent"] is True
    sched.run_until_idle()


def test_launch_frontend_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device",
                       "cpu", "--requests", "4", "--slots", "2",
                       "--prompt-len", "12", "--new-tokens", "4",
                       "--no-cal-cache", "--paged", "--speculate", "auto",
                       "--frontend", "--rate-rps", "200",
                       "--explain-decisions"])
    out = capsys.readouterr().out
    # Deadlines are on the wall clock: under load a request may be shed,
    # but every one of the four ends completed or shed.
    done = re.search(r"completed (\d+) \(in-SLO \d+\) shed (\d+)", out)
    assert "SLO-goodput" in out and done is not None
    assert int(done.group(1)) + int(done.group(2)) == 4
    assert "serve_admission" in out and "serve_page_size" in out
    assert "speculate: depth=" in out and "paged: page_size=" in out


# ---------------------------------------------------------------------------
# load generators: the port's copy against the reference
# ---------------------------------------------------------------------------

TRACES = {
    "poisson": dict(rate_rps=50.0),
    "bursty": dict(base_rate_rps=10.0, burst_rate_rps=200.0),
    "heavy": dict(rate_rps=50.0),
    "shared_prefix": dict(rate_rps=50.0),
    "templated": dict(rate_rps=50.0),
}


@pytest.mark.parametrize("name", sorted(TRACES))
@pytest.mark.parametrize("seed", [0, 3])
def test_loadgen_matches_reference(name, seed):
    kw = TRACES[name]
    ref = jlg.GENERATORS[name](64, seed=seed, **kw)
    got = tlg.GENERATORS[name](64, seed=seed, **kw)
    assert [dataclasses.astuple(t) for t in got] == \
        [dataclasses.astuple(t) for t in ref]
    assert tlg.trace_summary(got) == jlg.trace_summary(ref)
    for (_, a), (_, b) in zip(tlg.materialize(got, 512, seed=seed),
                              jlg.materialize(ref, 512, seed=seed),
                              strict=True):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_slo_model_and_deadlines():
    slo = tlg.SLOModel(ttft_s=0.5, per_token_s=0.1)
    assert slo.deadline_offset(10) == pytest.approx(1.5)
    assert slo.deadline_offset(20) > slo.deadline_offset(10)
    trace = tlg.poisson_trace(10, rate_rps=100.0, seed=0, slo=None)
    assert all(t.deadline_s is None for t in trace)
    trace = tlg.heavy_tailed_trace(200, rate_rps=50.0, seed=1)
    assert all(t.deadline_s > t.arrival_s for t in trace)
