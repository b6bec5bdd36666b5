"""The port's serve path on the CPU against the JAX package's: greedy
token identity and tick-for-tick identical schedules on one seeded trace,
fused == per-tick inside the port, and the slot pool's invariants."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.models import lm as jlm
from repro.serve import ServeScheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import strict
from repro_torch.core.acc import StaticCoreChunk
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (CacheLayoutError, ServeEngine, ServeScheduler,
                               SlotKVCachePool, SlotOverflowError)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams),
                                    tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _trace():
    """5 requests: prompt lengths 5-40, 4-9 new tokens (seeded)."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 256, int(rng.integers(5, 41))),
             int(rng.integers(4, 10))) for _ in range(5)]


def _port(tcfg, tparams, depth, **kw):
    return ServeScheduler(tcfg, tparams, n_slots=2, max_len=64,
                          acc=StaticCoreChunk(cores=2),
                          dispatch_depth=depth, device="cpu", **kw)


def _serve(sched, trace):
    rids = [sched.submit(p, m) for p, m in trace]
    outs = sched.run_until_idle()
    return [outs[r] for r in rids], [dataclasses.astuple(t)
                                     for t in sched.trace]


@pytest.mark.parametrize("depth", [None, 1, 4])
def test_tokens_identical_to_jax_scheduler(models, depth):
    """f32, both schedulers on the same fixed chunk decisions
    (StaticCoreChunk), so timing noise cannot move the prefill chunks."""
    jcfg, jparams, tcfg, tparams = models
    trace = _trace()
    ref = JaxScheduler(jcfg, jparams, n_slots=2, max_len=64,
                       acc=JaxStatic(cores=2), dispatch_depth=depth)
    ref_out, ref_ticks = _serve(ref, trace)
    out, ticks = _serve(_port(tcfg, tparams, depth), trace)
    assert out == ref_out
    assert ticks == ref_ticks
    assert [len(o) for o in out] == [m for _, m in trace]


def test_fused_equals_per_tick_inside_the_port(models):
    _, _, tcfg, tparams = models
    trace = _trace()
    per_tick, _ = _serve(_port(tcfg, tparams, None), trace)
    fused, _ = _serve(_port(tcfg, tparams, 3), trace)
    auto = _port(tcfg, tparams, "auto", sync_every=2)
    auto.warmup()
    fused_auto, _ = _serve(auto, trace)
    assert per_tick == fused == fused_auto
    assert auto.pool.allocations == 1


def test_pool_invariants(models):
    _, _, tcfg, tparams = models
    sched = _port(tcfg, tparams, 4)
    _serve(sched, _trace())
    assert sched.pool.allocations == 1
    assert sched.pool.free_slots() == 2
    pool = SlotKVCachePool(tcfg, 2, 16, device="cpu")
    slot = pool.acquire("r")
    pool.advance(slot, 16)
    with pytest.raises(SlotOverflowError):
        pool.advance(slot, 1)
    with pytest.raises(CacheLayoutError):
        pool.adopt([{k: v[:1] for k, v in c.items()} for c in pool.caches])
    other = SlotKVCachePool(tcfg, 2, 16, device="cpu")
    pool.adopt(other.caches)                  # same layout: accepted


def test_read_after_donation_raises_in_strict_mode(models):
    _, _, tcfg, _ = models
    pool = SlotKVCachePool(tcfg, 2, 8, device="cpu")
    caches = pool.caches
    pool.mark_donated("test dispatch")
    if strict.enabled():
        with pytest.raises(strict.DonatedCacheError):
            _ = pool.caches
    pool.adopt(caches)
    assert pool.caches is caches


def test_prefill_views_write_the_pool(models):
    _, _, tcfg, _ = models
    pool = SlotKVCachePool(tcfg, 3, 8, device="cpu")
    row = pool.read_slot(1)
    row[0]["k"].fill_(2.0)
    pool.write_slot(1, row)                     # a view: nothing to copy
    assert pool.caches[0]["k"][1].eq(2.0).all()
    foreign = [{k: torch.full_like(v[:1], 3.0) for k, v in c.items()}
               for c in pool.caches]
    pool.write_slot(2, foreign)
    assert pool.caches[0]["v"][2].eq(3.0).all()
    assert pool.caches[0]["v"][0].eq(0.0).all()


@pytest.mark.parametrize("kwargs", [
    dict(mesh=object()), dict(kernel_tuner=object())])
def test_unported_options_raise(models, kwargs):
    _, _, tcfg, tparams = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeScheduler(tcfg, tparams, n_slots=2, max_len=32,
                       dispatch_depth=2, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(paged=True), dict(speculate=2), dict(admission="adaptive")])
def test_formerly_unported_options_serve(models, kwargs):
    """The paged pool, speculation and adaptive admission serve on the
    CPU, with the plain scheduler's tokens."""
    _, _, tcfg, tparams = models
    trace = _trace()
    ref, _ = _serve(_port(tcfg, tparams, 2), trace)
    sched = _port(tcfg, tparams, 2, **kwargs)
    out, _ = _serve(sched, trace)
    assert out == ref
    assert sched.pool.allocations == 1
    assert sched.pool.free_slots() == 2


def test_engine_generates_through_the_scheduler(models):
    _, _, tcfg, tparams = models
    engine = ServeEngine(tcfg, tparams, batch=2, max_len=32,
                         dispatch_depth=2, device="cpu")
    prompt = np.random.default_rng(3).integers(0, 256, (2, 7))
    out = engine.generate(prompt, 5)
    assert out.shape == (2, 5)
    sched = _port(tcfg, tparams, None)
    rids = [sched.submit(p, 5) for p in prompt]
    ref = sched.run_until_idle()
    assert out.tolist() == [ref[r] for r in rids]


def test_launch_serve_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--slots", "2",
                       "--prompt-len", "12", "--new-tokens", "4",
                       "--no-cal-cache", "--explain-decisions"])
    out = capsys.readouterr().out
    assert "generated 12 tokens" in out
    assert "serve_dispatch_depth" in out
