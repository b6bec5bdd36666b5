"""The port's paged KV path on the CPU against the JAX package's: the
plain ``paged_flash_attention`` against ``paged_flash_attention_pallas``
in interpret mode over permuted page tables with garbage rows, the paged
pool's refcount / copy-on-write invariants under random interleavings,
stale-page poisoning, and paged serving's tokens against the port's
contiguous pool and the JAX paged scheduler."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.kernels.flash_attention import paged_flash_attention_pallas
from repro.models import lm as jlm
from repro.serve import ServeScheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import strict
from repro_torch.core.acc import AdaptiveCoreChunk, StaticCoreChunk
from repro_torch.core.adaptive import adaptive
from repro_torch.core.executor import SequentialExecutor
from repro_torch.kernels import flash_attention as tfa
from repro_torch.serve import (PagedKVCachePool, PagePoolExhaustedError,
                               RequestState, ServeScheduler,
                               SlotOverflowError)

# Kernel tolerances of tests/test_torch_kernels.py: f32 the same
# arithmetic summed in another order; bf16 one bf16 step (2^-8 relative).
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams),
                                    tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


# ---------------------------------------------------------------------------
# kernel 3: plain version vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

def _paged_inputs(seed, b, hq, hkv, sq, d, ps, max_len):
    """Random K/V laid into a randomly permuted page table; rows past each
    lane's length hold finite garbage (7.5e4) that must not leak."""
    rng = np.random.RandomState(seed)
    nblk = -(-max_len // ps)
    n_pages = 1 + b * nblk
    kv_lens = rng.randint(sq, nblk * ps + 1, size=b).astype(np.int32)
    q = rng.randn(b, hq, sq, d).astype(np.float32)
    kf = rng.randn(b, hkv, nblk * ps, d).astype(np.float32)
    vf = rng.randn(b, hkv, nblk * ps, d).astype(np.float32)
    pt = rng.permutation(np.arange(1, n_pages)).reshape(b, nblk) \
        .astype(np.int32)
    ks = np.full((n_pages * ps, hkv, d), 7.5e4, np.float32)
    vs = np.full((n_pages * ps, hkv, d), 7.5e4, np.float32)
    ks[:ps] = vs[:ps] = 0.0
    for lane in range(b):
        for j in range(nblk):
            lo, hi = j * ps, min((j + 1) * ps, int(kv_lens[lane]))
            if hi <= lo:
                continue
            rows = slice(pt[lane, j] * ps, pt[lane, j] * ps + (hi - lo))
            ks[rows] = kf[lane, :, lo:hi].transpose(1, 0, 2)
            vs[rows] = vf[lane, :, lo:hi].transpose(1, 0, 2)
    return q, ks, vs, pt, kv_lens, kf, vf


CASES = [  # (sq, group, d, ps)
    (1, 1, 64, 8), (1, 2, 128, 16), (1, 2, 64, 64),
    (2, 2, 128, 8), (2, 1, 64, 16),
    (4, 2, 64, 8), (4, 1, 128, 16), (4, 2, 128, 64),
    (8, 1, 64, 8), (8, 2, 128, 16), (8, 1, 64, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,group,d,ps", CASES)
def test_paged_attention_plain_matches_pallas(sq, group, d, ps, dtype):
    hkv = 2
    q, ks, vs, pt, lens, _, _ = _paged_inputs(
        sq * 1000 + ps + d, 2, hkv * group, hkv, sq, d, ps, 96)
    jt = getattr(jnp, dtype)
    ref = paged_flash_attention_pallas(
        jnp.asarray(q, jt), jnp.asarray(ks, jt), jnp.asarray(vs, jt),
        jnp.asarray(pt), jnp.asarray(lens), page_size=ps, interpret=True)
    tt = getattr(torch, dtype)
    out = tfa.paged_flash_attention(
        torch.from_numpy(q).to(tt), torch.from_numpy(ks).to(tt),
        torch.from_numpy(vs).to(tt), torch.from_numpy(pt),
        torch.from_numpy(lens), page_size=ps)
    assert out.dtype == tt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("ps", [8, 16, 64])
def test_paged_plain_equals_contiguous_plain(ps):
    """Over the same K/V the plain paged version is the contiguous plain
    version (the property the two kernels hold bit for bit on the card)."""
    q, ks, vs, pt, lens, kf, vf = _paged_inputs(ps, 3, 4, 2, 4, 16, ps, 80)
    lens_t = torch.from_numpy(lens)
    paged = tfa.paged_flash_attention(
        torch.from_numpy(q), torch.from_numpy(ks), torch.from_numpy(vs),
        torch.from_numpy(pt), lens_t, page_size=ps)
    contiguous = tfa.flash_attention(torch.from_numpy(q),
                                     torch.from_numpy(kf),
                                     torch.from_numpy(vf), lens_t)
    np.testing.assert_allclose(paged.numpy(), contiguous.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_paged_wrapper_checks_reject_bad_inputs():
    q = torch.randn(2, 4, 1, 16)
    store = torch.randn(5 * 8, 2, 16)
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([3, 9], dtype=torch.int32)
    tfa._check_paged(q, store, store, pt, lens, 8)              # valid
    with pytest.raises(ValueError, match="whole pages"):
        tfa._check_paged(q, store[:-1], store[:-1], pt, lens, 8)
    with pytest.raises(ValueError, match="int32"):
        tfa._check_paged(q, store, store, pt.long(), lens, 8)
    with pytest.raises(ValueError, match=r"lie in \[0, 5\)"):
        tfa._check_paged(q, store, store, pt + 1, lens, 8)
    with pytest.raises(TypeError):
        tfa._check_paged(q.half(), store.half(), store.half(), pt, lens, 8)
    with pytest.raises(ValueError, match="multiple"):
        tfa._check_paged(q, torch.randn(40, 3, 16), torch.randn(40, 3, 16),
                         pt, lens, 8)


def test_cpu_tensors_never_count_a_paged_launch():
    tfa.paged_launches.reset()
    q, ks, vs, pt, lens, _, _ = _paged_inputs(0, 1, 2, 1, 1, 8, 8, 16)
    tfa.paged_flash_attention(torch.from_numpy(q), torch.from_numpy(ks),
                              torch.from_numpy(vs), torch.from_numpy(pt),
                              torch.from_numpy(lens), page_size=8)
    assert tfa.paged_launches.count == 0


# ---------------------------------------------------------------------------
# the pool: refcount / CoW invariants under random interleavings
# ---------------------------------------------------------------------------

def _rows(cfg, rng, seg):
    """A batch-of-1 contiguous row list covering ``seg`` tokens."""
    h, d = cfg.n_kv_heads, cfg.head_dim_
    return [{"k": torch.from_numpy(rng.randn(1, h, seg, d).astype(
                np.float32)),
             "v": torch.from_numpy(rng.randn(1, h, seg, d).astype(
                 np.float32))}
            for _ in cfg.layer_kinds()]


def _check_refcounts(pool):
    """Every page's refcount equals the references the host holds: table
    entries plus prefix-cache entries (page 0 pinned)."""
    expected = [0] * pool.n_pages
    expected[0] = 1
    for slot in range(pool.n_slots):
        for pid in pool.page_tables[slot]:
            if pid:
                expected[pid] += 1
    for entry in pool._prefix.values():
        expected[entry.page] += 1
    assert pool.page_refs == expected, (pool.page_refs, expected)
    free = set(pool._free_pages)
    assert 0 not in free
    for pid in range(1, pool.n_pages):
        assert (pool.page_refs[pid] == 0) == (pid in free), pid
    assert pool.allocations == 1
    assert pool.pages_in_use() <= pool.n_pages - 1


def _cow_case(cfg, ops, seed):
    rng = np.random.RandomState(seed)
    pool = PagedKVCachePool(cfg, 3, 32, page_size=8, dtype=torch.float32,
                            device="cpu")
    base = tuple(int(t) for t in rng.randint(0, cfg.vocab_size, 20))
    prompts = [base, base[:16] + tuple((t + 1) % cfg.vocab_size
                                       for t in base[16:]), base[:9]]
    snapshots = {}      # prefix key -> layer-0 K rows at registration
    live = {}           # slot -> prompt tokens

    def snapshot(pid):
        ps = pool.page_size
        return pool.caches[0]["k"][pid * ps:(pid + 1) * ps].clone()

    for op, which, arg in ops:
        if op == 0 and pool.free_slots():          # admit with prefix
            toks = prompts[which]
            slot, reused = pool.acquire_with_prefix(f"r{arg}", toks)
            assert reused < len(toks)
            live[slot] = toks
        elif op == 1 and live:                     # prefill + publish
            slot = sorted(live)[which % len(live)]
            toks = live[slot]
            start = pool.positions[slot]
            if start < len(toks):
                pool.ensure_writable(slot, start, len(toks))
                pool.write_slot(slot, _rows(cfg, rng, pool.max_len),
                                start, len(toks))
                pool.positions[slot] = len(toks)
                pool.register_prefix(slot, toks)
                for j in range(-(-len(toks) // pool.page_size)):
                    end = min((j + 1) * pool.page_size, len(toks))
                    key = toks[:end]
                    if key in pool._prefix and key not in snapshots:
                        snapshots[key] = snapshot(pool._prefix[key].page)
        elif op == 2 and live:                     # decode one token
            slot = sorted(live)[which % len(live)]
            pos = pool.positions[slot]
            if pos < pool.max_len:
                pool.ensure_writable(slot, pos, pos + 1)
                for j in range(pos // pool.page_size,
                               -(-(pos + 1) // pool.page_size)):
                    assert pool.page_refs[pool.page_tables[slot][j]] == 1
                pool.write_slot(slot, _rows(cfg, rng, pool.max_len), pos,
                                pos + 1)
                pool.positions[slot] = pos + 1
        elif op == 3 and live:                     # fork CoW
            src = sorted(live)[which % len(live)]
            slot = pool.fork(src, f"f{arg}")
            if slot is not None:
                live[slot] = live[src]
        elif op == 4 and live:                     # release
            slot = sorted(live)[which % len(live)]
            pool.release(slot)
            del live[slot]
        _check_refcounts(pool)

    # Registered prefix pages were never mutated, whatever interleaving
    # of admits, writes, forks and releases ran above.
    for key, snap in snapshots.items():
        entry = pool._prefix.get(key)
        if entry is None:
            continue        # evicted for space
        assert torch.equal(snapshot(entry.page), snap), key


@pytest.mark.parametrize("seed", [0, 7, 91, 2024])
def test_cow_refcount_invariants(models, seed):
    _, _, tcfg, _ = models
    rng = np.random.RandomState(seed * 31 + 5)
    ops = [(int(rng.randint(0, 5)), int(rng.randint(0, 3)),
            int(rng.randint(0, 2**16))) for _ in range(24)]
    _cow_case(tcfg, ops, seed)


def test_stale_page_raises_under_strict(models, monkeypatch):
    _, _, tcfg, _ = models
    monkeypatch.setattr(strict, "_FORCED", True)
    pool = PagedKVCachePool(tcfg, 2, 32, page_size=8, device="cpu")
    s1 = pool.acquire("a")
    s2 = pool.acquire("b")
    pool.ensure_writable(s1, 0, 8)
    pool.ensure_writable(s2, 0, 8)
    freed = pool.page_tables[s2][0]
    pool.release(s2)                 # page freed -> poisoned
    assert freed in pool._poisoned
    pool.page_tables[s1][1] = freed  # a stale-table bug
    with pytest.raises(strict.StalePageError):
        pool.page_table_array()
    with pytest.raises(strict.StalePageError):
        pool.read_slot(s1)
    # Re-acquisition clears the poison: the page is valid again.
    pool.page_tables[s1][1] = 0
    pool.ensure_writable(s1, 8, 16)
    assert pool.page_tables[s1][1] not in pool._poisoned
    assert pool.page_table_array().dtype == torch.int32


@pytest.mark.parametrize("bad", [-1, "n_pages"])
def test_page_table_array_rejects_entries_outside_the_store(models, bad):
    """The pool checks every entry on its host copy before the upload:
    the kernel would trap on one outside the store."""
    _, _, tcfg, _ = models
    pool = PagedKVCachePool(tcfg, 2, 32, page_size=8, device="cpu")
    slot = pool.acquire("a")
    pool.ensure_writable(slot, 0, 8)
    assert pool.page_table_array().shape == (2, 4)
    pool.page_tables[slot][2] = pool.n_pages if bad == "n_pages" else bad
    with pytest.raises(ValueError, match="outside the store"):
        pool.page_table_array()


def test_cow_source_pages_survive_release(models):
    """Releasing a slot whose pages the prefix cache still references
    must not free them (refcount, not ownership, decides)."""
    _, _, tcfg, _ = models
    pool = PagedKVCachePool(tcfg, 2, 32, page_size=8, device="cpu")
    toks = tuple(range(16))
    slot, reused = pool.acquire_with_prefix("a", toks)
    assert reused == 0
    pool.ensure_writable(slot, 0, 16)
    pool.positions[slot] = 16
    pool.register_prefix(slot, toks)
    pages = [pool.page_tables[slot][j] for j in range(2)]
    pool.release(slot)
    for pid in pages:
        assert pool.page_refs[pid] == 1      # the cache still holds them
        assert pid not in pool._poisoned
    slot2, reused2 = pool.acquire_with_prefix("b", toks + (1, 2))
    assert reused2 == 16
    assert [pool.page_tables[slot2][j] for j in range(2)] == pages


def test_cow_copy_and_slot_io_round_trip(models):
    """A copy-on-write copies the page's rows in every layer and store;
    ``write_slot`` then ``read_slot`` returns the rows written."""
    _, _, tcfg, _ = models
    pool = PagedKVCachePool(tcfg, 2, 24, page_size=8, dtype=torch.float32,
                            device="cpu")
    rng = np.random.RandomState(3)
    slot = pool.acquire("a")
    pool.ensure_writable(slot, 0, 24)
    row = _rows(tcfg, rng, 24)
    pool.write_slot(slot, row, 0, 24)
    back = pool.read_slot(slot)
    for c, r in zip(back, row, strict=True):
        assert torch.equal(c["k"], r["k"]) and torch.equal(c["v"], r["v"])
    other = pool.fork(slot, "b")
    src = pool.page_tables[slot][1]
    assert pool.page_refs[src] == 2
    assert pool.ensure_writable(other, 9, 10)
    dst = pool.page_tables[other][1]
    assert dst != src and pool.cow_copies == 1
    for c in pool.caches:
        for name in ("k", "v"):
            assert torch.equal(c[name][dst * 8:(dst + 1) * 8],
                               c[name][src * 8:(src + 1) * 8])
    with pytest.raises(SlotOverflowError):
        pool.ensure_writable(slot, 20, 25)


def test_exhausted_pool_evicts_then_raises(models):
    _, _, tcfg, _ = models
    pool = PagedKVCachePool(tcfg, 2, 16, page_size=8, n_pages=4,
                            device="cpu")
    a = pool.acquire("a")
    pool.ensure_writable(a, 0, 16)
    pool.positions[a] = 16
    pool.register_prefix(a, tuple(range(16)))
    pool.release(a)                      # pages stay in the prefix cache
    b = pool.acquire("b")
    pool.ensure_writable(b, 0, 16)       # needs both: evicts LRU entries
    assert pool.prefix_evictions >= 1
    b2 = pool.fork(b, "b2")
    pool.ensure_writable(b2, 0, 1)       # CoW: evicts the last entry
    assert pool.prefix_stats()["prefix_entries"] == 0
    with pytest.raises(PagePoolExhaustedError):
        pool.ensure_writable(b2, 8, 9)   # every page is a live slot's


def test_paged_pool_refuses_windows_and_meshes(models):
    _, _, tcfg, _ = models
    with pytest.raises(ValueError, match="SWA"):
        PagedKVCachePool(tcfg, 2, 16, window=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedKVCachePool(tcfg, 2, 16, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# paged serving: tokens against the contiguous pool and the JAX scheduler
# ---------------------------------------------------------------------------

def _trace():
    """5 requests: prompt lengths 5-40, 4-9 new tokens (seeded)."""
    rng = np.random.default_rng(13)
    return [(rng.integers(0, 256, int(rng.integers(5, 41))),
             int(rng.integers(4, 10))) for _ in range(5)]


def _serve(sched, trace):
    rids = [sched.submit(p, m) for p, m in trace]
    outs = sched.run_until_idle()
    return [outs[r] for r in rids], [dataclasses.astuple(t)
                                     for t in sched.trace]


@pytest.mark.parametrize("depth", [1, 4])
def test_paged_tokens_match_contiguous_and_jax(models, depth):
    """f32, fixed chunk decisions (StaticCoreChunk) on both sides: the
    port's paged tokens equal its contiguous tokens and the JAX paged
    scheduler's, tick for tick."""
    jcfg, jparams, tcfg, tparams = models
    trace = _trace()
    ref = JaxScheduler(jcfg, jparams, n_slots=2, max_len=64,
                       acc=JaxStatic(cores=2), dispatch_depth=depth,
                       paged=True, page_size=8)
    ref_out, ref_ticks = _serve(ref, trace)
    kw = dict(n_slots=2, max_len=64, acc=StaticCoreChunk(cores=2),
              dispatch_depth=depth, device="cpu")
    contiguous, _ = _serve(ServeScheduler(tcfg, tparams, **kw), trace)
    sched = ServeScheduler(tcfg, tparams, paged=True, page_size=8, **kw)
    paged, ticks = _serve(sched, trace)
    assert paged == contiguous == ref_out
    assert ticks == ref_ticks
    assert [len(o) for o in paged] == [m for _, m in trace]
    assert sched.pool.allocations == 1
    assert sched.pool.free_slots() == 2


def _adaptive_sched(tcfg, tparams, **kw):
    return ServeScheduler(
        tcfg, tparams, n_slots=kw.pop("n_slots", 2),
        max_len=kw.pop("max_len", 48),
        executor=adaptive(SequentialExecutor(), AdaptiveCoreChunk()),
        device="cpu", **kw)


def test_prefix_reuse_does_not_change_tokens(models):
    """Identical prompts resubmitted: later requests map the first's
    pages read-only — hits go up, tokens do not move."""
    _, _, tcfg, tparams = models
    prompt = np.random.default_rng(3).integers(0, 256, 23)
    ref_sched = _adaptive_sched(tcfg, tparams, dispatch_depth="auto")
    ref_sched.warmup()
    r = ref_sched.submit(prompt, max_new_tokens=6)
    ref = ref_sched.run_until_idle()[r]
    sched = _adaptive_sched(tcfg, tparams, dispatch_depth="auto",
                            paged=True, page_size=8)
    sched.warmup()
    outs = []
    for _ in range(3):
        rid = sched.submit(prompt, max_new_tokens=6)
        outs.append(sched.run_until_idle()[rid])
        sched.clear_finished()
    assert outs == [ref, ref, ref]
    stats = sched.pool.prefix_stats()
    assert stats["prefix_hits"] >= 2
    assert stats["prefill_tokens_avoided"] > 0
    assert stats["cow_copies"] >= 1
    assert sched.pool.allocations == 1


def test_paged_requires_fused_decode(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="fused"):
        ServeScheduler(tcfg, tparams, n_slots=2, max_len=32, paged=True,
                       device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        ServeScheduler(tcfg, tparams, n_slots=2, max_len=32, paged=True,
                       dispatch_depth=2, page_size="big", device="cpu")


def test_page_size_and_interleave_decisions(models):
    _, _, tcfg, tparams = models
    # depth=1 keeps r1 decoding one token per tick, so the second
    # request's prefill lands while a decode lane is live.
    sched = _adaptive_sched(tcfg, tparams, dispatch_depth=1, paged=True)
    sched.warmup()
    model = sched.decision_model()
    entries = model.trace.entries("serve_page_size")
    assert entries, "page geometry was not decided through the model"
    assert sched.pool.page_size == entries[0].decision.chunk
    prompt = np.random.default_rng(5).integers(0, 256, 12)
    r1 = sched.submit(prompt, max_new_tokens=16)
    for _ in range(20):
        sched.tick()
        if sched.requests[r1].state is RequestState.DECODE:
            break
    sched.submit(prompt[:8], max_new_tokens=4)
    for _ in range(40):
        if not sched.pending:
            break
        sched.tick()
    sched.results()
    assert model.trace.entries("serve_prefill_interleave"), \
        "no serve_prefill_interleave decisions were traced"
    assert "serve_page_size" in model.explain()


def test_fixed_page_size_and_interleave_are_traced(models):
    _, _, tcfg, tparams = models
    sched = _adaptive_sched(tcfg, tparams, dispatch_depth=1, paged=True,
                            page_size=16, prefill_interleave=1)
    sched.warmup()
    prompt = np.random.default_rng(6).integers(0, 256, 12)
    r1 = sched.submit(prompt, max_new_tokens=8)
    for _ in range(20):
        sched.tick()
        if sched.requests[r1].state is RequestState.DECODE:
            break
    sched.submit(prompt[:7], max_new_tokens=3)
    sched.submit(prompt[:9], max_new_tokens=3)
    sched.run_until_idle()
    model = sched.decision_model()
    size = model.trace.entries("serve_page_size")[-1].decision
    assert size.chunk == 16 and size.policy == "fixed-page-size"
    inter = model.trace.entries("serve_prefill_interleave")
    assert inter and all(e.decision.chunk == 1 for e in inter)
