"""Measured kernel plans for kernels 1-3 (``kernels/autotune.py``,
``kernels/tuning.py``, ``kernels/ops.py``) on the CPU: candidate
legality at the main path's shapes and the ten archs' heads, the store
(round trip through ``persistent``, hardware and variant keyed apart, a
bucket-mate's winner capped, an illegal winner measured again), one plan
for both attention kernels, a lookup miss under a capture, the graphs'
scratch and capture key, and the served path against the untuned
scheduler and the JAX package's (the port of
``tests/test_kernel_autotune.py``'s tests of the same names).  On the
CPU every probe runs the plain version: the timings mean nothing, the
keys and the plans' effects are what is held here."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.serve import ServeScheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.acc import StaticCoreChunk
from repro_torch.core.calibration import CalibrationCache
from repro_torch.kernels import autotune, build, ops, tuning
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels.autotune import KernelTuner, shape_bucket
from repro_torch.models import flags
from repro_torch.serve import ServeScheduler
from repro_torch.serve import decode_loop as tdl
from repro_torch.serve import graphs as tgraphs

from test_torch_graph_step import _meta, _meta_inputs, card, meta_model  # noqa: F401

DTYPES = (torch.bfloat16, torch.float32)
# The main path: 8 slots of 1024 positions, decode / verify widths, the
# prefill buckets.
SLOTS, MAX_LEN = 8, 1024
WIDTHS = (1, 2, 4, 8, 16, 64, 256)
EXTENTS = (1, 40, 700, 1024, 1040)


def _tuner(tmp_path=None, hardware="hw-a"):
    cache = CalibrationCache() if tmp_path is None \
        else CalibrationCache.persistent(str(tmp_path))
    return KernelTuner(cache, repeats=1, hardware=hardware)


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_attention_candidates_are_legal(arch, dtype):
    """At the arch's heads, every main-path width and kv extent: the
    prior first, no duplicates, each plan one the wrapper takes
    (``check_plan``: split chunks whole split tiles, tile schedules the
    dtype runs), within the extent rounded up to a tile, and its scratch
    within what the graphs reserve for the step's widths."""
    cfg = get_config(arch)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    for sq in WIDTHS:
        prior = kfa.attention_plan(SLOTS, hq, hkv, sq, dtype)
        for skv in EXTENTS:
            cands = tuning.candidates_attention(SLOTS, hq, hkv, sq, skv,
                                                dtype)
            assert cands and len(set(cands)) == len(cands)
            assert cands[0] == tuning.cap_attention(
                kfa.with_value(prior, prior.chunk), skv) \
                if prior.path == "split" else cands[0] == prior
            reserve = tuning.attention_scratch_reserve(
                SLOTS, hq, hkv, tdl.STEP_WIDTHS, skv, dtype, cfg.head_dim_)
            for p in cands:
                kfa.check_plan("test", p, SLOTS, hq, hkv, sq, dtype)
                if p.path == "split":
                    assert p.chunk % p.kv_tile == 0
                    assert p.kv_tile <= p.chunk <= tuning.round_up(
                        skv, p.kv_tile)
                    if sq in tdl.STEP_WIDTHS:
                        assert p.scratch_bytes(skv, cfg.head_dim_) \
                            <= reserve
                else:
                    assert p.block_rows in kfa.tile_schedules(dtype)
                    assert p.scratch_bytes(skv, cfg.head_dim_) == 0


def test_candidates_at_the_main_path():
    """qwen3-0.6b decode in bf16: 256 keys a split first, then a quarter,
    a half, twice and four times it; prefill: the wgmma warpgroup, then
    the 16-row loop; f32 prefill has its one schedule; kernel 1: the
    default warps first."""
    dec = tuning.candidates_attention(8, 16, 8, 1, 1024, torch.bfloat16)
    assert [p.chunk for p in dec] == [256, 64, 128, 512, 1024]
    pre = tuning.candidates_attention(1, 16, 8, 256, 1024, torch.bfloat16)
    assert [(p.block_rows, p.tensor_cores) for p in pre] == [
        (64, True), (16, False)]
    assert [p.block_rows for p in tuning.candidates_attention(
        1, 16, 8, 256, 1024, torch.float32)] == [16]
    assert krms.WARPS == (8, 4, 2, 1) and krms.WARPS[0] == krms.DEFAULT_WARPS


@pytest.mark.parametrize("bad", [
    dict(chunk=48), dict(chunk=0), dict(block_rows=64, tensor_cores=True),
    dict(path="tile")])
def test_the_wrappers_refuse_an_illegal_plan(bad):
    """A plan off its path, a chunk not whole split tiles, or a tile
    schedule the dtype does not run raises in both wrappers, on the CPU
    as on the card."""
    q = torch.zeros(2, 4, 1, 16)
    k = torch.zeros(2, 2, 40, 16)
    split = kfa.attention_plan(2, 4, 2, 1, torch.float32)
    plan = dataclasses.replace(split, **bad)
    with pytest.raises(ValueError, match="not legal"):
        kfa.flash_attention(q, k, k, plan=plan)
    store = torch.zeros(48, 2, 16)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([5, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="not legal"):
        kfa.paged_flash_attention(q, store, store, table, lens, page_size=8,
                                  plan=plan)
    f32_tile = kfa.attention_plan(1, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="not legal"):
        kfa.check_plan("x", kfa.with_value(f32_tile, kfa.TILE_ROWS), 1, 4,
                       2, 64, torch.float32)
    with pytest.raises(ValueError, match="warps"):
        krms.rmsnorm(torch.zeros(2, 16), torch.ones(16), warps=3)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def _attend(tuner, *, skv=1024, sq=1, causal=True, window=None, run=None,
            dtype=torch.bfloat16):
    calls = []

    def probe(plan):
        calls.append(plan)
        return None if run is None else run(plan)

    plan = tuner.plan_attention(8, 16, 8, sq, skv, 128, probe, dtype=dtype,
                                causal=causal, window=window)
    return plan, calls


def test_winner_round_trip_and_hardware_apart(tmp_path):
    """A winner measured once persists through ``persistent``: a second
    tuner over the store searches nothing and takes the same plan; a
    tuner on other hardware keys apart (searches, and the first
    hardware's winner stays); kernel 1's warps the same way."""
    t1 = KernelTuner.persistent(str(tmp_path), repeats=1, hardware="hw-a")
    faster = {64: 3.0, 128: 2.0, 256: 4.0, 512: 1.0, 1024: 5.0}
    p1, calls = _attend(t1, run=lambda p: faster[p.chunk])
    assert t1.searches == 1 and p1.chunk == 512 and len(calls) == 10
    report = t1.reports[-1]
    assert report.prior == (256,) and report.winner == (512,)
    assert report.prior_seconds == 4.0 and report.winner_seconds == 1.0
    w1 = t1.plan_rows("rmsnorm", 8, 1024, lambda w: {8: 2.0, 4: 1.0}.get(
        w, 3.0), dtype=torch.bfloat16)
    assert w1 == 4
    t2 = KernelTuner.persistent(str(tmp_path), repeats=1, hardware="hw-a")
    p2, calls = _attend(t2)
    assert p2 == p1 and not calls
    assert t2.plan_rows("rmsnorm", 8, 1024, pytest.fail,
                        dtype=torch.bfloat16) == 4
    assert (t2.searches, t2.cache_hits) == (0, 2)
    t3 = KernelTuner.persistent(str(tmp_path), repeats=1, hardware="hw-b")
    _, calls = _attend(t3)
    assert t3.searches == 1 and calls
    t4 = KernelTuner.persistent(str(tmp_path), repeats=1, hardware="hw-a")
    assert _attend(t4)[0] == p1 and t4.searches == 0


def test_cpu_and_card_key_apart():
    """With no pinned hardware the kernel 1-3 keys name the call's
    device: a CPU winner never answers for the card."""
    t = KernelTuner(CalibrationCache(), repeats=1)
    cpu = t.attention_key(8, 16, 8, 1, 1024, 128, dtype=torch.float32,
                          device="cpu")
    card = t.attention_key(8, 16, 8, 1, 1024, 128, dtype=torch.float32,
                           device="cuda")
    assert cpu.hardware.startswith("cpu:") and card.hardware.startswith(
        "cuda:") and cpu.cache_key() != card.cache_key()


def test_variant_keys_apart():
    """causal and window change the work a plan does: each keys apart;
    the same variant again reads the winner held in memory."""
    t = _tuner()
    for causal, window in ((True, None), (False, None), (True, 64),
                           (True, None)):
        _attend(t, causal=causal, window=window)
    assert t.searches == 3


def test_bucket_mates_winner_is_capped_to_the_call():
    """A winner measured at 1024 keys (four times the prior) serves a
    700-key call of the same bucket capped to 704 (the extent in whole
    split tiles): no new search; splits past the extent are empty
    either way."""
    t = _tuner()
    p, _ = _attend(t, run=lambda plan: 1.0 / plan.chunk)
    assert p.chunk == 1024
    assert shape_bucket(700) == shape_bucket(1024)
    q, calls = _attend(t, skv=700)
    assert q.chunk == tuning.round_up(700, 64) == 704 and not calls
    assert t.searches == 1


def test_an_illegal_persisted_winner_is_measured_again():
    """A stored chunk that is not whole split tiles (a torn or foreign
    record) is measured again, not launched."""
    t = _tuner()
    key = t.attention_key(8, 16, 8, 1, 1024, 128, dtype=torch.bfloat16)
    t.cache.set_tuned(key.cache_key(), {"chunk": 48, "hw": "hw-a"})
    rkey = t.rows_key("rmsnorm", 8, 1024, dtype=torch.float32)
    t.cache.set_tuned(rkey.cache_key(), {"warps": 3, "hw": "hw-a"})
    p, calls = _attend(t)
    assert t.searches == 1 and calls and p.chunk % 64 == 0
    assert t.plan_rows("rmsnorm", 8, 1024, lambda w: None,
                       dtype=torch.float32) in krms.WARPS
    assert t.searches == 2


def test_both_attention_kernels_resolve_one_plan():
    """Kernel 2 over the contiguous cache and kernel 3 over the pages of
    the same K/V (the same call): one key, one search, one plan; their
    outputs agree bit for bit (the plain versions here)."""
    t = _tuner()
    rng = np.random.default_rng(3)
    b, hq, hkv, d, ps, n_blocks = 2, 4, 2, 16, 8, 4
    skv = ps * n_blocks
    q = torch.from_numpy(rng.standard_normal((b, hq, 1, d)).astype(
        np.float32))
    kc = torch.from_numpy(rng.standard_normal((b, hkv, skv, d)).astype(
        np.float32))
    lens = torch.tensor([11, 30], dtype=torch.int32)
    table = (1 + torch.arange(b * n_blocks, dtype=torch.int32)).reshape(
        b, n_blocks)
    store = torch.zeros((1 + b * n_blocks) * ps, hkv, d)
    rows = (table.long()[:, :, None] * ps + torch.arange(ps)).reshape(b, -1)
    store[rows.reshape(-1)] = kc.permute(0, 2, 1, 3).reshape(-1, hkv, d)
    with t.recording() as held:
        out2 = ops.flash_attention(q, kc, kc, lens, tuner=t)
        out3 = ops.paged_flash_attention(q, store, store, table, lens,
                                         page_size=ps, tuner=t)
    assert t.searches == 1 and torch.equal(out2, out3)
    assert len(held) == 1


def test_a_miss_during_a_capture_raises(monkeypatch):
    """A lookup that misses while a graph is captured raises (a search
    would synchronise inside the capture); one already resolved does
    not."""
    t = _tuner()
    plan, _ = _attend(t)
    monkeypatch.setattr(build, "capturing", lambda: True)
    assert _attend(t)[0] == plan
    with pytest.raises(RuntimeError, match="captured"):
        _attend(t, sq=2)
    with pytest.raises(RuntimeError, match="captured"):
        t.plan_rows("rmsnorm", 8, 1024, lambda w: None, dtype=torch.float32)
    assert t.searches == 1


def test_probes_count_no_launch_and_return_device_seconds():
    """The probes' own launches are taken back from the counters, and a
    probe's returned seconds stand in for the wall clock."""
    t = _tuner()
    before = krms.launches.count
    x = torch.randn(8, 64)
    ops.rmsnorm(x, torch.ones(64), tuner=t)
    assert krms.launches.count == before
    assert autotune.device_seconds(lambda: None, torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# the graphs: scratch reserve and the capture key (card branch on meta)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_graphs_reserve_every_candidates_scratch_and_recapture_on_a_new_winner(  # noqa: E501
        meta_model, card, paged):
    """With a tuner the eager step before the capture resolves every
    plan (the capture misses nothing), the scratch is sized for the
    largest plan any candidate takes, the winners join the graph's key:
    forgetting them captures anew, and the launches carry the plans."""
    tcfg, params = meta_model
    caches, table = _meta_inputs(tcfg, paged)
    graphs = tgraphs.DecodeGraphs()
    t = _tuner()
    kw = dict(kernel_tuner=t, max_depth=8, graphs=graphs)
    step = tdl.make_paged_decode_step(tcfg, page_size=8, **kw) if paged \
        else tdl.make_fused_decode_step(tcfg, **kw)
    args = (table,) if paged else ()
    step(params, caches, *args, _meta(3), _meta(3), [3, 1, 2])
    assert dict(graphs.captures) == {"fused": 1} and graphs.replays == 2
    assert t.searches > 0 and step.runner._plans
    assert graphs.scratch_bytes == tuning.attention_scratch_reserve(
        3, tcfg.n_heads, tcfg.n_kv_heads, tdl.STEP_WIDTHS, 48,
        torch.float32, tcfg.head_dim_)
    step(params, caches, *args, _meta(3), _meta(3), [2, 2, 2])
    assert dict(graphs.captures) == {"fused": 1}
    t.forget()
    card.calls.clear()
    step(params, caches, *args, _meta(3), _meta(3), [2, 2, 2])
    assert dict(graphs.captures) == {"fused": 2} and t.cache_hits > 0
    name = "repro_paged_flash_attention" if paged else \
        "repro_flash_attention"
    chunks = {a[-3] for n, a in card.calls if n == name}
    plans = [w for k, w in step.runner._plans if "attention" in k]
    assert plans and chunks == {w[0] for w in plans}
    warps = {a[-3] for n, a in card.calls if n == "repro_add_rmsnorm"}
    assert warps <= set(krms.WARPS)


# ---------------------------------------------------------------------------
# the served path on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams),
                                    tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_kernel_tuner_same_tokens(models, paged):
    """Reduced qwen3-0.6b, f32, on the CPU: the tuned scheduler (every
    prefill and decode forward under the tuner) gives the untuned one's
    tokens and the JAX package's, after measured searches; a second
    tuner over the same store searches nothing."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (10, 17)]

    def run(sched):
        rids = [sched.submit(p, max_new_tokens=4) for p in prompts]
        outs = sched.run_until_idle()
        return [list(outs[r]) for r in rids]

    kw = dict(n_slots=2, max_len=32, dispatch_depth=2)
    port_kw = dict(kw, acc=StaticCoreChunk(cores=2), device="cpu",
                   paged=paged, **({"page_size": 8} if paged else {}))
    cache = CalibrationCache()
    tuner = KernelTuner(cache, repeats=1)
    tuned = run(ServeScheduler(tcfg, tparams, kernel_tuner=tuner,
                               **port_kw))
    base = run(ServeScheduler(tcfg, tparams, **port_kw))
    ref = run(JaxScheduler(jcfg, jparams, **kw))
    assert tuned == base == [[int(t) for t in r] for r in ref]
    assert tuner.searches > 0
    again = KernelTuner(cache, repeats=1)
    assert run(ServeScheduler(tcfg, tparams, kernel_tuner=again,
                              **port_kw)) == base
    # Every call the first tuner answered (searched, or a bucket-mate's
    # winner read back) is a store hit for the second.
    assert again.searches == 0
    assert again.cache_hits == tuner.searches + tuner.cache_hits


@pytest.mark.parametrize("paged", [False, True])
def test_warmup_is_analytic_and_live_lanes_are_probed(models, monkeypatch,
                                                      paged):
    """``warmup`` measures the prefill buckets' plans (a first chunk at
    position 0, one lane) but runs the decode steps' analytic plans (its
    lanes hold no request); the decode plans are searched on the first
    dispatch over a full pool, and every attention probe is the served
    call itself: the live lanes' own lengths, never a lane at an extent
    it was not at.  With one request in two slots the pool never fills
    and the decode step keeps its analytic plans."""
    _, _, tcfg, tparams = models
    seen = []
    name = "paged_flash_attention" if paged else "flash_attention"
    real = getattr(kfa, name)

    def spy(*a, **k):
        if k.get("plan") is not None:
            seen.append(a[4 if paged else 3].clone())
        return real(*a, **k)

    monkeypatch.setattr(kfa, name, spy)
    tuner = KernelTuner(CalibrationCache(), repeats=1)
    sched = ServeScheduler(tcfg, tparams, n_slots=2, max_len=32,
                           dispatch_depth=2, acc=StaticCoreChunk(cores=2),
                           kernel_tuner=tuner, device="cpu", paged=paged,
                           **({"page_size": 8} if paged else {}))
    sched.warmup()
    assert seen and all(lens.numel() == 1 for lens in seen)
    warm = tuner.searches
    rng = np.random.default_rng(6)
    sched.submit(rng.integers(0, tcfg.vocab_size, 12), max_new_tokens=4)
    sched.run_until_idle()
    assert not [lens for lens in seen if lens.numel() == 2]
    assert tuner.searches == warm and not sched._tuned_steps
    for n in (10, 17):
        sched.submit(rng.integers(0, tcfg.vocab_size, n), max_new_tokens=4)
    sched.run_until_idle()
    assert tuner.searches > warm and sched._tuned_steps == {"fused"}
    decode = [lens for lens in seen if lens.numel() == 2]
    assert decode and all(int(lens.max()) <= 17 + 4 for lens in decode)
    # The first probe: a full pool, a live lane's own length.
    assert int(decode[0].max()) >= 10
    assert any(int(lens.min()) >= 10 for lens in decode)


def test_the_attention_probe_is_the_call_itself(monkeypatch):
    """Each candidate is timed on the call's own q, K/V and lengths (the
    same tensors), and the call then runs with the winner."""
    seen = []
    real = kfa.flash_attention

    def spy(q, k, v, kv_lens=None, **kw):
        seen.append((q, k, v, kv_lens, kw["plan"]))
        return real(q, k, v, kv_lens, **kw)

    monkeypatch.setattr(kfa, "flash_attention", spy)
    t = _tuner()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 1, 16, generator=g)
    k = torch.randn(2, 2, 300, 16, generator=g)
    lens = torch.tensor([37, 250], dtype=torch.int32)
    ops.flash_attention(q, k, k, lens, tuner=t)
    assert t.searches == 1
    cands = tuning.candidates_attention(2, 4, 2, 1, 300, torch.float32)
    assert len(seen) == 2 * len(cands) + 1
    assert all(a is q and b is k and c is k and d is lens
               for a, b, c, d, _ in seen)
    assert {p for *_, p in seen[:-1]} == set(cands)


def test_the_model_layers_pass_no_plan_without_a_tuner(monkeypatch):
    """With no tuner set the layers pass nothing (``warps=None``,
    ``plan=None``): the analytic plans and today's bits hold."""
    seen = []
    real = krms.add_rmsnorm

    def spy(*a, **k):
        seen.append(k.get("warps"))
        return real(*a, **k)

    monkeypatch.setattr(krms, "add_rmsnorm", spy)
    from repro_torch.models import common as cm

    assert flags.KERNEL_TUNER is None
    cm.add_rmsnorm({"g": torch.ones(8)}, torch.zeros(2, 8), torch.zeros(2, 8))
    with flags.kernel_tuner(_tuner()):
        cm.add_rmsnorm({"g": torch.ones(8)}, torch.zeros(2, 8),
                       torch.zeros(2, 8))
    assert seen[0] is None and seen[1] in krms.WARPS
