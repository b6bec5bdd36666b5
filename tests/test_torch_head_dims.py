"""Every head dim the reference's kernels take, on the CPU.

Two shapes the card used to refuse.  The reduced configs' head dim 16
has no register layout in kernel 1's rotary entry
(``rmsnorm.rope_has_layout``), so the model runs its q/k-norm as the
unfused composition there: kernel 1's ``rmsnorm`` on q and on k, then
``apply_rope`` (``models.common.qk_norm_rope``).  Kernels 2 and 3 take
head dims up to 256 in steps of 8 (two classes: padded to 128 or to
256).  Here: the composition against the fused entry's plain version
(values and gradients), the model's dispatch by shape on meta tensors,
the reduced qwen3's served tokens against the JAX package's at head dims
16 and 256, kernel 2's plain version at head dims past 128 against the
reference's ``flash_attention_pallas`` in interpret mode, kernel 3's
plain version against kernel 2's, and the wrappers' head-dim rule.  The
CUDA kernels run only on the card (``chip_smoke.py`` phase 20).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import lm as jlm
from repro.serve import ServeScheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.acc import StaticCoreChunk
from repro_torch.core.calibration import CalibrationCache
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import tuning
from repro_torch.kernels.autotune import KernelTuner
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.serve import ServeScheduler

from test_torch_rmsnorm_grad import _meta, card  # noqa: F401

DTYPES = (torch.float32, torch.bfloat16)


def _qk_inputs(d: int, dtype, seed: int = 0):
    rng = np.random.default_rng(seed + d)
    b, length, hq, hkv = 2, 5, 4, 2
    q = torch.from_numpy(rng.standard_normal((b, length, hq, d))
                         .astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((b, length, hkv, d))
                         .astype(np.float32)).to(dtype)
    gq = torch.from_numpy(1 + 0.1 * rng.standard_normal(d)
                          .astype(np.float32))
    gk = torch.from_numpy(1 + 0.1 * rng.standard_normal(d)
                          .astype(np.float32))
    cos, sin = tcm.rope_angles(torch.arange(length).repeat(b, 1), d, 1e4)
    dq = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)
                          ).to(dtype)
    dk = torch.from_numpy(rng.standard_normal(k.shape).astype(np.float32)
                          ).to(dtype)
    return q, k, gq, gk, cos.contiguous(), sin.contiguous(), dq, dk


# ---------------------------------------------------------------------------
# C.8: q/k-norm at a head dim the rotary entry has no layout for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dtype,has", [
    (16, torch.float32, False), (16, torch.bfloat16, False),
    (32, torch.float32, True), (32, torch.bfloat16, False),
    (64, torch.bfloat16, True), (128, torch.float32, True),
    (256, torch.float32, True), (256, torch.bfloat16, True),
    (512, torch.float32, True), (1024, torch.float32, False),
    (1024, torch.bfloat16, True), (2048, torch.bfloat16, False),
    (24, torch.float32, False),
])
def test_rope_layout_predicate(d, dtype, has):
    """8..128 vectors of 16 bytes (``_ROPE_VECTORS``): head dims 32..512
    in f32 and 64..1024 in bf16, powers of two."""
    assert krms.rope_has_layout(d, dtype) is has


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 32, 64])
def test_unfused_qk_norm_matches_the_fused_plain_version(d, dtype,
                                                         monkeypatch):
    """The model's composition with the predicate forced to "no layout"
    (``QKNormThenRopeFn``: ``rmsnorm`` on q and k, then the rotation;
    its backward the rotation's transpose, then ``rmsnorm_bwd``) against
    the fused entry's plain version (``QKNormRopeFn``:
    ``qk_norm_rope_ref`` and ``qk_norm_rope_bwd_ref``).  Values bit for
    bit (the same arithmetic, rounded at the same places); dq, dk, dγq,
    dγk bit for bit in f32 too, and in bf16 within 2e-2 absolute and
    relative: the composition rounds the rotated-back gradient to bf16
    for the norm's backward, the fused plain backward keeps it in f32."""
    monkeypatch.setattr(krms, "rope_has_layout", lambda d, dtype: False)
    q, k, gq, gk, cos, sin, dq, dk = _qk_inputs(d, dtype)
    eps = 1e-6
    leaves = {}
    for name in ("unfused", "fused"):
        qq, kk = q.clone().requires_grad_(), k.clone().requires_grad_()
        g1, g2 = gq.clone().requires_grad_(), gk.clone().requires_grad_()
        if name == "unfused":
            qo, ko = tcm.qk_norm_rope({"g": g1}, {"g": g2}, qq, kk, cos, sin,
                                      eps)
        else:
            qo, ko = krms.QKNormRopeFn.apply(qq, kk, g1, g2, cos, sin, eps)
        grads = torch.autograd.grad((qo, ko), (qq, kk, g1, g2), (dq, dk))
        leaves[name] = (qo.detach(), ko.detach(), *grads)
    fused_q, fused_k = krms.qk_norm_rope_ref(q, k, gq, gk, cos, sin, eps)
    assert torch.equal(leaves["unfused"][0], fused_q)
    assert torch.equal(leaves["unfused"][1], fused_k)
    assert torch.equal(leaves["fused"][0], fused_q)
    for a, b in zip(leaves["unfused"][2:], leaves["fused"][2:], strict=True):
        assert a.dtype == b.dtype
        if dtype == torch.float32:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [16, 128])
def test_model_dispatches_qk_norm_by_shape_on_the_card(card, d):
    """On the card's branch (meta tensors), f32: head dim 16 launches
    kernel 1's ``rmsnorm`` twice (q, then k) and the rotary entry never;
    head dim 128 launches the rotary entry once.  Each launch is kernel
    1's: no plain version runs."""
    dtype = torch.float32
    q, k = _meta(2, 3, 4, d, dtype=dtype), _meta(2, 3, 2, d, dtype=dtype)
    g = torch.empty(d, device="meta")
    cos = torch.empty(2, 3, d // 2, device="meta")
    qo, ko = tcm.qk_norm_rope({"g": g}, {"g": g}, q, k, cos, cos, 1e-6)
    assert qo.shape == q.shape and ko.shape == k.shape
    names = [c[0] for c in card.calls]
    if d == 16:
        assert names == ["repro_rmsnorm", "repro_rmsnorm"]
        assert [c[1][3:5] for c in card.calls] == [(24, 16), (12, 16)]
        assert krms.entry_launches["rmsnorm"].count == 2
    else:
        assert names == ["repro_qk_norm_rope"]
        assert krms.entry_launches["qk_norm_rope"].count == 1
    assert krms.launches.count == len(names)


@pytest.mark.parametrize("dtype", DTYPES)
def test_composition_trains_through_kernel_1_on_the_card(card, dtype):
    """Under autograd on the card's branch (meta tensors), head dim 16:
    the forward launches kernel 1's ``rmsnorm`` for q and for k, the
    backward its ``rmsnorm_bwd`` for each (the rotary entry and its
    backward never), and every input gets its gradient."""
    q = _meta(2, 3, 4, 16, dtype=dtype).requires_grad_()
    k = _meta(2, 3, 2, 16, dtype=dtype).requires_grad_()
    gq = torch.empty(16, device="meta").requires_grad_()
    gk = torch.empty(16, device="meta").requires_grad_()
    cos = torch.empty(2, 3, 8, device="meta")
    qo, ko = tcm.qk_norm_rope({"g": gq}, {"g": gk}, q, k, cos, cos, 1e-6)
    assert [c[0] for c in card.calls] == ["repro_rmsnorm", "repro_rmsnorm"]
    card.calls.clear()
    torch.autograd.backward([qo, ko], [torch.empty_like(qo),
                                       torch.empty_like(ko)])
    assert [c[0] for c in card.calls] == ["repro_rmsnorm_bwd",
                                          "repro_rmsnorm_bwd"]
    assert [c[1][6:8] for c in card.calls] == [(24, 16), (12, 16)]
    assert krms.entry_launches["qk_norm_rope"].count == 0
    assert krms.bwd_entry_launches["rmsnorm"].count == 2
    assert all(t.grad is not None for t in (q, k, gq, gk))


def test_a_width_kernel_1_refuses_still_raises(card):
    """The composition is a dispatch, not a fallback: a head dim that
    is not a multiple of 8 reaches kernel 1's ``rmsnorm``, which refuses
    it, and nothing launches."""
    q, k = _meta(2, 3, 4, 12, dtype=torch.float32), \
        _meta(2, 3, 2, 12, dtype=torch.float32)
    g = torch.empty(12, device="meta")
    cos = torch.empty(2, 3, 6, device="meta")
    with pytest.raises(ValueError, match="multiple of 8"):
        tcm.qk_norm_rope({"g": g}, {"g": g}, q, k, cos, cos, 1e-6)
    assert card.calls == [] and krms.launches.count == 0


def test_reduced_forward_runs_the_composition(monkeypatch):
    """The reduced qwen3 (head dim 16, f32): per forward, the plain norm
    twice (layer 0's ln1, the final norm) and twice a layer for q and k,
    the residual adds fused, the rotary entry never: 4·L + 1 launches of
    kernel 1 on the card (9 at the reduced 2 layers)."""
    cfg = get_config("qwen3-0.6b").reduced()
    assert not krms.rope_has_layout(cfg.head_dim_, torch.float32)
    params = tlm.init_params(0, cfg, device="cpu")
    calls = dict.fromkeys(("rmsnorm", "add_rmsnorm", "qk_norm_rope"), 0)

    def spy(name):
        real = getattr(krms, name)

        def fn(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return fn

    for name in calls:
        monkeypatch.setattr(krms, name, spy(name))
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 5)))
    caches = tlm.init_caches(cfg, 2, 16, device="cpu")
    tlm.forward_cached(params, tokens, caches, 0, cfg)
    assert calls == {"rmsnorm": 2 + 2 * cfg.n_layers,
                     "add_rmsnorm": 2 * cfg.n_layers - 1, "qk_norm_rope": 0}
    assert sum(calls.values()) == 4 * cfg.n_layers + 1


# ---------------------------------------------------------------------------
# the reduced qwen3 served, against the JAX package
# ---------------------------------------------------------------------------

def _qwen3(head_dim=None):
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    if head_dim is not None:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
        tcfg = dataclasses.replace(tcfg, head_dim=head_dim)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jcfg, jparams, tcfg, tparams


def _trace():
    rng = np.random.default_rng(31)
    return [(rng.integers(0, 256, n), 6) for n in (9, 20, 33, 5)]


def _serve(sched, trace):
    rids = [sched.submit(p, m) for p, m in trace]
    outs = sched.run_until_idle()
    return [outs[r] for r in rids]


@pytest.mark.parametrize("paged", [False, True])
def test_reduced_qwen3_tokens_equal_jax_without_a_layout(paged, monkeypatch):
    """f32 greedy tokens of the reduced qwen3 (head dim 16) with the
    predicate forced to "no layout": the port's scheduler, contiguous and
    paged with speculation at 4, equals the JAX scheduler on the same
    fixed chunk decisions; the rotary entry is never called."""
    jcfg, jparams, tcfg, tparams = _qwen3()
    monkeypatch.setattr(krms, "rope_has_layout", lambda d, dtype: False)
    fused = []
    real = krms.qk_norm_rope
    monkeypatch.setattr(krms, "qk_norm_rope",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    trace = _trace()
    kw = dict(n_slots=2, max_len=64, dispatch_depth=2)
    if paged:
        kw.update(paged=True, page_size=8, speculate=4)
    ref = _serve(JaxScheduler(jcfg, jparams, acc=JaxStatic(cores=2), **kw),
                 trace)
    sched = ServeScheduler(tcfg, tparams, acc=StaticCoreChunk(cores=2),
                           device="cpu", **kw)
    assert _serve(sched, trace) == ref
    assert [len(o) for o in ref] == [m for _, m in trace]
    assert fused == []


@pytest.mark.parametrize("paged", [False, True])
def test_reduced_qwen3_at_head_dim_256_tokens_equal_jax(paged):
    """The reduced qwen3 at head dim 256 (kernels 2 and 3's wide class,
    the rotary entry's layout of 64 f32 vectors): the port's f32 greedy
    tokens, contiguous and paged with speculation at 4, equal the JAX
    scheduler's."""
    jcfg, jparams, tcfg, tparams = _qwen3(head_dim=256)
    assert krms.rope_has_layout(256, torch.float32)
    assert kfa.head_dim_class(tcfg.head_dim_) == 256
    trace = _trace()
    kw = dict(n_slots=2, max_len=64, dispatch_depth=2)
    if paged:
        kw.update(paged=True, page_size=8, speculate=4)
    ref = _serve(JaxScheduler(jcfg, jparams, acc=JaxStatic(cores=2), **kw),
                 trace)
    sched = ServeScheduler(tcfg, tparams, acc=StaticCoreChunk(cores=2),
                           device="cpu", **kw)
    assert _serve(sched, trace) == ref


# ---------------------------------------------------------------------------
# kernels 2 and 3 past head dim 128
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["causal", "window", "non-causal"])
@pytest.mark.parametrize("d", [136, 192, 256])
def test_plain_attention_matches_pallas_past_128(d, mode):
    """Kernel 2's plain version at head dims of the wide class against
    the reference's ``flash_attention_pallas`` (interpret mode), whose
    blocks carry the whole head dim: GQA group 2, 16 queries end-aligned
    to 48 keys; a window of 20; non-causal (cross-attention).  f32,
    within 2e-5 (sums in another order)."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 4, 16, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, 48, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, 48, d)).astype(np.float32)
    causal = mode != "non-causal"
    window = 20 if mode == "window" else None
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, block_q=8, block_kv=16,
                                 interpret=True)
    out = kfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_plain_equals_contiguous_plain_at_256(ps, dtype):
    """Kernel 3's plain version over a permuted table equals kernel 2's
    over the same K/V laid out contiguously, bit for bit, at head dim
    256: lanes of lengths 1, 37 and 64, decode and a 5-row verify.  The
    contiguous K/V are token-major views (B, Skv, Hkv, D) -> (B, Hkv,
    Skv, D), the strides of the gathered pages, so that both plain
    versions take one summation order."""
    rng = np.random.default_rng(ps)
    b, hq, hkv, d, skv = 3, 4, 2, 256, 64
    kc = torch.from_numpy(rng.standard_normal((b, skv, hkv, d))
                          .astype(np.float32)).to(dtype).permute(0, 2, 1, 3)
    vc = torch.from_numpy(rng.standard_normal((b, skv, hkv, d))
                          .astype(np.float32)).to(dtype).permute(0, 2, 1, 3)
    lens = torch.tensor([1, 37, 64], dtype=torch.int32)
    nblk = skv // ps
    perm = torch.from_numpy(rng.permutation(b * nblk) + 1).to(torch.int32)
    table = perm.reshape(b, nblk)
    rows = (table.long()[:, :, None] * ps + torch.arange(ps)).reshape(b, -1)
    ks = torch.zeros((1 + b * nblk) * ps, hkv, d, dtype=dtype)
    vs = torch.zeros_like(ks)
    ks[rows.reshape(-1)] = kc.permute(0, 2, 1, 3).reshape(-1, hkv, d)
    vs[rows.reshape(-1)] = vc.permute(0, 2, 1, 3).reshape(-1, hkv, d)
    for sq in (1, 5):
        q = torch.from_numpy(rng.standard_normal((b, hq, sq, d))
                             .astype(np.float32)).to(dtype)
        lanes = lens.clamp(min=sq)
        paged = kfa.paged_flash_attention(q, ks, vs, table, lanes,
                                          page_size=ps)
        assert torch.equal(paged, kfa.flash_attention(q, kc, vc, lanes))


@pytest.mark.parametrize("d", list(range(8, 257, 8)))
def test_wrappers_take_every_head_dim_to_256(d):
    """8..256 in steps of 8, both wrappers' checks (on the CPU), and its
    class: padded to 128 up to 128, to 256 above; the split path's
    partials sized for the class."""
    q = torch.zeros(2, 4, 1, d)
    k = torch.zeros(2, 2, 16, d)
    lens = torch.full((2,), 16, dtype=torch.int32)
    kfa._check(q, k, k, lens)
    store = torch.zeros(32, 2, d)
    table = torch.zeros(2, 2, dtype=torch.int32)
    kfa._check_paged(q, store, store, table, lens, 16)
    width = 128 if d <= 128 else 256
    assert kfa.head_dim_class(d) == width
    assert kfa.part_bytes(d) == 4 * kfa.SPLIT_ROWS * (width + 2)


@pytest.mark.parametrize("d", [0, 4, 12, 100, 252, 264, 512])
def test_wrappers_refuse_other_head_dims(d):
    """Not a multiple of 8, or over 256: both wrappers refuse, on any
    device, before anything launches."""
    lens = torch.full((2,), 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        kfa._check(torch.zeros(2, 4, 1, d), torch.zeros(2, 2, 16, d),
                   torch.zeros(2, 2, 16, d), lens)
    store = torch.zeros(32, 2, d)
    with pytest.raises(ValueError, match="head dim"):
        kfa.paged_flash_attention(torch.zeros(2, 4, 1, d), store, store,
                                  torch.zeros(2, 2, dtype=torch.int32),
                                  lens, page_size=16)
    with pytest.raises(ValueError, match="head dim"):
        kfa.head_dim_class(d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq", [1, 4, 9, 256])
def test_plans_at_head_dim_256_are_legal_and_fit_the_reserve(sq, dtype):
    """At qwen3-0.6b's heads and head dim 256: every candidate plan the
    tuner may pick is one the wrappers take, the measured plan is one of
    them, and the scratch a capture reserves at 256 holds each of them
    (the wide class's partials: 4128 floats a split against 2080)."""
    skv = 1024
    widths = (1, 2, 4, 8)
    reserve = tuning.attention_scratch_reserve(8, 16, 8, widths, skv, dtype,
                                               256)
    assert reserve > tuning.attention_scratch_reserve(8, 16, 8, widths, skv,
                                                      dtype, 128)
    cands = tuning.candidates_attention(8, 16, 8, sq, skv, dtype)
    for p in cands:
        kfa.check_plan("test", p, 8, 16, 8, sq, dtype)
        if sq in widths:
            assert p.scratch_bytes(skv, 256) <= reserve
    tuner = KernelTuner(CalibrationCache(), repeats=1, hardware="hw-a")
    cost = {p: float(i + 1) for i, p in enumerate(reversed(cands))}
    plan = tuner.plan_attention(8, 16, 8, sq, skv, 256, lambda p: cost[p],
                                dtype=dtype)
    assert plan in cands and plan == min(cands, key=cost.get)
