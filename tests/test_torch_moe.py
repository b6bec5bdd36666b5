"""Mixture-of-experts on the CPU against the JAX package: mixtral-8x22b
(gated SiLU experts, sliding window) and grok-1-314b (gated GELU
experts, full attention) at their reduced sizes.

Same weights (the reference's ``init_params`` bridged through numpy),
same inputs (seeded numpy).  ``moe.apply`` with its kept and dropped
choices, ``lm.forward`` with its aux loss, every gradient leaf of
``loss_fn``, bf16 compute with the router kept f32, the scheduler's
greedy tokens (mixtral on the ring, grok on both pools, speculative and
streamed), the decode step bodies with experts inside, the reference's
capacity rule under chunking and padding (ROADMAP.md, faults of the
reference), and a spy that the MoE path reads nothing back to the host
and calls neither ``F.one_hot`` nor ``index_add_``.  The MoE layer on
the card runs only there (``chip_smoke.py`` phase 10).

Tolerances: f32 on both sides, sums in other orders: 1e-5 on outputs
and logits, 1e-6 on the aux loss, gradients within 1e-3 of each leaf's
norm.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve import ServeScheduler as JaxScheduler
from repro.serve import decode_loop as jdl
from repro.train.autotune import serve_profiles as jserve_profiles
from repro_torch import bridge, tree
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.acc import StaticCoreChunk
from repro_torch.data import make_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serve import ServeFrontend, ServeScheduler
from repro_torch.serve import decode_loop as tdl
from repro_torch.train.autotune import serve_profiles

MIXTRAL, GROK = "mixtral-8x22b", "grok-1-314b"
MOE = (MIXTRAL, GROK)
TOL = 1e-5


def _cfgs(name: str, **changes):
    return (dataclasses.replace(jax_config(name).reduced(), **changes),
            dataclasses.replace(get_config(name).reduced(), **changes))


def _params(name: str, seed: int = 0, dtype=None, **changes):
    """(jcfg, jparams, tcfg, tparams): the reduced arch's reference
    weights and the port's copy of them (in ``dtype``, the compute dtype
    by default)."""
    jcfg, tcfg = _cfgs(name, **changes)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu", dtype=dtype)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=MOE)
def arch(request):
    return _params(request.param)


@pytest.fixture(scope="module")
def grok():
    return _params(GROK)


@pytest.fixture(scope="module")
def mixtral():
    return _params(MIXTRAL)


def _layer0(jparams, tcfg):
    """Layer 0's MoE weights: the reference's leaves and the port's."""
    arrays = jax.tree.map(lambda a: np.asarray(a)[0],
                          jparams["blocks"]["pos0"]["moe"])
    port = {k: ({kk: torch.from_numpy(vv.copy()) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v.copy()))
            for k, v in arrays.items()}
    return jax.tree.map(jnp.asarray, arrays), port


class _Record:
    """Records the arguments of ``module._dispatch_compute_combine``."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        real = module._dispatch_compute_combine

        def spy(tokens, gate_idx, gate_w, p, cfg, capacity):
            self.calls.append((np.asarray(gate_idx), capacity))
            return real(tokens, gate_idx, gate_w, p, cfg, capacity)

        monkeypatch.setattr(module, "_dispatch_compute_combine", spy)


def _keep(gate_idx: np.ndarray, e: int, capacity: int) -> np.ndarray:
    """The kept choices by the reference's rule, in numpy: a choice's
    place is the count of earlier choices (token-major) of its expert."""
    flat = gate_idx.reshape(-1)
    seen = np.zeros(e, dtype=np.int64)
    keep = np.zeros(flat.shape, dtype=bool)
    for i, ex in enumerate(flat):
        keep[i] = seen[ex] < capacity
        seen[ex] += 1
    return keep


# ---------------------------------------------------------------------------
# configs, bridge, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_configs_are_the_reference_numbers_and_registered(name):
    assert name in ARCH_NAMES
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jax_config(name))
    tlm.check_ported(get_config(name))
    jp, jd = jserve_profiles(jax_config(name))
    tp, td = serve_profiles(get_config(name))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert get_config(name).active_param_count() == \
        jax_config(name).active_param_count()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bridge_unstacks_the_experts_and_keeps_the_router_f32(dtype):
    jcfg, jparams, tcfg, tparams = _params(GROK, dtype=dtype)
    arrays = jax.tree.map(np.asarray, jparams)
    e, d, ff = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    for layer, p in enumerate(tparams["layers"]):
        assert "ffn" not in p
        m = p["moe"]
        assert m["router"]["w"].dtype == torch.float32
        assert m["router"]["w"].shape == (d, e)
        for name, shape in (("w_up", (e, d, ff)), ("w_gate", (e, d, ff)),
                            ("w_down", (e, ff, d))):
            assert m[name].shape == shape and m[name].dtype == dtype
            np.testing.assert_array_equal(
                m[name].float().numpy(), torch.from_numpy(
                    arrays["blocks"]["pos0"]["moe"][name][layer]).to(
                        dtype).float().numpy())
        np.testing.assert_array_equal(
            m["router"]["w"].numpy(),
            arrays["blocks"]["pos0"]["moe"]["router"]["w"][layer])
    n_ref = sum(a.size for a in jax.tree.leaves(arrays))
    assert sum(t.numel() for t in tree.leaves(tparams)) == n_ref


def test_init_params_draws_the_reference_shapes_and_scales():
    cfg = get_config(MIXTRAL).reduced()
    p = tlm.init_params(0, dataclasses.replace(cfg, compute_dtype="bfloat16"),
                        device="cpu")
    m = p["layers"][1]["moe"]
    assert m["router"]["w"].dtype == torch.float32
    assert m["w_up"].dtype == m["w_down"].dtype == torch.bfloat16
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert m["w_gate"].shape == (e, d, ff) and m["w_down"].shape == (e, ff, d)
    # d^-0.5 for the router and every expert weight, w_down too (within
    # four standard errors of a sample's std, sigma / sqrt(2n)).
    for w in (m["router"]["w"], m["w_up"], m["w_down"]):
        assert float(w.float().std()) == pytest.approx(
            d ** -0.5, rel=4 / (2 * w.numel()) ** 0.5)


# ---------------------------------------------------------------------------
# the MoE layer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [8.0, 1.25])
@pytest.mark.parametrize("name", MOE)
def test_moe_apply_matches_the_reference(name, factor, monkeypatch):
    """t = 64 tokens: drop-free at capacity factor 8.0; at 1.25 the
    capacity is 40 places for 32 expected choices per expert, choices
    drop, and the dropped sets are the reference's."""
    jcfg, jparams, tcfg, _ = _params(name, capacity_factor=factor)
    jp, tp = _layer0(jparams, tcfg)
    rng = np.random.default_rng(3)
    # Tokens that share a direction, as a layer's hidden states do, so
    # that the router favours some experts.
    x = (rng.standard_normal((4, 16, 64))
         + 2.0 * rng.standard_normal(64)).astype(np.float32)
    jrec, trec = _Record(monkeypatch, jmoe), _Record(monkeypatch, tmoe)
    jout, jaux = jmoe.apply(jp, jnp.asarray(x), jcfg)
    tout, taux = tmoe.apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    (jidx, jcap), (tidx, tcap) = jrec.calls[0], trec.calls[0]
    assert tcap == jcap == tmoe.capacity(64, tcfg)
    np.testing.assert_array_equal(tidx, jidx)
    _, keep = tmoe.placement(torch.from_numpy(tidx), tcfg, tcap)
    ref_keep = _keep(jidx, tcfg.n_experts, jcap)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert (~ref_keep).any() == (factor == 1.25)


def test_capacity_is_the_reference_rule():
    cfg = get_config(GROK)
    assert [tmoe.capacity(t, cfg) for t in (1, 8, 16, 72, 256, 4600)] == \
        [1, 8, 16, 22, 80, 1437]
    red = get_config(GROK).reduced()
    assert tmoe.capacity(64, red) == 256            # 8.0: drop-free


def test_forward_logits_and_aux_match_the_reference(arch):
    jcfg, jparams, tcfg, tparams = arch
    batch = make_batch(tcfg, 2, 24, kind="train", seed=1, device="cpu")
    jlogits, jaux = jlm.forward(jparams, {"tokens": jnp.asarray(
        batch["tokens"].numpy())}, jcfg)
    with torch.no_grad():
        logits, aux = tlm.forward(tparams, batch, tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    assert float(jaux) > 0.0
    assert abs(float(aux) - float(jaux)) <= 1e-6
    jloss = float(jlm.loss_fn(jparams, {k: jnp.asarray(v.numpy())
                                        for k, v in batch.items()}, jcfg))
    with torch.no_grad():
        loss = float(tlm.loss_fn(tparams, batch, tcfg))
        loss_remat = float(tlm.loss_fn(tparams, batch, tcfg, remat=True))
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert loss_remat == loss


def _jax_leaf(jtree, path):
    if path[0] == "layers":
        node = jtree["blocks"]["pos0"]
        for key in path[2:]:
            node = node[key]
        return np.asarray(node, np.float32)[path[1]]
    node = jtree
    for key in path:
        node = node[key]
    return np.asarray(node, np.float32)


def test_every_gradient_leaf_matches_jax_grad(arch):
    jcfg, jparams, tcfg, tparams = arch
    batch = make_batch(tcfg, 2, 24, kind="train", seed=2, device="cpu")
    jgrads = jax.grad(jlm.loss_fn)(
        jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, jcfg)
    flat = [p.detach().requires_grad_() for p in tree.leaves(tparams)]
    loss = tlm.loss_fn(tree.unflatten(tparams, flat), batch, tcfg)
    grads = tree.unflatten(tparams, torch.autograd.grad(loss, flat))
    paths = tree.with_paths(grads)
    # embed, final norm, lm head; per layer 2 norms, 4 attention
    # weights, the router and 3 expert stacks.
    assert len(paths) == 3 + tcfg.n_layers * 10
    for path, g in paths:
        ref = _jax_leaf(jgrads, path)
        assert g.shape == ref.shape, path
        err = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref),
                                                    1e-30)
        assert err < 1e-3, (path, err)


def test_bf16_compute_with_the_router_in_f32(monkeypatch):
    """grok at bf16 compute, the router kept f32.  Each MoE layer of the
    port, given the reference's own bf16 input to that layer, picks the
    reference's experts and agrees at bf16's precision; in the whole
    forward, layer 0 (the same input in both) routes identically.  Later
    layers' inputs differ by bf16 roundings of other summation orders,
    which may flip a near-tie (this seed: one choice of 64 in layer 1,
    probabilities 0.2859 against 0.2850), so they are compared one layer
    at a time."""
    jcfg, jparams, tcfg, tparams = _params(GROK, compute_dtype="bfloat16")
    assert tparams["layers"][0]["moe"]["router"]["w"].dtype == torch.float32
    assert tparams["layers"][0]["moe"]["w_up"].dtype == torch.bfloat16
    batch = make_batch(tcfg, 2, 16, kind="train", seed=4, device="cpu")
    seen = []
    real = jmoe._dispatch_compute_combine

    def spy(tokens, gate_idx, gate_w, p, cfg, cap):
        out = real(tokens, gate_idx, gate_w, p, cfg, cap)
        seen.append((np.asarray(tokens.astype(jnp.float32)),
                     np.asarray(gate_idx), np.asarray(out, np.float32)))
        return out

    monkeypatch.setattr(jmoe, "_dispatch_compute_combine", spy)
    with jax.disable_jit():
        jlm.forward(jparams, {"tokens": jnp.asarray(
            batch["tokens"].numpy())}, jcfg)
    trec = _Record(monkeypatch, tmoe)
    with torch.no_grad():
        logits, aux = tlm.forward(tparams, batch, tcfg)
    assert logits.dtype == torch.bfloat16 and bool(logits.isfinite().all())
    assert len(seen) == len(trec.calls) == tcfg.n_layers
    np.testing.assert_array_equal(trec.calls[0][0], seen[0][1])
    for layer, (x, idx, ref) in enumerate(seen):
        with torch.no_grad():
            out, _ = tmoe.apply(tparams["layers"][layer]["moe"],
                                torch.from_numpy(x).to(torch.bfloat16)[None],
                                tcfg)
        np.testing.assert_array_equal(trec.calls[-1][0], idx)
        err = np.abs(out[0].float().numpy() - ref).max()
        assert err <= 2e-2 * np.abs(ref).max(), (layer, err)


# ---------------------------------------------------------------------------
# the reference's capacity rule: a token depends on its batch
# ---------------------------------------------------------------------------

def _last_row(fwd, params, cfg, caches, toks, chunks, pad_to=None):
    """Prefill ``toks`` (1, P) in ``chunks`` (lengths), the last chunk
    zero-padded to ``pad_to`` rows; the last real row's logits."""
    start = 0
    for n in chunks:
        piece = toks[:, start:start + n]
        last = n - 1
        if pad_to is not None and start + n == toks.shape[1]:
            piece = np.pad(piece, ((0, 0), (0, pad_to - n)))
        logits, caches = fwd(params, piece, caches, start, cfg, last)
        start += n
    return np.asarray(logits, np.float32)[:, 0]


def test_capacity_makes_a_token_depend_on_its_chunk_as_in_the_reference():
    """mixtral-8x22b reduced at capacity factor 1.25 (window off: the
    reference's chunked ring is not causal, a fault of its own): one
    prompt of 64 prefilled as one chunk (capacity 40), as two of 32
    (capacity 20 each) and as one padded to 128 (capacity 80).  The
    reference's last-row logits differ between the three, since other
    choices drop; the port's equal the reference's in each case."""
    jcfg, jparams, tcfg, tparams = _params(MIXTRAL, capacity_factor=1.25,
                                           attn_window=None)
    toks = np.random.default_rng(6).integers(0, 256, (1, 64))

    def jfwd(params, piece, caches, start, cfg, last):
        return jlm.forward_cached(params, jnp.asarray(piece), caches, start,
                                  cfg, logit_index=last)

    def tfwd(params, piece, caches, start, cfg, last):
        return tlm.forward_cached(params, torch.from_numpy(piece), caches,
                                  start, cfg, logit_index=last)

    ref, port = {}, {}
    for case, chunks, pad in (("one", [64], None), ("two", [32, 32], None),
                              ("padded", [64], 128)):
        ref[case] = _last_row(jfwd, jparams, jcfg,
                              jlm.init_caches(jcfg, 1, 128), toks, chunks,
                              pad)
        with torch.no_grad():
            port[case] = _last_row(
                tfwd, tparams, tcfg,
                tlm.init_caches(tcfg, 1, 128, device="cpu"), toks, chunks,
                pad)
        np.testing.assert_allclose(port[case], ref[case], atol=TOL, rtol=0)
    assert np.abs(ref["one"] - ref["two"]).max() > 1e-3
    assert np.abs(ref["one"] - ref["padded"]).max() > 1e-3


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _trace():
    """4 requests, prompts 9-40 tokens (two past the reduced window of
    16), 6 new tokens each."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 256, n), 6) for n in (20, 33, 9, 40)]


def _serve(sched, trace):
    rids = [sched.submit(p, m) for p, m in trace]
    outs = sched.run_until_idle()
    return [outs[r] for r in rids]


@pytest.mark.parametrize("paged", [False, True])
def test_grok_tokens_identical_to_jax(grok, paged):
    """f32 greedy tokens on fixed chunk decisions, prefill chunks padded
    to their bucket in both (the pad rows take capacity places in
    both)."""
    jcfg, jparams, tcfg, tparams = grok
    trace = _trace()
    kw = dict(n_slots=2, max_len=64, dispatch_depth=2)
    if paged:
        kw.update(paged=True, page_size=8)
    ref = _serve(JaxScheduler(jcfg, jparams, acc=JaxStatic(cores=2), **kw),
                 trace)
    sched = ServeScheduler(tcfg, tparams, acc=StaticCoreChunk(cores=2),
                           device="cpu", **kw)
    assert sched._pad_ok
    assert _serve(sched, trace) == ref
    assert [len(o) for o in ref] == [m for _, m in trace]


def test_mixtral_ring_tokens_identical_to_jax(mixtral):
    """Mixtral on the ring (contiguous, window 16): the JAX scheduler's
    tokens with prefill chunks of 1, where its ring is exact; no chunk
    is padded in either (the window)."""
    jcfg, jparams, tcfg, tparams = mixtral
    kw = dict(n_slots=2, max_len=64, dispatch_depth=2, chunk_buckets=(1,))
    ref = _serve(JaxScheduler(jcfg, jparams, acc=JaxStatic(cores=2), **kw),
                 _trace())
    sched = ServeScheduler(tcfg, tparams, acc=StaticCoreChunk(cores=2),
                           device="cpu", **kw)
    assert not sched._pad_ok
    assert _serve(sched, _trace()) == ref
    assert sched.pool.caches[0]["k"].shape[2] == tcfg.attn_window


@pytest.fixture(scope="module")
def rollout(mixtral):
    """Each trace prompt's greedy continuation by the reference's
    ``lm.forward`` (window 16, drop-free at the reduced capacity factor
    8.0) over the whole sequence."""
    jcfg, jparams, _, _ = mixtral
    fwd = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t}, jcfg)[0])
    outs = []
    for prompt, n in _trace():
        seq = list(prompt)
        for _ in range(n):
            padded = np.zeros((1, 48), dtype=np.int32)
            padded[0, :len(seq)] = seq
            logits = np.asarray(fwd(jparams, jnp.asarray(padded)))
            seq.append(int(logits[0, len(seq) - 1].argmax()))
        outs.append(seq[len(prompt):])
    return outs


@pytest.mark.parametrize("chunk", [5, 16])
def test_mixtral_ring_tokens_equal_the_reference_rollout(mixtral, rollout,
                                                         chunk):
    _, _, tcfg, tparams = mixtral
    sched = ServeScheduler(tcfg, tparams, n_slots=2, max_len=64,
                           acc=StaticCoreChunk(cores=2),
                           chunk_buckets=(chunk,), dispatch_depth=4,
                           device="cpu")
    assert _serve(sched, _trace()) == rollout


def test_mixtral_refusals_stay(mixtral):
    _, _, tcfg, tparams = mixtral
    kw = dict(n_slots=2, max_len=64, dispatch_depth=2, device="cpu")
    with pytest.raises(ValueError, match="full attention"):
        ServeScheduler(tcfg, tparams, speculate=2, **kw)
    with pytest.raises(ValueError, match="SWA"):
        ServeScheduler(tcfg, tparams, paged=True, page_size=8, **kw)


def _spec_prompts():
    motif = [7, 3, 11, 5]
    rng = np.random.RandomState(4)
    return [((motif * 5)[:14], 9), (list(rng.randint(0, 256, 9)), 7),
            ((motif * 3)[:6], 8)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_grok_spec_tokens_identical_to_greedy(grok, d, paged):
    _, _, tcfg, tparams = grok
    kw = dict(n_slots=3, max_len=64, dispatch_depth=4, device="cpu",
              acc=StaticCoreChunk(cores=2))
    if paged:
        kw.update(paged=True, page_size=8)
    ref = _serve(ServeScheduler(tcfg, tparams, **kw), _spec_prompts())
    sched = ServeScheduler(tcfg, tparams, speculate=d, **kw)
    assert _serve(sched, _spec_prompts()) == ref
    assert sched.spec_stats()["verifies"] > 0


def test_grok_streamed_tokens_equal_batch(grok):
    _, _, tcfg, tparams = grok
    kw = dict(n_slots=2, max_len=48, dispatch_depth=3, device="cpu",
              acc=StaticCoreChunk(cores=2), paged=True, page_size=8)
    prompts = [p for p, _ in _trace()[:3]]
    batch = _serve(ServeScheduler(tcfg, tparams, **kw),
                   [(p, 5) for p in prompts])

    async def go():
        async with ServeFrontend(ServeScheduler(tcfg, tparams, **kw)) as fe:
            streams = [await fe.submit(p, 5) for p in prompts]
            return [[t async for t in s] for s in streams]

    assert asyncio.run(go()) == batch


# ---------------------------------------------------------------------------
# the decode step bodies with experts inside, against the JAX steps
# ---------------------------------------------------------------------------

N, MAX_LEN, PS, DEPTH = 3, 48, 8, 8
POSS = [5, 9, 12]
BUDGETS = [[7, 0, 3], [2, 5, 0]]


def _contiguous(cfg, seed, rows=MAX_LEN):
    rng = np.random.default_rng(seed)
    shape = (N, cfg.n_kv_heads, rows, cfg.head_dim_)
    return [{name: rng.standard_normal(shape).astype(np.float32)
             for name in ("k", "v")} for _ in range(cfg.n_layers)]


def _paged(cfg, seed):
    rng = np.random.default_rng(seed)
    per = MAX_LEN // PS
    shape = ((1 + N * per) * PS, cfg.n_kv_heads, cfg.head_dim_)
    stores = [{name: rng.standard_normal(shape).astype(np.float32)
               for name in ("k", "v")} for _ in range(cfg.n_layers)]
    table = (1 + rng.permutation(N * per)).reshape(N, per).astype(np.int32)
    return stores, table


def _hist(seed, toks):
    hist = np.random.default_rng(seed).integers(0, 6, (N, 16)).astype(
        np.int64)
    hist[:, :3] = -1
    hist[:, -1] = toks
    return hist


def _toks(seed):
    return np.random.default_rng(seed).integers(0, 256, N).astype(np.int64)


def _t(tree_):
    return [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
            for c in tree_]


def _j(tree_):
    return [{k: jnp.asarray(v) for k, v in c.items()} for c in tree_]


def _close(tcaches, jcaches, skip_rows=0):
    for t, j in zip(tcaches, jcaches, strict=True):
        for name in ("k", "v"):
            np.testing.assert_allclose(t[name].numpy()[skip_rows:],
                                       np.asarray(j[name])[skip_rows:],
                                       atol=TOL, rtol=TOL)


def _i32(x):
    return jnp.asarray(x, jnp.int32)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("budgets", BUDGETS)
def test_fused_step_with_experts_matches_jax(grok, budgets, paged):
    jcfg, jparams, tcfg, tparams = grok
    toks = _toks(2)
    if paged:
        (kv, table) = _paged(tcfg, 3)
        jc, jout, jtoks = jdl.make_paged_decode_step(
            jcfg, page_size=PS, max_len=MAX_LEN, max_depth=DEPTH)(
                jparams, _j(kv), jnp.asarray(table), _i32(toks), _i32(POSS),
                _i32(budgets))
        tc, tout, ttoks = tdl.make_paged_decode_step(
            tcfg, page_size=PS, max_depth=DEPTH)(
                tparams, _t(kv), torch.from_numpy(table),
                torch.from_numpy(toks), torch.tensor(POSS), budgets)
    else:
        kv = _contiguous(tcfg, 1)
        jc, jout, jtoks = jdl.make_fused_decode_step(jcfg, max_depth=DEPTH)(
            jparams, _j(kv), _i32(toks), _i32(POSS), _i32(budgets))
        tc, tout, ttoks = tdl.make_fused_decode_step(tcfg, max_depth=DEPTH)(
            tparams, _t(kv), torch.from_numpy(toks), torch.tensor(POSS),
            budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close(tc, jc, skip_rows=PS if paged else 0)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_spec_step_with_experts_matches_jax(grok, d, paged):
    """Verify windows of N lanes x (d + 1) rows route together: idle and
    spent lanes' rows take capacity places in lane order in both."""
    jcfg, jparams, tcfg, tparams = grok
    toks = _toks(6)
    hist = _hist(7, toks)
    budgets = BUDGETS[0]
    if paged:
        kv, table = _paged(tcfg, 8)
        jc, jhist, jout, jtoks, jstats = jdl.make_paged_spec_decode_step(
            jcfg, depth=d, page_size=PS, max_len=MAX_LEN, max_depth=DEPTH)(
                jparams, _j(kv), jnp.asarray(table), _i32(hist), _i32(toks),
                _i32(POSS), _i32(budgets))
        tc, thist, tout, ttoks, tstats, _ = tdl.make_paged_spec_decode_step(
            tcfg, depth=d, page_size=PS, max_depth=DEPTH)(
                tparams, _t(kv), torch.from_numpy(table),
                torch.from_numpy(hist), torch.from_numpy(toks),
                torch.tensor(POSS), budgets)
    else:
        kv = _contiguous(tcfg, 5)
        jc, jhist, jout, jtoks, jstats = jdl.make_spec_decode_step(
            jcfg, depth=d, max_depth=DEPTH)(
                jparams, _j(kv), _i32(hist), _i32(toks), _i32(POSS),
                _i32(budgets))
        tc, thist, tout, ttoks, tstats, _ = tdl.make_spec_decode_step(
            tcfg, depth=d, max_depth=DEPTH)(
                tparams, _t(kv), torch.from_numpy(hist),
                torch.from_numpy(toks), torch.tensor(POSS), budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    _close(tc, jc, skip_rows=PS if paged else 0)


def test_windowed_fused_step_with_experts_matches_jax(mixtral):
    """Mixtral's fused step over a ring pool (lanes before the wrap, past
    it, two laps on) against the JAX step, whose token-by-token ring is
    exact."""
    jcfg, jparams, tcfg, tparams = mixtral
    kv = _contiguous(tcfg, 9, rows=tcfg.attn_window)
    toks, poss, budgets = _toks(10), [5, 20, 37], [7, 0, 3]
    jc, jout, jtoks = jdl.make_fused_decode_step(jcfg, max_depth=DEPTH)(
        jparams, _j(kv), _i32(toks), _i32(poss), _i32(budgets))
    tc, tout, ttoks = tdl.make_fused_decode_step(
        tcfg, window=tcfg.attn_window, max_depth=DEPTH)(
            tparams, _t(kv), torch.from_numpy(toks), torch.tensor(poss),
            budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close(tc, jc)


# ---------------------------------------------------------------------------
# the MoE path on the device: no host read, no index-validating op
# ---------------------------------------------------------------------------

# Ops that read a value back to the host (``.item()``, a boolean-mask
# index, ``nonzero``), or whose results on the card have no fixed order.
_BANNED = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
           "aten.one_hot", "aten.index_add", "aten.repeat_interleave")


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name.startswith(("aten.index", "aten._unsafe_index")) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for a in args if isinstance(a, (list, tuple)) for i in a):
            name = "aten.nonzero (a boolean-mask index)"
        self.names.append(name)
        return func(*args, **(kwargs or {}))


def _banned(names):
    return sorted({n for n in names if n.startswith(_BANNED)})


def test_the_spy_sees_what_it_bans():
    with _Ops() as ops:
        F.one_hot(torch.tensor([1, 0, 2]), 3)
        torch.zeros(3).index_add_(0, torch.tensor([0, 0]), torch.ones(2))
        torch.tensor([1.0, 2.0])[torch.tensor([True, False])]
    banned = _banned(ops.names)
    assert "aten._local_scalar_dense" in banned or "aten.one_hot" in banned
    assert "aten.index_add_" in banned
    assert "aten.nonzero (a boolean-mask index)" in banned


@pytest.mark.parametrize("paged", [False, True])
def test_moe_path_makes_no_host_read(grok, monkeypatch, paged):
    """Every MoE layer of one fused decode step (the body a CUDA graph
    captures) records no host read and neither ``one_hot`` nor
    ``index_add``; ``F.one_hot`` and ``Tensor.index_add_`` are never
    called.  (The CPU's plain paged attention checks its table on the
    host; that check is the CPU path's alone, so the spy listens inside
    the MoE layers.)"""
    _, _, tcfg, tparams = grok
    called, layers = [], []
    monkeypatch.setattr(F, "one_hot", lambda *a, **k: called.append(1))
    monkeypatch.setattr(torch.Tensor, "index_add_",
                        lambda *a, **k: called.append(2))
    real = tmoe.apply

    def listen(p, x, cfg):
        with _Ops() as ops:
            out = real(p, x, cfg)
        layers.append(ops.names)
        return out

    monkeypatch.setattr(tmoe, "apply", listen)
    toks = torch.from_numpy(_toks(2))
    if paged:
        kv, table = _paged(tcfg, 3)
        tdl.make_paged_decode_step(tcfg, page_size=PS, max_depth=DEPTH)(
            tparams, _t(kv), torch.from_numpy(table), toks,
            torch.tensor(POSS), [2, 2, 2])
    else:
        tdl.make_fused_decode_step(tcfg, max_depth=DEPTH)(
            tparams, _t(_contiguous(tcfg, 1)), toks, torch.tensor(POSS),
            [2, 2, 2])
    assert not called
    assert len(layers) == 2 * tcfg.n_layers          # two steps
    for names in layers:
        assert "aten.topk" in names and "aten.index_copy" in names
        assert _banned(names) == []


def test_moe_layer_runs_on_meta_tensors():
    """Every shape is static: the layer runs on meta tensors (any host
    read would raise) and gives the input's shape."""
    cfg = get_config(GROK).reduced()
    p = tlm.init_params(0, cfg, device="cpu")["layers"][0]["moe"]
    meta = {k: ({kk: vv.to("meta") for kk, vv in v.items()}
                if isinstance(v, dict) else v.to("meta"))
            for k, v in p.items()}
    out, aux = tmoe.apply(meta, torch.empty(3, 9, cfg.d_model,
                                            device="meta"), cfg)
    assert out.shape == (3, 9, cfg.d_model) and out.device.type == "meta"
    assert aux.shape == ()


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_serve_cli_takes_the_moe_archs(name, capsys):
    launch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--no-cal-cache"])
    out = capsys.readouterr().out
    assert f"arch={name} device=cpu requests=3" in out
    assert "generated" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", MOE)
def test_serve_cli_without_a_card_raises(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", name, "--reduced", "--requests", "3",
                           "--slots", "2", "--no-cal-cache"])
