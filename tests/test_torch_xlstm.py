"""The xLSTM family on the CPU against the JAX package: xlstm-350m
(seven ``mlstm`` blocks, then an ``slstm`` block, no feed-forward) at
its reduced size (8 layers, d 64, 8 heads of 16), f32.

Same weights (the reference's ``init_params`` bridged through numpy),
same inputs (seeded numpy).  ``mlstm_apply`` and ``slstm_apply`` with
and without a state, ``lm.forward`` / ``loss_fn`` and every gradient
leaf, the per-token ``forward_cached``, the scheduler's greedy tokens
over both pools, the pools' state rows, the acquire rule for sLSTM's
``m``, a spent lane's state, kernel 1's launches per forward, and the
CLIs.  The card runs the same path at full width and depth in
``chip_smoke.py`` phase 12.

Tolerances: f32 on both sides, sums in other orders: 1e-5 on block
outputs, logits and states; 3e-4 (the reference's ``tests/test_gla.py``
tolerance, as ``test_torch_hybrid.py`` uses it) where the chunk-parallel
GLA meets another order of arithmetic; 5e-5 on the logits of the
per-token serve path, whose 8 layers each divide 17-channel state sums
by their normaliser; gradients to 1e-4 of each leaf's norm, as
``test_torch_train.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.models import lm as jlm
from repro.models import xlstm as jxlstm
from repro.serve import ServeScheduler as JaxScheduler
from repro_torch import bridge, tree
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.acc import StaticCoreChunk
from repro_torch.kernels import rmsnorm as krms
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as txlstm
from repro_torch.serve import (PagedKVCachePool, ServeScheduler,
                               SlotKVCachePool)
from repro_torch.serve import decode_loop as tdl
from repro_torch.serve.engine import prefill_segments

XLSTM = "xlstm-350m"
TOL = 1e-5
GLA_TOL = 3e-4
STACK_TOL = 5e-5
GRAD_TOL = 1e-4


def _params(seed: int = 0):
    jcfg = jax_config(XLSTM).reduced()
    tcfg = get_config(XLSTM).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def xl():
    return _params()


def _tokens(n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, length))


def _x(b: int, length: int, d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, length, d)).astype(np.float32)


def _block(jparams, tparams, cfg, layer: int, name: str):
    """The reference's and the port's parameters of one layer's block."""
    period = len(cfg.block_pattern)
    g, i = divmod(layer, period)
    jp = jax.tree.map(lambda a: a[g], jparams["blocks"][f"pos{i}"][name])
    return jp, tparams["layers"][layer][name]


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the config, the guard and the bridge
# ---------------------------------------------------------------------------

def test_config_is_the_reference_and_registered():
    assert XLSTM in ARCH_NAMES
    assert dataclasses.asdict(get_config(XLSTM)) == \
        dataclasses.asdict(jax_config(XLSTM))
    cfg = get_config(XLSTM)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.d_ff, cfg.vocab_size) == \
        (24, 1024, 2048, 4, 512, 0, 50304)
    assert cfg.layer_kinds().count("slstm") == 3
    tlm.check_ported(cfg)
    assert 350e6 < cfg.param_count() < 360e6


def test_bridge_and_init_params_hold_the_reference_leaves(xl):
    """Every reference leaf lands once, unstacked per layer; the port's
    own ``init_params`` draws the same tree of shapes."""
    jcfg, jparams, tcfg, tparams = xl
    arrays = jax.tree.map(np.asarray, jparams)
    for layer, kind in enumerate(tcfg.layer_kinds()):
        jp, tp = _block(arrays, tparams, tcfg, layer, kind)
        assert set(tparams["layers"][layer]) == {"ln1", kind}
        for name in jp:
            np.testing.assert_array_equal(tp[name]["w"].numpy(),
                                          jp[name]["w"])
    own = tlm.init_params(0, tcfg, device="cpu")
    assert [(p, tuple(t.shape)) for p, t in tree.with_paths(own)] == \
        [(p, tuple(t.shape)) for p, t in tree.with_paths(tparams)]


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [64, 70])
def test_mlstm_apply_without_state_matches_the_reference(xl, length):
    """The chunk-parallel path: a whole chunk, and 70 padded to 128."""
    jcfg, jparams, tcfg, tparams = xl
    jp, tp = _block(jparams, tparams, tcfg, 1, "mlstm")
    x = _x(2, length, tcfg.d_model, 5)
    ref, _ = jxlstm.mlstm_apply(jp, jnp.asarray(x), jcfg)
    got = txlstm.mlstm_apply(tp, torch.from_numpy(x), tcfg)
    _close(got, ref, GLA_TOL)


def test_mlstm_apply_with_state_matches_the_reference(xl):
    """Two calls of per-token steps from a random state: outputs and the
    state within 1e-5 of the reference's; the state updated in place;
    the per-token outputs within the GLA tolerance of the chunked path
    from zero."""
    jcfg, jparams, tcfg, tparams = xl
    jp, tp = _block(jparams, tparams, tcfg, 2, "mlstm")
    x = _x(2, 9, tcfg.d_model, 6)
    rng = np.random.default_rng(7)
    mem0 = 0.1 * rng.standard_normal(
        (2, tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_head_dim + 1)
    ).astype(np.float32)
    state = {"mem": torch.from_numpy(mem0.copy())}
    ptr = state["mem"].data_ptr()
    js = {"mem": jnp.asarray(mem0)}
    for lo, hi in ((0, 4), (4, 9)):
        ref, js = jxlstm.mlstm_apply(jp, jnp.asarray(x[:, lo:hi]), jcfg,
                                     state=js)
        got = txlstm.mlstm_apply(tp, torch.from_numpy(x[:, lo:hi]), tcfg,
                                 state=state)
        _close(got, ref, TOL)
        _close(state["mem"], js["mem"], TOL)
    assert state["mem"].data_ptr() == ptr
    fresh = txlstm.mlstm_init_state(tcfg, 2, torch.device("cpu"))
    stepped = txlstm.mlstm_apply(tp, torch.from_numpy(x), tcfg, state=fresh)
    chunked = txlstm.mlstm_apply(tp, torch.from_numpy(x), tcfg)
    _close(stepped, chunked.numpy(), GLA_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_the_reference(xl, with_state):
    """Token by token on both paths, as the reference's scan: outputs
    and the final (c, n, m) within 1e-5; from a random state when given,
    else from the fresh one (m at -1e30)."""
    jcfg, jparams, tcfg, tparams = xl
    jp, tp = _block(jparams, tparams, tcfg, 7, "slstm")
    x = _x(3, 11, tcfg.d_model, 8)
    if with_state:
        rng = np.random.default_rng(9)
        di = tcfg.d_inner
        s0 = {"c": rng.standard_normal((3, di)).astype(np.float32),
              "n": np.abs(rng.standard_normal((3, di))).astype(np.float32),
              "m": rng.standard_normal((3, di)).astype(np.float32)}
        js = {k: jnp.asarray(v) for k, v in s0.items()}
        state = {k: torch.from_numpy(v.copy()) for k, v in s0.items()}
    else:
        js = None
        state = None
    ref, jnew = jxlstm.slstm_apply(jp, jnp.asarray(x), jcfg, state=js)
    got = txlstm.slstm_apply(tp, torch.from_numpy(x), tcfg, state=state)
    _close(got, ref, TOL)
    if with_state:
        for name in ("c", "n", "m"):
            _close(state[name], jnew[name], TOL)
    fresh = txlstm.slstm_init_state(tcfg, 2, torch.device("cpu"))
    jfresh = jxlstm.slstm_init_state(jcfg, 2)
    for name in ("c", "n", "m"):
        np.testing.assert_array_equal(fresh[name].numpy(),
                                      np.asarray(jfresh[name]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_keep_the_state_of_dropped_lanes(xl, kind):
    """``keep`` False (a spent lane of a decode step) or a lane ``rows``
    leaves out: its state rows stay bit for bit; the others step."""
    _, _, tcfg, tparams = xl
    layer = 0 if kind == "mlstm" else 7
    tp = tparams["layers"][layer][kind]
    init = txlstm.mlstm_init_state if kind == "mlstm" \
        else txlstm.slstm_init_state
    x = torch.from_numpy(_x(3, 1, tcfg.d_model, 10))
    apply = txlstm.mlstm_apply if kind == "mlstm" else txlstm.slstm_apply
    for kw in (dict(keep=torch.tensor([True, False, True])),
               dict(rows=torch.tensor([0, 2]))):
        state = init(tcfg, 3, torch.device("cpu"))
        for t in state.values():
            t.add_(torch.rand(t.shape, generator=torch.Generator()
                              .manual_seed(1)))
        before = {k: v.clone() for k, v in state.items()}
        apply(tp, x, tcfg, state=state, **kw)
        for name, t in state.items():
            assert torch.equal(t[1], before[name][1]), (kw, name)
            assert not torch.equal(t[0], before[name][0]), (kw, name)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [64, 70])
def test_forward_and_loss_match_the_reference(xl, length):
    jcfg, jparams, tcfg, tparams = xl
    toks = _tokens(2, length, 1)
    labels = _tokens(2, length, 2)
    ref, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tlm.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(got, ref, GLA_TOL)
    assert float(aux) == 0.0
    jloss = jlm.loss_fn(jparams, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)}, jcfg)
    loss = tlm.loss_fn(tparams, {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels)}, tcfg)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def _jax_leaf(jtree, path, cfg):
    """The reference leaf at a port path (layer i: group i // period of
    ``blocks/pos{i % period}``)."""
    if path[0] == "layers":
        g, i = divmod(path[1], len(cfg.block_pattern))
        node = jtree["blocks"][f"pos{i}"]
        for key in path[2:]:
            node = node[key]
        return np.asarray(node, np.float32)[g]
    node = jtree
    for key in path:
        node = node[key]
    return np.asarray(node, np.float32)


def grad_parity(jcfg, jparams, tcfg, tparams, batch_size=2, seq=32,
                tol=GRAD_TOL, feats=False):
    """Every gradient leaf of the port's ``loss_fn`` against ``jax.grad``
    of the reference's, each within ``tol`` of the leaf's norm; returns
    the worst relative error."""
    from repro.data import make_batch as jmake_batch
    from repro_torch.data import make_batch

    jbatch = jmake_batch(jcfg, batch_size, seq, kind="train", seed=3)
    tbatch = make_batch(tcfg, batch_size, seq, kind="train", seed=3,
                        device="cpu")
    jgrads = jax.jit(jax.grad(jlm.loss_fn), static_argnums=2)(
        jparams, jbatch, jcfg)
    flat = [p.detach().requires_grad_() for p in tree.leaves(tparams)]
    loss = tlm.loss_fn(tree.unflatten(tparams, flat), tbatch, tcfg)
    grads = tree.unflatten(tparams, [
        torch.zeros_like(p) if g is None else g for p, g in zip(
            flat, torch.autograd.grad(loss, flat, allow_unused=True))])
    worst = 0.0
    for path, g in tree.with_paths(grads):
        ref = _jax_leaf(jgrads, path, tcfg)
        assert g.shape == ref.shape, path
        err = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref),
                                                    1e-30)
        assert err < tol, (path, err)
        worst = max(worst, err)
    return worst


def test_every_gradient_leaf_matches_jax_grad(xl):
    grad_parity(*xl)


def test_forward_cached_per_token_matches_the_reference(xl):
    """Prefill chunks of 7 (each token one recurrent step) then decode
    steps at per-lane positions: every fed position's logits within
    5e-5 of the reference's ``forward_cached``, the states within 1e-5,
    and
    within the GLA tolerance of the chunk-parallel ``lm.forward``."""
    jcfg, jparams, tcfg, tparams = xl
    toks = _tokens(2, 26, 3)
    caches = tlm.init_caches(tcfg, 2, 64, device="cpu")
    jc = jlm.init_caches(jcfg, 2, 64)
    port, ref = [], []
    for start, step in prefill_segments(22, 7):
        piece = toks[:, start:start + step]
        lg, _ = tlm.forward_cached(tparams, torch.from_numpy(piece), caches,
                                   start, tcfg, all_logits=True)
        port.append(lg)
        jl, jc = jlm.forward_cached(jparams, jnp.asarray(piece), jc, start,
                                    jcfg, all_logits=True)
        ref.append(np.asarray(jl))
    for t in range(22, 26):
        lg, _ = tlm.forward_cached(tparams, torch.from_numpy(toks[:, t:t + 1]),
                                   caches, torch.tensor([t, t]), tcfg)
        port.append(lg)
        jl, jc = jlm.forward_cached(jparams, jnp.asarray(toks[:, t:t + 1]),
                                    jc, t, jcfg)
        ref.append(np.asarray(jl))
    port = torch.cat(port, dim=1).numpy()
    np.testing.assert_allclose(port, np.concatenate(ref, axis=1),
                               atol=STACK_TOL, rtol=STACK_TOL)
    full, _ = tlm.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(port, full.numpy(), atol=GLA_TOL,
                               rtol=GLA_TOL)
    for kind, c, j in zip(tcfg.layer_kinds(), caches, jc, strict=True):
        assert set(c) == ({"mem"} if kind == "mlstm" else {"c", "n", "m"})
        for name in c:
            _close(c[name], j[name], TOL)


def test_kernel1_launches_per_forward(xl, monkeypatch):
    """1 + n_layers (25 at full depth): layer 0's ln1, then one fused
    add + norm per block, the last with the final norm."""
    _, _, tcfg, tparams = xl
    counts = dict.fromkeys(("rmsnorm", "add_rmsnorm", "qk_norm_rope"), 0)
    for name in counts:
        real = getattr(krms, name)

        def fn(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(krms, name, fn)
    with torch.no_grad():
        tlm.forward(tparams, {"tokens": torch.zeros(1, 5, dtype=torch.long)},
                    tcfg)
    assert counts == {"rmsnorm": 1, "add_rmsnorm": tcfg.n_layers,
                      "qk_norm_rope": 0}
    assert 1 + get_config(XLSTM).n_layers == 25


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _trace():
    """4 requests, prompts 8-17 tokens, 5 new tokens each."""
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 256, n), 5) for n in (12, 17, 9, 8)]


def _serve(sched, trace):
    rids = [sched.submit(p, m) for p, m in trace]
    outs = sched.run_until_idle()
    return [outs[r] for r in rids]


@pytest.fixture(scope="module")
def jax_tokens(xl):
    """The JAX scheduler's greedy tokens of the trace (contiguous, fused
    depth 2, chunks of at most 8)."""
    jcfg, jparams, _, _ = xl
    return _serve(JaxScheduler(jcfg, jparams, acc=JaxStatic(cores=2),
                               n_slots=2, max_len=48, chunk_buckets=(8,),
                               dispatch_depth=2), _trace())


@pytest.mark.parametrize("pool", ["contiguous", "per-tick", "paged"])
def test_scheduler_tokens_identical_to_jax(xl, jax_tokens, pool):
    """f32 greedy tokens of the port's scheduler equal the JAX
    scheduler's over the slot pool (fused and per-tick) and the paged
    pool; prefill chunks are exact-size (no pad tokens into a state)."""
    _, _, tcfg, tparams = xl
    kw = dict(n_slots=2, max_len=48, chunk_buckets=(8,),
              dispatch_depth=None if pool == "per-tick" else 2)
    if pool == "paged":
        kw.update(paged=True, page_size=8)
    sched = ServeScheduler(tcfg, tparams, acc=StaticCoreChunk(cores=2),
                           device="cpu", **kw)
    sched.warmup()
    assert _serve(sched, _trace()) == jax_tokens
    assert [len(o) for o in jax_tokens] == [m for _, m in _trace()]
    assert not sched._pad_ok


def test_served_tokens_equal_the_forward_rollout(xl, jax_tokens):
    """The acquire rule: the pools zero every state row, so a served
    sequence starts sLSTM's ``m`` at 0 where ``lm.forward`` starts it at
    -1e30.  The stabilised form makes the two starts agree (the scaled
    c and n give the same c / n) up to rounding and the ``max(n, 1e-6)``
    floor: the slstm block's outputs from the two starts are within
    1e-5, and the served tokens equal a greedy rollout of the
    chunk-parallel ``lm.forward`` token for token."""
    _, _, tcfg, tparams = xl
    tp = tparams["layers"][7]["slstm"]
    x = torch.from_numpy(_x(2, 12, tcfg.d_model, 12))
    zeroed = txlstm.slstm_init_state(tcfg, 2, torch.device("cpu"))
    zeroed["m"].zero_()
    _close(txlstm.slstm_apply(tp, x, tcfg, state=zeroed),
           txlstm.slstm_apply(tp, x, tcfg).numpy(), TOL)
    pool = SlotKVCachePool(tcfg, 2, 32, device="cpu")
    for c in pool.caches:
        for t in c.values():
            t.fill_(3.0)
    slot = pool.acquire("a")
    assert pool.caches[7]["m"][slot].eq(0).all()
    assert pool.caches[0]["mem"][slot].eq(0).all()
    for (prompt, n_new), served in zip(_trace(), jax_tokens, strict=True):
        seq = list(prompt)
        for _ in range(n_new):
            logits, _ = tlm.forward(
                tparams, {"tokens": torch.tensor([seq])}, tcfg)
            seq.append(int(logits[0, -1].argmax()))
        assert seq[len(prompt):] == served


def test_pools_hold_the_xlstm_state_rows(xl):
    """Both pools: the state rows are the layer's slot rows, no K/V at
    all (no layer attends), ``acquire`` zeroes only the acquired slot's
    rows, the paged pool keeps no prefix."""
    _, _, tcfg, _ = xl
    for pool in (SlotKVCachePool(tcfg, 3, 32, device="cpu"),
                 PagedKVCachePool(tcfg, 3, 32, page_size=8, device="cpu")):
        for kind, c in zip(tcfg.layer_kinds(), pool.caches, strict=True):
            want = {"mem": (3, 8, 16, 17)} if kind == "mlstm" else \
                {name: (3, 128) for name in ("c", "n", "m")}
            assert {k: tuple(t.shape) for k, t in c.items()} == want
            for t in c.values():
                t.fill_(2.0)
        slot = pool.acquire("a")
        for c in pool.caches:
            for t in c.values():
                assert t[slot].eq(0).all()
                assert t[[s for s in range(3) if s != slot]].eq(2).all()
        if isinstance(pool, PagedKVCachePool):
            assert pool.prefix_cache is False


@pytest.mark.parametrize("budgets", [[5, 0, 2], [0, 3, 3]])
def test_fused_step_keeps_a_spent_lanes_state(xl, budgets):
    """The fused decode step from random states: a lane with no budget
    keeps its mLSTM and sLSTM state bit for bit; the others equal the
    per-token ``forward_cached`` steps."""
    _, _, tcfg, tparams = xl
    rng = np.random.default_rng(13)
    caches = tlm.init_caches(tcfg, 3, 32, device="cpu")
    for c in caches:
        for t in c.values():
            t.copy_(torch.from_numpy(
                0.1 * rng.standard_normal(t.shape).astype(np.float32)))
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    toks = torch.tensor([3, 5, 7])
    tc, out, _ = tdl.make_fused_decode_step(tcfg, max_depth=8)(
        tparams, caches, toks, torch.tensor([4, 11, 20]), budgets)
    spent = [lane for lane in range(3) if budgets[lane] == 0]
    live = [lane for lane in range(3) if budgets[lane] > 0]
    for t, b in zip(tc, before, strict=True):
        for name in t:
            assert torch.equal(t[name][spent], b[name][spent])
            assert not torch.equal(t[name][live], b[name][live])
    # One lane stepped alone through forward_cached gives its tokens.
    lane = live[0]
    solo = [{k: v[lane:lane + 1].clone() for k, v in b.items()}
            for b in before]
    tok = toks[lane:lane + 1, None]
    for i in range(budgets[lane]):
        lg, _ = tlm.forward_cached(tparams, tok, solo, 0, tcfg)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        assert int(tok) == int(out[i, lane])


def test_speculation_stays_refused(xl):
    _, _, tcfg, tparams = xl
    with pytest.raises(ValueError, match="recurrent"):
        ServeScheduler(tcfg, tparams, n_slots=2, max_len=32,
                       dispatch_depth=2, speculate=2, device="cpu")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_serve_cli_takes_xlstm(paged, capsys):
    launch_serve.main(["--arch", XLSTM, "--reduced", "--device", "cpu",
                       "--requests", "2", "--slots", "2", "--prompt-len",
                       "12", "--new-tokens", "3", "--no-cal-cache"]
                      + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert f"arch={XLSTM} device=cpu requests=2" in out
    assert "generated 6 tokens" in out


def test_train_cli_takes_xlstm(tmp_path, capsys):
    launch_train.main(["--arch", XLSTM, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--no-cal-cache", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={XLSTM}" in out and "done: 2 steps" in out
