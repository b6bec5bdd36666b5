"""The vision family on the CPU against the JAX package:
llama-3.2-vision-11b (attention blocks with a ``cross_attn`` block every
fifth layer, attending the stub frontend's patch embeddings) at its
reduced size (5 layers, d 64, 4/2 heads of 16, 8 frontend tokens), f32.

Same weights (the reference's ``init_params`` bridged through numpy),
same inputs (seeded numpy, and ``make_batch``'s features).
``cross_attention`` at 8 and at 1601 frontend tokens, through the
training path and kernel 2's plain version; ``lm.forward`` / ``loss_fn``
and every gradient leaf; ``forward_cached``; ``ServeEngine.generate``
with features against the JAX engine's tokens; the scheduler's and the
pools' refusal; ``make_batch``; kernel 1's launches per forward; the
CLIs.  The card runs the same path at full width in ``chip_smoke.py``
phase 13.

Tolerances: f32 on both sides, sums in other orders: 1e-5 on a block's
output, 1e-4 on logits through the 5-layer stack (as
``tests/test_torch_engine.py``), gradients to 1e-4 of each leaf's norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.data import make_batch as jmake_batch
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeScheduler as JaxScheduler
from repro_torch import bridge, tree
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import batch_shapes, make_batch
from repro_torch.kernels import rmsnorm as krms
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.serve import (PagedKVCachePool, ServeEngine, ServeScheduler,
                               SlotKVCachePool)

from test_torch_xlstm import grad_parity

VISION = "llama-3.2-vision-11b"
TOL = 1e-5
STACK_TOL = 1e-4


@pytest.fixture(scope="module")
def vis():
    jcfg = jax_config(VISION).reduced()
    tcfg = get_config(VISION).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jcfg, jparams, tcfg, tparams


def _feats(b: int, t: int, d: int, seed: int) -> np.ndarray:
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (b, t, d))).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the registry, the config and the bridge
# ---------------------------------------------------------------------------

def test_registry_holds_every_reference_arch():
    """The port's registry is the JAX package's, and the port has every
    block kind of every config."""
    assert set(ARCH_NAMES) == set(JAX_ARCH_NAMES) and len(ARCH_NAMES) == 10
    for name in ARCH_NAMES:
        tlm.check_ported(get_config(name))
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_config(name))


def test_config_is_the_reference():
    cfg = get_config(VISION)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
            cfg.num_frontend_tokens) == \
        (40, 4096, 32, 8, 128, 14336, 128256, 1601)
    assert cfg.layer_kinds().count("cross_attn") == 8
    assert 9.5e9 < cfg.param_count() < 10e9


def test_bridge_and_init_params_hold_the_reference_leaves(vis):
    jcfg, jparams, tcfg, tparams = vis
    arrays = jax.tree.map(np.asarray, jparams)
    layer = tcfg.layer_kinds().index("cross_attn")
    xp = tparams["layers"][layer]
    assert set(xp) == {"ln1", "xattn", "ln2", "ffn"}
    ref = arrays["blocks"][f"pos{layer}"]["xattn"]
    assert set(xp["xattn"]) == set(ref) and "kv_norm" in ref
    np.testing.assert_array_equal(xp["xattn"]["kv_norm"]["g"].numpy(),
                                  ref["kv_norm"]["g"][0])
    np.testing.assert_array_equal(xp["xattn"]["wk"]["w"].numpy(),
                                  ref["wk"]["w"][0])
    own = tlm.init_params(0, tcfg, device="cpu")
    assert [(p, tuple(t.shape)) for p, t in tree.with_paths(own)] == \
        [(p, tuple(t.shape)) for p, t in tree.with_paths(tparams)]


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skv", [8, 1601])
@pytest.mark.parametrize("sq", [1, 6])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_cross_attention_matches_the_reference(vis, skv, sq, impl):
    """Queries of a decode step (1) and a prefill chunk (6) over 8 and
    1601 frontend tokens: the training path (``chunked``) and kernel 2's
    plain version (``flash`` on the CPU) against the reference's."""
    jcfg, jparams, tcfg, tparams = vis
    layer = tcfg.layer_kinds().index("cross_attn")
    jp = jax.tree.map(lambda a: a[0],
                      jparams["blocks"][f"pos{layer}"]["xattn"])
    tp = tparams["layers"][layer]["xattn"]
    x = np.random.default_rng(skv + sq).standard_normal(
        (2, sq, tcfg.d_model)).astype(np.float32)
    f = _feats(2, skv, tcfg.d_model, 4)
    ref = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(f), jcfg)
    got = tattn.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(f),
                                tcfg, impl=impl)
    _close(got, ref, TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _batch(cfg, maker, b=2, s=24, kind="train", **kw):
    return maker(cfg, b, s, kind=kind, seed=1, **kw)


def test_make_batch_returns_the_reference_features(vis):
    """The same tokens, labels and features from one seed: f32 at the
    reduced size; at the full config the features in bf16, bit for bit
    (a batch of one, 1601 x 4096)."""
    jcfg, _, tcfg, _ = vis
    for kind in ("train", "prefill"):
        jb = jmake_batch(jcfg, 3, 17, kind=kind, seed=2)
        tb = make_batch(tcfg, 3, 17, kind=kind, seed=2, device="cpu")
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(
                tb[k].float().numpy(), np.asarray(jb[k], np.float32))
    assert batch_shapes(tcfg, 3, 17)["frontend_feats"] == \
        ((3, 8, 64), torch.float32)
    full_j, full_t = jax_config(VISION), get_config(VISION)
    jb = jmake_batch(full_j, 1, 4, kind="prefill", seed=5)
    tb = make_batch(full_t, 1, 4, kind="prefill", seed=5, device="cpu")
    assert tb["frontend_feats"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb["frontend_feats"].float().numpy(),
        np.asarray(jb["frontend_feats"], np.float32))


def test_forward_and_loss_match_the_reference(vis):
    jcfg, jparams, tcfg, tparams = vis
    jb = _batch(jcfg, jmake_batch)
    tb = _batch(tcfg, make_batch, device="cpu")
    ref, _ = jlm.forward(jparams, jb, jcfg)
    got, aux = tlm.forward(tparams, tb, tcfg)
    _close(got, ref, STACK_TOL)
    assert float(aux) == 0.0
    jloss = jlm.loss_fn(jparams, jb, jcfg)
    assert float(tlm.loss_fn(tparams, tb, tcfg)) == \
        pytest.approx(float(jloss), rel=1e-5)
    assert float(tlm.loss_fn(tparams, tb, tcfg, remat=True)) == \
        float(tlm.loss_fn(tparams, tb, tcfg))
    with pytest.raises(ValueError, match="frontend_feats"):
        tlm.forward(tparams, {"tokens": tb["tokens"]}, tcfg)


def test_every_gradient_leaf_matches_jax_grad(vis):
    """The features' path too: kv_norm's gain and the cross K/V weights."""
    grad_parity(*vis, seq=24)


def test_forward_cached_matches_the_reference(vis):
    """Prefill chunks then decode steps with the features: every fed
    position's logits within the stack tolerance of the reference's
    ``forward_cached``; a ``cross_attn`` layer's cache entry is None."""
    jcfg, jparams, tcfg, tparams = vis
    toks = np.random.default_rng(3).integers(0, 256, (2, 20))
    f = _feats(2, 8, tcfg.d_model, 6)
    caches = tlm.init_caches(tcfg, 2, 32, device="cpu")
    assert [c is None for c in caches] == \
        [k == "cross_attn" for k in tcfg.layer_kinds()]
    jc = jlm.init_caches(jcfg, 2, 32)
    for start, step in ((0, 7), (7, 9), (16, 1), (17, 1), (18, 2)):
        piece = toks[:, start:start + step]
        lg, _ = tlm.forward_cached(tparams, torch.from_numpy(piece), caches,
                                   start, tcfg, all_logits=True,
                                   frontend_feats=torch.from_numpy(f))
        jl, jc = jlm.forward_cached(jparams, jnp.asarray(piece), jc, start,
                                    jcfg, all_logits=True,
                                    frontend_feats=jnp.asarray(f))
        _close(lg, jl, STACK_TOL)


def test_kernel1_launches_per_forward(vis, monkeypatch):
    """Layer 0's ln1, two fused adds per attention layer and per
    cross-attention layer, and ``kv_norm`` per cross-attention layer:
    1 + 2 * 5 + 1 = 12 here, 1 + 2 * 40 + 8 = 89 at full depth."""
    _, _, tcfg, tparams = vis
    counts = dict.fromkeys(("rmsnorm", "add_rmsnorm", "qk_norm_rope"), 0)
    for name in counts:
        real = getattr(krms, name)

        def fn(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(krms, name, fn)
    tb = _batch(tcfg, make_batch, b=1, s=5, kind="prefill", device="cpu")
    with torch.no_grad():
        tlm.forward(tparams, tb, tcfg)
    assert counts == {"rmsnorm": 2, "add_rmsnorm": 10, "qk_norm_rope": 0}
    full = get_config(VISION)
    assert 1 + 2 * full.n_layers + full.layer_kinds().count("cross_attn") \
        == 89


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_engine_tokens_identical_to_jax(vis):
    """``ServeEngine.generate(frontend_feats=...)`` takes the lock-step
    path, as the reference's, and gives the JAX engine's greedy tokens
    (f32); a second ``generate`` after it continues from the state."""
    jcfg, jparams, tcfg, tparams = vis
    tb = _batch(tcfg, make_batch, b=3, s=11, kind="prefill", device="cpu")
    jb = _batch(jcfg, jmake_batch, b=3, s=11, kind="prefill")
    jeng = JaxEngine(jcfg, jparams, batch=3, max_len=40)
    teng = ServeEngine(tcfg, tparams, batch=3, max_len=40, device="cpu")
    ref = jeng.generate(jb["tokens"], 6, frontend_feats=jb["frontend_feats"])
    got = teng.generate(tb["tokens"], 6, frontend_feats=tb["frontend_feats"])
    assert got.tolist() == np.asarray(ref).tolist()
    assert teng.pos == jeng.pos == 11 + 6 and teng._sched is None
    more = np.asarray(jeng.generate(ref[:, -1:], 3,
                                    frontend_feats=jb["frontend_feats"]))
    got2 = teng.generate(got[:, -1:], 3, frontend_feats=tb["frontend_feats"])
    assert got2.tolist() == more.tolist()


def test_scheduler_and_pools_refuse_cross_attention(vis):
    """The reference's ``ValueError``, from the scheduler and from each
    pool; the JAX scheduler raises the same message."""
    jcfg, jparams, tcfg, tparams = vis
    with pytest.raises(ValueError) as ref:
        JaxScheduler(jcfg, jparams, n_slots=2, max_len=32)
    with pytest.raises(ValueError) as got:
        ServeScheduler(tcfg, tparams, n_slots=2, max_len=32, device="cpu")
    assert str(got.value) == str(ref.value)
    for pool in (SlotKVCachePool, PagedKVCachePool):
        with pytest.raises(ValueError, match="cross-attention"):
            pool(tcfg, 2, 32, device="cpu")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_serve_cli_routes_to_the_lockstep_path(capsys):
    launch_serve.main(["--arch", VISION, "--reduced", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "9",
                       "--new-tokens", "3", "--no-cal-cache"])
    out = capsys.readouterr().out
    assert "cross-attention: lock-step batch path" in out
    assert "generated 6 tokens" in out


def test_train_cli_takes_the_vision_arch(tmp_path, capsys):
    launch_train.main(["--arch", VISION, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--accum", "2", "--no-cal-cache", "--ckpt",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={VISION}" in out and "done: 2 steps" in out
