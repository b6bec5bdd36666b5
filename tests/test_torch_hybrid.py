"""The hybrid Mamba2 family on the CPU against the JAX package:
zamba2-1.2b (five ``mamba2`` blocks, then a ``shared_attn`` block whose
weights every use shares) at its reduced size (6 layers) and a 14-layer
variant (two pattern groups and two tail layers), f32.

Same weights (the reference's ``init_params`` bridged through numpy),
same inputs (seeded numpy).  ``chunked_gla`` / ``gla_step`` and
``mamba2.apply`` on both of its paths, ``lm.forward`` and the per-token
``forward_cached``, the scheduler's greedy tokens over both pools, the
engine's lock-step path, the pools' state rows (zeroed on acquire, no
prefix reuse), the fused step keeping a spent lane's state, and kernel
1's launches per forward.  The card runs the same path at full width and
depth in ``chip_smoke.py`` phase 11.

Tolerances: f32 on both sides, sums in other orders: 1e-5 on logits,
block outputs and states; 3e-4, the reference's own ``tests/test_gla.py``
tolerance, where the chunk-parallel GLA meets another order of
arithmetic (the per-token path, the O(L²) oracle) or runs through a
14-layer ``lm.forward`` (its within-chunk factors exp(±m) scale the
rounding of either side's sums).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.models import gla as jgla
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba
from repro.serve import ServeScheduler as JaxScheduler
from repro.serve import decode_loop as jdl
from repro_torch import bridge
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.acc import StaticCoreChunk
from repro_torch.kernels import rmsnorm as krms
from repro_torch.launch import serve as launch_serve
from repro_torch.models import gla as tgla
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmamba
from repro_torch.serve import (PagedKVCachePool, ServeEngine, ServeScheduler,
                               SlotKVCachePool)
from repro_torch.serve import decode_loop as tdl
from repro_torch.serve.engine import prefill_segments

ZAMBA = "zamba2-1.2b"
TOL = 1e-5
GLA_TOL = 3e-4


def _params(n_layers: int | None = None, seed: int = 0):
    """(jcfg, jparams, tcfg, tparams): reduced zamba2 (or ``n_layers`` of
    it) with the reference's weights, every Mamba2 per-head parameter
    and conv bias drawn non-zero (the reference initialises them to 0
    and 1, which would hide one the port dropped or misread)."""
    changes = {} if n_layers is None else {"n_layers": n_layers}
    jcfg = dataclasses.replace(jax_config(ZAMBA).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(ZAMBA).reduced(), **changes)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if path[-1].key in ("a_log", "dt_bias", "d_skip", "conv_b"):
            return leaf + jnp.asarray(
                0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    jparams = jax.tree_util.tree_map_with_path(perturb, jparams)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def zamba():
    return _params()


@pytest.fixture(scope="module")
def zamba14():
    return _params(14)


def _tokens(n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, length))


def _gla_inputs(b, length, h, n, p, seed):
    """The reference test's draws (``tests/test_gla.py::make``)."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, length, h, n).astype(np.float32) * 0.3
    k = rs.randn(b, length, h, n).astype(np.float32) * 0.3
    v = rs.randn(b, length, h, p).astype(np.float32)
    ld = -np.abs(rs.randn(b, length, h).astype(np.float32)) * 0.5
    g = rs.randn(b, length, h).astype(np.float32) * 0.3
    return q, k, v, ld, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the config, the guard and the bridge
# ---------------------------------------------------------------------------

def test_config_is_the_reference_and_registered():
    assert ZAMBA in ARCH_NAMES
    assert dataclasses.asdict(get_config(ZAMBA)) == \
        dataclasses.asdict(jax_config(ZAMBA))
    cfg = get_config(ZAMBA)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.ssm_state, cfg.ssm_head_dim) == \
        (38, 2048, 32, 32, 64, 8192, 64, 64)
    tlm.check_ported(cfg)
    assert cfg.layer_kinds().count("shared_attn") == 6


@pytest.mark.parametrize("kind", ["lstm", "rwkv", "xattn"])
def test_check_ported_still_refuses_the_other_kinds(kind):
    cfg = dataclasses.replace(get_config(ZAMBA).reduced(),
                              block_pattern=("mamba2", kind))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.check_ported(cfg)


def test_bridge_holds_the_shared_block_once_and_the_tail(zamba14):
    """14 layers: two groups of six, then two tail layers; every leaf of
    the reference lands once, the shared block at the top level."""
    jcfg, jparams, tcfg, tparams = zamba14
    arrays = jax.tree.map(np.asarray, jparams)
    assert len(arrays["tail"]) == 2 and len(tparams["layers"]) == 14
    np.testing.assert_array_equal(
        tparams["shared_block"]["attn"]["wq"]["w"].numpy(),
        arrays["shared_block"]["attn"]["wq"]["w"])
    kinds = tcfg.layer_kinds()
    for layer, p in enumerate(tparams["layers"]):
        if kinds[layer] == "shared_attn":
            assert set(p) == {"ln1", "proj"}
            np.testing.assert_array_equal(
                p["proj"]["w"].numpy(),
                arrays["blocks"]["pos5"]["proj"]["w"][layer // 6])
        else:
            ref = arrays["blocks"][f"pos{layer % 6}"]["mamba"] \
                if layer < 12 else arrays["tail"][layer - 12]["mamba"]
            idx = (layer // 6,) if layer < 12 else ()
            for name in ("in_proj", "out_proj"):
                np.testing.assert_array_equal(p["mamba"][name]["w"].numpy(),
                                              ref[name]["w"][idx])
            np.testing.assert_array_equal(p["mamba"]["a_log"].numpy(),
                                          ref["a_log"][idx])
    n_ref = sum(a.size for a in jax.tree.leaves(arrays))
    n_port = sum(t.numel() for t in jax.tree.leaves(tparams))
    assert n_port == n_ref


def test_init_params_draws_the_reference_shapes():
    """The port's own draw has the reference's tree: the same leaves and
    shapes; the Mamba2 parameters of ``KEEP_PARAM_DTYPE`` in f32 under a
    bf16 compute dtype."""
    jcfg = jax_config(ZAMBA).reduced()
    tcfg = dataclasses.replace(get_config(ZAMBA).reduced(),
                               compute_dtype="bfloat16")
    ref = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    port = tlm.init_params(0, tcfg, device="cpu")
    assert sorted(port["shared_block"]) == sorted(ref["shared_block"])
    for layer in range(tcfg.n_layers):
        p = port["layers"][layer]
        r = ref["blocks"][f"pos{layer}"]
        assert sorted(p) == sorted(r)
        for path, leaf in jax.tree_util.tree_leaves_with_path(r):
            got = p
            for key in path:
                got = got[key.key]
            assert tuple(got.shape) == tuple(leaf.shape[1:])
            keep = path[-1].key in tlm.KEEP_PARAM_DTYPE \
                or path[-2].key in tlm.KEEP_PARAM_DTYPE
            assert got.dtype == (torch.float32 if keep else torch.bfloat16)


# ---------------------------------------------------------------------------
# the GLA engine and the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,length,gain", [
    (16, 64, True), (64, 128, False), (8, 24, True)])
def test_chunked_gla_matches_the_reference(chunk, length, gain):
    q, k, v, ld, g = _gla_inputs(2, length, 3, 8, 16, seed=chunk + length)
    gj, gt = (jnp.asarray(g), torch.from_numpy(g)) if gain else (None, None)
    yj, sj = jgla.chunked_gla(*_j(q, k, v, ld), gj, chunk=chunk)
    yt, st = tgla.chunked_gla(*_t(q, k, v, ld), gt, chunk=chunk)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL,
                               rtol=TOL)
    oracle = jgla.gla_reference(*_j(q, k, v, ld), gj)
    np.testing.assert_allclose(
        tgla.gla_reference(*_t(q, k, v, ld), gt).numpy(), np.asarray(oracle),
        atol=TOL, rtol=TOL)
    np.testing.assert_allclose(yt.numpy(), np.asarray(oracle),
                               atol=GLA_TOL, rtol=GLA_TOL)


def test_chunked_gla_continues_from_an_initial_state():
    q, k, v, ld, g = _gla_inputs(1, 96, 2, 4, 4, seed=7)
    y1, s1 = tgla.chunked_gla(*_t(q[:, :48], k[:, :48], v[:, :48],
                                  ld[:, :48], g[:, :48]), chunk=16)
    y2, s2 = tgla.chunked_gla(*_t(q[:, 48:], k[:, 48:], v[:, 48:],
                                  ld[:, 48:], g[:, 48:]), chunk=16,
                              initial_state=s1)
    jy2, js2 = jgla.chunked_gla(*_j(q[:, 48:], k[:, 48:], v[:, 48:],
                                    ld[:, 48:], g[:, 48:]), chunk=16,
                                initial_state=jnp.asarray(s1.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), atol=TOL,
                               rtol=TOL)
    y_full, s_full = tgla.chunked_gla(*_t(q, k, v, ld, g), chunk=16)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=GLA_TOL, rtol=GLA_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=GLA_TOL,
                               rtol=GLA_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tgla.chunked_gla(*_t(q[:, :40], k[:, :40], v[:, :40], ld[:, :40]),
                         chunk=16)


def test_chunked_gla_overflows_for_strong_decays_as_the_reference_does():
    """A fault of the reference, kept: with a log-decay of -3 a step, a
    chunk of 64 drives exp(cumsum) to 0 and the chunk's stabiliser
    exp(m) to inf, so ``chunked_gla`` gives NaN at the same places in
    both packages, where the recurrent ``gla_step`` the serve path runs
    stays finite (ROADMAP.md, faults of the reference)."""
    q, k, v, _, g = _gla_inputs(1, 64, 2, 4, 4, seed=12)
    ld = np.full((1, 64, 2), -3.0, np.float32)
    yj, _ = jgla.chunked_gla(*_j(q, k, v, ld, g), chunk=64)
    yt, _ = tgla.chunked_gla(*_t(q, k, v, ld, g), chunk=64)
    bad = ~np.isfinite(np.asarray(yj))
    assert bad.any()
    np.testing.assert_array_equal(~np.isfinite(yt.numpy()), bad)
    s = torch.zeros(1, 2, 4, 4)
    for t in range(64):
        y, s = tgla.gla_step(*_t(q[:, t], k[:, t], v[:, t], ld[:, t],
                                 g[:, t]), s)
        assert bool(torch.isfinite(y).all())


def test_gla_step_matches_the_reference_and_the_chunked_path():
    """Token by token from a zero state, with and without a gain: each
    step within 1e-5 of the reference's ``gla_step``, the whole run
    within the GLA tolerance of ``chunked_gla``."""
    q, k, v, ld, g = _gla_inputs(2, 32, 2, 8, 8, seed=3)
    for gain in (g, None):
        st = torch.zeros(2, 2, 8, 8)
        sj = jnp.zeros((2, 2, 8, 8))
        ys = []
        for t in range(32):
            gt = None if gain is None else torch.from_numpy(gain[:, t])
            yt, st = tgla.gla_step(*_t(q[:, t], k[:, t], v[:, t], ld[:, t]),
                                   gt, st)
            yj, sj = jgla.gla_step(*_j(q[:, t], k[:, t], v[:, t], ld[:, t]),
                                   None if gain is None
                                   else jnp.asarray(gain[:, t]), sj)
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL,
                                       rtol=TOL)
            ys.append(yt)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=TOL,
                                   rtol=TOL)
        y, s = tgla.chunked_gla(*_t(q, k, v, ld),
                                None if gain is None
                                else torch.from_numpy(gain), chunk=16)
        np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y.numpy(),
                                   atol=GLA_TOL, rtol=GLA_TOL)


def _block(params, layer):
    return params["layers"][layer]["mamba"]


def _jblock(jparams, layer):
    return jax.tree.map(lambda a: a[0], jparams["blocks"][f"pos{layer}"]
                        )["mamba"]


@pytest.mark.parametrize("length", [5, 70])
def test_mamba2_apply_matches_the_reference_on_both_paths(zamba, length):
    """No state: the chunked path (padded to 64); a zero state: one
    ``gla_step`` per token, the state written in place and equal to the
    reference's new state."""
    jcfg, jparams, tcfg, tparams = zamba
    x = np.random.default_rng(length).standard_normal(
        (2, length, tcfg.d_model)).astype(np.float32)
    jout, jstate = jmamba.apply(_jblock(jparams, 1), jnp.asarray(x), jcfg)
    out = tmamba.apply(_block(tparams, 1), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    jz = jmamba.init_state(jcfg, 2, jnp.float32)
    jout2, jnew = jmamba.apply(_jblock(jparams, 1), jnp.asarray(x), jcfg,
                               state=jz)
    state = tmamba.init_state(tcfg, 2, torch.float32, torch.device("cpu"))
    ssm, conv = state["ssm"], state["conv"]
    out2 = tmamba.apply(_block(tparams, 1), torch.from_numpy(x), tcfg,
                        state=state)
    assert state["ssm"] is ssm and state["conv"] is conv
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout2), atol=TOL,
                               rtol=TOL)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(jnew[name]), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(jstate[name]), atol=GLA_TOL,
                                   rtol=GLA_TOL)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=GLA_TOL,
                               rtol=GLA_TOL)


def test_mamba2_conv_carry_across_two_calls(zamba):
    """7 tokens then 4 through one state: the second call's output (the
    conv reading the first call's last three rows) equals the
    reference's, and the two calls equal one call of 11."""
    jcfg, jparams, tcfg, tparams = zamba
    x = np.random.default_rng(4).standard_normal(
        (1, 11, tcfg.d_model)).astype(np.float32)
    js = jmamba.init_state(jcfg, 1, jnp.float32)
    _, js = jmamba.apply(_jblock(jparams, 2), jnp.asarray(x[:, :7]), jcfg,
                         state=js)
    jout, js = jmamba.apply(_jblock(jparams, 2), jnp.asarray(x[:, 7:]), jcfg,
                            state=js)
    state = tmamba.init_state(tcfg, 1, torch.float32, torch.device("cpu"))
    first = tmamba.apply(_block(tparams, 2), torch.from_numpy(x[:, :7]),
                         tcfg, state=state)
    second = tmamba.apply(_block(tparams, 2), torch.from_numpy(x[:, 7:]),
                          tcfg, state=state)
    np.testing.assert_allclose(second.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(state["conv"].numpy(),
                               np.asarray(js["conv"]), atol=TOL, rtol=TOL)
    whole = tmamba.apply(
        _block(tparams, 2), torch.from_numpy(x), tcfg,
        state=tmamba.init_state(tcfg, 1, torch.float32, torch.device("cpu")))
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(),
                               whole.numpy(), atol=TOL, rtol=TOL)


def test_mamba2_keeps_the_state_of_dropped_lanes(zamba):
    """``keep`` False (a spent decode lane) and lanes ``rows`` leaves out
    come out of a stateful call with their state bit for bit."""
    _, _, tcfg, tparams = zamba
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 1, tcfg.d_model)).astype(np.float32))
    state = tmamba.init_state(tcfg, 3, torch.float32, torch.device("cpu"))
    for t in state.values():
        t.normal_(generator=torch.Generator().manual_seed(6))
    before = {k: t.clone() for k, t in state.items()}
    tmamba.apply(_block(tparams, 0), x, tcfg, state=state,
                 keep=torch.tensor([True, False, True]))
    tmamba.apply(_block(tparams, 0), x, tcfg, state=state,
                 rows=torch.tensor([0, 2]),
                 keep=torch.tensor([True, False]))
    for name, t in state.items():
        # Lane 1 dropped by ``keep`` twice; lanes 0 and 2 written once
        # or twice.
        assert torch.equal(t[1], before[name][1])
        assert not torch.equal(t[0], before[name][0])
        assert not torch.equal(t[2], before[name][2])


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which,length", [("zamba", 64),
                                          ("zamba14", 70)])
def test_forward_matches_the_reference(which, length, request):
    """The chunk-parallel path (a whole chunk, and 70 padded to 128)
    within the GLA tolerance: its within-chunk factors exp(±m) scale
    the rounding of either side's sums."""
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(which)
    toks = _tokens(2, length, 1)
    ref, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tlm.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GLA_TOL,
                               rtol=GLA_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("which", ["zamba", "zamba14"])
def test_forward_cached_per_token_matches_the_reference(which, request):
    """Prefill chunks of 7 (each token one recurrent step) then decode
    steps at per-lane positions: every fed position's logits within
    1e-5 of the reference's ``forward_cached``, and within the GLA
    tolerance of the chunk-parallel ``lm.forward``."""
    jcfg, jparams, tcfg, tparams = request.getfixturevalue(which)
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
    np.testing.assert_allclose(port, np.concatenate(ref, axis=1), atol=TOL,
                               rtol=TOL)
    full, _ = tlm.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(port, full.numpy(), atol=GLA_TOL,
                               rtol=GLA_TOL)
    kinds = tcfg.layer_kinds()
    for kind, c, j in zip(kinds, caches, jc, strict=True):
        names = ("k", "v") if kind == "shared_attn" else ("ssm", "conv")
        assert set(c) == set(names)
        for name in names:
            np.testing.assert_allclose(c[name].numpy(), np.asarray(j[name]),
                                       atol=TOL, rtol=TOL)


class _Spy:
    """Counts calls of kernel 1's entries (``rmsnorm``, ``add_rmsnorm``,
    ``qk_norm_rope``: one launch each on the card) inside each
    ``lm.forward_cached`` call, and in all."""

    def __init__(self, monkeypatch):
        self.per_call = []
        self.entries = dict.fromkeys(("rmsnorm", "add_rmsnorm",
                                      "qk_norm_rope"), 0)
        for name in self.entries:
            monkeypatch.setattr(krms, name, self._entry(name))
        real = tlm.forward_cached

        def spy(*args, **kwargs):
            before = sum(self.entries.values())
            out = real(*args, **kwargs)
            self.per_call.append(sum(self.entries.values()) - before)
            return out

        monkeypatch.setattr(tlm, "forward_cached", spy)

    def _entry(self, name):
        real = getattr(krms, name)

        def fn(*args, **kwargs):
            self.entries[name] += 1
            return real(*args, **kwargs)

        return fn


def _kernel1_per_forward(cfg) -> int:
    """Layer 0's ln1, one add + norm per layer (the last with the final
    norm), and the shared block's inner add + ln2 at each use."""
    return 1 + cfg.n_layers + cfg.layer_kinds().count("shared_attn")


@pytest.mark.parametrize("which,want", [("zamba", 8), ("zamba14", 17)])
def test_kernel1_launches_per_forward(which, want, request, monkeypatch):
    """8 on the reduced config (45 at full depth: 1 + 37 + 1 + 6), for
    every prefill chunk and decode step of a scheduler run and for a
    full forward: the plain norm twice (layer 0's ln1, the final norm),
    the rest fused adds, no q/k-norm."""
    _, _, tcfg, tparams = request.getfixturevalue(which)
    assert _kernel1_per_forward(tcfg) == want
    assert _kernel1_per_forward(get_config(ZAMBA)) == 45
    spy = _Spy(monkeypatch)
    sched = ServeScheduler(tcfg, tparams, n_slots=2, max_len=32,
                           acc=StaticCoreChunk(cores=2), dispatch_depth=2,
                           device="cpu")
    sched.submit(np.arange(9), 3)
    sched.run_until_idle()
    assert len(spy.per_call) >= 2 and set(spy.per_call) == {want}
    spy.entries = dict.fromkeys(spy.entries, 0)
    tlm.forward(tparams, {"tokens": torch.zeros(1, 5, dtype=torch.long)},
                tcfg)
    assert spy.entries == {"rmsnorm": 1, "add_rmsnorm": want - 1,
                           "qk_norm_rope": 0}


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
def jax_tokens(zamba):
    """The JAX scheduler's greedy tokens of the trace (contiguous, fused
    depth 2, chunks of at most 8)."""
    jcfg, jparams, _, _ = zamba
    return _serve(JaxScheduler(jcfg, jparams, acc=JaxStatic(cores=2),
                               n_slots=2, max_len=48, chunk_buckets=(8,),
                               dispatch_depth=2), _trace())


@pytest.mark.parametrize("pool", ["contiguous", "per-tick", "paged"])
def test_scheduler_tokens_identical_to_jax(zamba, jax_tokens, pool):
    """f32 greedy tokens of the port's scheduler equal the JAX
    scheduler's: the fused path over the slot pool, the per-tick path,
    and the paged pool; the JAX paged scheduler agrees with its own
    contiguous one."""
    jcfg, jparams, tcfg, tparams = zamba
    kw = dict(n_slots=2, max_len=48, chunk_buckets=(8,),
              dispatch_depth=None if pool == "per-tick" else 2)
    if pool == "paged":
        kw.update(paged=True, page_size=8)
        ref = _serve(JaxScheduler(jcfg, jparams, acc=JaxStatic(cores=2),
                                  **kw), _trace())
        assert ref == jax_tokens
    sched = ServeScheduler(tcfg, tparams, acc=StaticCoreChunk(cores=2),
                           device="cpu", **kw)
    sched.warmup()
    assert _serve(sched, _trace()) == jax_tokens
    assert [len(o) for o in jax_tokens] == [m for _, m in _trace()]
    # Exact-size chunks (a recurrent state would absorb pad tokens).
    assert not sched._pad_ok
    assert all(step <= 8 for t in sched.trace for _, step in t.prefill_ops)


@pytest.mark.parametrize("paged", [False, True])
def test_a_reused_slot_serves_as_a_fresh_pool(zamba, jax_tokens, paged):
    """One slot: every request runs in slot 0 after the one before it
    released it (and after the warm-up wrote garbage into its state); the
    tokens are a fresh pool's."""
    _, _, tcfg, tparams = zamba
    sched = ServeScheduler(tcfg, tparams, n_slots=1, max_len=48,
                           acc=StaticCoreChunk(cores=2), chunk_buckets=(8,),
                           dispatch_depth=2, paged=paged, page_size=8,
                           device="cpu")
    sched.warmup()
    assert _serve(sched, _trace()) == jax_tokens
    assert {r.slot for r in sched.requests.values()} == {0}


def test_a_repeated_prompt_is_prefilled_in_full(zamba):
    """The paged pool keeps no prefix for a recurrent arch: the same
    prompt served twice is prefilled twice in full and gives the same
    tokens; qwen3's pool keeps its prefix cache."""
    _, _, tcfg, tparams = zamba
    prompt = np.random.default_rng(2).integers(0, 256, 20)
    sched = ServeScheduler(tcfg, tparams, n_slots=2, max_len=48,
                           acc=StaticCoreChunk(cores=1), chunk_buckets=(8,),
                           dispatch_depth=2, paged=True, page_size=8,
                           device="cpu")
    assert sched.pool.prefix_cache is False
    first = _serve(sched, [(prompt, 4)])
    second = _serve(sched, [(prompt, 4)])
    assert first == second
    stats = sched.pool.prefix_stats()
    assert stats["prefix_hits"] == 0 and stats["prefix_entries"] == 0
    assert stats["prefill_tokens_avoided"] == 0
    assert sum(step for t in sched.trace for _, step in t.prefill_ops) == 40


def test_speculation_stays_refused(zamba):
    _, _, tcfg, tparams = zamba
    for speculate in (2, "auto"):
        with pytest.raises(ValueError, match="attention-only"):
            ServeScheduler(tcfg, tparams, n_slots=2, max_len=32,
                           dispatch_depth=2, speculate=speculate,
                           device="cpu")


def _states(n, cfg, seed):
    """Random K/V for the shared-attention layers and random states for
    the Mamba2 layers, as numpy, over ``n`` lanes of 48 positions."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in cfg.layer_kinds():
        if kind == "shared_attn":
            shape = (n, cfg.n_kv_heads, 48, cfg.head_dim_)
            out.append({name: rng.standard_normal(shape).astype(np.float32)
                        for name in ("k", "v")})
        else:
            conv = cfg.d_inner + 2 * cfg.ssm_state
            out.append({
                "ssm": rng.standard_normal(
                    (n, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
                ).astype(np.float32),
                "conv": rng.standard_normal(
                    (n, cfg.conv_width - 1, conv)).astype(np.float32)})
    return out


@pytest.mark.parametrize("budgets", [[5, 0, 2], [0, 3, 3]])
def test_fused_step_keeps_a_spent_lanes_state(zamba, budgets):
    """The fused decode step against the JAX step from random states and
    K/V: the same tokens, every state and K/V row within 1e-5, and a
    lane with no budget keeps its state and K/V bit for bit (the
    reference's ``masked_merge``)."""
    jcfg, jparams, tcfg, tparams = zamba
    before = _states(3, tcfg, 8)
    toks = np.random.default_rng(9).integers(0, 256, 3)
    poss = [4, 11, 20]
    jc, jout, jtoks = jdl.make_fused_decode_step(jcfg, max_depth=8)(
        jparams, [{k: jnp.asarray(v) for k, v in c.items()} for c in before],
        jnp.asarray(toks, jnp.int32), jnp.asarray(poss, jnp.int32),
        jnp.asarray(budgets, jnp.int32))
    caches = [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
              for c in before]
    tc, tout, ttoks = tdl.make_fused_decode_step(tcfg, max_depth=8)(
        tparams, caches, torch.from_numpy(toks), torch.tensor(poss), budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    spent = [lane for lane in range(3) if budgets[lane] == 0]
    for t, j, b in zip(tc, jc, before, strict=True):
        for name in t:
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                       atol=TOL, rtol=TOL)
            np.testing.assert_array_equal(t[name].numpy()[spent],
                                          b[name][spent])


def test_paged_step_keeps_a_spent_lanes_state(zamba):
    """The paged decode step from the same states: tokens and states
    equal the contiguous step's, a spent lane's state bit for bit."""
    _, _, tcfg, tparams = zamba
    before = _states(3, tcfg, 10)
    toks, poss, budgets = torch.tensor([3, 5, 7]), [4, 11, 20], [4, 0, 2]
    contiguous = [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
                  for c in before]
    cc, cout, ctoks = tdl.make_fused_decode_step(tcfg, max_depth=8)(
        tparams, contiguous, toks, torch.tensor(poss), budgets)
    # Lane b's positions [0, 48) on pages 1 + 6b .. 6 + 6b, in order.
    ps, per = 8, 6
    table = (1 + torch.arange(3 * per)).view(3, per).to(torch.int32)
    paged = []
    for c in before:
        if "k" in c:
            paged.append({name: torch.cat([
                torch.zeros(ps, tcfg.n_kv_heads, tcfg.head_dim_),
                torch.from_numpy(c[name]).permute(0, 2, 1, 3).reshape(
                    -1, tcfg.n_kv_heads, tcfg.head_dim_)])
                for name in ("k", "v")})
        else:
            paged.append({k: torch.from_numpy(v.copy())
                          for k, v in c.items()})
    pc, pout, ptoks = tdl.make_paged_decode_step(tcfg, page_size=ps,
                                                 max_depth=8)(
        tparams, paged, table, toks, torch.tensor(poss), budgets)
    assert torch.equal(pout, cout) and torch.equal(ptoks, ctoks)
    for p, c, b in zip(pc, cc, before, strict=True):
        if "ssm" in p:
            for name in p:
                np.testing.assert_allclose(p[name].numpy(), c[name].numpy(),
                                           atol=TOL, rtol=TOL)
                np.testing.assert_array_equal(p[name].numpy()[1], b[name][1])


def test_pools_hold_state_rows(zamba):
    """Both pools: the state rows sit beside the K/V in the layout,
    ``read_slot`` / ``write_slot`` carry them, ``acquire`` zeroes them
    (and only the acquired slot's), ``fork`` copies them."""
    _, _, tcfg, _ = zamba
    for pool in (SlotKVCachePool(tcfg, 3, 32, device="cpu"),
                 PagedKVCachePool(tcfg, 3, 32, page_size=8, device="cpu")):
        kinds = tcfg.layer_kinds()
        for kind, c in zip(kinds, pool.caches, strict=True):
            assert set(c) == ({"k", "v"} if kind == "shared_attn"
                              else {"ssm", "conv"})
            for t in c.values():
                t.fill_(2.0)
        slot = pool.acquire("a")
        for kind, c in zip(kinds, pool.caches, strict=True):
            if kind == "mamba2":
                for t in c.values():
                    assert t[slot].eq(0).all()
                    assert t[[s for s in range(3) if s != slot]].eq(2).all()
            else:
                assert c["k"].eq(2).all()
        row = pool.read_slot(slot)
        assert row[0]["ssm"].shape == (1, *pool.caches[0]["ssm"].shape[1:])
        row[0]["ssm"] = torch.full_like(row[0]["ssm"], 5.0)
        pool.write_slot(slot, row)
        assert pool.caches[0]["ssm"][slot].eq(5).all()
        if isinstance(pool, PagedKVCachePool):
            other = pool.fork(slot, "b")
            assert pool.caches[0]["ssm"][other].eq(5).all()
            views = pool.slot_caches(slot)
            assert views[0]["ssm"].data_ptr() == \
                pool.caches[0]["ssm"][slot].data_ptr()
            assert views[5] is pool.caches[5]


def test_engine_lockstep_carries_the_state(zamba, jax_tokens):
    """``ServeEngine``: a first ``generate`` through the scheduler, then
    the lock-step path on an engine that holds state (prefill segments of
    3 and the rest, decode steps): the same tokens."""
    _, _, tcfg, tparams = zamba
    trace = _trace()
    prompts = np.stack([trace[0][0][:8], trace[3][0][:8]])
    engine = ServeEngine(tcfg, tparams, batch=2, max_len=48, device="cpu")
    scheduled = engine.generate(torch.from_numpy(prompts), 5)
    assert scheduled[1].tolist() == jax_tokens[3]
    engine.prefill(torch.from_numpy(prompts[:, :3]), chunk=3)
    lockstep = engine.generate(torch.from_numpy(prompts[:, 3:]), 5)
    assert engine.pos == 8 + 5
    assert lockstep.tolist() == scheduled.tolist()


@pytest.mark.parametrize("paged", [False, True])
def test_serve_cli_takes_zamba2(paged, capsys):
    launch_serve.main(["--arch", ZAMBA, "--reduced", "--device", "cpu",
                       "--requests", "2", "--slots", "2", "--prompt-len",
                       "12", "--new-tokens", "3", "--no-cal-cache"]
                      + (["--paged"] if paged else []))
    out = capsys.readouterr().out
    assert f"arch={ZAMBA} device=cpu requests=2" in out
    assert "generated 6 tokens" in out
    if paged:
        assert "prefix_hits=0" in out or "paged:" in out
