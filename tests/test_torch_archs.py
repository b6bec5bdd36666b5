"""The dense family on the CPU against the JAX package: granite-34b
(MQA, non-gated GELU), qwen1.5-32b (MHA, QKV bias), h2o-danube-1.8b
(sliding window, head dim 80 at full width) and musicgen-medium (MHA,
non-gated GELU), at their reduced sizes, f32.

Same weights (the reference's ``init_params`` bridged through numpy),
same tokens (seeded numpy).  ``forward_cached`` logits, the scheduler's
greedy tokens (contiguous and paged), the sliding-window ring under
chunked prefill (against the reference's full-sequence ``lm.forward``,
not its chunked ring, which is not causal), the refusals that stay, and
the attention plan and plain kernels at the family's full-width head
shapes.  The CUDA kernels at these shapes run only on the card
(``chip_smoke.py`` phase 9).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.acc import StaticCoreChunk as JaxStatic
from repro.kernels import ops as K
from repro.models import lm as jlm
from repro.serve import ServeScheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.acc import StaticCoreChunk
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trms
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as tlm
from repro_torch.serve import ServeEngine, ServeScheduler
from repro_torch.serve.engine import prefill_segments

DENSE = ("granite-34b", "qwen1.5-32b", "h2o-danube-1.8b", "musicgen-medium")
FULL = ("granite-34b", "qwen1.5-32b", "musicgen-medium")   # no window
DANUBE = "h2o-danube-1.8b"


def _params(name: str, seed: int = 0):
    """(jcfg, jparams, tcfg, tparams): the reduced arch's reference
    weights, with every QKV bias drawn non-zero (the reference initialises
    them to zero, which would hide a bias the port dropped)."""
    jcfg = jax_config(name).reduced()
    tcfg = get_config(name).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)

        def bias(path, leaf):
            if path[-1].key == "b":
                return jnp.asarray(0.1 * rng.standard_normal(leaf.shape),
                                   leaf.dtype)
            return leaf

        jparams = jax.tree_util.tree_map_with_path(bias, jparams)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    return _params(request.param)


@pytest.fixture(scope="module")
def danube():
    return _params(DANUBE)


def _tokens(n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, length))


# ---------------------------------------------------------------------------
# configs and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_configs_are_the_reference_numbers_and_registered(name):
    assert name in ARCH_NAMES
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jax_config(name))
    tlm.check_ported(get_config(name))


def test_bridge_carries_biases_and_the_ungated_ffn(arch):
    jcfg, jparams, tcfg, tparams = arch
    arrays = jax.tree.map(np.asarray, jparams)
    blocks = arrays["blocks"]["pos0"]
    for layer, p in enumerate(tparams["layers"]):
        for name in ("wq", "wk", "wv"):
            assert ("b" in p["attn"][name]) == tcfg.qkv_bias
            if tcfg.qkv_bias:
                np.testing.assert_array_equal(
                    p["attn"][name]["b"].numpy(),
                    blocks["attn"][name]["b"][layer])
        assert ("w_gate" in p["ffn"]) == tcfg.ffn_gated
        np.testing.assert_array_equal(p["ffn"]["w_up"]["w"].numpy(),
                                      blocks["ffn"]["w_up"]["w"][layer])
    n_ref = sum(a.size for a in jax.tree.leaves(arrays))
    n_port = sum(t.numel() for t in jax.tree.leaves(tparams))
    assert n_port == n_ref


# ---------------------------------------------------------------------------
# forward_cached against the reference
# ---------------------------------------------------------------------------

def test_forward_cached_matches_the_reference(arch):
    """Chunked prefill then decode steps; every fed position's logits
    within 1e-5 of the reference's.  Without a window against the
    reference's ``forward_cached``; under danube's window (16 reduced,
    the prompt 40 long) against its full-sequence ``lm.forward`` and its
    token-by-token path, with the port's chunks cut at the ring's end."""
    jcfg, jparams, tcfg, tparams = arch
    toks = _tokens(2, 40, 3)
    window = tcfg.attn_window
    caches = tlm.init_caches(tcfg, 2, 64, device="cpu")
    port = []
    for start, step in prefill_segments(36, 7, window=window):
        lg, _ = tlm.forward_cached(tparams, torch.from_numpy(
            toks[:, start:start + step]), caches, start, tcfg,
            all_logits=True)
        port.append(lg)
    for t in range(36, 40):
        lg, _ = tlm.forward_cached(tparams, torch.from_numpy(
            toks[:, t:t + 1]), caches, torch.tensor([t, t]), tcfg)
        port.append(lg)
    port = torch.cat(port, dim=1).numpy()
    if window is None:
        jc = jlm.init_caches(jcfg, 2, 64)
        ref = []
        for start, step in prefill_segments(36, 7):
            lg, jc = jlm.forward_cached(jparams, jnp.asarray(
                toks[:, start:start + step]), jc, start, jcfg,
                all_logits=True)
            ref.append(np.asarray(lg))
        for t in range(36, 40):
            lg, jc = jlm.forward_cached(jparams, jnp.asarray(
                toks[:, t:t + 1]), jc, t, jcfg)
            ref.append(np.asarray(lg))
        ref = np.concatenate(ref, axis=1)
    else:
        full, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
        ref = np.asarray(full)
        jc = jlm.init_caches(jcfg, 2, 64)
        by_token = []
        for t in range(40):
            lg, jc = jlm.forward_cached(jparams, jnp.asarray(
                toks[:, t:t + 1]), jc, t, jcfg)
            by_token.append(np.asarray(lg))
        np.testing.assert_allclose(port, np.concatenate(by_token, axis=1),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=0)


def test_ring_prefill_chunk_is_causal_where_the_reference_is_not(danube):
    """A prefill chunk of 8 at position 0: the reference's ring attention
    masks only the populated slots, so its logits stray more than 0.1
    from its own ``lm.forward``; the port's stay within 1e-5 (see
    ROADMAP.md, faults of the reference)."""
    jcfg, jparams, tcfg, tparams = danube
    toks = _tokens(1, 8, 5)
    full, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    full = np.asarray(full)
    jc = jlm.init_caches(jcfg, 1, 64)
    ref_chunk, _ = jlm.forward_cached(jparams, jnp.asarray(toks), jc, 0,
                                      jcfg, all_logits=True)
    caches = tlm.init_caches(tcfg, 1, 64, device="cpu")
    port, _ = tlm.forward_cached(tparams, torch.from_numpy(toks), caches, 0,
                                 tcfg, all_logits=True)
    assert np.abs(np.asarray(ref_chunk) - full).max() > 0.1
    np.testing.assert_allclose(port.numpy(), full, atol=1e-5, rtol=0)


def test_ring_rejects_a_chunk_across_its_end(danube):
    _, _, tcfg, tparams = danube
    caches = tlm.init_caches(tcfg, 1, 64, device="cpu")
    with pytest.raises(ValueError, match="ring's end"):
        tlm.forward_cached(tparams, torch.zeros((1, 4), dtype=torch.long),
                           caches, 14, tcfg)
    with pytest.raises(ValueError, match="one new row per lane"):
        tlm.forward_cached(tparams, torch.zeros((1, 2), dtype=torch.long),
                           caches, torch.tensor([3]), tcfg)


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
@pytest.mark.parametrize("name", FULL)
def test_scheduler_tokens_identical_to_jax(name, paged):
    """f32 greedy tokens of the port's ``ServeScheduler`` equal the JAX
    scheduler's on the same fixed chunk decisions, contiguous and
    paged."""
    jcfg, jparams, tcfg, tparams = _params(name)
    trace = _trace()
    kw = dict(n_slots=2, max_len=64, dispatch_depth=2)
    if paged:
        kw.update(paged=True, page_size=8)
    ref = _serve(JaxScheduler(jcfg, jparams, acc=JaxStatic(cores=2), **kw),
                 trace)
    sched = ServeScheduler(tcfg, tparams, acc=StaticCoreChunk(cores=2),
                           device="cpu", **kw)
    assert _serve(sched, trace) == ref
    assert [len(o) for o in ref] == [m for _, m in trace]


@pytest.fixture(scope="module")
def rollout(danube):
    """Each trace prompt's greedy continuation by the reference's
    ``lm.forward`` (window 16) over the whole sequence, padded to one
    length so that one compile serves every step (causal: the padding
    after a position never reaches it)."""
    jcfg, jparams, _, _ = danube
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


@pytest.mark.parametrize("depth", [None, 4])
@pytest.mark.parametrize("chunk", [1, 5, 8, 16])
def test_windowed_tokens_equal_the_reference_rollout(danube, rollout, chunk,
                                                     depth):
    """danube's served tokens, prompts past the window, prefill chunks of
    at most ``chunk`` (cut at the ring's end): the reference's greedy
    rollout, whatever the chunk size and decode path."""
    _, _, tcfg, tparams = danube
    sched = ServeScheduler(tcfg, tparams, n_slots=2, max_len=64,
                           acc=StaticCoreChunk(cores=2),
                           chunk_buckets=(chunk,), dispatch_depth=depth,
                           device="cpu")
    assert _serve(sched, _trace()) == rollout
    steps = [s for t in sched.trace for _, s in t.prefill_ops]
    assert max(steps) == chunk
    assert sched.pool.caches[0]["k"].shape[2] == tcfg.attn_window


@pytest.mark.parametrize("budgets", [[7, 0, 3], [2, 5, 0]])
def test_windowed_fused_step_matches_jax(danube, budgets):
    """The fused decode step over a ring pool (window 16, lanes at
    positions 5, 20 and 37: before the wrap, past it, two laps on)
    against the JAX step, whose token-by-token ring is exact: the same
    tokens, the same ring rows (each lane's writes at ``pos % 16``, a
    spent lane's rows unchanged)."""
    from repro.serve import decode_loop as jdl
    from repro_torch.serve import decode_loop as tdl

    jcfg, jparams, tcfg, tparams = danube
    rng = np.random.default_rng(7)
    shape = (3, tcfg.n_kv_heads, tcfg.attn_window, tcfg.head_dim_)
    kv = [{name: rng.standard_normal(shape).astype(np.float32)
           for name in ("k", "v")} for _ in range(tcfg.n_layers)]
    toks, poss = rng.integers(0, 256, 3), [5, 20, 37]
    jc, jout, jtoks = jdl.make_fused_decode_step(jcfg, max_depth=8)(
        jparams, [{k: jnp.asarray(v) for k, v in c.items()} for c in kv],
        jnp.asarray(toks, jnp.int32), jnp.asarray(poss, jnp.int32),
        jnp.asarray(budgets, jnp.int32))
    caches = [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
              for c in kv]
    tc, tout, ttoks = tdl.make_fused_decode_step(
        tcfg, window=tcfg.attn_window, max_depth=8)(
            tparams, caches, torch.from_numpy(toks), torch.tensor(poss),
            budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    for t, j, before in zip(tc, jc, kv, strict=True):
        for name in ("k", "v"):
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                       atol=1e-5, rtol=1e-5)
            spent = [lane for lane in range(3) if budgets[lane] == 0]
            np.testing.assert_array_equal(t[name].numpy()[spent],
                                          before[name][spent])


def test_engine_lockstep_runs_through_the_ring(danube, rollout):
    """``ServeEngine``: a first ``generate`` through the scheduler, then
    the lock-step path (prefill segments cut at the ring's end, decode
    steps past the wrap) on an engine that holds state."""
    _, _, tcfg, tparams = danube
    trace = _trace()
    prompts = np.stack([trace[0][0][:20], trace[1][0][:20]])
    engine = ServeEngine(tcfg, tparams, batch=2, max_len=64, device="cpu")
    scheduled = engine.generate(torch.from_numpy(prompts), 6)
    assert scheduled[0].tolist() == rollout[0]
    engine.prefill(torch.from_numpy(prompts[:, :3]), chunk=3)
    lockstep = engine.generate(torch.from_numpy(prompts[:, 3:]), 6)
    assert engine.pos == 20 + 6
    assert lockstep.tolist() == scheduled.tolist()


def test_window_refusals_stay(danube):
    """Speculation and the paged pool refuse a window, as the
    reference's do."""
    _, _, tcfg, tparams = danube
    kw = dict(n_slots=2, max_len=64, dispatch_depth=2, device="cpu")
    with pytest.raises(ValueError, match="full attention"):
        ServeScheduler(tcfg, tparams, speculate=2, **kw)
    with pytest.raises(ValueError, match="SWA"):
        ServeScheduler(tcfg, tparams, paged=True, page_size=8, **kw)


@pytest.mark.parametrize("name", DENSE)
def test_serve_cli_takes_every_dense_arch(name, capsys):
    launch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "2", "--slots", "2", "--prompt-len",
                       "20", "--new-tokens", "3", "--no-cal-cache"])
    out = capsys.readouterr().out
    assert f"arch={name} device=cpu requests=2" in out
    assert "generated 6 tokens" in out


# ---------------------------------------------------------------------------
# kernels 1-3 at the family's full-width shapes (plain versions; the
# plan, which the CUDA source mirrors)
# ---------------------------------------------------------------------------

# (Hq, Hkv, D) at full width.
HEADS = {"granite-34b": (48, 1, 128), "qwen1.5-32b": (40, 40, 128),
         "h2o-danube-1.8b": (32, 8, 80), "musicgen-medium": (24, 24, 64)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", DENSE)
def test_attention_plan_at_the_family_shapes(name, dtype):
    """Decode (Sq 1) and a prefill chunk of 256 over 8 lanes: granite's
    48 packed rows per kv head go to the tile path even at decode; the
    others' decode rows (1 or 4) to the split path."""
    hq, hkv, d = HEADS[name]
    full = get_config(name)
    assert (full.n_heads, full.n_kv_heads, full.head_dim_) == (hq, hkv, d)
    decode = tfa.attention_plan(8, hq, hkv, 1, dtype)
    assert decode.rows == hq // hkv
    assert decode.path == ("tile" if hq // hkv > tfa.SPLIT_ROWS else "split")
    assert tfa.attention_plan(1, hq, hkv, 256, dtype).path == "tile"
    if name == "granite-34b":
        assert decode.path == "tile" and decode.scratch_bytes(8192) == 0


@pytest.mark.parametrize("d", [64, 80, 128])
def test_wrappers_accept_the_family_head_dims(d):
    """Kernels 2 and 3 take head dims 64 and 80 inside kMaxD 128; a dim
    off the 8-element vector or past 128 is refused."""
    q = torch.zeros(2, 4, 1, d)
    k = torch.zeros(2, 2, 16, d)
    lens = torch.full((2,), 16, dtype=torch.int32)
    tfa._check(q, k, k, lens)
    store = torch.zeros(32, 2, d)
    table = torch.zeros(2, 2, dtype=torch.int32)
    tfa._check_paged(q, store, store, table, lens, 16)
    for bad in (84, 136):
        with pytest.raises(ValueError, match="head dim"):
            tfa._check(torch.zeros(2, 4, 1, bad), torch.zeros(2, 2, 16, bad),
                       torch.zeros(2, 2, 16, bad), lens)


@pytest.mark.parametrize("hq,hkv,d,sq", [
    (48, 1, 128, 1),      # granite decode: 48 packed rows, tile path
    (48, 1, 128, 3),
    (40, 40, 128, 1),     # qwen1.5: group 1
    (40, 40, 128, 17),
    (32, 8, 80, 4),       # danube: D 80, group 4
    (32, 8, 80, 5),
    (24, 24, 64, 16),     # musicgen: D 64, group 1
])
def test_plain_attention_matches_pallas_at_the_family_shapes(hq, hkv, d, sq):
    rng = np.random.default_rng(hq + d + sq)
    skv = 40
    q = rng.standard_normal((1, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((1, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((1, hkv, skv, d)).astype(np.float32)
    ref = K.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, block_q=8, block_kv=16,
                            interpret=True)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_plain_windowed_attention_matches_pallas_at_head_dim_80():
    rng = np.random.default_rng(80)
    q = rng.standard_normal((1, 32, 24, 80)).astype(np.float32)
    k = rng.standard_normal((1, 8, 24, 80)).astype(np.float32)
    v = rng.standard_normal((1, 8, 24, 80)).astype(np.float32)
    ref = K.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=16, block_q=8, block_kv=8,
                            interpret=True)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1536, 2560, 5120, 6144])
def test_rmsnorm_plain_matches_pallas_at_the_family_widths(d, dtype):
    """Kernel 1's rows at the four model widths: on the card its
    runtime-loop path, since no width here is a register layout (a power
    of two from 8 to 256 16-byte vectors)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((8, d)).astype(np.float32) * 3.0
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = K.rmsnorm(jx, jnp.asarray(g), eps=1e-6, interpret=True)
    out = trms.rmsnorm(tx, torch.from_numpy(g), eps=1e-6)
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == "float32" \
        else dict(atol=3e-2, rtol=1e-2)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32), **tol)
    layouts = (8, 16, 32, 64, 128, 256)
    assert d * 2 // 16 not in layouts and d * 4 // 16 not in layouts
