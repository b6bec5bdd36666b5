"""The port's model layer on the CPU against the JAX package's: the
weight bridge, ``forward_cached`` logits over chunked prefill and decode,
and the cache contents after the writes.  Same weights (bridged through
numpy), same tokens (seeded numpy)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm as tlm


def _configs(dtype: str):
    jcfg = dataclasses.replace(jax_config("qwen3-0.6b").reduced(),
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               compute_dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs("float32")
    return jlm.init_params(jax.random.PRNGKey(0), jcfg)


def test_configs_are_the_same_numbers():
    assert dataclasses.asdict(get_config("qwen3-0.6b")) == \
        dataclasses.asdict(jax_config("qwen3-0.6b"))


def test_bridge_unstacks_layer_groups(jax_params):
    _, tcfg = _configs("float32")
    arrays = jax.tree.map(np.asarray, jax_params)
    params = bridge.from_reference(arrays, tcfg, device="cpu")
    assert len(params["layers"]) == tcfg.n_layers
    for layer in range(tcfg.n_layers):
        np.testing.assert_array_equal(
            params["layers"][layer]["attn"]["wq"]["w"].numpy(),
            arrays["blocks"]["pos0"]["attn"]["wq"]["w"][layer])
        np.testing.assert_array_equal(
            params["layers"][layer]["ffn"]["w_gate"]["w"].numpy(),
            arrays["blocks"]["pos0"]["ffn"]["w_gate"]["w"][layer])
    np.testing.assert_array_equal(params["embed"]["table"].numpy(),
                                  arrays["embed"]["table"])
    assert "lm_head" not in params          # tied embeddings


def test_bridge_casts_weights_once_and_keeps_norms(jax_params):
    _, tcfg = _configs("bfloat16")
    params = bridge.from_reference(jax.tree.map(np.asarray, jax_params),
                                   tcfg, device="cpu")
    assert params["layers"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert params["embed"]["table"].dtype == torch.bfloat16
    assert params["layers"][0]["attn"]["q_norm"]["g"].dtype == torch.float32
    assert params["final_norm"]["g"].dtype == torch.float32


def _run_both(jax_params, dtype: str):
    """Two prefill chunks into a 2-row cache, then 3 decode steps; the
    port's decode steps take per-lane positions, as the serve loop's."""
    jcfg, tcfg = _configs(dtype)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jax_params),
                                    tcfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20))
    jc = jlm.init_caches(jcfg, 2, 32)
    tc = tlm.init_caches(tcfg, 2, 32, device="cpu")
    logits, pos = [], 0
    for piece in (toks[:, :12], toks[:, 12:]):
        jl, jc = jlm.forward_cached(jax_params, jnp.asarray(piece), jc, pos,
                                    jcfg)
        tl, tc = tlm.forward_cached(tparams, torch.from_numpy(piece), tc,
                                    pos, tcfg)
        logits.append((jl, tl))
        pos += piece.shape[1]
    tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1))[:, None]
    for _ in range(3):
        jl, jc = jlm.forward_cached(jax_params, jnp.asarray(tok), jc, pos,
                                    jcfg)
        tl, tc = tlm.forward_cached(tparams, torch.from_numpy(tok.copy()), tc,
                                    torch.full((2,), pos), tcfg)
        logits.append((jl, tl))
        pos += 1
        tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1))[:, None]
    return logits, jc, tc


def test_forward_cached_f32_matches_jax(jax_params):
    """f32: the same arithmetic in another summation order."""
    logits, jc, tc = _run_both(jax_params, "float32")
    for jl, tl in logits:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
    for jlayer, tlayer in zip(jc, tc, strict=True):
        for name in ("k", "v"):
            np.testing.assert_allclose(tlayer[name].numpy(),
                                       np.asarray(jlayer[name]),
                                       atol=1e-5, rtol=1e-5)


def test_forward_cached_bf16_matches_jax(jax_params):
    """bf16 compute: the two frameworks round activations at different
    places (XLA fuses casts away), so each of the few dozen bf16 ops may
    differ by a bf16 step (2^-8 relative); logits are O(0.1-1) here."""
    logits, jc, tc = _run_both(jax_params, "bfloat16")
    for jl, tl in logits:
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, dtype=np.float32),
                                   atol=5e-2, rtol=5e-2)
    for jlayer, tlayer in zip(jc, tc, strict=True):
        np.testing.assert_allclose(tlayer["k"].float().numpy(),
                                   np.asarray(jlayer["k"], np.float32),
                                   atol=5e-2, rtol=5e-2)


def test_decode_writes_only_the_requested_lanes(jax_params):
    _, tcfg = _configs("float32")
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jax_params),
                                    tcfg, device="cpu")
    caches = tlm.init_caches(tcfg, 3, 8, device="cpu")
    tlm.forward_cached(tparams, torch.tensor([[1], [2], [3]]), caches,
                       torch.tensor([0, 4, 7]), tcfg,
                       write_rows=torch.tensor([0, 2]))
    k = caches[0]["k"]
    assert k[0, :, 0].abs().sum() > 0 and k[2, :, 7].abs().sum() > 0
    assert k[1].abs().sum() == 0            # the inactive lane is untouched


def test_cache_write_past_the_end_raises(jax_params):
    """JAX's dynamic_update_slice would clamp this write silently."""
    _, tcfg = _configs("float32")
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jax_params),
                                    tcfg, device="cpu")
    caches = tlm.init_caches(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        tlm.forward_cached(tparams, torch.zeros((1, 4), dtype=torch.long),
                           caches, 6, tcfg)


def test_init_params_is_seeded():
    _, tcfg = _configs("float32")
    a = tlm.init_params(3, tcfg, device="cpu")
    b = tlm.init_params(3, tcfg, device="cpu")
    c = tlm.init_params(4, tcfg, device="cpu")
    assert torch.equal(a["layers"][1]["attn"]["wo"]["w"],
                       b["layers"][1]["attn"]["wo"]["w"])
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])


def test_unported_block_kinds_raise():
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              block_pattern=("mamba2",))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.init_params(0, cfg, device="cpu")
