"""The port's kernel modules on the CPU: each plain PyTorch version held
against the JAX package's Pallas kernel run in interpret mode (and, for
per-lane kv lengths, against the reference's ``_cache_attention``).

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds them against these same plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as K
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import _cache_attention
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rmsnorm as trms

# f32: the same arithmetic summed in another order.  bf16: both sides
# compute in f32 and round once to bf16, so a different last f32 bit can
# move the output by one bf16 step (2^-8 relative).
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}


def _pair(x: np.ndarray, dtype: str):
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x.copy()).to(getattr(torch, dtype))
    return jx, tx


def _close(t: torch.Tensor, j, dtype: str):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, dtype=np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_rmsnorm_plain_matches_pallas(d, dtype):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((24, d)).astype(np.float32) * 3.0
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ref = K.rmsnorm(jx, jnp.asarray(g), eps=1e-6, interpret=True)
    out = trms.rmsnorm(tx, torch.from_numpy(g), eps=1e-6)
    assert out.dtype == tx.dtype
    _close(out, ref, dtype)


def _qkv(rng, b, hq, hkv, sq, skv, d):
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,sq,skv", [
    (4, 2, 16, 16),      # GQA, square
    (4, 2, 8, 40),       # GQA, queries end-aligned, kv padded by ops
    (8, 1, 5, 37),       # MQA, ragged both ways
])
def test_attention_plain_matches_pallas(hq, hkv, sq, skv, dtype):
    rng = np.random.default_rng(hq * 100 + skv)
    q, k, v = _qkv(rng, 2, hq, hkv, sq, skv, 16)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    ref = K.flash_attention(jq, jk, jv, causal=True, block_q=8,
                            block_kv=16, interpret=True)
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    _close(out, ref, dtype)


@pytest.mark.parametrize("window", [1, 7, 64])
def test_attention_plain_window_matches_pallas(window):
    rng = np.random.default_rng(window)
    q, k, v = _qkv(rng, 1, 4, 2, 12, 48, 16)
    ref = K.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window, block_q=4,
                            block_kv=16, interpret=True)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window)
    _close(out, ref, "float32")


@pytest.mark.parametrize("kv_len,window", [(29, None), (29, 7), (3, None)])
def test_attention_plain_kv_padding_matches_pallas(kv_len, window):
    """kv_len < Skv: keys past it are padding; queries end at kv_len."""
    rng = np.random.default_rng(kv_len)
    q, k, v = _qkv(rng, 2, 4, 2, 3, 32, 16)
    ref = flash_attention_pallas(
        jnp.asarray(np.pad(q, ((0, 0), (0, 0), (0, 1), (0, 0)))),
        jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
        kv_len=kv_len, sq_true=3, block_q=4, block_kv=16, interpret=True)
    lens = torch.full((2,), kv_len, dtype=torch.int32)
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), lens, causal=True,
                              window=window)
    _close(out, np.asarray(ref)[:, :, :3], "float32")


@pytest.mark.parametrize("sq", [1, 4])
def test_attention_per_lane_lengths_match_cache_attention(sq):
    """A batch whose lanes each sit at their own cache length — the
    fused decode's call — against the reference's einsum-softmax
    ``_cache_attention`` lane by lane."""
    rng = np.random.default_rng(sq)
    q, k, v = _qkv(rng, 4, 4, 2, sq, 24, 16)
    lens = [sq, 9, 17, 24]
    out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              torch.tensor(lens, dtype=torch.int32))
    for b, n in enumerate(lens):
        ref = _cache_attention(jnp.asarray(q[b:b + 1]),
                               jnp.asarray(k[b:b + 1]),
                               jnp.asarray(v[b:b + 1]), n, causal=True)
        _close(out[b:b + 1], ref, "float32")


def test_attention_no_key_row_is_zero():
    """A query row with no visible key gives 0, as the flash kernel does
    (the einsum-softmax would give NaN)."""
    q = torch.randn(1, 2, 3, 16)
    k = torch.randn(1, 2, 8, 16)
    out = tfa.flash_attention(q, k, k.clone(),
                              torch.tensor([1], dtype=torch.int32))
    assert torch.isfinite(out).all()
    assert out[0, :, :2].abs().max() == 0     # rows at positions -2, -1
    assert out[0, :, 2].abs().max() > 0


def test_cpu_tensors_never_count_a_launch():
    trms.launches.reset()
    tfa.launches.reset()
    trms.rmsnorm(torch.randn(4, 16), torch.ones(16))
    tfa.flash_attention(torch.randn(1, 2, 1, 16), torch.randn(1, 1, 4, 16),
                        torch.randn(1, 1, 4, 16))
    assert trms.launches.count == 0
    assert tfa.launches.count == 0


def test_wrapper_checks_reject_bad_inputs():
    q = torch.randn(1, 4, 2, 16)
    k = torch.randn(1, 2, 8, 16)
    lens = torch.tensor([8], dtype=torch.int32)
    tfa._check(q, k, k, lens)                         # a valid call
    with pytest.raises(TypeError):
        tfa._check(q.half(), k.half(), k.half(), lens)
    with pytest.raises(ValueError):
        tfa._check(q, torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16),
                   lens)
    with pytest.raises(ValueError):
        tfa._check(q, k, k, lens.long())
    with pytest.raises(ValueError):
        tfa._check(q.transpose(2, 3).contiguous().transpose(2, 3), k, k,
                   lens)
