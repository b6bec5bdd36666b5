"""Kernel 1's fused entry points on the CPU: ``add_rmsnorm`` (the
residual add and the norm after it) and ``qk_norm_rope`` (q- and k-norm
and the rotary embedding), their plain versions against the JAX
package's functions, how the model's forward calls them, and, on meta
tensors, that each wrapper launches its kernel once and computes nothing
with library ops.  Plus the allocation of kernel 6's output.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them
against these plain versions there, and each fused launch bit for bit
against its unfused composition.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models import common as jcm
from repro_torch.configs import get_config
from repro_torch.kernels import adjacent_difference as kad
from repro_torch.kernels import rmsnorm as krms
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm

DTYPES = ["float32", "bfloat16"]
# f32: the same arithmetic, the row's sum in another order.  bf16: both
# sides compute in f32 and round once, so a different last f32 bit can
# move an output by one bf16 step (2^-8 relative).
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=1e-2)}


def _pair(x: np.ndarray, dtype: str):
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


def _close(t: torch.Tensor, j, dtype: str, **tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, dtype=np.float32),
                               **(tol or TOL[dtype]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [128, 1024])
def test_add_rmsnorm_plain_matches_pallas(d, dtype):
    """(s, h) against JAX ``x + y`` and then ``rmsnorm_pallas`` in
    interpret mode: s bit for bit (one rounded add on both sides), h
    within TOL."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((16, d)).astype(np.float32) * 2.0
    y = rng.standard_normal((16, d)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(x, dtype), _pair(y, dtype)
    js = jx + jy
    jh = rmsnorm_pallas(js, jnp.asarray(g), eps=1e-6, block_rows=8,
                        interpret=True)
    s, h = krms.add_rmsnorm(tx, ty, torch.from_numpy(g), eps=1e-6)
    assert s.dtype == h.dtype == tx.dtype
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js, dtype=np.float32))
    _close(h, jh, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_is_bit_equal_to_x_plus_y(dtype):
    """The residual stream the fused entry returns is PyTorch's own
    ``x + y``, and its norm is the plain norm of that sum."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 64, generator=gen).to(getattr(torch, dtype))
    y = torch.randn(3, 5, 64, generator=gen).to(getattr(torch, dtype))
    g = 1.0 + 0.1 * torch.randn(64, generator=gen)
    s, h = krms.add_rmsnorm(x, y, g, eps=1e-5)
    assert torch.equal(s, x + y)
    assert torch.equal(h, krms.rmsnorm(x + y, g, eps=1e-5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,length,hq,hkv,d", [
    (2, 3, 4, 2, 16), (8, 1, 16, 8, 128), (1, 5, 2, 1, 64)])
def test_qk_norm_rope_plain_matches_jax(b, length, hq, hkv, d, dtype):
    """q', k' against the reference model's ``apply_rope(rmsnorm(.))``.
    The port's layout is (B, L, H, D) with cos/sin (B, L, D/2); the
    reference rotates (B, H, S, D) with broadcast angles.  The reference
    norm multiplies by rsqrt where kernel 1 divides by sqrt (ROADMAP
    kernel note): a last-bit difference in f32, one bf16 step at most."""
    rng = np.random.default_rng(b * 100 + d)
    q = rng.standard_normal((b, length, hq, d)).astype(np.float32) * 3.0
    k = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    gq = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    gk = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    # The same angles on both sides: the two frameworks' pow and cos may
    # differ in a last bit, which this test is not about.
    ang = rng.uniform(0, 4000, (b, length, d // 2)).astype(np.float32)
    tcos, tsin = torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    jcos, jsin = jnp.asarray(np.cos(ang)), jnp.asarray(np.sin(ang))
    (jq, tq), (jk, tk) = _pair(q, dtype), _pair(k, dtype)
    qo, ko = krms.qk_norm_rope(tq, tk, torch.from_numpy(gq),
                               torch.from_numpy(gk), tcos, tsin, eps=1e-6)
    assert qo.shape == tq.shape and ko.shape == tk.shape
    assert qo.dtype == ko.dtype == tq.dtype
    for t, j, g in ((qo, jq, gq), (ko, jk, gk)):
        jn = jcm.rmsnorm({"g": jnp.asarray(g)}, j, 1e-6)
        ref = jcm.apply_rope(jnp.transpose(jn, (0, 2, 1, 3)),
                             jcos[:, None], jsin[:, None])
        _close(t.transpose(1, 2), ref, dtype)


def test_qk_norm_rope_is_norm_then_model_rope():
    """The plain fused version is kernel 1's norm followed by the model's
    rotary embedding, bit for bit, and the model's rotary embedding is
    the kernels package's one definition of it."""
    assert tcm.apply_rope is krms.rope_ref
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 6, 32, generator=gen).bfloat16()
    k = torch.randn(2, 4, 3, 32, generator=gen).bfloat16()
    gq, gk = torch.rand(32, generator=gen), torch.rand(32, generator=gen)
    cos, sin = tcm.rope_angles(torch.arange(8).view(2, 4), 32, 1e4)
    qo, ko = krms.qk_norm_rope(q, k, gq, gk, cos, sin, eps=1e-6)
    assert torch.equal(qo, tcm.apply_rope(krms.rmsnorm(q, gq, eps=1e-6),
                                          cos, sin))
    assert torch.equal(ko, tcm.apply_rope(krms.rmsnorm(k, gk, eps=1e-6),
                                          cos, sin))


def test_forward_calls_the_fused_entries(monkeypatch):
    """One forward at reduced depth: each residual add goes through
    ``add_rmsnorm`` except the last (2·n_layers − 1 calls), one
    ``qk_norm_rope`` per layer, and the plain norm twice (layer 0's ln1
    and the final norm): 3·n_layers + 1 launches of kernel 1 on the
    card, 85 at qwen3-0.6b's 28 layers."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              n_layers=3)
    params = tlm.init_params(0, cfg, device="cpu")
    calls = {"rmsnorm": 0, "add_rmsnorm": 0, "qk_norm_rope": 0}

    def spy(name):
        real = getattr(krms, name)

        def fn(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return fn

    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5)))
    caches = tlm.init_caches(cfg, 2, 16, device="cpu")
    ref, _ = tlm.forward_cached(params, tokens, caches, 0, cfg)
    for name in calls:
        monkeypatch.setattr(krms, name, spy(name))
    caches = tlm.init_caches(cfg, 2, 16, device="cpu")
    out, _ = tlm.forward_cached(params, tokens, caches, 0, cfg)
    assert calls == {"rmsnorm": 2, "add_rmsnorm": 2 * cfg.n_layers - 1,
                     "qk_norm_rope": cfg.n_layers}
    assert sum(calls.values()) == 3 * cfg.n_layers + 1
    assert torch.equal(out, ref)


# ---------------------------------------------------------------------------
# the CUDA branch of the wrappers, driven on meta tensors (no card)
# ---------------------------------------------------------------------------

class _Record(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


# Any of these on the way would mean a library op computed part of the
# kernel's work.
LIBRARY = {"rms_norm", "layer_norm", "mean", "sqrt", "rsqrt", "add",
           "__add__", "sub", "__sub__", "mul", "__mul__", "cat", "pow"}


@pytest.fixture
def card(monkeypatch):
    """The wrappers' card branch with a recording library in place of the
    built one; meta tensors stand in for CUDA tensors."""
    lib = _FakeLib()
    monkeypatch.setattr(krms, "_lib", lambda: lib)
    monkeypatch.setattr(krms, "_require_card", lambda name, x: None)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    krms.reset_counts()
    yield lib
    krms.reset_counts()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rmsnorm_launches_once(card, dtype):
    x, y = _meta(8, 1, 1024, dtype=dtype), _meta(8, 1, 1024, dtype=dtype)
    g = torch.empty(1024, device="meta")
    with _Record() as rec:
        s, h = krms.add_rmsnorm(x, y, g, eps=1e-6)
    assert not LIBRARY & set(rec.calls)
    assert [c[0] for c in card.calls] == ["repro_add_rmsnorm"]
    # rows, d, eps, the block's warps (the default: no plan given), dtype
    assert card.calls[0][1][5:10] == (8, 1024, 1e-6, krms.DEFAULT_WARPS,
                                      krms._DTYPES[dtype])
    assert s.shape == h.shape == x.shape and s.dtype == h.dtype == dtype
    assert krms.launches.count == 1
    assert krms.entry_launches["add_rmsnorm"].count == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qk_norm_rope_launches_once_for_q_and_k(card, dtype):
    q, k = _meta(8, 1, 16, 128, dtype=dtype), _meta(8, 1, 8, 128, dtype=dtype)
    g = torch.empty(128, device="meta")
    cos = torch.empty(8, 1, 64, device="meta")
    with _Record() as rec:
        qo, ko = krms.qk_norm_rope(q, k, g, g, cos, cos, eps=1e-6)
    assert not LIBRARY & set(rec.calls)
    assert [c[0] for c in card.calls] == ["repro_qk_norm_rope"]
    assert card.calls[0][1][8:13] == (8 * 16, 8 * 8, 16, 8, 128)
    assert qo.shape == q.shape and ko.shape == k.shape
    assert krms.launches.count == 1
    assert krms.entry_launches["qk_norm_rope"].count == 1


def test_rmsnorm_launches_once(card):
    with _Record() as rec:
        out = krms.rmsnorm(_meta(4096, 1024), torch.empty(1024, device="meta"))
    assert not LIBRARY & set(rec.calls)
    assert [c[0] for c in card.calls] == ["repro_rmsnorm"]
    assert card.calls[0][1][3:5] == (4096, 1024)
    assert card.calls[0][1][6] == krms.DEFAULT_WARPS == 8
    assert out.shape == (4096, 1024)
    assert krms.launches.count == krms.entry_launches["rmsnorm"].count == 1


@pytest.mark.parametrize("case,error", [
    ("head dim without a layout", ValueError),
    ("cos of the wrong shape", ValueError),
    ("sin in bf16", ValueError),
    ("k of another type", TypeError),
    ("q not contiguous", ValueError),
])
def test_qk_norm_rope_refuses_what_the_kernel_does_not_take(card, case,
                                                            error):
    q, k = _meta(2, 3, 4, 128), _meta(2, 3, 2, 128)
    g = torch.empty(128, device="meta")
    cos = sin = torch.empty(2, 3, 64, device="meta")
    if case == "head dim without a layout":
        q, k, g = _meta(2, 3, 4, 80), _meta(2, 3, 2, 80), g[:80]
        cos = sin = cos[..., :40]
    elif case == "cos of the wrong shape":
        cos = torch.empty(2, 3, 128, device="meta")
    elif case == "sin in bf16":
        sin = _meta(2, 3, 64)
    elif case == "k of another type":
        k = _meta(2, 3, 2, 128, dtype=torch.float32)
    else:
        q = _meta(2, 4, 3, 128).transpose(1, 2)
    with pytest.raises(error):
        krms.qk_norm_rope(q, k, g, g, cos, sin)
    assert card.calls == [] and krms.launches.count == 0


def test_add_rmsnorm_refuses_mismatched_inputs(card):
    g = torch.empty(64, device="meta")
    with pytest.raises(ValueError):
        krms.add_rmsnorm(_meta(4, 64), _meta(2, 64), g)
    with pytest.raises(TypeError):
        krms.add_rmsnorm(_meta(4, 64), _meta(4, 64, dtype=torch.float32), g)
    with pytest.raises(ValueError):
        krms.add_rmsnorm(_meta(4, 60), _meta(4, 60), g[:60])
    assert card.calls == []


def test_cpu_tensors_never_count_a_launch():
    krms.reset_counts()
    x = torch.randn(2, 1, 2, 16)
    g = torch.ones(16)
    cos, sin = tcm.rope_angles(torch.zeros(2, 1), 16, 1e4)
    krms.add_rmsnorm(x, x, g)
    krms.qk_norm_rope(x, x, g, g, cos, sin)
    assert krms.launches.count == 0
    assert all(c.count == 0 for c in krms.entry_launches.values())


# ---------------------------------------------------------------------------
# kernel 6's output allocation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", range(8))
def test_adjacent_difference_output_shares_the_input_alignment(dtype,
                                                               offset):
    """The kernel loads and stores whole 16-byte vectors only where x and
    its output lie at the same offset from a boundary; an interior `par`
    chunk is a view one element left of one."""
    base = torch.zeros(4096 + 8, dtype=dtype)
    x = base[offset:offset + 4096]
    out = kad.out_like(x)
    assert out.shape == x.shape and out.dtype == dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16
