"""Kernel 1's backward on the CPU: the autograd entries ``RMSNormFn``,
``AddRMSNormFn`` and ``QKNormRopeFn`` (their plain backward versions
here) against the JAX package's custom VJP (``repro.kernels.ops.rmsnorm``,
the Pallas forward in interpret mode and the closed-form backward) and
JAX autodiff of the unfused compositions; ``gradcheck`` of the plain
path in f64; and, on meta tensors, the card branch: one backward launch
per entry, no library op computing the backward, the grad guard of the
raw forward entries, and the backward's constants against the CUDA
source.

The CUDA backward runs only on the card; ``chip_smoke.py`` phase 8 holds
it against these plain versions there and checks that two calls give
the same bits.  Since the backward became one kernel a call, the meta
tests also hold each entry to one C call with no zeroed or cast dγ, and
its scratch to one buffer per device and stream, made once.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.kernels import ops as kops
from repro.models import common as jcm
from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm as krms
from repro_torch.models import common as tcm

DTYPES = ["float32", "bfloat16"]
# f32: the same closed form; the reference multiplies by rsqrt in its
# forward where kernel 1 divides by sqrt, and sums in another order.
# bf16: x, y and the cotangents are bf16 on both sides, the arithmetic f32,
# each result rounded once to bf16 (one step, 2^-8 relative, at |dx| up to
# ~10), and dγ summed in f32 over the rows.
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=6e-2, rtol=2e-2)}
EPS = 1e-6


def _pair(x: np.ndarray, dtype: str):
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


def _close(t: torch.Tensor, j, dtype: str):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, dtype=np.float32), **TOL[dtype])


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_()


@pytest.mark.parametrize("shape,dtype", [
    ((50, 128), "float32"), ((50, 128), "bfloat16"), ((2, 7, 64), "float32"),
    ((2, 7, 64), "bfloat16"), ((3, 1024), "float32")])
def test_rmsnorm_grad_matches_the_reference_custom_vjp(shape, dtype):
    """dx and dγ against ``jax.value_and_grad`` of ``ops.rmsnorm`` (the
    reference's custom VJP) for one random cotangent."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    g = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    jval, (jdx, jdg) = jax.value_and_grad(
        lambda a, b: jnp.sum((kops.rmsnorm(a, b, eps=EPS) * jw)
                             .astype(jnp.float32)), argnums=(0, 1))(
        jx, jnp.asarray(g))
    tx, tg = _leaf(tx), _leaf(torch.from_numpy(g))
    out = krms.RMSNormFn.apply(tx, tg, EPS)
    out.backward(tw)
    assert tx.grad.dtype == tx.dtype and tg.grad.dtype == torch.float32
    _close(tx.grad, jdx, dtype)
    _close(tg.grad, jdg, dtype)
    assert float((out * tw).float().sum().detach()) == pytest.approx(
        float(jval), rel=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("use_s", [True, False])
def test_add_rmsnorm_grad_matches_the_unfused_composition(use_s, dtype):
    """d(x, y, γ) against JAX autodiff of ``s = x + y`` followed by the
    reference's norm, for a loss on both outputs, or on the norm alone
    (the residual's gradient is then None and is not added)."""
    rng = np.random.default_rng(7 + use_s)
    x = rng.standard_normal((4, 9, 128)).astype(np.float32)
    y = rng.standard_normal((4, 9, 128)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    ws = rng.standard_normal(x.shape).astype(np.float32)
    wh = rng.standard_normal(x.shape).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(x, dtype), _pair(y, dtype)
    (jws, tws), (jwh, twh) = _pair(ws, dtype), _pair(wh, dtype)

    def jloss(a, b, gam):
        s = a + b
        h = kops.rmsnorm(s, gam, eps=EPS)
        out = jnp.sum((h * jwh).astype(jnp.float32))
        return out + jnp.sum((s * jws).astype(jnp.float32)) if use_s else out

    jdx, jdy, jdg = jax.grad(jloss, argnums=(0, 1, 2))(jx, jy,
                                                       jnp.asarray(g))
    tx, ty, tg = _leaf(tx), _leaf(ty), _leaf(torch.from_numpy(g))
    s, h = krms.AddRMSNormFn.apply(tx, ty, tg, EPS)
    loss = (h * twh).float().sum()
    if use_s:
        loss = loss + (s * tws).float().sum()
    loss.backward()
    _close(tx.grad, jdx, dtype)
    _close(ty.grad, jdy, dtype)
    _close(tg.grad, jdg, dtype)


@pytest.mark.parametrize("b,length,hq,hkv,d,dtype", [
    (2, 3, 4, 2, 16, "bfloat16"), (2, 3, 4, 2, 16, "float32"),
    (1, 6, 16, 8, 128, "float32")])
def test_qk_norm_rope_grad_matches_the_unfused_composition(b, length, hq,
                                                           hkv, d, dtype):
    """dq, dk, dγq, dγk against JAX autodiff of the reference's
    ``apply_rope(ops.rmsnorm(.))`` (its custom VJP inside) in its (B, H,
    S, D) layout; the same angles on both sides."""
    rng = np.random.default_rng(b * 10 + d)
    q = rng.standard_normal((b, length, hq, d)).astype(np.float32) * 3.0
    k = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    gq = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    gk = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    wq = rng.standard_normal(q.shape).astype(np.float32)
    wk = rng.standard_normal(k.shape).astype(np.float32)
    ang = rng.uniform(0, 4000, (b, length, d // 2)).astype(np.float32)
    tcos, tsin = torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    jcos, jsin = jnp.asarray(np.cos(ang))[:, None], \
        jnp.asarray(np.sin(ang))[:, None]
    (jq, tq), (jk, tk) = _pair(q, dtype), _pair(k, dtype)
    (jwq, twq), (jwk, twk) = _pair(wq, dtype), _pair(wk, dtype)

    def jloss(qq, kk, g1, g2):
        def rot(t, g):
            n = kops.rmsnorm(jnp.transpose(t, (0, 2, 1, 3)), g, eps=EPS)
            return jnp.transpose(jcm.apply_rope(n, jcos, jsin), (0, 2, 1, 3))
        return (jnp.sum((rot(qq, g1) * jwq).astype(jnp.float32))
                + jnp.sum((rot(kk, g2) * jwk).astype(jnp.float32)))

    grads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jq, jk, jnp.asarray(gq), jnp.asarray(gk))
    leaves = [_leaf(tq), _leaf(tk), _leaf(torch.from_numpy(gq)),
              _leaf(torch.from_numpy(gk))]
    qo, ko = krms.QKNormRopeFn.apply(*leaves, tcos, tsin, EPS)
    ((qo * twq).float().sum() + (ko * twk).float().sum()).backward()
    for t, j in zip(leaves, grads, strict=True):
        _close(t.grad, j, dtype)


def test_plain_backward_passes_gradcheck_in_f64():
    """The three autograd entries' plain backward against finite
    differences of their plain forward, all in f64."""
    gen = torch.Generator().manual_seed(3)

    def r(*shape):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).requires_grad_()

    x, y, g = r(3, 5, 16), r(3, 5, 16), r(16)
    assert torch.autograd.gradcheck(
        lambda a, b: krms.RMSNormFn.apply(a, b, EPS), (x, g))
    assert torch.autograd.gradcheck(
        lambda a, b, c: krms.AddRMSNormFn.apply(a, b, c, EPS), (x, y, g))
    assert torch.autograd.gradcheck(
        lambda a, b, c: krms.AddRMSNormFn.apply(a, b, c, EPS)[1], (x, y, g))
    q, k, gq, gk = r(2, 3, 4, 16), r(2, 3, 2, 16), r(16), r(16)
    cos, sin = tcm.rope_angles(torch.arange(6).view(2, 3), 16, 1e4)
    assert torch.autograd.gradcheck(
        lambda a, b, c, d: krms.QKNormRopeFn.apply(a, b, c, d, cos, sin, EPS),
        (q, k, gq, gk))


def test_model_norms_go_through_the_autograd_entries():
    """Gradients reach the parameters upstream of every model norm: the
    common-layer functions are the autograd entries."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 32, generator=gen, requires_grad=True)
    p = {"g": torch.ones(32, requires_grad=True)}
    s, h = tcm.add_rmsnorm(p, x, x, 1e-5)
    (tcm.rmsnorm(p, h, 1e-5).sum() + s.sum()).backward()
    assert x.grad is not None and p["g"].grad is not None
    assert bool(torch.isfinite(x.grad).all())


# ---------------------------------------------------------------------------
# the card branch, driven on meta tensors (no card)
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


LIBRARY = {"rms_norm", "layer_norm", "mean", "sqrt", "rsqrt", "add",
           "__add__", "sub", "__sub__", "mul", "__mul__", "cat", "pow",
           "sum", "matmul", "einsum"}


@pytest.fixture
def card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(krms, "_lib", lambda: lib)
    monkeypatch.setattr(krms, "_require_card", lambda name, x: None)
    monkeypatch.setattr(build, "sm_count", lambda device: SMS)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    krms.reset_counts()
    yield lib
    krms.reset_counts()


# The stand-in card's SMs (an H100 SXM's): the backward's grid, and so its
# scratch's partial rows, is at most this many blocks.
SMS = 132


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_refuse_grad_predicate():
    """The predicate holds, and the guard raises, only with grad mode on
    and an input requiring grad; the guard names the entry to use."""
    a, b = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert not build.records_grad(a) and build.records_grad(a, b)
    with torch.no_grad():
        assert not build.records_grad(a, b)
    build.refuse_grad("k", "the autograd entry", a)
    with pytest.raises(RuntimeError, match="the autograd entry"):
        build.refuse_grad("k", "the autograd entry", a, b)
    with torch.no_grad():
        build.refuse_grad("k", "the autograd entry", a, b)


@pytest.mark.parametrize("entry", ["rmsnorm", "add_rmsnorm", "qk_norm_rope"])
def test_raw_entries_refuse_inputs_that_require_grad(card, entry):
    """On the card branch a raw forward entry never returns a detached
    result: with grad on and an input requiring grad it raises, naming
    the autograd entry; under no_grad it launches."""
    x = _meta(8, 1, 2, 128).requires_grad_()
    g = torch.empty(128, device="meta")
    cos = torch.empty(8, 1, 64, device="meta")
    call = {"rmsnorm": lambda: krms.rmsnorm(x, g),
            "add_rmsnorm": lambda: krms.add_rmsnorm(x, x, g),
            "qk_norm_rope": lambda: krms.qk_norm_rope(x, x, g, g, cos, cos)}
    use = {"rmsnorm": "RMSNormFn", "add_rmsnorm": "AddRMSNormFn",
           "qk_norm_rope": "QKNormRopeFn"}[entry]
    with pytest.raises(RuntimeError, match=use):
        call[entry]()
    assert card.calls == []
    with torch.no_grad():
        call[entry]()
    assert [c[0] for c in card.calls] == [f"repro_{entry}"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_entries_launch_forward_and_backward_once(card, dtype):
    """One forward launch and one backward launch per autograd entry, no
    library op computing either, the counters by entry."""
    x = _meta(4096, 1024, dtype=dtype).requires_grad_()
    y = _meta(4096, 1024, dtype=dtype).requires_grad_()
    g = torch.empty(1024, device="meta").requires_grad_()
    q = _meta(2, 4, 16, 128, dtype=dtype).requires_grad_()
    k = _meta(2, 4, 8, 128, dtype=dtype).requires_grad_()
    gq = torch.empty(128, device="meta").requires_grad_()
    cos = torch.empty(2, 4, 64, device="meta")
    h = krms.RMSNormFn.apply(x, g, EPS)
    s, h2 = krms.AddRMSNormFn.apply(x, y, g, EPS)
    qo, ko = krms.QKNormRopeFn.apply(q, k, gq, gq, cos, cos, EPS)
    fwd = [c[0] for c in card.calls]
    card.calls.clear()
    with _Record() as rec:
        torch.autograd.backward([h, s, h2, qo, ko],
                                [torch.empty_like(t) for t in
                                 (h, s, h2, qo, ko)])
    assert not LIBRARY & set(rec.calls)
    assert fwd == ["repro_rmsnorm", "repro_add_rmsnorm", "repro_qk_norm_rope"]
    assert sorted(c[0] for c in card.calls) == [
        "repro_add_rmsnorm_bwd", "repro_qk_norm_rope_bwd",
        "repro_rmsnorm_bwd"]
    args = {c[0]: c[1] for c in card.calls}
    assert args["repro_rmsnorm_bwd"][6:8] == (4096, 1024)
    assert args["repro_add_rmsnorm_bwd"][7:9] == (4096, 1024)
    assert args["repro_qk_norm_rope_bwd"][13:18] == (2 * 4 * 16, 2 * 4 * 8,
                                                     16, 8, 128)
    assert krms.launches.count == krms.bwd_launches.count == 3
    assert all(c.count == 1 for c in krms.bwd_entry_launches.values())
    assert x.grad is not None and g.grad is not None and gq.grad is not None


def test_add_rmsnorm_backward_passes_no_residual_gradient_when_unused(card):
    """The last layer's residual output is not used: its gradient is
    None, and the kernel gets a null pointer for it."""
    x = _meta(16, 1024).requires_grad_()
    g = torch.empty(1024, device="meta")
    _, h = krms.AddRMSNormFn.apply(x, x, g, EPS)
    card.calls.clear()
    h.backward(torch.empty_like(h))
    (name, args), = card.calls
    assert name == "repro_add_rmsnorm_bwd" and args[2] is None


@pytest.mark.parametrize("d,dtype", [
    (krms.BWD_MAX_D + 8, torch.bfloat16), (2 * krms.BWD_MAX_D, torch.bfloat16),
    (krms.BWD_MAX_D + 8, torch.float32)])
def test_backward_refuses_rows_without_a_layout(card, d, dtype):
    """Every width that is a multiple of 8 has a layout or the generic
    loop up to ``BWD_MAX_D``; past it the wrapper refuses, no launch."""
    with pytest.raises(ValueError, match="backward"):
        krms.rmsnorm_bwd(_meta(4, d, dtype=dtype),
                         torch.empty(d, device="meta"),
                         _meta(4, d, dtype=dtype))
    assert card.calls == []


def test_backward_constants_match_the_cuda_source():
    src = (pathlib.Path(krms.__file__).parent / "csrc" / "rmsnorm.cu"
           ).read_text()
    # The grid is sized from the card (its SMs), not capped by a constant.
    assert "kBwdMaxBlocks" not in src
    assert "return small ? 1 : (groups < c.sms ? groups : c.sms);" in src
    assert "const int grid = a.tokens < c.sms ? a.tokens : c.sms;" in src
    assert int(re.search(r"kBwdMaxD = (\d+);", src).group(1)) \
        == krms.BWD_MAX_D
    assert int(re.search(r"kBwdHeader = (\d+);", src).group(1)) \
        == krms.BWD_SCRATCH_HEADER
    threads = int(re.search(r"kBwdThreads = (\d+);", src).group(1))
    elems = int(re.search(r"kBwdRegElems = (\d+);", src).group(1))
    assert "kBwdRegMaxD = kBwdThreads * kBwdRegElems;" in src
    assert threads * elems == krms.BWD_REG_MAX_D


@pytest.fixture
def scratch(monkeypatch):
    """A fresh scratch table, so each test sees its own buffers."""
    table = {}
    monkeypatch.setattr(krms, "_bwd_scratch", table)
    return table


def _bwd_calls(entry, dtype, gdtype):
    """One call of a backward entry on meta tensors at the training path's
    shapes, γ in ``gdtype``."""
    x = _meta(4096, 1024, dtype=dtype)
    g = torch.empty(1024, dtype=gdtype, device="meta")
    if entry == "rmsnorm":
        return krms.rmsnorm_bwd(x, g, x, eps=EPS)
    if entry == "add_rmsnorm":
        return krms.add_rmsnorm_bwd(x, g, x, x, eps=EPS)
    q = _meta(8, 512, 16, 128, dtype=dtype)
    k = _meta(8, 512, 8, 128, dtype=dtype)
    gq = torch.empty(128, dtype=gdtype, device="meta")
    cos = torch.empty(8, 512, 64, device="meta")
    return krms.qk_norm_rope_bwd(q, k, gq, gq, cos, cos, q, k, eps=EPS)


@pytest.mark.parametrize("gdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["rmsnorm", "add_rmsnorm", "qk_norm_rope"])
def test_backward_entry_is_one_c_call_with_no_zeroed_dgamma(card, scratch,
                                                             entry, dtype,
                                                             gdtype):
    """A warm call (its scratch made) is exactly one C call; no tensor op
    zeroes, fills or casts anything (dγ is written by the kernel in γ's
    type, γ read in its own); the x and γ type codes reach the kernel."""
    _bwd_calls(entry, dtype, gdtype)
    card.calls.clear()
    with _Record() as rec:
        outs = _bwd_calls(entry, dtype, gdtype)
    assert [c[0] for c in card.calls] == [f"repro_{entry}_bwd"]
    assert not {"zeros", "zeros_like", "fill_", "zero_", "to", "float",
                "copy_", "full"} & set(rec.calls)
    assert all(t.dtype == gdtype for t in outs[len(outs) // 2:])
    assert all(t.dtype == dtype for t in outs[:len(outs) // 2])
    args = card.calls[0][1]
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert args[-3:-1] == (codes[dtype], codes[gdtype])


def test_backward_scratch_is_made_once_per_device_and_stream(card, scratch,
                                                             monkeypatch):
    """The first call makes the scratch (zeroed, header and partial rows);
    a second call on the same stream reuses it, a wider one grows it, a
    call on another stream gets its own."""
    with _Record() as rec:
        _bwd_calls("rmsnorm", torch.bfloat16, torch.float32)
    assert rec.calls.count("zeros") == 1
    (key, buf), = scratch.items()
    assert buf.numel() == krms.BWD_SCRATCH_HEADER \
        + 4 * SMS * 1024
    assert card.calls[0][1][5] == buf.data_ptr()
    _bwd_calls("add_rmsnorm", torch.bfloat16, torch.float32)
    _bwd_calls("rmsnorm", torch.float32, torch.bfloat16)
    assert list(scratch) == [key] and scratch[key] is buf
    x = _meta(4096, 2048)
    krms.rmsnorm_bwd(x, torch.empty(2048, device="meta"), x, eps=EPS)
    assert scratch[key] is not buf and scratch[key].numel() \
        == krms.BWD_SCRATCH_HEADER + 4 * SMS * 2048

    class _Other:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Other())
    _bwd_calls("qk_norm_rope", torch.bfloat16, torch.bfloat16)
    assert len(scratch) == 2 and scratch[(key[0], 7)].numel() \
        == krms.BWD_SCRATCH_HEADER + 4 * SMS * 2 * 128


def test_backward_refuses_a_gamma_type_it_cannot_write(card, scratch):
    """dγ is written in γ's type by the kernel: f32 or bf16; another type,
    or two different types of γq and γk, is refused before any launch."""
    x = _meta(8, 1024)
    with pytest.raises(TypeError, match="gamma"):
        krms.rmsnorm_bwd(x, torch.empty(1024, dtype=torch.float16,
                                        device="meta"), x, eps=EPS)
    q = _meta(2, 3, 4, 128)
    cos = torch.empty(2, 3, 64, device="meta")
    with pytest.raises(TypeError, match="gamma"):
        krms.qk_norm_rope_bwd(q, q, torch.empty(128, device="meta"),
                              torch.empty(128, dtype=torch.bfloat16,
                                          device="meta"),
                              cos, cos, q, q, eps=EPS)
    assert card.calls == []


def test_cpu_backward_never_counts_a_launch():
    krms.reset_counts()
    x = torch.randn(3, 16, requires_grad=True)
    krms.RMSNormFn.apply(x, torch.ones(16), EPS).sum().backward()
    assert krms.launches.count == krms.bwd_launches.count == 0
