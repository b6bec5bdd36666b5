"""Kernel 1's backward at every width its forward takes: rows of up to
8192 elements held in registers (bf16 and f32, every registry width:
1024..6144) and the generic loop for any wider multiple of 8, on the
CPU.

The wrappers' checks and launch arguments on meta tensors (the card
branch with a recording library), the plain backward against the JAX
package's custom VJP (``_rmsnorm_diffable_bwd``) at those widths, the
backward's constants and layouts against ``csrc/rmsnorm.cu``, and
gradient parity with ``jax.grad`` for two of the wide families at their
reduced size (h2o-danube-1.8b with its sliding window, zamba2-1.2b
through ``chunked_gla``'s backward).  ``chip_smoke.py`` phase 8 runs the
CUDA backward at these widths, two calls bit for bit.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as kops
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import rmsnorm as krms

from test_torch_rmsnorm_grad import SMS, _meta, card  # noqa: F401
from test_torch_xlstm import grad_parity

WIDTHS = [1536, 2048, 2560, 4096, 5120, 6144, 8192]
DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
SRC = (pathlib.Path(krms.__file__).parent / "csrc" / "rmsnorm.cu"
       ).read_text()


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_takes_every_wide_row(card, d, dtype):  # noqa: F811
    """``rmsnorm_bwd`` and ``add_rmsnorm_bwd`` launch once each at the
    width, with d and the row count as the kernel reads them and the
    stream's scratch: a header and min(rows, the card's SMs) partial rows
    of d floats."""
    rows = 4096
    x = _meta(rows, d, dtype=dtype)
    g = torch.empty(d, device="meta")
    dx, dg = krms.rmsnorm_bwd(x, g, _meta(rows, d, dtype=dtype), eps=EPS)
    ds, dgs = krms.add_rmsnorm_bwd(x, g, _meta(rows, d, dtype=dtype),
                                   _meta(rows, d, dtype=dtype), eps=EPS)
    assert [c[0] for c in card.calls] == ["repro_rmsnorm_bwd",
                                          "repro_add_rmsnorm_bwd"]
    assert card.calls[0][1][6:8] == (rows, d)
    assert card.calls[1][1][7:9] == (rows, d)
    assert dx.shape == ds.shape == x.shape and dx.dtype == dtype
    assert dg.shape == dgs.shape == (d,)
    assert krms._partial_rows(x) == SMS
    assert krms._partial_rows(_meta(8, d, dtype=dtype)) == 8
    assert card.calls[0][1][5] == card.calls[1][1][6]     # one scratch
    assert krms.bwd_launches.count == 2


@pytest.mark.parametrize("d,dtype", [(1540, torch.bfloat16),
                                     (6150, torch.float32),
                                     (krms.BWD_MAX_D + 8, torch.bfloat16)])
def test_backward_still_refuses_what_it_cannot_take(card, d,  # noqa: F811
                                                    dtype):
    """A width that is not a multiple of 8, or past ``BWD_MAX_D`` (the
    generic path's partial row in shared memory): a ValueError, no
    launch."""
    with pytest.raises(ValueError):
        krms.rmsnorm_bwd(_meta(4, d, dtype=dtype),
                         torch.empty(d, device="meta"),
                         _meta(4, d, dtype=dtype))
    assert card.calls == []


def test_rotary_backward_keeps_its_forward_widths(card):  # noqa: F811
    """The rotary entry's backward takes the head rows its forward has
    (8..128 vectors) and no generic width."""
    cos = torch.empty(2, 3, 40, device="meta")
    q = _meta(2, 3, 4, 80)
    g = torch.empty(80, device="meta")
    with pytest.raises(ValueError, match="backward"):
        krms.qk_norm_rope_bwd(q, q, g, g, cos, cos, q, q)
    assert card.calls == []


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_the_reference_vjp(d, dtype):
    """The plain backward (what the kernel is held to on the card)
    against ``_rmsnorm_diffable_bwd`` on the same x, γ and dy: dx in the
    type (f32 to 2e-5; bf16 within one rounding step), dγ f32 to 1e-4
    of its norm (rows summed in another order)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((8, d)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((8, d)).astype(np.float32)
    jt = getattr(jnp, dtype)
    tt = getattr(torch, dtype)
    jdx, jdg = kops._rmsnorm_diffable_bwd(
        EPS, 8, True, (jnp.asarray(x, jt), jnp.asarray(gamma)),
        jnp.asarray(dy, jt))
    tdx, tdg = krms.rmsnorm_bwd(torch.from_numpy(x).to(tt),
                                torch.from_numpy(gamma),
                                torch.from_numpy(dy).to(tt), eps=EPS)
    assert tdx.dtype == tt and tdg.dtype == torch.float32
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == "float32" \
        else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(tdx.float().numpy(),
                               np.asarray(jdx, np.float32), **tol)
    ref = np.asarray(jdg, np.float32)
    assert np.linalg.norm(tdg.numpy() - ref) < 1e-4 * np.linalg.norm(ref)


def test_backward_constants_and_layouts_match_the_cuda_source():
    """``BWD_MAX_D`` / ``BWD_REG_MAX_D`` are the source's, and no
    constant caps the grid (the card's SMs do); plain rows are held by 1..512 threads (a power of two, 16
    elements each: 8192 at most, bf16 or f32), the rotary entry's head
    rows of 8..128 vectors by 2 vectors a thread, every wider width goes to
    the generic loop, and its partial row fits the card's shared memory
    (227 KB a block)."""
    assert "kBwdMaxBlocks" not in SRC and not hasattr(krms,
                                                       "BWD_MAX_BLOCKS")
    assert int(re.search(r"kBwdMaxD = (\d+);", SRC).group(1)) \
        == krms.BWD_MAX_D
    assert krms.BWD_MAX_D * 4 <= 227 * 1024
    threads = int(re.search(r"kBwdThreads = (\d+);", SRC).group(1))
    elems = int(re.search(r"kBwdRegElems = (\d+);", SRC).group(1))
    assert threads * elems == krms.BWD_REG_MAX_D == 8192
    body = SRC[SRC.index("int launch_bwd_any("):]
    body = body[:body.index("\n}\n")]
    rope = body[:body.index("if (a.d > kBwdRegMaxD)")]
    plain = body[body.index("if (a.d > kBwdRegMaxD)"):]
    assert [int(c) for c in re.findall(r"case (\d+):", rope)] \
        == list(krms._ROPE_VECTORS)
    assert [int(c) for c in re.findall(r"case (\d+):", plain)] \
        == [2 ** i for i in range(10)]
    assert "return launch_bwd_generic<T>" in plain
    assert "static_assert(TPR * VPT * N <= kBwdRegMaxD" in SRC


def _source_threads_per_row(d, itemsize):
    """Threads a plain row of d takes in the source's layouts: the least
    power of two holding it at kBwdRegElems elements each, or None (the
    generic loop) past kBwdRegMaxD."""
    elems = int(re.search(r"kBwdRegElems = (\d+);", SRC).group(1))
    if d > krms.BWD_REG_MAX_D:
        return None
    per = elems // (16 // itemsize) * (16 // itemsize)
    t = 1
    while t * per < d:
        t *= 2
    return t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", sorted({get_config(n).d_model
                                      for n in ARCH_NAMES} | {8192}))
def test_every_registry_width_is_held_in_registers(d, dtype):
    """Every registry width (and 8192) has a register layout of the
    source in both types: the threads a row takes are among the source's
    cases and at most a block; the next width past 8192 does not."""
    body = SRC[SRC.index("int launch_bwd_any("):]
    body = body[body.index("if (a.d > kBwdRegMaxD)"):body.index("\n}\n")]
    cases = {int(c) for c in re.findall(r"case (\d+):", body)}
    threads = int(re.search(r"kBwdThreads = (\d+);", SRC).group(1))
    item = torch.empty(0, dtype=dtype).element_size()
    tpr = _source_threads_per_row(d, item)
    assert tpr in cases and tpr <= threads
    assert _source_threads_per_row(krms.BWD_REG_MAX_D + 8, item) is None


# ---------------------------------------------------------------------------
# training parity of the wide families (reduced)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "zamba2-1.2b"])
def test_wide_family_gradients_match_jax_grad(name):
    """Every gradient leaf of ``loss_fn`` within 1e-4 of the leaf's norm
    of ``jax.grad``: danube through its 16-token window, zamba2 through
    ``chunked_gla``'s backward and the shared block used at every
    ``shared_attn`` layer (its gradient summed over the uses)."""
    jcfg = jax_config(name).reduced()
    tcfg = get_config(name).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    grad_parity(jcfg, jparams, tcfg, tparams, seq=32)
