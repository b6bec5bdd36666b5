"""The port's parallel algorithms against the JAX package's, on the CPU.

Every algorithm runs through both packages on the same numpy input under
the three policies of ``tests/test_algorithms.py`` — ``seq``, static
``par`` (4 workers, 2 chunks per core) and acc ``par`` (T0 pinned to
10 µs) — and the port's ``par.on(adaptive(ex))`` form of the last, at
n = 4097 and at the edge sizes.  Reduce and scan sum in
another order than the reference (other chunks, other kernel blocks), so
their tolerances scale with the sum of |x|.

On a CUDA tensor the default operators' chunk bodies are the
hand-written kernels; here the same routing reaches their plain versions,
which the routing tests below watch.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import algorithms as jalg
from repro.algorithms import detail as jdetail
from repro.core import AdaptiveCoreChunk as JAcc
from repro.core import HostParallelExecutor as JHost
from repro.core import StaticCoreChunk as JStatic
from repro.core import par as jpar
from repro.core import seq as jseq
from repro_torch import algorithms as talg
from repro_torch.algorithms import detail as tdetail
from repro_torch.core import AdaptiveCoreChunk as TAcc
from repro_torch.core import HostParallelExecutor as THost
from repro_torch.core import MeshExecutor, adaptive
from repro_torch.core import StaticCoreChunk as TStatic
from repro_torch.core import par as tpar
from repro_torch.core import seq as tseq
from repro_torch.kernels import ops as tops

POLICIES = ["seq", "par-static", "par-acc", "par-adaptive"]


@pytest.fixture(scope="module")
def hosts():
    jh, th = JHost(max_workers=4), THost(max_workers=4)
    yield jh, th
    jh.shutdown()
    th.shutdown()


@pytest.fixture(params=POLICIES)
def policy(request, hosts):
    """(JAX policy, port policy) of one kind.  ``par-adaptive`` is the
    port's ``par.on(adaptive(ex))`` form against the reference's
    explicit acc object: the two make the same decisions."""
    jh, th = hosts
    return {
        "seq": (jseq, tseq),
        "par-static": (jpar.on(jh).with_(JStatic(4, 2)),
                       tpar.on(th).with_(TStatic(4, 2))),
        "par-acc": (jpar.on(jh).with_(JAcc(t0_override=1e-5)),
                    tpar.on(th).with_(TAcc(t0_override=1e-5))),
        "par-adaptive": (jpar.on(jh).with_(JAcc(t0_override=1e-5)),
                         tpar.on(adaptive(th, TAcc(t0_override=1e-5)))),
    }[request.param]


def _x(n: int = 4097, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _both(x: np.ndarray, dtype: str = "float32"):
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a)


def _sum_tol(x: np.ndarray, rel: float) -> float:
    """Absolute tolerance of a sum over x taken in another order."""
    return rel * float(np.abs(x.astype(np.float64)).sum()) + 1e-6


# (name, jax call, port call); each call takes (policy, x).
MAPS = [
    ("transform", lambda p, x: jalg.transform(p, x, lambda c: c * 2 + 1),
     lambda p, x: talg.transform(p, x, lambda c: c * 2 + 1)),
    ("transform_binary",
     lambda p, x: jalg.transform(p, x, lambda a, b: a * b + a,
                                 jnp.ones_like(x)),
     lambda p, x: talg.transform(p, x, lambda a, b: a * b + a,
                                 torch.ones_like(x))),
    ("for_each", lambda p, x: jalg.for_each(p, x, lambda c: c - 3),
     lambda p, x: talg.for_each(p, x, lambda c: c - 3)),
    ("copy", jalg.copy, talg.copy),
    ("fill", lambda p, x: jalg.fill(p, x, 3.5),
     lambda p, x: talg.fill(p, x, 3.5)),
    ("adjacent_difference", jalg.adjacent_difference,
     talg.adjacent_difference),
    ("adjacent_difference_op",
     lambda p, x: jalg.adjacent_difference(p, x, jnp.add),
     lambda p, x: talg.adjacent_difference(p, x, torch.add)),
    ("artificial_work_8", lambda p, x: jalg.artificial_work(p, x, iters=8),
     lambda p, x: talg.artificial_work(p, x, iters=8)),
    ("artificial_work_256", jalg.artificial_work, talg.artificial_work),
]


@pytest.mark.parametrize("name,jf,tf", MAPS, ids=[m[0] for m in MAPS])
def test_map_algorithms_match_reference(policy, name, jf, tf):
    jp, tp = policy
    jx, tx = _both(_x())
    out = tf(tp, tx)
    assert out.shape == tx.shape and out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(jf(jp, jx)), rtol=1e-5,
                               atol=1e-6)


def test_stencil3_matches_reference(policy):
    jp, tp = policy
    jx, tx = _both(_x())
    # XLA may fuse the three products into FMAs; PyTorch rounds each.
    np.testing.assert_allclose(_np(talg.stencil3(tp, tx)),
                               _np(jalg.stencil3(jp, jx)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("op", ["add", "max", "min", "mul_init"])
def test_reduce_matches_reference(policy, op):
    jp, tp = policy
    x = _x()
    jx, tx = _both(x)
    if op == "mul_init":          # a product needs small factors
        x = (1.0 + 1e-3 * x).astype(np.float32)
        jx, tx = _both(x)
    jop, top = {"add": (jnp.add, torch.add),
                "max": (jnp.maximum, torch.maximum),
                "min": (jnp.minimum, torch.minimum),
                "mul_init": (jnp.multiply, torch.mul)}[op]
    out = talg.reduce(tp, tx, top)
    ref = jalg.reduce(jp, jx, jop)
    assert out.shape == () and out.dtype == tx.dtype
    tol = _sum_tol(x, 1e-6) if op == "add" else 1e-5
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5, atol=tol)


def test_reduce_with_init_matches_reference(policy):
    jp, tp = policy
    x = _x()
    jx, tx = _both(x)
    np.testing.assert_allclose(
        float(talg.reduce(tp, tx, torch.add, init=2.5)),
        float(jalg.reduce(jp, jx, jnp.add, init=2.5)), atol=_sum_tol(x, 1e-6))


def test_generic_operator_reduce_and_scan_match_reference(policy):
    """A user operator with no fused partial: a tree fold and a doubling
    scan in plain PyTorch against the reference's lax.reduce and
    associative_scan."""
    jp, tp = policy
    x = np.random.RandomState(5).randint(-50, 50, 1031).astype(np.int32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())

    def jop(a, b):
        return jnp.maximum(a, b) + 0

    def top(a, b):
        return torch.maximum(a, b) + 0

    assert int(talg.reduce(tp, tx, top, init=-1000)) == \
        int(jalg.reduce(jp, jx, jop, init=-1000))
    np.testing.assert_array_equal(_np(talg.inclusive_scan(tp, tx, top)),
                                  _np(jalg.inclusive_scan(jp, jx, jop)))
    np.testing.assert_array_equal(_np(talg.inclusive_scan(tp, tx)),
                                  _np(jalg.inclusive_scan(jp, jx)))


def test_transform_reduce_and_quantifiers_match_reference(policy):
    jp, tp = policy
    jx, tx = _both(_x())
    assert int(talg.count_if(tp, tx, lambda c: c > 0)) == \
        int(jalg.count_if(jp, jx, lambda c: c > 0))
    np.testing.assert_allclose(
        float(talg.transform_reduce(tp, tx, lambda c: c * c)),
        float(jalg.transform_reduce(jp, jx, lambda c: c * c)), rtol=1e-5)
    for name, pred in (("all_of", lambda c: c > -100),
                       ("any_of", lambda c: c > 2),
                       ("none_of", lambda c: c > 100),
                       ("all_of", lambda c: c > 0),
                       ("none_of", lambda c: c > 2)):
        assert bool(getattr(talg, name)(tp, tx, pred)) == \
            bool(getattr(jalg, name)(jp, jx, pred)), name


def test_min_max_element_match_reference(policy):
    jp, tp = policy
    x = _x()
    x[[100, 3000]] = x.max() + 1.0       # a tie: the first one wins
    jx, tx = _both(x)
    for name in ("min_element", "max_element"):
        v, i = getattr(talg, name)(tp, tx)
        jv, ji = getattr(jalg, name)(jp, jx)
        assert float(v) == float(jv) and int(i) == int(ji), name
    assert int(talg.max_element(tp, tx)[1]) == 100


def test_scans_match_reference(policy):
    jp, tp = policy
    x = _x()
    jx, tx = _both(x)
    run = np.cumsum(np.abs(x.astype(np.float64)))
    inc = _np(talg.inclusive_scan(tp, tx))
    assert np.all(np.abs(inc - _np(jalg.inclusive_scan(jp, jx)))
                  <= 1e-6 * run + 1e-5)
    exc = talg.exclusive_scan(tp, tx, 0.0)
    jexc = jalg.exclusive_scan(jp, jx, 0.0)
    assert exc.shape == tx.shape and float(exc[0]) == 0.0
    assert np.all(np.abs(_np(exc)[1:] - _np(jexc)[1:])
                  <= 1e-6 * run[:-1] + 1e-5)


def test_generate_matches_reference(policy):
    jp, tp = policy
    out = talg.generate(tp, 100, lambda i: i * i, device="cpu")
    ref = jalg.generate(jp, 100, lambda i: i * i)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(_np(out), _np(ref))


def test_generate_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        talg.generate(tseq, 10, lambda i: i)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 129])
def test_edge_sizes_match_reference(policy, n):
    """Static par at n = 7 makes one-element chunks (8 of them)."""
    jp, tp = policy
    x = np.arange(n, dtype=np.float32) * 0.75 - 2.0
    jx, tx = _both(x)
    for name in ("adjacent_difference", "inclusive_scan", "artificial_work",
                 "copy"):
        out = getattr(talg, name)(tp, tx)
        ref = getattr(jalg, name)(jp, jx)
        assert out.shape == tuple(ref.shape), name
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    exc = talg.exclusive_scan(tp, tx, 1.5)
    np.testing.assert_allclose(_np(exc), _np(jalg.exclusive_scan(jp, jx, 1.5)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(talg.reduce(tp, tx)),
                               float(jalg.reduce(jp, jx)), atol=1e-4)
    if n:
        v, i = talg.min_element(tp, tx)
        jv, ji = jalg.min_element(jp, jx)
        assert (float(v), int(i)) == (float(jv), int(ji))


@pytest.mark.parametrize("name", ["adjacent_difference", "reduce",
                                  "inclusive_scan"])
def test_bfloat16_matches_reference(policy, name):
    """bf16 sums: the port accumulates each chunk in f32 (the kernels'
    plain versions), the reference in its own order; both round to bf16."""
    jp, tp = policy
    x = _x(1500, seed=4)
    jx, tx = _both(x, "bfloat16")
    out = getattr(talg, name)(tp, tx)
    ref = getattr(jalg, name)(jp, jx)
    assert out.dtype == torch.bfloat16
    if name == "adjacent_difference":
        np.testing.assert_array_equal(_np(out), _np(ref))
    elif name == "reduce":
        assert abs(float(out) - float(ref)) <= _sum_tol(x, 2 ** -7)
    else:
        run = np.cumsum(np.abs(x.astype(np.float64)))
        assert np.all(np.abs(_np(out) - _np(ref)) <= 2 ** -6 * run + 1e-2)


@pytest.mark.parametrize("count", [1, 2, 7, 129, 4097, 10 ** 5])
@pytest.mark.parametrize("kind", ["seq", "default", "static"])
def test_plans_match_reference(hosts, kind, count):
    """With no measurement in the way, the port's customization points
    cut the same chunks as the reference's."""
    jh, th = hosts
    jp, tp = {"seq": (jseq, tseq), "default": (jpar.on(jh), tpar.on(th)),
              "static": (jpar.on(jh).with_(JStatic(3, 5)),
                         tpar.on(th).with_(TStatic(3, 5)))}[kind]
    jplan = jdetail.plan(jp, count)
    tplan = tdetail.plan(tp, count)
    assert (tplan.cores, tplan.chunk_elems, tplan.parallel) == \
        (jplan.cores, jplan.chunk_elems, jplan.parallel)
    assert [(c.start, c.size) for c in tplan.chunks] == \
        [(c.start, c.size) for c in jplan.chunks]


@pytest.mark.parametrize("n,multiple", [(7, 4), (8, 4), (1, 3)])
def test_pad_to_matches_reference(n, multiple):
    x = np.arange(n, dtype=np.float32)
    jp, jn = jdetail.pad_to(jnp.asarray(x), multiple, fill=-1)
    tp, tn = tdetail.pad_to(torch.from_numpy(x), multiple, fill=-1)
    assert tn == jn == n
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_mesh_policy_raises_not_implemented():
    mesh = MeshExecutor(types.SimpleNamespace(shape={"data": 4}))
    x = torch.ones(64)
    for pol in (tpar.on(mesh), tpar.on(adaptive(mesh))):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            talg.transform(pol, x, lambda c: c + 1)
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            talg.reduce(pol, x)
    assert float(talg.reduce(tseq.on(mesh), x)) == 64.0   # seq: no mesh


ROUTES = [
    # (algorithm call, kernel wrapper in ops, routed?)
    (lambda p, x: talg.adjacent_difference(p, x), "adjacent_difference",
     True),
    (lambda p, x: talg.adjacent_difference(p, x, torch.add),
     "adjacent_difference", False),
    (lambda p, x: talg.reduce(p, x), "reduce_sum", True),
    (lambda p, x: talg.reduce(p, x, torch.maximum), "reduce_sum", False),
    (lambda p, x: talg.transform_reduce(p, x, torch.abs), "reduce_sum",
     False),
    (lambda p, x: talg.inclusive_scan(p, x), "inclusive_scan", True),
    (lambda p, x: talg.exclusive_scan(p, x, 0.0), "inclusive_scan", True),
    (lambda p, x: talg.inclusive_scan(p, x, torch.maximum),
     "inclusive_scan", False),
    (lambda p, x: talg.artificial_work(p, x, iters=2), "artificial_work",
     True),
]


@pytest.mark.parametrize("call,kernel,routed,dtype", [
    r + (dtype,) for r in ROUTES for dtype in ("float32", "bfloat16", "int32")
    if r[1] != "artificial_work" or dtype == "float32"])
def test_default_operators_route_through_the_kernels(
        hosts, monkeypatch, call, kernel, routed, dtype):
    """The default operators over f32/bf16 (f32 only for artificial
    work, which raises TypeError otherwise) reach the kernel wrappers,
    once per chunk under par; other operators and dtypes never do."""
    _, th = hosts
    calls = []
    real = getattr(tops, kernel)

    def spy(x, **kw):
        calls.append(x.shape[0])
        return real(x, **kw)

    monkeypatch.setattr(tops, kernel, spy)
    x = torch.from_numpy(_x(1000)).to(getattr(torch, dtype))
    call(tpar.on(th).with_(TStatic(4, 2)), x)
    expect = routed and dtype != "int32"
    assert bool(calls) == expect
    if expect:
        assert len(calls) == 8 and sum(calls) >= 1000


def test_measured_body_times_the_card_only_for_a_card_tensor(monkeypatch):
    """A CPU tensor's body is wall-clocked as in the reference; a
    ``DeviceBody`` (what ``measured_body`` makes for a CUDA tensor) goes
    to the CUDA-event measurement, so its per-element time holds no
    launch or wait."""
    from repro_torch.core import calibration as tcal

    x = torch.from_numpy(_x(1000))
    body = tdetail.measured_body(lambda c: c + 1, x)
    assert not isinstance(body, tcal.DeviceBody)
    assert torch.equal(body(3, 5), x[3:8] + 1)
    seen = []
    monkeypatch.setattr(tcal, "measure_iteration_device",
                        lambda b, count: seen.append((b, count)) or 2e-12)
    dev_body = tcal.DeviceBody(lambda start, size: None, stream=None)
    acc = TAcc(t0_override=1e-5)
    with THost(max_workers=2) as ex:
        assert acc.measure_iteration(ex, dev_body, 1 << 24,
                                     key=("device", 1)) == 2e-12
        assert acc.measure_iteration(ex, body, 1000, key=("host", 1)) > 0
    assert seen == [(dev_body, 1 << 24)]


@pytest.mark.parametrize("call", [
    lambda p, x: talg.artificial_work(p, x, iters=8),
    lambda p, x: talg.transform(p, x, torch.neg),
], ids=["artificial_work", "transform_same_fn"])
def test_second_call_reuses_the_calibration(monkeypatch, call):
    """artificial_work keys its calibration by ``iters`` and transform by
    its function object, so a second call with the same body measures
    nothing again."""
    from repro_torch.core import calibration as tcal

    measured = []
    real = tcal.measure_iteration_wallclock
    monkeypatch.setattr(
        tcal, "measure_iteration_wallclock",
        lambda body, count: measured.append(count) or real(body, count))
    x = torch.from_numpy(_x())
    with THost(max_workers=2) as ex:
        pol = tpar.on(adaptive(ex, TAcc(t0_override=1e-5)))
        first = call(pol, x)
        assert len(measured) == 1
        torch.testing.assert_close(call(pol, x), first, rtol=0, atol=0)
    assert len(measured) == 1
