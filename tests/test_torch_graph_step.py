"""The decode dispatch as one device program (``serve/graphs.py`` and the
step bodies of ``serve/decode_loop.py``) on the CPU: the static-buffer
runner against the JAX package's fused, paged and speculative steps
(reduced qwen3-0.6b, f32, seeded numpy inputs), then the runner's card
branch driven on meta tensors with recording libraries and a stand-in
for the CUDA graph: the same ops and launches whatever the positions,
the active set and the page table, no host read, the launches a capture
counts taken back and added at each replay, the attention scratch
reserved once before the first capture, each dispatch's own outputs,
and no visible K/V row of an inactive lane changed."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.serve import decode_loop as jdl
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.calibration import CalibrationCache
from repro_torch.kernels import build
from repro_torch.kernels.autotune import KernelTuner
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import rmsnorm as krms
from repro_torch.models import lm as tlm
from repro_torch.serve import decode_loop as tdl
from repro_torch.serve import graphs as tgraphs

N, MAX_LEN, PS, DEPTH = 3, 48, 8, 8
POSS = [5, 9, 12]
BUDGETS = [[7, 0, 3], [2, 5, 0], [4, 4, 4]]
# f32 on both sides, sums in other orders over two layers.
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams),
                                    tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _contiguous(cfg, seed):
    """Random K/V (seeded numpy) in the (B, Hkv, S, D) layout of both."""
    rng = np.random.default_rng(seed)
    shape = (N, cfg.n_kv_heads, MAX_LEN, cfg.head_dim_)
    return [{name: rng.standard_normal(shape).astype(np.float32)
             for name in ("k", "v")} for _ in range(cfg.n_layers)]


def _paged(cfg, seed):
    """Random flat stores (n_pages * ps, Hkv, D) and a permuted table;
    page 0 is the scratch page no table maps."""
    rng = np.random.default_rng(seed)
    per = MAX_LEN // PS
    rows = (1 + N * per) * PS
    shape = (rows, cfg.n_kv_heads, cfg.head_dim_)
    stores = [{name: rng.standard_normal(shape).astype(np.float32)
               for name in ("k", "v")} for _ in range(cfg.n_layers)]
    table = (1 + rng.permutation(N * per)).reshape(N, per).astype(np.int32)
    return stores, table


def _hist(seed, h=16):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 6, (N, h)).astype(np.int64)
    hist[:, :3] = -1
    return hist


def _toks(seed):
    return np.random.default_rng(seed).integers(0, 256, N).astype(np.int64)


def _torch_tree(tree):
    return [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
            for c in tree]


def _jax_tree(tree):
    return [{k: jnp.asarray(v) for k, v in c.items()} for c in tree]


def _close(tcaches, jcaches, skip_rows=0):
    for t, j in zip(tcaches, jcaches, strict=True):
        for name in ("k", "v"):
            np.testing.assert_allclose(t[name].numpy()[skip_rows:],
                                       np.asarray(j[name])[skip_rows:],
                                       atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the runner on the CPU against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budgets", BUDGETS)
def test_fused_step_matches_jax(models, budgets):
    jcfg, jparams, tcfg, tparams = models
    kv, toks = _contiguous(tcfg, 1), _toks(2)
    jstep = jdl.make_fused_decode_step(jcfg, max_depth=DEPTH)
    jc, jout, jtoks = jstep(jparams, _jax_tree(kv), jnp.asarray(toks,
                                                               jnp.int32),
                            jnp.asarray(POSS, jnp.int32),
                            jnp.asarray(budgets, jnp.int32))
    tstep = tdl.make_fused_decode_step(tcfg, max_depth=DEPTH)
    tc, tout, ttoks = tstep(tparams, _torch_tree(kv), torch.from_numpy(toks),
                            torch.tensor(POSS), budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close(tc, jc)


@pytest.mark.parametrize("budgets", BUDGETS)
def test_paged_step_matches_jax(models, budgets):
    """The scratch page (rows [0, ps)) takes inactive lanes' writes in
    both, at other rows of it; every other row must agree."""
    jcfg, jparams, tcfg, tparams = models
    (stores, table), toks = _paged(tcfg, 3), _toks(4)
    jstep = jdl.make_paged_decode_step(jcfg, page_size=PS, max_len=MAX_LEN,
                                       max_depth=DEPTH)
    jc, jout, jtoks = jstep(jparams, _jax_tree(stores), jnp.asarray(table),
                            jnp.asarray(toks, jnp.int32),
                            jnp.asarray(POSS, jnp.int32),
                            jnp.asarray(budgets, jnp.int32))
    tstep = tdl.make_paged_decode_step(tcfg, page_size=PS, max_depth=DEPTH)
    tc, tout, ttoks = tstep(tparams, _torch_tree(stores),
                            torch.from_numpy(table), torch.from_numpy(toks),
                            torch.tensor(POSS), budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close(tc, jc, skip_rows=PS)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("budgets", BUDGETS[:2])
def test_spec_step_matches_jax(models, d, budgets):
    jcfg, jparams, tcfg, tparams = models
    kv, toks, hist = _contiguous(tcfg, 5), _toks(6), _hist(7)
    hist[:, -1] = toks
    jstep = jdl.make_spec_decode_step(jcfg, depth=d, max_depth=DEPTH)
    jc, jhist, jout, jtoks, jstats = jstep(
        jparams, _jax_tree(kv), jnp.asarray(hist, jnp.int32),
        jnp.asarray(toks, jnp.int32), jnp.asarray(POSS, jnp.int32),
        jnp.asarray(budgets, jnp.int32))
    tstep = tdl.make_spec_decode_step(tcfg, depth=d, max_depth=DEPTH)
    tc, thist, tout, ttoks, tstats, reads = tstep(
        tparams, _torch_tree(kv), torch.from_numpy(hist),
        torch.from_numpy(toks), torch.tensor(POSS), budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    assert reads == tstats[0].item() - -(-max(budgets) // d) + 1
    _close(tc, jc)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_paged_spec_step_matches_jax(models, d):
    jcfg, jparams, tcfg, tparams = models
    (stores, table), toks, hist = _paged(tcfg, 8), _toks(9), _hist(10)
    hist[:, -1] = toks
    budgets = BUDGETS[0]
    jstep = jdl.make_paged_spec_decode_step(jcfg, depth=d, page_size=PS,
                                            max_len=MAX_LEN, max_depth=DEPTH)
    jc, jhist, jout, jtoks, jstats = jstep(
        jparams, _jax_tree(stores), jnp.asarray(table),
        jnp.asarray(hist, jnp.int32), jnp.asarray(toks, jnp.int32),
        jnp.asarray(POSS, jnp.int32), jnp.asarray(budgets, jnp.int32))
    tstep = tdl.make_paged_spec_decode_step(tcfg, depth=d, page_size=PS,
                                            max_depth=DEPTH)
    tc, thist, tout, ttoks, tstats, _ = tstep(
        tparams, _torch_tree(stores), torch.from_numpy(table),
        torch.from_numpy(hist), torch.from_numpy(toks), torch.tensor(POSS),
        budgets)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    _close(tc, jc, skip_rows=PS)


def test_masked_merge_matches_reference():
    rng = np.random.default_rng(11)
    old = [{"k": rng.standard_normal((4, 2, 5, 3)).astype(np.float32),
            "v": rng.standard_normal((4, 2, 5, 3)).astype(np.float32)}]
    new = [{k: v + 1.0 for k, v in c.items()} for c in old]
    active = np.array([True, False, True, False])
    ref = jdl.masked_merge(_jax_tree(old), _jax_tree(new),
                           jnp.asarray(active))
    out = tdl.masked_merge(_torch_tree(old), _torch_tree(new),
                           torch.from_numpy(active))
    for r, o in zip(ref, out, strict=True):
        for name in ("k", "v"):
            np.testing.assert_array_equal(o[name].numpy(),
                                          np.asarray(r[name]))


@pytest.mark.parametrize("d", [None, 2, 4])
def test_reference_named_lane_factories_equal_the_folded_ones(models, d):
    """``make_paged_lane_step`` / ``make_paged_spec_lane_step`` (the
    reference's names and keywords) give what ``make_lane_step`` /
    ``make_spec_lane_step(page_size=)`` give on the same paged inputs: the
    same tokens and every store row bit for bit; ``depth=`` on the
    verify lanes refuses another width; each takes the reference's
    keywords, ``kernel_tuner`` among them: with a tuner the lanes give
    the untuned tokens and rows (on the CPU the plain versions run and
    the tuner resolves every plan's key)."""
    import inspect

    _, _, tcfg, tparams = models
    stores, table = _paged(tcfg, 17)
    toks = torch.from_numpy(_toks(18))
    poss, keep = torch.tensor(POSS), torch.tensor([True, False, True])
    if d is None:
        wrapped = tdl.make_paged_lane_step(tcfg, page_size=PS,
                                           max_len=MAX_LEN)
        folded = tdl.make_lane_step(tcfg, page_size=PS)
        feed = toks
        names = (jdl.make_paged_lane_step, tdl.make_paged_lane_step)
    else:
        wrapped = tdl.make_paged_spec_lane_step(tcfg, depth=d, page_size=PS,
                                                max_len=MAX_LEN)
        folded = tdl.make_spec_lane_step(tcfg, page_size=PS)
        feed = torch.stack([toks] * d, dim=1)
        names = (jdl.make_paged_spec_lane_step, tdl.make_paged_spec_lane_step)
        with pytest.raises(ValueError, match="depth"):
            wrapped(tparams, _torch_tree(stores), feed[:, :1], poss,
                    torch.from_numpy(table), keep)
    outs = []
    for lanes in (wrapped, folded):
        caches = _torch_tree(stores)
        outs.append((lanes(tparams, caches, feed, poss,
                           torch.from_numpy(table), keep), caches))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1], strict=True):
        for name in ("k", "v"):
            assert torch.equal(a[name], b[name])
    for ref, port in (names, (jdl.make_lane_step, tdl.make_lane_step),
                      (jdl.make_spec_lane_step, tdl.make_spec_lane_step)):
        assert set(inspect.signature(ref).parameters) <= \
            set(inspect.signature(port).parameters)
    tuner = KernelTuner(CalibrationCache(), repeats=1)
    tuned = names[1](tcfg, page_size=PS, max_len=MAX_LEN,
                     kernel_tuner=tuner,
                     **({} if d is None else {"depth": d}))
    caches = _torch_tree(stores)
    got = tuned(tparams, caches, feed, poss, torch.from_numpy(table), keep)
    assert torch.equal(got, outs[0][0]) and tuner.searches > 0
    for a, b in zip(caches, outs[0][1], strict=True):
        for name in ("k", "v"):
            assert torch.equal(a[name], b[name])


# ---------------------------------------------------------------------------
# no visible row of an inactive lane changes; each dispatch's own outputs
# ---------------------------------------------------------------------------

def _lane_rows(caches, lane, lo, hi):
    return [c[name][lane, :, lo:hi].clone() for c in caches
            for name in ("k", "v")]


@pytest.mark.parametrize("spec", [None, 2, 8])
def test_inactive_lanes_keep_their_rows(models, spec):
    """Budgets [7, 0, 3]: lane 1 has none, lane 2 stops after 3 of the
    dispatch's steps.  Lane 1's rows are all unchanged, and every lane's
    rows before its position are unchanged (the causal mask reads only
    those, and the written ones after)."""
    _, _, tcfg, tparams = models
    caches = _torch_tree(_contiguous(tcfg, 12))
    before = [_lane_rows(caches, lane, 0, MAX_LEN) for lane in range(N)]
    toks, poss = torch.from_numpy(_toks(13)), torch.tensor(POSS)
    budgets = BUDGETS[0]
    if spec is None:
        step = tdl.make_fused_decode_step(tcfg, max_depth=DEPTH)
        hist = ()
    else:
        step = tdl.make_spec_decode_step(tcfg, depth=spec, max_depth=DEPTH)
        hist = (torch.from_numpy(_hist(14)),)
    out = step(tparams, caches, *hist, toks, poss, budgets)
    after = [_lane_rows(out[0], lane, 0, MAX_LEN) for lane in range(N)]
    for a, b in zip(before[1], after[1], strict=True):
        assert torch.equal(a, b)
    for lane in range(N):
        for a, b in zip(before[lane], after[lane], strict=True):
            assert torch.equal(a[:, :POSS[lane]], b[:, :POSS[lane]])
    # Past the lane's budget (and its verify window) nothing was written.
    end = POSS[2] + budgets[2] + (spec - 1 if spec else 0)
    for a, b in zip(before[2], after[2], strict=True):
        assert torch.equal(a[:, end:], b[:, end:])


def test_paged_inactive_lanes_write_only_the_scratch_page(models):
    _, _, tcfg, tparams = models
    stores, table = _paged(tcfg, 15)
    caches = _torch_tree(stores)
    before = [{k: t.clone() for k, t in c.items()} for c in caches]
    budgets = BUDGETS[0]
    step = tdl.make_paged_decode_step(tcfg, page_size=PS, max_depth=DEPTH)
    out = step(tparams, caches, torch.from_numpy(table),
               torch.from_numpy(_toks(16)), torch.tensor(POSS), budgets)
    written = {int(table[lane, p // PS]) * PS + p % PS
               for lane in range(N)
               for p in range(POSS[lane], POSS[lane] + budgets[lane])}
    for b, a in zip(before, out[0], strict=True):
        for name in ("k", "v"):
            changed = (b[name] != a[name]).flatten(1).any(1)
            rows = set(torch.nonzero(changed).flatten().tolist())
            assert rows - set(range(PS)) <= written


def test_each_dispatch_hands_out_its_own_outputs(models):
    _, _, tcfg, tparams = models
    caches = _torch_tree(_contiguous(tcfg, 17))
    toks, poss = torch.from_numpy(_toks(18)), torch.tensor(POSS)
    fused = tdl.make_fused_decode_step(tcfg, max_depth=DEPTH)
    caches, out1, toks1 = fused(tparams, caches, toks, poss, [2, 2, 2])
    kept = out1.clone()
    caches, out2, toks2 = fused(tparams, caches, toks1, poss + 2,
                                [3, 3, 3])
    assert out1.data_ptr() != out2.data_ptr()
    assert toks1.data_ptr() != toks2.data_ptr()
    assert torch.equal(out1, kept) and not torch.equal(out1, out2)
    spec = tdl.make_spec_decode_step(tcfg, depth=2, max_depth=DEPTH)
    hist = torch.from_numpy(_hist(19))
    caches, h1, o1, t1, s1, _ = spec(tparams, caches, hist, toks, poss + 5,
                                [2, 2, 2])
    kept = [x.clone() for x in (h1, o1, s1)]
    caches, h2, o2, _, s2, _ = spec(tparams, caches, h1, t1, poss + 7,
                                    [4, 0, 1])
    for a, b in ((h1, h2), (o1, o2), (s1, s2)):
        assert a.data_ptr() != b.data_ptr()
    for a, b in zip(kept, (h1, o1, s1), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the card branch, on meta tensors
# ---------------------------------------------------------------------------

class _Record(TorchFunctionMode):
    """Every torch function with the shapes of its tensor arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        shapes = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else
                       (a if isinstance(a, (int, float, bool, str))
                        else type(a).__name__)
                       for a in list(args) + list(kwargs.values()))
        self.calls.append((getattr(func, "__name__", str(func)), shapes))
        return func(*args, **kwargs)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


class _Stream:
    cuda_stream = 4242

    def wait_stream(self, other):
        pass


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def card(monkeypatch):
    """The card branch with recording libraries, a stand-in stream and a
    stand-in for the CUDA graph whose capture sets the wrappers'
    capturing flag; meta tensors stand in for CUDA tensors."""
    lib = _FakeLib()
    monkeypatch.setattr(krms, "_lib", lambda: lib)
    monkeypatch.setattr(krms, "_require_card", lambda name, x: None)
    monkeypatch.setattr(kfa, "_require_card", lambda name, x: None)
    monkeypatch.setattr(kfa, "_fn", lambda: lib.repro_flash_attention)
    monkeypatch.setattr(kfa, "_paged_fn",
                        lambda: lib.repro_paged_flash_attention)
    stream = _Stream()
    capturing = [False]

    @contextlib.contextmanager
    def capture(graph, pool=None, stream=None):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(build, "capturing", lambda: capturing[0])
    monkeypatch.setattr(tgraphs, "_on_card", lambda t: True)
    monkeypatch.setattr(tgraphs, "_streams", {})
    krms.reset_counts()
    for c in (kfa.launches, kfa.paged_launches):
        c.reset()
    yield lib
    krms.reset_counts()
    for c in (kfa.launches, kfa.paged_launches):
        c.reset()


@pytest.fixture(scope="module")
def meta_model():
    """The reduced model with a head dim the rotary entry has a register
    layout for (32 in f32), its weights as meta tensors."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              head_dim=32)
    return cfg, _meta_tree(tlm.init_params(0, cfg, device="cpu"))


def _meta_tree(tree):
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta_tree(v) for v in tree]
    return tree.to("meta")


def _meta(*shape, dtype=torch.long):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_inputs(cfg, paged):
    if paged:
        rows = (1 + N * (MAX_LEN // PS)) * PS
        shape = (rows, cfg.n_kv_heads, cfg.head_dim_)
        table = _meta(N, MAX_LEN // PS, dtype=torch.int32)
    else:
        shape = (N, cfg.n_kv_heads, MAX_LEN, cfg.head_dim_)
        table = None
    caches = [{name: _meta(*shape, dtype=torch.float32)
               for name in ("k", "v")} for _ in range(cfg.n_layers)]
    return caches, table


def _step_fn(cfg, spec, paged, graphs=None):
    if spec:
        return tdl.make_paged_spec_decode_step(
            cfg, depth=spec, page_size=PS, max_depth=DEPTH, graphs=graphs) \
            if paged else tdl.make_spec_decode_step(
                cfg, depth=spec, max_depth=DEPTH, graphs=graphs)
    return tdl.make_paged_decode_step(cfg, page_size=PS, max_depth=DEPTH,
                                      graphs=graphs) if paged \
        else tdl.make_fused_decode_step(cfg, max_depth=DEPTH, graphs=graphs)


@pytest.mark.parametrize("spec", [None, 4])
@pytest.mark.parametrize("paged", [False, True])
def test_one_step_is_the_same_program_for_any_input(meta_model, card, spec,
                                                    paged):
    """The body over runner states loaded with different budgets (the
    active sets), positions and tables records the same ops with the
    same shapes and the same launches with the same arguments.  Every
    tensor is a meta tensor, so any host read would raise."""
    tcfg, params = meta_model
    lib = card
    caches, table = _meta_inputs(tcfg, paged)
    body = tdl.spec_body(tdl.make_spec_lane_step(
        tcfg, page_size=PS if paged else None), spec) if spec \
        else tdl.fused_body(tdl.make_lane_step(
            tcfg, page_size=PS if paged else None))
    runner = tgraphs.StepRunner(tgraphs.DecodeGraphs(), "probe", body,
                                length=spec or 1,
                                heads=(tcfg.n_heads, tcfg.n_kv_heads),
                                widths=(1, 2, 4, 8),
                                page_size=PS if paged else None)
    programs = []
    # The first run allocates the attention scratch; record from the
    # second on.
    for budgets in [BUDGETS[0]] + BUDGETS:
        st = runner.load(params, caches, _meta(N), _meta(N), budgets, DEPTH,
                         table=table, hist=_meta(N, 16) if spec else None)
        lib.calls.clear()
        with _Record() as rec:
            body(params, caches, st)
        programs.append((rec.calls, [(name, args) for name, args in
                                     lib.calls]))
    programs = programs[1:]
    for other in programs[1:]:
        for got, want in zip(other, programs[0], strict=True):
            diff = next((i for i, (a, b) in enumerate(zip(got, want))
                         if a != b), None)
            assert diff is None and len(got) == len(want), \
                (diff, got[diff - 2:diff + 2] if diff else len(got),
                 want[diff - 2:diff + 2] if diff else len(want))
    launched = [name for name, _ in programs[0][1]]
    attention = "repro_paged_flash_attention" if paged \
        else "repro_flash_attention"
    assert launched.count(attention) == tcfg.n_layers
    assert len(launched) == 4 * tcfg.n_layers + 1


@pytest.fixture(scope="module")
def meta_hybrid():
    """Reduced zamba2 (five Mamba2 layers, then the shared attention
    block), its weights as meta tensors."""
    cfg = get_config("zamba2-1.2b").reduced()
    return cfg, _meta_tree(tlm.init_params(0, cfg, device="cpu"))


@pytest.mark.parametrize("paged", [False, True])
def test_hybrid_step_is_the_same_program_for_any_input(meta_hybrid, card,
                                                       paged):
    """The fused body over zamba2's states and K/V, loaded with
    different budgets, positions and tables, records the same ops with
    the same shapes and the same launches: the recurrent state's update
    under ``keep`` reads nothing back to the host and takes no shape from
    the active set, so one captured graph serves every step.  Kernel 1
    launches 8 times a step (1 + 6 layers + the shared block's ln2),
    kernel 2 or 3 once (the one shared-attention layer)."""
    tcfg, params = meta_hybrid
    lib = card
    table = _meta(N, MAX_LEN // PS, dtype=torch.int32) if paged else None
    caches = []
    for kind in tcfg.layer_kinds():
        if kind == "shared_attn":
            shape = ((1 + N * (MAX_LEN // PS)) * PS, tcfg.n_kv_heads,
                     tcfg.head_dim_) if paged \
                else (N, tcfg.n_kv_heads, MAX_LEN, tcfg.head_dim_)
            caches.append({name: _meta(*shape, dtype=torch.float32)
                           for name in ("k", "v")})
        else:
            caches.append({
                "ssm": _meta(N, tcfg.ssm_heads, tcfg.ssm_state,
                             tcfg.ssm_head_dim, dtype=torch.float32),
                "conv": _meta(N, tcfg.conv_width - 1,
                              tcfg.d_inner + 2 * tcfg.ssm_state,
                              dtype=torch.float32)})
    body = tdl.fused_body(tdl.make_lane_step(
        tcfg, page_size=PS if paged else None))
    runner = tgraphs.StepRunner(tgraphs.DecodeGraphs(), "probe", body,
                                length=1,
                                heads=(tcfg.n_heads, tcfg.n_kv_heads),
                                widths=(1,), page_size=PS if paged else None)
    programs = []
    for budgets in [BUDGETS[0]] + BUDGETS:
        st = runner.load(params, caches, _meta(N), _meta(N), budgets, DEPTH,
                         table=table)
        lib.calls.clear()
        with _Record() as rec:
            body(params, caches, st)
        programs.append((rec.calls, [(name, args) for name, args in
                                     lib.calls]))
    programs = programs[1:]
    for other in programs[1:]:
        assert other == programs[0]
    launched = [name for name, _ in programs[0][1]]
    attention = "repro_paged_flash_attention" if paged \
        else "repro_flash_attention"
    assert launched.count(attention) == 1
    assert len(launched) == 8 + 1
    assert runner._scratch_need() >= 0


@pytest.mark.parametrize("paged", [False, True])
def test_replays_count_what_the_capture_counted(meta_model, card, paged):
    """One dispatch of 7 steps: the first step runs (85-style kernel-1
    launches once), its capture counts nothing, the 6 replays add the
    capture's launches each, and the listeners hear of each replay with
    the forward's (B, L)."""
    tcfg, params = meta_model
    caches, table = _meta_inputs(tcfg, paged)
    graphs = tgraphs.DecodeGraphs()
    step = _step_fn(tcfg, None, paged, graphs)
    heard = []
    tgraphs.replay_listeners.append(heard.append)
    args = (table,) if paged else ()
    try:
        out = step(params, caches, *args, _meta(N), _meta(N), [7, 0, 3])
    finally:
        tgraphs.replay_listeners.remove(heard.append)
    per_forward = 3 * tcfg.n_layers + 1
    assert dict(graphs.captures) == {"fused": 1}
    assert graphs.replays == 6 and len(heard) == 6
    assert krms.launches.count == 7 * per_forward
    assert krms.entry_launches["qk_norm_rope"].count == 7 * tcfg.n_layers
    attention = kfa.paged_launches if paged else kfa.launches
    assert attention.count == 7 * tcfg.n_layers
    assert {cap.forward for cap in heard} == {(N, 1)}
    assert all(cap.tally[krms.launches] == (per_forward, {})
               for cap in heard)
    if paged:
        assert kfa.paged_launches.by_key == {
            (N, 1, PS, 0): 7 * tcfg.n_layers}
    # A second dispatch with the same key only replays.
    step(params, out[0], *args, _meta(N), _meta(N), [2, 2, 2])
    assert dict(graphs.captures) == {"fused": 1} and graphs.replays == 8


@pytest.mark.parametrize("paged", [False, True])
def test_scratch_is_reserved_once_before_the_first_capture(meta_model, card,
                                                           paged,
                                                           monkeypatch):
    """The fused step and every verify width share one DecodeGraphs: the
    first capture sizes its scratch for the largest of them at the
    cache's capacity, and no later capture grows or replaces it; no
    per-stream buffer is made on the capture stream.  (The speculative
    dispatch's round-count read, the one host read it makes, answers
    "done" here: a meta tensor has no value.)"""
    tcfg, params = meta_model
    kfa._scratch.pop((None, _Stream.cuda_stream), None)
    monkeypatch.setattr(tdl, "to_host", lambda t: np.array(0))
    caches, table = _meta_inputs(tcfg, paged)
    graphs = tgraphs.DecodeGraphs()
    pt = (table,) if paged else ()
    skv = MAX_LEN
    need = max(kfa.attention_plan(N, tcfg.n_heads, tcfg.n_kv_heads, sq,
                                  torch.float32).scratch_bytes(skv)
               for sq in (1, 2, 4, 8))
    caches, _, _ = _step_fn(tcfg, None, paged, graphs)(
        params, caches, *pt, _meta(N), _meta(N), [1, 1, 1])
    buf = graphs.scratch
    assert graphs.scratch_bytes == buf.numel() == need
    for d in (2, 4, 8):
        caches, *_ = _step_fn(tcfg, d, paged, graphs)(
            params, caches, *pt, _meta(N, 16), _meta(N), _meta(N),
            [1, 1, 1])
        assert graphs.scratch is buf
    assert graphs.generation == 0
    assert (None, _Stream.cuda_stream) not in kfa._scratch
    assert dict(graphs.captures) == {"fused": 1, "spec2": 1, "spec4": 1,
                                     "spec8": 1}


@pytest.mark.parametrize("size", [None, 1])
def test_a_capture_without_its_scratch_raises(meta_model, card, monkeypatch,
                                              size):
    """A capture with no buffer bound, or with one smaller than a call
    needs, raises rather than bake a per-stream buffer's address."""
    tcfg, params = meta_model

    def reserve(self, nbytes, device):
        self.scratch = None if size is None \
            else torch.empty(size, dtype=torch.uint8, device=device)

    monkeypatch.setattr(tgraphs.DecodeGraphs, "reserve", reserve)
    caches, _ = _meta_inputs(tcfg, False)
    step = _step_fn(tcfg, None, False, tgraphs.DecodeGraphs())
    match = "must bind" if size is None else "bound buffer"
    with pytest.raises(RuntimeError, match=match):
        step(params, caches, _meta(N), _meta(N), [2, 2, 2])


def test_counters_snapshot_restore_and_tally():
    c = build.LaunchCounter("probe")
    c.add()
    snap = build.snapshot()
    c.add()
    c.add(("shape", 1))
    tally = build.tally_since(snap)
    assert tally == {c: (2, {("shape", 1): 1})}
    build.restore(snap)
    assert c.count == 1 and c.by_key == {}
    build.add_tally(tally)
    build.add_tally(tally)
    assert c.count == 5 and c.by_key == {("shape", 1): 2}
    build._counters.remove(c)
