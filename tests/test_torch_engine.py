"""The port's lock-step engine path (``ServeEngine.prefill`` / ``decode``
/ ``pos`` / ``caches``, ``make_decode_step``) against the JAX package's
on the CPU (reduced qwen3-0.6b, f32, seeded numpy prompts), the route
``generate`` takes once the engine holds cache state, and the serve
CLI's ``--print-launch-profile``, ``--cal-cache-dir`` and ``--strict``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.serve import ServeEngine as JaxEngine
from repro.serve import engine as jengine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import strict
from repro_torch.core.calibration import CalibrationCache
from repro_torch.kernels.autotune import KernelTuner
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm as tlm
from repro_torch.serve import ServeEngine, make_decode_step

# f32 on both sides, sums in other orders over two layers (as
# tests/test_torch_models.py).
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, jparams),
                                    tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(seed, b=2, s=12):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def _engines(models, max_len=40):
    jcfg, jparams, tcfg, tparams = models
    return (JaxEngine(jcfg, jparams, batch=2, max_len=max_len),
            ServeEngine(tcfg, tparams, batch=2, max_len=max_len,
                        device="cpu"))


@pytest.mark.parametrize("chunk", [None, 5, 12])
def test_prefill_and_decode_match_jax(models, chunk):
    """Chunked prefill then four greedy lock-step steps: logits within
    TOL and the same tokens; ``pos`` advances by what was fed."""
    jeng, teng = _engines(models)
    prompt = _prompt(0)
    jl = jeng.prefill(jnp.asarray(prompt), chunk=chunk)
    tl = teng.prefill(torch.from_numpy(prompt), chunk=chunk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    assert teng.pos == jeng.pos == prompt.shape[1]
    for _ in range(4):
        jtok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        ttok = torch.argmax(tl[:, -1], dim=-1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl = jeng.decode(jnp.asarray(jtok))
        tl = teng.decode(ttok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    assert teng.pos == jeng.pos == prompt.shape[1] + 4
    for jc, tc in zip(jeng.caches, teng.caches, strict=True):
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   atol=1e-5, rtol=1e-5)


def test_generate_after_prefill_takes_the_lockstep_route(models):
    """With cache state (``pos != 0``) ``generate`` prefills after it and
    decodes the batch in lock step, as the reference does; no scheduler
    is built."""
    jeng, teng = _engines(models, max_len=48)
    first, second = _prompt(1, s=8), _prompt(2, s=6)
    jeng.prefill(jnp.asarray(first))
    teng.prefill(torch.from_numpy(first))
    jout = jeng.generate(jnp.asarray(second), 5)
    tout = teng.generate(torch.from_numpy(second), 5)
    assert teng._sched is None
    assert tout.shape == (2, 5) and tout.dtype == torch.long
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert teng.pos == jeng.pos == 8 + 6 + 5


def test_generate_from_empty_state_goes_through_the_scheduler(models):
    _, _, tcfg, tparams = models
    engine = ServeEngine(tcfg, tparams, batch=2, max_len=32,
                         dispatch_depth=2, device="cpu")
    engine.generate(_prompt(3, s=5), 3)
    assert engine._sched is not None and engine.pos == 0
    assert engine._caches is None


def test_make_decode_step_matches_reference(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _prompt(4, s=3)
    jc = jlm.init_caches(jcfg, 2, 16)
    tc = tlm.init_caches(tcfg, 2, 16, device="cpu")
    jstep = jax.jit(jengine.make_decode_step(jcfg))
    tstep = make_decode_step(tcfg)
    for pos, piece in ((0, toks), (3, toks[:, :1])):
        jl, jc = jstep(jparams, jc, jnp.asarray(piece), pos)
        tl, tc = tstep(tparams, tc, torch.from_numpy(piece), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    for j, t in zip(jc, tc, strict=True):
        np.testing.assert_allclose(t["v"].numpy(), np.asarray(j["v"]),
                                   atol=1e-5, rtol=1e-5)


def test_unported_engine_options_raise(models):
    """No engine option raises any more: ``kernel_tuner`` (now ported)
    is taken on both paths, scheduled and lock-step, with the
    untuned tokens.  Frontend features are taken: an arch with no
    ``cross_attn`` layer reads none of them, and ``generate`` with them
    takes the lock-step path (as the reference), with the tokens of a
    run without them."""
    _, _, tcfg, tparams = models
    tuner = KernelTuner(CalibrationCache(), repeats=1)
    for lockstep in (False, True):
        tuned = ServeEngine(tcfg, tparams, batch=1, max_len=16,
                            device="cpu", kernel_tuner=tuner)
        untuned = ServeEngine(tcfg, tparams, batch=1, max_len=16,
                              device="cpu")
        feats = torch.zeros(1, 4, 8) if lockstep else None
        assert torch.equal(
            tuned.generate(_prompt(6, b=1, s=4), 3, frontend_feats=feats),
            untuned.generate(_prompt(6, b=1, s=4), 3, frontend_feats=feats))
    assert tuner.searches > 0
    feats = torch.zeros(1, 4, 8)
    engine = ServeEngine(tcfg, tparams, batch=1, max_len=16, device="cpu")
    plain = ServeEngine(tcfg, tparams, batch=1, max_len=16, device="cpu")
    for call in (lambda e, f: e.prefill(_prompt(5, b=1, s=4),
                                        frontend_feats=f),
                 lambda e, f: e.decode(_prompt(5, b=1, s=1),
                                       frontend_feats=f),
                 lambda e, f: e.generate(_prompt(5, b=1, s=4), 2,
                                         frontend_feats=f)):
        assert torch.equal(call(engine, feats), call(plain, None))
    assert engine._sched is None and engine.pos == plain.pos == 4 + 1 + 4 + 2


# ---------------------------------------------------------------------------
# the serve CLI's flags
# ---------------------------------------------------------------------------

def test_print_launch_profile_prints_and_exits(capsys):
    launch_serve.main(["--print-launch-profile"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(launch_serve.LAUNCH_PROFILE) >= 3
    for line, (var, value, why) in zip(lines, launch_serve.LAUNCH_PROFILE,
                                       strict=True):
        assert line == f"export {var}={value}  # {why}"
        assert not var.startswith(("XLA", "JAX", "TF_"))


def _serve_args(*extra):
    return ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--requests", "2", "--slots", "2", "--prompt-len", "8",
            "--new-tokens", "2", *extra]


def test_cal_cache_dir_gets_the_calibration_file(tmp_path, capsys):
    launch_serve.main(_serve_args("--cal-cache-dir", str(tmp_path)))
    out = capsys.readouterr().out
    path = os.path.join(str(tmp_path), "calibration.json")
    assert os.path.exists(path)
    assert f"calibration cache: {path}" in out


def test_strict_serves_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(strict, "_FORCED", False)
    monkeypatch.delenv("REPRO_STRICT", raising=False)
    assert not strict.enabled()
    launch_serve.main(_serve_args("--strict", "--no-cal-cache"))
    assert strict.enabled()
    out = capsys.readouterr().out
    assert "generated 4 tokens" in out
