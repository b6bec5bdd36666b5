"""The port's training path on the CPU against the JAX package's: batch
generation, the full-sequence forward and loss, every gradient leaf,
one AdamW update (default, bf16 moments, master weights), the LR
schedules, an 8-step training trajectory, accumulation and remat, the
acc train plan, the one-shot prefill step, the attention the training
forward runs, and the training CLI.  Same weights (the reference's
``init_params`` leaves bridged through numpy in f32), same batches.

Tolerances: f32 on both sides; the port's norm divides by sqrt where the
reference multiplies by rsqrt (ROADMAP kernel note), and sums run in
other orders, so values agree to ~1e-6 relative per op and gradients to
1e-4 of each leaf's norm; an 8-step run compounds it to ~1e-4 of the
loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.core.acc import AdaptiveCoreChunk as JAcc
from repro.core.executor import MeshExecutor as JMeshExecutor
from repro.core.hardware import TPU_V5E, HardwareSpec as JHardware
from repro.data import make_batch as jmake_batch
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.serve.engine import make_prefill_step as jmake_prefill_step
from repro.train import choose_plan as jchoose_plan
from repro.train import make_train_step as jmake_train_step
from repro_torch import bridge, tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.acc import AdaptiveCoreChunk
from repro_torch.core.adaptive import adaptive
from repro_torch.core.executor import MeshExecutor
from repro_torch.core.hardware import H100_SXM, HardwareSpec
from repro_torch.data import make_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw, schedule
from repro_torch.serve import make_prefill_step
from repro_torch.train import (choose_plan, make_eval_step, make_loss_fn,
                               make_train_step)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("qwen3-0.6b").reduced()
    tcfg = get_config("qwen3-0.6b").reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    arrays = jax.tree.map(np.asarray, jparams)
    jbatch = jmake_batch(jcfg, 4, 32, kind="train", seed=0)
    tbatch = make_batch(tcfg, 4, 32, kind="train", seed=0, device="cpu")
    return jcfg, tcfg, jparams, arrays, jbatch, tbatch


def _params(arrays, cfg, dtype=torch.float32):
    return bridge.from_reference(arrays, cfg, device="cpu", dtype=dtype)


def _jax_leaf(jtree, path):
    """The reference leaf at a port path: layer i of the port is slice i
    of the stacked ``blocks/pos0`` leaf."""
    if path[0] == "layers":
        node = jtree["blocks"]["pos0"]
        for key in path[2:]:
            node = node[key]
        return np.asarray(node, np.float32)[path[1]]
    node = jtree
    for key in path:
        node = node[key]
    return np.asarray(node, np.float32)


def _grads(params, batch, cfg, **kw):
    flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = tlm.loss_fn(tree.unflatten(params, flat), batch, cfg, **kw)
    return loss, tree.unflatten(params, torch.autograd.grad(loss, flat))


@pytest.mark.parametrize("kind,seed", [("train", 0), ("train", 5),
                                       ("prefill", 3)])
def test_make_batch_matches_the_reference(setup, kind, seed):
    jcfg, tcfg = setup[:2]
    jb = jmake_batch(jcfg, 3, 17, kind=kind, seed=seed)
    tb = make_batch(tcfg, 3, 17, kind=kind, seed=seed, device="cpu")
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tb[k].dtype == torch.int64
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_forward_and_loss_match_the_reference(setup):
    jcfg, tcfg, jparams, arrays, jbatch, tbatch = setup
    params = _params(arrays, tcfg)
    jlogits, _ = jax.jit(jlm.forward, static_argnums=2)(jparams, jbatch,
                                                        jcfg)
    logits, aux = tlm.forward(params, tbatch, tcfg)
    assert logits.shape == (4, 32, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    jloss = float(jax.jit(jlm.loss_fn, static_argnums=2)(jparams, jbatch,
                                                         jcfg))
    with torch.no_grad():
        loss = float(tlm.loss_fn(params, tbatch, tcfg))
        loss_remat = float(tlm.loss_fn(params, tbatch, tcfg, remat=True))
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert loss_remat == loss


def test_every_gradient_leaf_matches_jax_grad(setup):
    jcfg, tcfg, jparams, arrays, jbatch, tbatch = setup
    jgrads = jax.jit(jax.grad(jlm.loss_fn), static_argnums=2)(
        jparams, jbatch, jcfg)
    _, grads = _grads(_params(arrays, tcfg), tbatch, tcfg)
    paths = tree.with_paths(grads)
    assert len(paths) == 2 + tcfg.n_layers * 11     # embed, final, layers
    for path, g in paths:
        ref = _jax_leaf(jgrads, path)
        assert g.shape == ref.shape, path
        err = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref),
                                                    1e-30)
        assert err < 1e-4, (path, err)


def test_remat_and_accumulation_give_the_same_step(setup):
    """remat=True recomputes the same ops (the same gradients, bit for
    bit); accum=2 on the batch equals accum=1 (the reference's
    ``test_grad_accum_equivalence``)."""
    _, tcfg, _, arrays, _, tbatch = setup
    l0, g0 = _grads(_params(arrays, tcfg), tbatch, tcfg)
    l1, g1 = _grads(_params(arrays, tcfg), tbatch, tcfg, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(tree.leaves(g0), tree.leaves(g1), strict=True):
        assert torch.equal(a, b)
    opt = AdamWConfig(lr=1e-3)
    out = {}
    for accum in (1, 2):
        params = _params(arrays, tcfg)
        step = make_train_step(tcfg, opt, accum=accum)
        out[accum] = step(params, adamw.init_state(params), tbatch)
    (p1, _, m1), (p2, _, m2) = out[1], out[2]
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(tree.leaves(p1), tree.leaves(p2), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("case", ["default", "bf16 moments",
                                  "master weights"])
def test_adamw_update_matches_the_reference(setup, case):
    """Two updates from the same grads and state: parameters, moments,
    step, master copy and grad norm.  With master weights the working
    parameters are bf16, so the master copy carries the update."""
    _, tcfg, _, arrays, _, _ = setup
    kw = {"default": {}, "bf16 moments": {"moment_dtype": "bfloat16"},
          "master weights": {"master_weights": True}}[case]
    pdtype = "bfloat16" if case == "master weights" else "float32"
    jcfg_opt, tcfg_opt = JAdamWConfig(lr=1e-2, **kw), AdamWConfig(lr=1e-2,
                                                                  **kw)
    jp = jax.tree.map(lambda a: jnp.asarray(a, pdtype), arrays)
    tp = tree.map_leaves(lambda a: torch.tensor(
        np.asarray(a, np.float32)).to(getattr(torch, pdtype)), arrays)
    rng = np.random.default_rng(11)
    graw = [rng.standard_normal(np.shape(a)).astype(np.float32)
            for a in jax.tree.leaves(arrays)]
    jg = jax.tree.unflatten(jax.tree.structure(arrays),
                            [jnp.asarray(g) for g in graw])
    tg = tree.unflatten(arrays, [torch.from_numpy(g) for g in graw])
    js = jadamw.init_state(jp, jcfg_opt if kw else None)
    ts = adamw.init_state(tp, tcfg_opt if kw else None)
    jupdate = jax.jit(jadamw.update, static_argnums=3)
    for _ in range(2):
        jp, js, jm = jupdate(jg, js, jp, jcfg_opt)
        tp, ts, tm = adamw.update(tg, ts, tp, tcfg_opt)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 2
    assert sorted(ts) == sorted(js)
    # f32 leaves: the same ops in the same order, but the global norm is
    # summed in another order, and it scales every update (~1e-7
    # relative; a parameter near zero keeps that error of the update's
    # size lr, not of its own).  bf16 leaves: that can flip one rounding,
    # one bf16 step (2^-8 relative).  With bf16 moments such a flip in
    # step 1's m or v moves step 2's update by up to lr · 2^-8.
    lr = jcfg_opt.lr
    update_atol = lr * (2.0 ** -8 if kw.get("moment_dtype") else 1e-6)
    for name, jt, tt in (("params", jp, tp), ("m", js["m"], ts["m"]),
                         ("v", js["v"], ts["v"]),
                         ("master", js.get("master"), ts.get("master"))):
        if jt is None:
            continue
        for (path, t), j in zip(tree.with_paths(tt), jax.tree.leaves(jt),
                                strict=True):
            assert str(t.dtype)[6:] == str(j.dtype), (name, path)
            atol = 1e-12 if name in ("m", "v") else update_atol
            rtol = 1e-5 if t.dtype == torch.float32 else 2.0 ** -7
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), rtol=rtol,
                                       atol=atol, err_msg=f"{name} {path}")


def test_schedules_match_the_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=5, total_steps=40)
    for step in range(0, 50, 3):
        assert float(schedule.warmup_cosine(step, **kw)) == pytest.approx(
            float(jschedule.warmup_cosine(step, **kw)), rel=1e-6)
        assert float(schedule.constant(step, **kw)) == pytest.approx(
            float(jschedule.constant(step, **kw)), rel=1e-7)
    s = torch.tensor(7, dtype=torch.int32)
    assert schedule.warmup_cosine(s, **kw).dtype == torch.float32


def test_eight_steps_follow_the_reference_trajectory(setup):
    """The jitted reference step and the port's step from the same
    weights and batch: the losses agree step by step and fall by at
    least 0.3 (the reference's ``test_loss_decreases``)."""
    jcfg, tcfg, jparams, arrays, jbatch, tbatch = setup
    jstep = jax.jit(jmake_train_step(jcfg, JAdamWConfig(lr=1e-3)))
    tstep = make_train_step(tcfg, AdamWConfig(lr=1e-3))
    jp, js = jparams, jadamw.init_state(jparams)
    tp = _params(arrays, tcfg)
    ts = adamw.init_state(tp)
    jl, tl = [], []
    for _ in range(8):
        jp, js, jm = jstep(jp, js, jbatch)
        tp, ts, tm = tstep(tp, ts, tbatch)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    assert tl[-1] < tl[0] - 0.3
    evaluated = float(make_eval_step(tcfg)(tp, tbatch))
    assert evaluated == pytest.approx(float(make_loss_fn(tcfg)(
        tp, tbatch).detach()), rel=1e-6)


class _Mesh:
    """A mesh stand-in both packages' ``MeshExecutor`` read: its shape."""

    def __init__(self, data: int):
        self.shape = {"data": data, "model": 1}


@pytest.mark.parametrize("data", [1, 4])
@pytest.mark.parametrize("batch,seq", [(8, 64), (4, 32), (256, 4096),
                                       (12, 512)])
@pytest.mark.parametrize("hw", ["h100", "tpu-v5e"])
def test_choose_plan_matches_the_reference(setup, hw, batch, seq, data):
    """The same TrainPlan (widths, microbatches, and the acc decision
    under it) from both packages for one hardware spec and mesh width;
    with one device the port's ``make_host_mesh`` is the mesh."""
    jcfg, tcfg = setup[:2]
    spec = H100_SXM if hw == "h100" else HardwareSpec(
        **dataclasses.asdict(TPU_V5E))
    jspec = JHardware(**dataclasses.asdict(spec))
    tm = tmesh.make_host_mesh("cpu") if data == 1 else _Mesh(data)
    tplan = choose_plan(tcfg, ShapeConfig("t", seq, batch, "train"),
                        adaptive(MeshExecutor(tm),
                                 AdaptiveCoreChunk(hardware=spec)))
    jplan = jchoose_plan(jcfg, JShape("t", seq, batch, "train"),
                         JMeshExecutor(_Mesh(data)), JAcc(hardware=jspec))
    assert (tplan.data_parallel, tplan.accum, tplan.microbatch) == \
        (jplan.data_parallel, jplan.accum, jplan.microbatch)
    assert dataclasses.asdict(tplan.decision) == \
        dataclasses.asdict(jplan.decision)


def test_host_mesh_needs_a_card_unless_asked_for_the_cpu():
    assert tmesh.make_host_mesh("cpu").shape == {"data": 1, "model": 1}
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_host_mesh()


@pytest.mark.parametrize("impl", ["chunked", "naive", "flash"])
def test_prefill_step_matches_forward_cached(setup, impl):
    """The one-shot prefill's last-token logits against the cached
    forward's (the serve path) and the reference's prefill step."""
    jcfg, tcfg, jparams, arrays, jbatch, tbatch = setup
    params = _params(arrays, tcfg)
    tokens = {"tokens": tbatch["tokens"]}
    with torch.no_grad():
        out = make_prefill_step(tcfg, attn_impl=impl)(params, tokens)
        caches = tlm.init_caches(tcfg, 4, 32, device="cpu")
        cached, _ = tlm.forward_cached(params, tokens["tokens"], caches, 0,
                                       tcfg)
    ref = jmake_prefill_step(jcfg)(jparams, {"tokens": jbatch["tokens"]})
    assert out.shape == (4, 1, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), cached.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window,kv_len,sq", [
    (True, None, None, 24), (True, 5, None, 24), (False, None, 20, 8),
    (True, None, 20, 8)])
def test_attention_chunked_matches_the_reference(causal, window, kv_len, sq):
    """Several kv blocks (block_kv 8 over 24 keys, one padded), GQA,
    windows and end-aligned rows against the reference's."""
    rng = np.random.default_rng(sq + (window or 0))
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 22, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 22, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, kv_len=kv_len, block_kv=8)
    ref = jattn.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    out = tattn.attention_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_flash_sdpa_refuses_to_train():
    """Kernel 2 has no backward: under grad with an input that requires
    grad, ``sdpa(impl="flash")`` raises instead of cutting the graph."""
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    k = torch.randn(1, 1, 4, 8)
    with pytest.raises(RuntimeError, match="chunked"):
        tattn.sdpa(q, k, k, impl="flash")
    with torch.no_grad():
        assert tattn.sdpa(q, k, k, impl="flash").shape == q.shape


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "3",
                  "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--no-cal-cache", "--ckpt", str(tmp_path / "ck"),
                  "--log-every", "1", "--explain-decisions"])
    out = capsys.readouterr().out
    assert "acc plan: data_parallel=1 accum=1" in out
    assert out.count("gnorm") == 3 and "tok/s" in out
    assert "train_plan" in out
    # --kernel-autotune is taken: the same losses as the untuned run
    # (kernel 1's warps change no bits; the CPU runs the plain versions),
    # after measured searches, and the reference's searches/reused line.
    args = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu", "--no-cal-cache",
            "--accum", "1", "--log-every", "1"]
    runs = []
    for extra in ([], ["--kernel-autotune"]):
        tlaunch.main(args + ["--ckpt", str(tmp_path / f"k{len(extra)}")]
                     + extra)
        runs.append(capsys.readouterr().out)
    losses = [[ln.split("gnorm")[0] for ln in out.splitlines()
               if ln.startswith("step")] for out in runs]
    assert losses[0] == losses[1] and len(losses[0]) == 2
    line = [ln for ln in runs[1].splitlines()
            if ln.startswith("kernel autotune:")]
    assert line and "measured searches" in line[0] \
        and not line[0].startswith("kernel autotune: 0 ")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlaunch.main(["--arch", "qwen3-0.6b", "--reduced"])
