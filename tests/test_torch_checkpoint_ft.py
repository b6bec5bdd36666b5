"""The port's checkpointing, fault-tolerant trainer and straggler
analysis on the CPU: the JAX package's own tests of them
(``tests/test_train_and_ft.py``) run on the port, plus a save that must
not see an in-place update made after it returned, and the straggler
numbers against the reference's."""
import os

import numpy as np
import pytest
import torch

from repro.runtime import stragglers as jstragglers
from repro_torch import tree
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline, make_batch
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime import (FaultTolerantTrainer, SimulatedFailure,
                                 mitigation_table, straggler_step_time)
from repro_torch.train import make_train_step


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-0.6b").reduced()
    params = lm.init_params(0, cfg, device="cpu", dtype=lm.param_dtype(cfg))
    return cfg, params, adamw.init_state(params)


def _copy(t):
    return tree.map_leaves(torch.clone, t)


def test_checkpoint_roundtrip(setup, tmp_path):
    _, params, opt = setup
    d = str(tmp_path / "ck")
    opt = dict(opt, m=tree.map_leaves(lambda m: m.to(torch.bfloat16) + 1,
                                      opt["m"]))
    checkpointer.save(d, 7, (params, opt))
    path = checkpointer.latest(d)
    assert path and path.endswith("step_00000007")
    like = (tree.map_leaves(torch.zeros_like, params),
            tree.map_leaves(torch.zeros_like, opt))
    (p2, o2), step = checkpointer.restore(path, like)
    assert step == 7
    for a, b in zip(tree.leaves((params, opt)), tree.leaves((p2, o2)),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_prune_and_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        checkpointer.save(d, s, {"x": torch.ones(3)}, keep=2)
    kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    # a checkpoint without DONE must be invisible
    os.remove(os.path.join(d, "step_00000005", "DONE"))
    assert checkpointer.latest(d).endswith("step_00000004")


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ck")
    ac = checkpointer.AsyncCheckpointer(d)
    ac.save_async(3, {"w": torch.arange(5)})
    ac.wait()
    assert checkpointer.latest(d).endswith("step_00000003")


def test_async_save_copies_before_returning(tmp_path):
    """The optimizer updates tensors in place: a tensor changed right
    after ``save_async`` returned is saved with the value it had."""
    d = str(tmp_path / "ck")
    w = torch.arange(4096, dtype=torch.float32)
    ac = checkpointer.AsyncCheckpointer(d)
    ac.save_async(1, {"w": w})
    w.add_(1000.0)
    ac.wait()
    out, _ = checkpointer.restore(checkpointer.latest(d),
                                  {"w": torch.zeros(4096)})
    assert torch.equal(out["w"], torch.arange(4096, dtype=torch.float32))


def _data(cfg):
    i = 0
    while True:
        yield make_batch(cfg, 4, 32, kind="train", seed=i, device="cpu")
        i += 1


def test_ft_restart_recovers(setup, tmp_path):
    cfg, params, opt = setup
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    fails = {5, 9}

    def hook(s):
        if s in fails:
            fails.discard(s)
            raise SimulatedFailure(f"node lost @{s}")

    tr = FaultTolerantTrainer(step, str(tmp_path / "ft"), save_every=3,
                              failure_hook=hook)
    p, o, log = tr.run(_copy(params), _copy(opt), _data(cfg), num_steps=12)
    assert len(log) >= 12          # all 12 steps eventually ran
    assert not fails               # both failures were hit and survived
    assert checkpointer.latest(str(tmp_path / "ft")) is not None
    assert int(o["step"]) == 12 and all(np.isfinite(m["loss"]) for m in log)


def test_ft_restart_equals_an_uninterrupted_run(setup, tmp_path):
    """One batch repeated: a run that fails at step 3 and restarts from
    its step-2 checkpoint ends where an uninterrupted run ends."""
    cfg, params, opt = setup
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    batch = make_batch(cfg, 4, 32, kind="train", seed=0, device="cpu")

    def repeat():
        while True:
            yield batch

    fails = {3}

    def hook(s):
        if s in fails:
            fails.discard(s)
            raise SimulatedFailure("once")

    runs = {}
    for name, h in (("plain", None), ("restart", hook)):
        tr = FaultTolerantTrainer(step, str(tmp_path / name), save_every=2,
                                  failure_hook=h)
        runs[name] = tr.run(_copy(params), _copy(opt), repeat(),
                            num_steps=6)
    (p0, _, l0), (p1, _, l1) = runs["plain"], runs["restart"]
    assert not fails and len(l1) == 7
    assert l1[-1]["loss"] == l0[-1]["loss"]
    for a, b in zip(tree.leaves(p0), tree.leaves(p1), strict=True):
        assert torch.equal(a, b)


def test_ft_exceeds_max_restarts(setup, tmp_path):
    cfg, params, opt = setup
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))

    def hook(s):
        raise SimulatedFailure("always")

    tr = FaultTolerantTrainer(step, str(tmp_path / "ft2"), save_every=3,
                              failure_hook=hook, max_restarts=2)
    with pytest.raises(SimulatedFailure):
        tr.run(_copy(params), _copy(opt), _data(cfg), num_steps=5)


def test_token_pipeline_yields_the_seeded_batches(setup):
    cfg = setup[0]
    it = iter(TokenPipeline(cfg, 2, 8, seed=4, device="cpu"))
    for i in range(3):
        b = next(it)
        ref = make_batch(cfg, 2, 8, kind="train", seed=4 + i, device="cpu")
        assert torch.equal(b["tokens"], ref["tokens"])
        assert torch.equal(b["labels"], ref["labels"])
    it.close()


def test_straggler_numbers_match_the_reference():
    tab = mitigation_table(slowdown=5.0, n_devices=64)
    assert tab == jstragglers.mitigation_table(slowdown=5.0, n_devices=64)
    assert tab[8] < tab[1] and tab[8] < 1.6      # the reference's claims
    for kw in (dict(n_devices=8, chunks_per_device=4, slowdown=3.0),
               dict(n_devices=256, chunks_per_device=8, slowdown=5.0,
                    straggler_fraction=0.05, seed=2)):
        assert straggler_step_time(**kw) == \
            jstragglers.straggler_step_time(**kw)
