"""The roofline on one card (``analysis/roofline.py``) on the CPU:
``model_flops`` and ``flash_attention_hbm_bytes`` against the JAX
package's for every arch, the eager cost count of one reduced
``forward_cached`` against its closed form, and
``ServeScheduler.decode_cost_analysis`` leaving the pool, the tokens and
the step state as they were.

The reference's ``decode_cost_analysis`` reads XLA's cost analysis of the
compiled loop body; it is not compared with the port's count: XLA counts
masked keys (the whole cache), fused bytes and its own elementwise flops
under definitions of its own, where the port counts each kernel's
visible keys and each tensor op's inputs and outputs once."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JShape
from repro.kernels import tuning as jtuning
from repro_torch.analysis import roofline
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.acc import StaticCoreChunk
from repro_torch.kernels import build
from repro_torch.models import lm
from repro_torch.serve import ServeScheduler

SHAPES = (("train", 2048, 16), ("prefill", 4096, 4), ("decode", 1024, 64))


@pytest.mark.parametrize("kind,seq,batch", SHAPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_attention_bytes_equal_the_reference(arch, kind,
                                                             seq, batch):
    """Same formula, same configs: the same numbers.  The attention
    traffic at the reference's query block (its VMEM plan) is the
    reference's number; the port's default block is its tile path's."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    shape = ShapeConfig(kind, seq, batch, kind)
    jshape = JShape(kind, seq, batch, kind)
    assert roofline.model_flops(cfg, shape) == jroof.model_flops(jcfg,
                                                                 jshape)
    if cfg.head_dim_ and any(k in ("attn", "shared_attn", "cross_attn")
                             for k in cfg.layer_kinds()):
        bq, _ = jtuning.plan_attention(seq, seq, jcfg.head_dim_,
                                       bytes_per_elem=2)
        for chips, passes in ((1, 4.0), (4, 1.0)):
            assert roofline.flash_attention_hbm_bytes(
                cfg, shape, chips=chips, passes=passes, block_q=bq) == \
                jroof.flash_attention_hbm_bytes(jcfg, jshape, chips=chips,
                                                passes=passes)
        assert roofline.flash_attention_hbm_bytes(cfg, shape, chips=1) > 0


def test_report_terms():
    rep = roofline.RooflineReport(
        arch="a", shape="s", mesh="1", chips=1, flops_per_device=2e12,
        bytes_per_device=1e9, collective_bytes_per_device=0.0,
        collective_detail={}, compute_s=2e12 / 989e12, memory_s=1e9 / 3.35e12,
        collective_s=0.0, model_flops=1e12, useful_fraction=0.5,
        peak_memory_bytes=0.0, argument_bytes=0.0)
    assert rep.dominant == "compute" and rep.step_time_s == rep.compute_s
    assert rep.roofline_fraction == pytest.approx(0.5)
    d = rep.to_dict()
    assert d["dominant"] == "compute" and "roofline" in roofline.format_row(
        rep)


def _visible(lens, sq, skv):
    kj = np.arange(skv)
    qi = np.asarray(lens)[:, None] - sq + np.arange(sq)[None]
    mask = (kj[None, None] < np.asarray(lens)[:, None, None]) \
        & (qi[:, :, None] >= kj[None, None])
    return int(mask.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_count_of_one_forward_matches_its_closed_form(dtype):
    """Reduced qwen3-0.6b (every weight of it in a product, the tied
    embedding as the head), 2 lanes x 8 tokens at position 5, every
    position's logits: the count's flops less kernel 1's are 2 · N ·
    tokens plus 4 · D · Hq per visible (query, key) within 1%; products
    count on the tensor cores in bf16 and off them in f32; kernel 1's
    count is its entries' formula; at least the weights are read."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              compute_dtype=dtype)
    p = lm.init_params(0, cfg, device="cpu", dtype=getattr(torch, dtype))
    b, length, pos, max_len = 2, 8, 5, 32
    caches = lm.init_caches(cfg, b, max_len, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, length)))
    costs = roofline.count_costs(lm.forward_cached, p, toks, caches, pos,
                                 cfg, all_logits=True)
    n = cfg.active_param_count()
    attn = 4 * cfg.head_dim_ * cfg.n_heads * cfg.n_layers * _visible(
        [pos + length] * b, length, max_len)
    norms = costs.kernels["rmsnorm"].other_flops
    want = 2 * n * b * length + attn
    assert abs(costs.flops - norms - want) <= 0.01 * want
    assert costs.kernels["flash_attention"].other_flops + \
        costs.kernels["flash_attention"].tensor_flops == attn
    if dtype == "bfloat16":
        assert costs.tensor_flops >= 2 * n * b * length + attn
    else:
        assert costs.tensor_flops == 0
    rows, d = b * length, cfg.d_model
    heads = b * length * (cfg.n_heads + cfg.n_kv_heads) * cfg.head_dim_
    # Two plain norms (layer 0's ln1, the final one), 2L - 1 residual
    # adds with their norms, L q/k-norms with the rotation.
    assert norms == 4 * rows * d * 2 + 5 * rows * d * (2 * cfg.n_layers - 1) \
        + 10 * heads * cfg.n_layers
    weights = sum(t.numel() * t.element_size()
                  for t in (p["embed"]["table"],))
    assert costs.bytes >= weights
    assert not build.work_sinks
    t, by = costs.bound()
    assert t > 0 and by in ("bytes", "operations")


@pytest.fixture(scope="module")
def tcfg():
    return get_config("qwen3-0.6b").reduced()


def _state(sched):
    pool = sched.pool
    out = [t.clone() for c in pool.caches for t in c.values()]
    out += [torch.tensor(pool.positions)]
    for t in (sched._dev_toks, sched._dev_hist):
        if t is not None:
            out.append(t.clone())
    for fn in [sched._fused_fn, *sched._spec_fns.values()]:
        if fn is not None and fn.runner.state is not None:
            st = fn.runner.state
            out += [getattr(st, f.name).clone()
                    for f in dataclasses.fields(st)
                    if getattr(st, f.name) is not None]
    return out


@pytest.mark.parametrize("mode", ["fused", "paged", "spec"])
def test_decode_cost_analysis_leaves_the_scheduler_as_it_was(tcfg, mode):
    """Mid-run (two requests decoding), the count of one decode-loop
    iteration of the live path: the reference's keys, positive flops and
    bytes, attention and kernel 1 among the kernels; every cache row,
    position, carry token, history and step-state buffer bit for bit as
    before, no launch counted, and the next ticks emit what they would
    have."""
    p = lm.init_params(0, tcfg, device="cpu")
    kw = dict(n_slots=2, max_len=64, acc=StaticCoreChunk(cores=2),
              dispatch_depth=2, device="cpu")
    if mode == "paged":
        kw.update(paged=True, page_size=8)
    if mode == "spec":
        kw.update(speculate=2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (9, 14)]

    def start():
        sched = ServeScheduler(tcfg, p, **kw)
        rids = [sched.submit(x, max_new_tokens=8) for x in prompts]
        for _ in range(3):
            sched.tick()
        return sched, rids

    sched, rids = start()
    before = _state(sched)
    launches = build.snapshot()
    report = sched.decode_cost_analysis()
    assert build.snapshot() == launches
    after = _state(sched)
    assert len(before) == len(after)
    assert all(torch.equal(a, b) for a, b in zip(before, after, strict=True))
    for key in ("flops_per_device", "hbm_bytes_per_device",
                "collective_wire_bytes_per_device", "n_devices"):
        assert key in report
    assert report["flops_per_device"] > 0 and report["n_devices"] == 1
    assert report["hbm_bytes_per_device"] > 0
    attn = "paged_flash_attention" if mode == "paged" else "flash_attention"
    assert set(report["kernels"]) == {"rmsnorm", attn}
    assert report["path"] == {"fused": "fused", "paged": "fused-paged",
                              "spec": "spec2"}[mode]
    outs = sched.run_until_idle()
    ref, ref_rids = start()
    ref_outs = ref.run_until_idle()
    assert [outs[r] for r in rids] == [ref_outs[r] for r in ref_rids]
