"""Attention split over 'model' where the q and kv heads do not both
divide it: the "kv_shared" and "head_dim" rules (``launch/sharding.
attention_rule``), held against the JAX package on gloo CPU ranks.

* The rule of each of the ten archs at a 'model' extent of 16, for the
  training step and for serving; a rank's rotary pairs under
  "head_dim"; the local caches against the plan's cache specs.
* Four gloo ranks (``test_torch_fsdp.spawn``): the reduced qwen3-0.6b
  (4 q / 2 kv heads) on (1, 4), where it is "kv_shared" (on (2, 2)
  "split"), served through both pools: the JAX package's single-device
  scheduler's tokens; its (1, 4) sharded step within 2e-5 of the JAX
  step (the loss within 1e-5).  A reduced qwen1.5-32b with 6 q and 6 kv
  heads in both packages (6 does not divide 4; head_dim 16 splits into
  4 blocks of rotary pairs) on (1, 4), "head_dim": both pools' tokens,
  and the paged pool's under speculation, the JAX scheduler's; every
  lock-step decode step's logits, through the contiguous engine and
  through the paged stores (a rank's rows D / 4 dims of every head,
  read through the page table), within 1e-5 of the JAX decode step's,
  the greedy tokens the same.
* The dry run's qwen1.5-32b ``decode_32k`` on the single-pod mesh fits
  the card with no ``--cache-seq-model``: its cache splits 16 ways.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import sharding
from repro_torch.models import attention, flags
from repro_torch.models import lm as tlm

from test_torch_fsdp import EPS, LR, _jax_init, _jax_train, spawn
from test_torch_seq_shard import check_step, train_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN3, QWEN15 = "qwen3-0.6b", "qwen1.5-32b"
# (training rule, serving rule, cross-attention rule) at 'model' 16.
RULES = {
    "qwen3-0.6b": ("kv_shared", "kv_shared", "whole"),
    "granite-34b": ("kv_shared", "kv_shared", "whole"),
    "qwen1.5-32b": ("whole", "head_dim", "whole"),
    "h2o-danube-1.8b": ("kv_shared", "kv_shared", "whole"),
    "musicgen-medium": ("whole", "head_dim", "whole"),
    "mixtral-8x22b": ("kv_shared", "kv_shared", "whole"),
    "grok-1-314b": ("kv_shared", "kv_shared", "whole"),
    "zamba2-1.2b": ("split", "split", "whole"),
    "xlstm-350m": ("whole", "whole", "whole"),
    "llama-3.2-vision-11b": ("kv_shared", "kv_shared", "kv_shared"),
}
SERVE_SPEC = [(14, 9), (9, 3), (6, 7)]     # (prompt_len, new_tokens)
SERVE = dict(n_slots=4, max_len=48, dispatch_depth=4)
DECODE_BATCH, DECODE_MAX, PROMPT, NEW = 2, 32, 8, 12


def _stub(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


class _Rank:
    """A stub mesh with coordinates, for ``local_shard``."""

    def __init__(self, shape: dict, coords: dict):
        self.shape, self._coords = dict(shape), coords

    def coord(self, axis):
        return self._coords[axis]


def _qwen15_6(cfg):
    """qwen1.5's reduced config with 6 q and 6 kv heads (either
    package's)."""
    return dataclasses.replace(cfg.reduced(), n_heads=6, n_kv_heads=6)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_attention_rule_of_each_arch_at_model_sixteen(arch):
    """The rule for training (no cache) and serving (cached) at a 'model'
    extent of 16; under "kv_shared" the K/V leaves keep the reference's
    contiguous column split and a rank's cache holds one kv head; under
    "head_dim" the q/k/v columns and ``wo``'s rows split one segment per
    half-head and the cache holds D / 16 dims."""
    cfg = get_config(arch)
    mesh = _stub({"data": 16, "model": 16})
    train, serve = sharding.tp_plan(cfg, mesh), \
        sharding.tp_plan(cfg, mesh, cached=True)
    assert (train.attn, serve.attn, train.xattn) == RULES[arch]
    params = tlm.init_params(0, cfg, device="meta")
    specs = sharding.serve_param_specs(cfg, params, mesh)
    family = "shared_block" if arch.startswith("zamba2") else "layers"
    if serve.attn == "whole":
        return
    block = specs["shared_block"]["attn"] if family == "shared_block" \
        else specs["layers"][0]["attn"]
    hkv, d = attention.local_kv(cfg, serve)
    if serve.attn == "kv_shared":
        assert block["wk"]["w"] == (None, "model")
        assert (hkv, d) == (1, cfg.head_dim_)
    elif serve.attn == "head_dim":
        seg = block["wq"]["w"][1]
        assert isinstance(seg, sharding.Segments)
        assert seg.sizes == (cfg.head_dim_ // 2,) * (2 * cfg.n_heads)
        assert isinstance(block["wo"]["w"][0], sharding.Segments)
        assert (hkv, d) == (cfg.n_kv_heads, cfg.head_dim_ // 16)
    else:
        assert (hkv, d) == (cfg.n_kv_heads // 16, cfg.head_dim_)


@pytest.mark.parametrize("m", [2, 4])
def test_head_dim_rank_holds_rotary_pairs(m):
    """A "head_dim" rank's columns of ``wq`` are D / (2m) dims of the
    first half of every head and their partners in the second half, so
    the rotary embedding of its local q with its block of the
    frequencies is its dims of the whole q's (bit for bit); at 2 ranks
    the rule is forced (6 heads split 2 ways)."""
    cfg = _qwen15_6(get_config(QWEN15))
    mesh_shape = {"data": 1, "model": m}
    params = tlm.init_params(0, cfg, device="cpu")
    specs = sharding.serve_param_specs(cfg, params, _stub(mesh_shape),
                                       force_attn="head_dim")
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    d = cfg.head_dim_
    cos, sin = tlm.cm.rope_angles(torch.arange(5).expand(2, 5), d,
                                  cfg.rope_theta)
    wq = params["layers"][0]["attn"]["wq"]
    full = tlm.cm.apply_rope((x @ wq["w"] + wq["b"]).view(2, 5, 6, d), cos,
                             sin)
    w = d // (2 * m)
    for r in range(m):
        rank = _Rank(mesh_shape, {"model": r})
        lw = sharding.local_shard(wq["w"], specs["layers"][0]["attn"]["wq"]
                                  ["w"], rank)
        lb = sharding.local_shard(wq["b"], specs["layers"][0]["attn"]["wq"]
                                  ["b"], rank)
        tp = flags.TensorParallel(None, m, r, "head_dim", True, True)
        with flags.tensor_parallel(tp):
            c, s = attention._rope_block(cos, sin)
        got = tlm.cm.apply_rope((x @ lw + lb).view(2, 5, 6, d // m), c, s)
        dims = list(range(r * w, (r + 1) * w)) \
            + list(range(d // 2 + r * w, d // 2 + (r + 1) * w))
        assert torch.equal(got, full[..., dims])


@pytest.mark.parametrize("arch,rule", [(QWEN3, None), (QWEN15, "head_dim"),
                                       ("granite-34b", None)])
def test_local_caches_are_the_plan_cache_specs_blocks(arch, rule):
    """Every rank's ``lm.init_caches(..., tp=plan)`` has the shape of its
    block of the whole cache by ``cache_specs(..., plan=plan)``: the kv
    heads it holds ("kv_shared": the one its q heads read, chosen by
    ``sharding.Grouped``) or its dims ("head_dim")."""
    cfg = get_config(arch).reduced()
    if arch == QWEN15:
        cfg = _qwen15_6(get_config(QWEN15))
    mesh_shape = {"data": 1, "model": 4}
    plan = sharding.tp_plan(cfg, _stub(mesh_shape), cached=True,
                            force_attn=rule)
    whole = tlm.init_caches(cfg, 2, 16, device="meta")
    specs = sharding.cache_specs(cfg, _stub(mesh_shape), 2, 16, plan=plan)
    for r in range(4):
        rank = _Rank(mesh_shape, {"data": 0, "model": r})
        local = tlm.init_caches(cfg, 2, 16, device="meta", tp=plan)
        for c, w, spec in zip(local, whole, specs, strict=True):
            block = sharding.local_shard(torch.empty(w["k"].shape), spec["k"],
                                         rank)
            assert tuple(block.shape) == tuple(c["k"].shape), (r, spec)
    if plan.attn == "kv_shared":
        hkv = cfg.n_kv_heads
        heads = [sharding.local_shard(torch.arange(hkv)[None, :, None, None],
                                      specs[0]["k"],
                                      _Rank(mesh_shape, {"data": 0,
                                                         "model": r}))
                 .flatten().tolist() for r in range(4)]
        assert heads == [[r * hkv // 4] for r in range(4)]
    # The paged stores (rows, Hkv, D) under "head_dim": a rank's rows
    # hold its rotary pairs of every kv head's dims.
    hd = dataclasses.replace(plan, attn="head_dim")
    store = sharding.paged_cache_specs(cfg, _stub(mesh_shape), 2, 16,
                                       plan=hd)[0]["k"]
    assert store[:2] == (None, None)
    assert isinstance(store[2], sharding.Segments)
    d = cfg.head_dim_
    for r in range(4):
        block = sharding.local_shard(
            torch.arange(d)[None, None, :].expand(3, cfg.n_kv_heads, d),
            store, _Rank(mesh_shape, {"data": 0, "model": r}))
        w = d // 8
        assert block[0, 0].tolist() == \
            list(range(r * w, (r + 1) * w)) \
            + list(range(d // 2 + r * w, d // 2 + (r + 1) * w))
        assert tuple(block.shape) == (3,) + attention.local_kv(cfg, hd)


# ---------------------------------------------------------------------------
# the children's side
# ---------------------------------------------------------------------------

def _prompts() -> list:
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, p) for p, _ in SERVE_SPEC]


def _decode_prompt() -> np.ndarray:
    return np.random.default_rng(9).integers(0, 256, (DECODE_BATCH, PROMPT))


def head_split(rank, arrays) -> dict:
    from repro_torch import bridge
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import adamw
    from repro_torch.serve import ServeEngine, ServeScheduler

    out = {}
    mesh = mesh_lib.make_serve_mesh(1, 4)
    cfgs = {QWEN3: get_config(QWEN3).reduced(),
            QWEN15: _qwen15_6(get_config(QWEN15))}
    for arch, cfg in cfgs.items():
        params = bridge.from_reference(arrays[arch], cfg, device="cpu")
        for paged in (False, True, "spec"):
            kw = SERVE if not paged else dict(
                SERVE, paged=True, page_size=8,
                speculate=2 if paged == "spec" else None)
            if paged == "spec" and arch != QWEN15:
                continue
            sched = ServeScheduler(cfg, params,
                                   acc=StaticCoreChunk(cores=2),
                                   mesh=mesh, device="cpu", **kw)
            sched.warmup()
            rids = [sched.submit(p, n) for p, (_, n) in
                    zip(_prompts(), SERVE_SPEC, strict=True)]
            outs = sched.run_until_idle()
            out[arch, paged] = {
                "tokens": [outs[r] for r in rids], "attn": sched.tp.attn,
                "kv": [(c["k"].shape[1], c["k"].shape[-1])
                       for c in sched.pool.caches],
                "verifies": sched.spec_stats()["verifies"]}
    # The lock-step decode of the "head_dim" qwen1.5, one token a step.
    cfg = cfgs[QWEN15]
    eng = ServeEngine(cfg, bridge.from_reference(arrays[QWEN15], cfg,
                                                 device="cpu"),
                      batch=DECODE_BATCH, max_len=DECODE_MAX, mesh=mesh,
                      device="cpu")
    prompt = torch.from_numpy(_decode_prompt())
    logits = []
    for t in range(PROMPT + NEW):
        tok = prompt[:, t:t + 1] if t < PROMPT \
            else torch.from_numpy(logits[-1]).argmax(-1)[:, None]
        logits.append(eng.decode(tok)[:, -1].numpy())
    out["decode"] = {"logits": logits, "attn": eng._lockstep()[1].attn,
                     "rows": tuple(eng.caches[0]["k"].shape)}
    out["paged_decode"] = _paged_decode(cfg, arrays[QWEN15], mesh)
    out["plan22"] = sharding.tp_plan(
        cfgs[QWEN3], mesh_lib.make_serve_mesh(2, 2), cached=True).attn
    tmesh = mesh_lib.make_mesh((1, 4), ("data", "model"))
    out["train"] = train_run(rank, tmesh, cfgs[QWEN3], arrays[QWEN3],
                             adamw.AdamWConfig(lr=LR, eps=EPS))
    return out


def _paged_decode(cfg, arrays, mesh) -> dict:
    """The lock-step decode of ``_decode_prompt`` through a "head_dim"
    paged pool's stores: both lanes one token a step, written through
    their page tables, every step's last logits."""
    from repro_torch import bridge
    from repro_torch.core.acc import StaticCoreChunk
    from repro_torch.serve import ServeScheduler

    sched = ServeScheduler(cfg, bridge.from_reference(arrays, cfg,
                                                      device="cpu"),
                           n_slots=DECODE_BATCH, max_len=DECODE_MAX,
                           acc=StaticCoreChunk(cores=2), paged=True,
                           page_size=8, dispatch_depth=1, mesh=mesh,
                           device="cpu")
    pool = sched.pool
    slots = [pool.acquire(i) for i in range(DECODE_BATCH)]
    for s in slots:
        pool.ensure_writable(s, 0, PROMPT + NEW)
    table = pool.page_table_array()[slots]
    prompt = torch.from_numpy(_decode_prompt())
    logits = []
    with flags.tensor_parallel(sched.tp):
        for t in range(PROMPT + NEW):
            tok = prompt[:, t:t + 1] if t < PROMPT \
                else torch.from_numpy(logits[-1]).argmax(-1)[:, None]
            out, _ = tlm.forward_cached(sched.params, tok, pool.caches, t,
                                        cfg, page_table=table, page_size=8)
            logits.append(out[:, -1].numpy())
    return {"logits": logits, "store": tuple(pool.caches[0]["k"].shape)}


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def _jax_tokens(jcfg, jparams) -> list:
    from repro.core.acc import StaticCoreChunk as JStatic
    from repro.serve import ServeScheduler as JScheduler

    sched = JScheduler(jcfg, jparams, n_slots=2, max_len=SERVE["max_len"],
                       acc=JStatic(cores=2),
                       dispatch_depth=SERVE["dispatch_depth"])
    sched.warmup()
    rids = [sched.submit(p, n) for p, (_, n) in
            zip(_prompts(), SERVE_SPEC, strict=True)]
    outs = sched.run_until_idle()
    return [outs[r] for r in rids]


def _jax_decode(jcfg, jparams) -> tuple[list, list]:
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.serve import engine as jengine

    step = jax.jit(jengine.make_decode_step(jcfg))
    caches = jlm.init_caches(jcfg, DECODE_BATCH, DECODE_MAX)
    prompt = _decode_prompt()
    logits, tokens = [], []
    for t in range(PROMPT + NEW):
        if t < PROMPT:
            tok = jnp.asarray(prompt[:, t:t + 1])
        else:
            tok = jnp.argmax(jnp.asarray(logits[-1]), -1)[:, None]
            tokens.append(np.asarray(tok[:, 0]).tolist())
        out, caches = step(jparams, caches, tok, t)
        logits.append(np.asarray(out[:, -1], np.float32))
    return logits, tokens


# The dry run's qwen1.5-32b decode_32k on the single-pod mesh, no lever.
DRY = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen1.5-32b", "decode_32k", False,
                          out_dir=sys.argv[1], verbose=False)
    print(json.dumps(rec, default=str))
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import lm as jlm
    from repro.optim import AdamWConfig as JAdamWConfig

    tmp = tmp_path_factory.mktemp("head-split")
    dry = subprocess.Popen(
        [sys.executable, "-c", DRY, str(tmp / "dry")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jq = _jax_init(QWEN3)
    jh_cfg = _qwen15_6(jax_config(QWEN15))
    jh = jlm.init_params(jax.random.PRNGKey(0), jh_cfg)
    arrays = {QWEN3: jq[2], QWEN15: jax.tree.map(np.asarray, jh)}
    res = spawn(tmp, "test_torch_head_split:head_split", 4, arrays)
    ref = {"tokens": {QWEN3: _jax_tokens(jq[0], jq[1]),
                      QWEN15: _jax_tokens(jh_cfg, jh)},
           "decode": _jax_decode(jh_cfg, jh),
           "train": (jq[0], _jax_train(jq[0], jq[1],
                                       JAdamWConfig(lr=LR, eps=EPS)))}
    out, err = dry.communicate(timeout=300)
    assert dry.returncode == 0, err[-4000:]
    return res, ref, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("paged", [False, True])
def test_kv_shared_serving_matches_jax(run, paged):
    """The reduced qwen3 on (1, 4) is "kv_shared" (on (2, 2) "split"):
    every rank's tokens, through either pool, are the JAX package's
    single-device scheduler's; a rank's cache holds one kv head."""
    res, ref, _ = run
    for r in res:
        got = res[r][QWEN3, paged]
        assert got["attn"] == "kv_shared"
        assert got["tokens"] == ref["tokens"][QWEN3]
        assert set(got["kv"]) == {(1, 16)}
    assert res[0]["plan22"] == "split"


def test_kv_shared_sharded_step_matches_jax(run):
    """The reduced qwen3's sharded step on (1, 4) ("kv_shared": the K/V
    columns gathered over 'model', their gradient reduce-scattered):
    two steps within 2e-5 of the JAX step, the loss within 1e-5."""
    res, ref, _ = run
    jcfg, jref = ref["train"]
    check_step(get_config(QWEN3).reduced(), jcfg, {"data": 1, "model": 4},
               {r: res[r]["train"] for r in res}, jref)


def _decode_matches(dec: dict, ref: tuple) -> None:
    jlogits, jtokens = ref
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(dec["logits"], jlogits, strict=True))
    assert diff <= 1e-5, diff
    toks = [np.argmax(lg, -1).tolist() for lg in dec["logits"][PROMPT - 1:-1]]
    assert toks == jtokens


def test_head_dim_serving_matches_jax(run):
    """The 6-head qwen1.5 on (1, 4) is "head_dim": the contiguous pool's
    tokens are the JAX scheduler's on every rank, every lock-step decode
    step's logits within 1e-5 of the JAX decode step's with the same
    greedy tokens, and a rank's cache rows hold 4 of each head's 16
    dims."""
    res, ref, _ = run
    for r in res:
        got = res[r][QWEN15, False]
        assert got["attn"] == "head_dim"
        assert got["tokens"] == ref["tokens"][QWEN15]
        assert set(got["kv"]) == {(6, 4)}
        dec = res[r]["decode"]
        assert dec["attn"] == "head_dim" and dec["rows"][1:] == (6, 32, 4)
        _decode_matches(dec, ref["decode"])


def test_paged_pool_serves_head_dim(run):
    """The paged pool under "head_dim" on (1, 4): a rank's page stores
    hold 4 of each of the 6 kv heads' 16 dims; its tokens, and with
    speculation (verifies drained) too, are the JAX scheduler's on every
    rank; the lock-step decode through the paged stores gives every
    step's logits within 1e-5 of the JAX decode step's and the same
    greedy tokens."""
    res, ref, _ = run
    for r in res:
        for mode in (True, "spec"):
            got = res[r][QWEN15, mode]
            assert got["attn"] == "head_dim"
            assert got["tokens"] == ref["tokens"][QWEN15], mode
            assert set(got["kv"]) == {(6, 4)}
        assert res[r][QWEN15, "spec"]["verifies"] > 0
        dec = res[r]["paged_decode"]
        assert dec["store"][1:] == (6, 4)
        _decode_matches(dec, ref["decode"])


def test_dry_run_qwen15_decode_fits_without_cache_seq_model(run):
    """qwen1.5-32b ``decode_32k`` on (16, 16): "head_dim" splits its 40
    kv heads' 128 dims 16 ways, so rank 0's cache is 64 layers × K and V
    × 8 rows × 40 heads × 32768 × 8 dims × 2 bytes = 21.5 GB, and the
    step fits the card with the sequence whole."""
    *_, rec = run
    assert rec["status"] == "ok", rec.get("error")
    assert rec["attention"] == "head_dim" and rec["cache_seq"] is None
    assert rec["fits"] is True
    cache = 64 * 2 * 8 * 40 * 32768 * 8 * 2
    assert cache <= rec["argument_bytes"] <= 80e9
    assert rec["collective_detail"]["counts"]["all-reduce"] > 0
