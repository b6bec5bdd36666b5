"""Decode caches with the sequence on a mesh axis, held against the JAX
package's decode step on one device, and kernel 2's softmax statistics.

The spawned scenario (``test_torch_fsdp.spawn``: four gloo ranks, the
children importing nothing of JAX) drives ``ServeEngine``'s lock-step
path one token a step, the prompt included, and records every step's
logits:

* the reduced h2o-danube-1.8b (window 16: a ring of 16 rows) at batch 1
  on (2, 1) and (4, 1): the batch does not split over 'data', so the
  ring's rows lie there, 8 or 4 a rank, as the reference's
  ``cache_specs`` put them; 40 positions wrap the ring twice, and at
  the first steps the last ranks hold no valid row;
* the reduced qwen3-0.6b at batch 2 on (1, 2) with ``cache_seq_model``:
  the rows on 'model', the attention blocks whole, the feed-forward and
  the vocabulary split.

Every step's logits within 1e-5 of the JAX decode step's
(``jax.jit(make_decode_step)``, one token a step from the same weights)
and the greedy tokens identical.  Without a spawn: ``merge_blocks`` and
the plain version's log-sum-exp, and the dry run's train cell with
``--seq-shard`` and ``--moe-ff2d``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models.attention import merge_blocks

from test_torch_fsdp import spawn

DANUBE, QWEN3 = "h2o-danube-1.8b", "qwen3-0.6b"
# (arch, mesh (data, model), batch, max_len, cache_seq_model)
RUNS = [(DANUBE, (2, 1), 1, 64, False), (DANUBE, (4, 1), 1, 64, False),
        (QWEN3, (1, 2), 2, 32, True)]
PROMPT, NEW = 10, {DANUBE: 30, QWEN3: 20}
TOL = 1e-5


def _prompt(arch: str, batch: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, 256, (batch, PROMPT))


# ---------------------------------------------------------------------------
# the children's side
# ---------------------------------------------------------------------------

def seq_decode(rank, arrays):
    from repro_torch import bridge
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import ServeEngine

    out = {}
    for arch, shape, batch, max_len, seq_model in RUNS:
        mesh = make_serve_mesh(*shape)
        if not mesh.contains:
            continue
        cfg = get_config(arch).reduced()
        params = bridge.from_reference(arrays[arch], cfg, device="cpu")
        eng = ServeEngine(cfg, params, batch=batch, max_len=max_len,
                          mesh=mesh, cache_seq_model=seq_model,
                          device="cpu")
        _, tp, _ = eng._lockstep()
        seq = eng.seq
        rows = [c["k"].shape[2] for c in eng.caches if c is not None]
        logits, tokens = [], []
        for t in range(PROMPT):
            step = torch.from_numpy(_prompt(arch, batch)[:, t:t + 1])
            logits.append(eng.decode(step)[:, -1].numpy())
        for _ in range(NEW[arch]):
            tok = torch.from_numpy(logits[-1]).argmax(-1)[:, None]
            tokens.append(tok[:, 0].tolist())
            logits.append(eng.decode(tok)[:, -1].numpy())
        out[arch, shape] = {"logits": logits, "tokens": tokens,
                            "seq": (seq.size, seq.index), "rows": rows,
                            "attn_split": tp.attn != "whole"}
    return out


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def _jax_rollout(arch, jcfg, jparams, batch, max_len):
    """Every step's logits of the reference's decode step fed one token
    at a time, the prompt then its own greedy tokens."""
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
    from repro.serve import engine as jengine

    step = jax.jit(jengine.make_decode_step(jcfg))
    caches = jlm.init_caches(jcfg, batch, max_len)
    logits, tokens = [], []
    prompt = _prompt(arch, batch)
    for t in range(PROMPT + NEW[arch]):
        if t < PROMPT:
            tok = jnp.asarray(prompt[:, t:t + 1])
        else:
            tok = jnp.argmax(jnp.asarray(logits[-1]), -1)[:, None]
            tokens.append(np.asarray(tok[:, 0]).tolist())
        out, caches = step(jparams, caches, tok, t)
        logits.append(np.asarray(out[:, -1], np.float32))
    return logits, tokens


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax

    from repro.configs import get_config as jax_config
    from repro.models import lm as jlm

    ref, arrays = {}, {}
    for arch in (DANUBE, QWEN3):
        jcfg = jax_config(arch).reduced()
        ref[arch] = (jcfg, jlm.init_params(jax.random.PRNGKey(0), jcfg))
        arrays[arch] = jax.tree.map(np.asarray, ref[arch][1])
    res = spawn(tmp_path_factory.mktemp("seq-cache"),
                "test_torch_seq_cache:seq_decode", 4, arrays)
    rollouts = {(arch, batch): _jax_rollout(arch, *ref[arch], batch, max_len)
                for arch, _, batch, max_len, _ in RUNS}
    return res, rollouts


@pytest.mark.parametrize("arch,shape,batch,max_len,seq_model", RUNS)
def test_sequence_split_decode_matches_the_jax_decode_step(
        run, arch, shape, batch, max_len, seq_model):
    """Every rank's logits at every step within 1e-5 of the JAX decode
    step's, the greedy tokens identical; each rank holds its block of
    the ring's (or the cache's) rows."""
    res, rollouts = run
    jlogits, jtokens = rollouts[arch, batch]
    cfg = get_config(arch).reduced()
    axis = 1 if seq_model else 0
    n = shape[axis]
    total = min(cfg.attn_window or max_len, max_len)
    for r in range(shape[0] * shape[1]):
        got = res[r][arch, shape]
        assert got["tokens"] == jtokens
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(got["logits"], jlogits, strict=True))
        assert diff <= TOL, diff
        assert got["seq"][0] == n
        assert set(got["rows"]) == {total // n}
        assert got["attn_split"] == (not seq_model and cfg.n_kv_heads
                                     % shape[1] == 0)
    assert sorted(res[r][arch, shape]["seq"][1]
                  for r in range(shape[0] * shape[1])) == sorted(
        list(range(n)) * (shape[0] * shape[1] // n))


# ---------------------------------------------------------------------------
# no spawn: the merge and the statistics
# ---------------------------------------------------------------------------

def _qkv(b, hq, hkv, s, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype) for shape in
            ((b, hq, 1, d), (b, hkv, s, d), (b, hkv, s, d))]


# The merge's tolerance: f32 1e-6; bf16 2^-7 of the output's largest
# magnitude, since each block's output, the merged one and the whole
# cache's are rounded to bf16 once each (half an ulp, 2^-9 relative,
# each).
MERGE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [2, 4])
def test_merged_blocks_equal_attention_over_the_whole_cache(blocks, dtype):
    """A cache of 64 rows cut into 2 or 4 blocks, each lane's length
    clamped to each block (a lane of length 5 leaves the later blocks
    empty), each block through kernel 2's plain version with its
    statistics, merged: the output of attention over the whole cache
    (``MERGE_TOL``), and the whole cache's log-sum-exp within 1e-5."""
    q, k, v = _qkv(3, 8, 2, 64, 16, dtype)
    lens = torch.tensor([64, 37, 5], dtype=torch.int32)
    want, want_lse = kfa.flash_attention(q, k, v, lens, return_lse=True)
    blk = 64 // blocks
    outs, lses = [], []
    for i in range(blocks):
        local = (lens - i * blk).clamp(0, blk).to(torch.int32)
        o, lse = kfa.flash_attention(
            q, k[:, :, i * blk:(i + 1) * blk].contiguous(),
            v[:, :, i * blk:(i + 1) * blk].contiguous(), local,
            return_lse=True)
        outs.append(o)
        lses.append(lse)
    assert torch.isinf(lses[-1][2]).all() and not outs[-1][2].any()
    got, got_lse = merge_blocks(torch.stack(outs), torch.stack(lses))
    assert got.dtype == dtype
    scale = 1.0 if dtype == torch.float32 else float(want.abs().max())
    assert float((got.float() - want.float()).abs().max()) \
        <= MERGE_TOL[dtype] * scale
    assert float((got_lse - want_lse).abs().max()) <= 1e-5


def test_plain_log_sum_exp_of_the_visible_scores():
    """The plain version's statistic is the log-sum-exp of each row's
    scaled visible scores (causal, windowed, per-lane lengths), -inf with
    its output 0 for a row that sees no key; the output is the one
    without statistics."""
    q, k, v = _qkv(2, 4, 2, 24, 8, torch.float32, seed=1)
    q = torch.cat([q] * 3, dim=2)                        # 3 query rows
    lens = torch.tensor([24, 2], dtype=torch.int32)
    out, lse = kfa.attention_ref(q, k, v, lens, window=2, return_lse=True)
    assert torch.equal(out, kfa.attention_ref(q, k, v, lens, window=2))
    scale = 1 / math.sqrt(8)
    for b in range(2):
        n = int(lens[b])
        for h in range(4):
            for r in range(3):
                pos = n - 3 + r
                keys = [j for j in range(n) if j <= pos and pos - j < 2]
                if not keys:
                    assert lse[b, h, r] == float("-inf")
                    assert not out[b, h, r].any()
                    continue
                s = torch.stack([q[b, h, r] @ k[b, h // 2, j] * scale
                                 for j in keys])
                assert abs(float(torch.logsumexp(s, 0) - lse[b, h, r])) \
                    <= 1e-6
    # The merge of one block is the block itself.
    o1, l1 = merge_blocks(out[None], lse[None])
    assert torch.equal(o1, out) and torch.equal(l1, lse)


def test_kernel_two_stores_its_statistics_in_every_schedule():
    """The C entry takes the statistics' pointer and passes it to the
    shared launch, and each of the three kernels that writes a row's
    output stores the row's log-sum-exp beside it (the split path's
    merge, the 16-row loop and the wgmma tile); the wrapper counts
    those calls apart."""
    import pathlib

    csrc = pathlib.Path(kfa.__file__).parent / "csrc"
    cu = (csrc / "flash_attention.cu").read_text()
    cuh = (csrc / "flash_attention.cuh").read_text()
    assert "void* out, void* lse, void* scratch" in cu
    assert cu.count("static_cast<float*>(lse)") == 2
    assert cuh.count("row_lse<") == 3
    assert "cudaStream_t s, float* lse = nullptr" in cuh
    assert kfa.lse_launches.name == "flash_attention_lse"


# The cell cut to 8 layers (the count's time is its layers' ops).
_BOTH_LEVERS = """
import dataclasses, json, sys
from repro_torch.launch import dryrun
full = dryrun.get_config
dryrun.get_config = lambda a: dataclasses.replace(full(a), n_layers=8)
rec = dryrun.run_cell("mixtral-8x22b", "train_4k", False, out_dir=sys.argv[1],
                      accum=2, seq_shard=True, moe_ff2d=True, tag="levers",
                      verbose=False)
print(json.dumps(rec, default=str))
"""


def test_dry_run_refuses_the_unported_levers(tmp_path):
    """``--seq-shard`` and ``--moe-ff2d`` no longer raise: a train cell
    (mixtral-8x22b ``train_4k`` on the single-pod mesh) counts with both
    levers (the cell cut to 8 layers), and its JSON records them; the
    weight-stationary experts
    hold their hidden dim over both axes, so no FSDP gather moves them
    and the step gathers its dispatch buffers over 'data' instead."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _BOTH_LEVERS, str(tmp_path)], cwd=root,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["seq_shard"] is True and rec["moe_ff2d"] is True
    assert rec["attention"] == "kv_shared"
    counts = rec["collective_detail"]["counts"]
    assert counts["reduce-scatter"] > 0 and counts["all-gather"] > 0
    with open(tmp_path / "mixtral-8x22b__train_4k__single__levers.json") as f:
        assert json.load(f)["moe_ff2d"] is True
