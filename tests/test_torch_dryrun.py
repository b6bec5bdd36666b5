"""The production dry run (``launch/dryrun.py``) on the CPU: a count on
meta tensors as rank 0 of a fake process group of 512 ranks, held
against the reference's specs and plans.

Every case that joins the fake group runs in a subprocess (a process
joins one default group for good); the cells' subprocesses run side by
side.  Train cells run at ``accum`` 2 here (a count's flops and bytes do
not depend on it; the plans' ``accum`` is held against the reference's
by the plan-only sweep), so the file stays well under its 90 s.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import shape_applicable as jshape_applicable
from repro.data import input_specs as jinput_specs
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, get_shape
from repro_torch.data import input_specs
from repro_torch.launch import sharding
from repro_torch.models import lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")
TIMEOUT_S = 240

# (group, arch, shape, multi_pod, run_cell keywords); a group is one
# subprocess.
CELLS = [
    ("a", "qwen3-0.6b", "train_4k", False, {"accum": 2}),
    ("b", "mixtral-8x22b", "train_4k", False, {"accum": 2}),
    ("c", "mixtral-8x22b", "train_4k", False,
     {"accum": 2, "moe_local": True, "tag": "local"}),
    ("d", "grok-1-314b", "decode_32k", True, {}),
    ("d", "qwen3-0.6b", "long_500k", False, {}),
    # The Mamba2 blocks split over 'model' (counted for real: ~50 s, a
    # group of its own).
    ("e", "zamba2-1.2b", "train_4k", False, {"accum": 2}),
    # Caches with the sequence on a mesh axis: 'data' (batch 1), 'model'.
    ("f", "h2o-danube-1.8b", "long_500k", False, {}),
    ("f", "qwen1.5-32b", "decode_32k", False,
     {"cache_seq_model": True, "tag": "seqmodel"}),
]

SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.launch import dryrun, mesh as mesh_lib
    cells, out = json.loads(sys.argv[1]), sys.argv[2]
    recs = {}
    for arch, shape, multi, kw in cells:
        rec = dryrun.run_cell(arch, shape, multi, out_dir=out, verbose=False,
                              **kw)
        recs[rec["cell"]] = rec
    meshes = {}
    for multi in (False, True):
        m, name, chips = dryrun._mesh(multi)
        meshes[name] = {"shape": m.shape, "chips": chips, "size": m.size,
                        "coords": [m.coord(a) for a in m.axis_names],
                        "groups": {str(a): torch.distributed.get_world_size(g)
                                   for a, g in m.groups.items()},
                        "agree": m.agree(lambda: 7)}
    print(json.dumps({"cells": recs, "meshes": meshes}, default=str))
""")

# The FSDP-only count: rank 0 of a (16, 1) mesh against the whole step.
FSDP_ONLY = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_config, get_shape
    from repro_torch.data import input_specs
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    mesh_lib.init_fake(512)
    mesh = mesh_lib.make_mesh((16, 1), ("data", "model"))
    rec = dryrun.run_cell("qwen3-0.6b", "train_4k", False, out_dir=sys.argv[1],
                          accum=2, mesh=mesh, verbose=False)
    cfg, shape = get_config("qwen3-0.6b"), get_shape("train_4k")
    params = lm.init_params(0, cfg, device="meta", dtype=torch.float32)
    opt = adamw.init_state(params, adamw.AdamWConfig())
    step = make_train_step(cfg, adamw.AdamWConfig(), accum=2)
    with build.plain_on_meta():
        whole = roofline.count_costs(step, params, opt,
                                     input_specs(cfg, shape))
    print(json.dumps({"rec": rec, "whole": whole.tensor_flops}, default=str))
""")


def _popen(code: str, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code, *args], env=ENV,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group of cells, the FSDP-only count and both packages'
    plan-only sweeps, run side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    groups = sorted({c[0] for c in CELLS})
    procs = {g: _popen(SCRIPT, json.dumps(
        [[a, s, m, kw] for gg, a, s, m, kw in CELLS if gg == g]),
        str(tmp / "cells")) for g in groups}
    procs["fsdp"] = _popen(FSDP_ONLY, str(tmp / "fsdp"))
    plans = {}
    for pkg in ("repro", "repro_torch"):
        plans[pkg] = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.launch.dryrun", "--all",
             "--plan-only", "--out", str(tmp / pkg)], env=ENV, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {g: _result(p) for g, p in procs.items()}
    for pkg, p in plans.items():
        _, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err[-4000:]
    cells = {}
    meshes = None
    for g in groups:
        cells.update(out[g]["cells"])
        meshes = out[g]["meshes"]
    return {"cells": cells, "meshes": meshes, "fsdp": out["fsdp"],
            "plans": {pkg: tmp / pkg for pkg in plans}}


def _cell(runs, arch, shape, mesh, tag=""):
    return runs["cells"][f"{arch}__{shape}__{mesh}" + (f"__{tag}" if tag
                                                       else "")]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCH_NAMES))
def test_input_specs_match_the_reference(arch, shape):
    """Meta tensors of the reference's ``ShapeDtypeStruct`` shapes and
    dtypes, key for key."""
    got = input_specs(get_config(arch), get_shape(shape))
    want = jinput_specs(jax_config(arch), JSHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k


def _arg_bytes(arch: str, shape_name: str, mesh_shape: dict) -> int:
    """The bytes of rank 0's blocks of a train cell's parameters (the
    training specs), AdamW moments (``opt_specs``, f32) and step, and its
    rows of the batch (``batch_specs``)."""
    class Stub:
        shape = dict(mesh_shape)

    cfg, shape = get_config(arch), get_shape(shape_name)
    params = lm.init_params(0, cfg, device="meta", dtype=torch.float32)
    pspec = sharding.train_param_specs(cfg, params, Stub())
    ospec = sharding.opt_specs(pspec)

    def local(shape_, spec) -> int:
        n = int(np.prod(shape_))
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n //= mesh_shape[a]
        return n

    from repro_torch import tree
    total = 0
    for (_, leaf), spec in zip(tree.with_paths(params),
                               sharding.spec_leaves(pspec), strict=True):
        total += local(leaf.shape, spec) * 4
    for name in ("m", "v"):
        for (_, leaf), spec in zip(tree.with_paths(params),
                                   sharding.spec_leaves(ospec[name]),
                                   strict=True):
            total += local(leaf.shape, spec) * 4
    total += 4                                       # the step, int32
    bspec = sharding.batch_specs(cfg, Stub(), shape.global_batch)
    for k, t in input_specs(cfg, shape).items():
        total += local(t.shape, bspec[k]) * t.element_size()
    return total


@pytest.mark.parametrize("arch,tag", [("qwen3-0.6b", ""),
                                      ("mixtral-8x22b", ""),
                                      ("mixtral-8x22b", "local")])
def test_train_cells_count_and_their_arguments_are_the_blocks(runs, arch,
                                                              tag):
    """A ported train cell is ``ok`` with positive flops, bytes and
    collective bytes; its argument bytes are the sum of rank 0's blocks
    by the training specs; their q heads divide 'model' 16 and their 8
    kv heads do not, so each kv head is shared by the two ranks whose q
    heads read it ("kv_shared")."""
    rec = _cell(runs, arch, "train_4k", "single", tag)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["accum"] == 2
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0
    assert rec["collective_detail"]["counts"]["all-gather"] > 0
    assert rec["peak_memory_bytes"] > 0 and isinstance(rec["fits"], bool)
    assert rec["attention"] == "kv_shared"
    assert rec["argument_bytes"] == _arg_bytes(arch, "train_4k",
                                               {"data": 16, "model": 16})


def test_group_local_dispatch_moves_fewer_bytes_than_global(runs):
    """Under ``--moe-local`` each rank places its own tokens: no count
    of the other ranks is gathered and its expert buffers hold its own
    capacity, so it moves fewer bytes than the global dispatch."""
    glob = _cell(runs, "mixtral-8x22b", "train_4k", "single")
    local = _cell(runs, "mixtral-8x22b", "train_4k", "single", "local")
    assert local["bytes_per_device"] < glob["bytes_per_device"]
    assert local["argument_bytes"] == glob["argument_bytes"]


def test_decode_cell_counts_over_fsdp_weights_on_two_pods(runs):
    """grok-1-314b's decode step on (2, 16, 16): ``ok``, the FSDP
    gathers and the tensor-parallel sums counted, kernels 1 and 2 by
    their own work."""
    rec = _cell(runs, "grok-1-314b", "decode_32k", "multi")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 512
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0
    counts = rec["collective_detail"]["counts"]
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    assert set(rec["kernels"]) == {"rmsnorm", "flash_attention"}


def test_unported_and_inapplicable_cells(runs):
    """No cell is ``not_ported`` any more: zamba2's Mamba2 blocks split
    over 'model' 16 (``ok``, the Mamba2 heads split, the shared attention
    too), and danube's ``long_500k`` decode at batch 1 holds its ring's
    rows over 'data' (``ok``, ``cache_seq`` 'data', kernel 2 counted); a
    full-attention arch at ``long_500k`` is ``skipped`` with the
    reference's reason."""
    rec = _cell(runs, "zamba2-1.2b", "train_4k", "single")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["attention"] == "split" and rec["tensor_flops"] > 0
    rec = _cell(runs, "h2o-danube-1.8b", "long_500k", "single")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cache_seq"] == "data" and "flash_attention" in rec["kernels"]
    assert rec["collective_detail"]["counts"]["all-gather"] > 0
    rec = _cell(runs, "qwen3-0.6b", "long_500k", "single")
    ok, reason = jshape_applicable(jax_config("qwen3-0.6b"),
                                   JSHAPES["long_500k"])
    assert not ok and rec == {"cell": "qwen3-0.6b__long_500k__single",
                              "status": "skipped", "reason": reason}


def test_cache_seq_model_fits_qwen15_decode(runs):
    """``--cache-seq-model``: qwen1.5-32b's decode_32k cache holds its
    sequence over 'model' (its 40 kv heads do not split over 16), the
    attention blocks whole, and rank 0's step fits the card: the cache a
    rank holds is 64 layers x K and V x 8 rows x 40 heads x 2048 x 128 x
    2 bytes = 21.5 GB."""
    rec = _cell(runs, "qwen1.5-32b", "decode_32k", "single", "seqmodel")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cache_seq"] == "model" and rec["attention"] == "whole"
    assert rec["fits"] is True
    cache = 64 * 2 * 8 * 40 * (32768 // 16) * 128 * 2
    assert cache <= rec["argument_bytes"] <= 80e9


def test_production_meshes_on_the_fake_group(runs):
    """(16, 16) over 256 ranks and (2, 16, 16) over 512, rank 0 at the
    origin, each axis group of its extent and the batch axes' group of
    32; a decision agreed on the fake group is rank 0's."""
    single, multi = runs["meshes"]["single"], runs["meshes"]["multi"]
    assert single["shape"] == {"data": 16, "model": 16}
    assert multi["shape"] == {"pod": 2, "data": 16, "model": 16}
    assert (single["chips"], single["size"]) == (256, 256)
    assert (multi["chips"], multi["size"]) == (512, 512)
    assert single["coords"] == [0, 0] and multi["coords"] == [0, 0, 0]
    assert single["groups"] == {"data": 16, "model": 16}
    assert multi["groups"] == {"pod": 2, "data": 16, "model": 16,
                               "('pod', 'data')": 32}
    assert single["agree"] == multi["agree"] == 7


def test_fsdp_only_count_is_a_sixteenth_of_the_whole_step(runs):
    """qwen3-0.6b ``train_4k`` on a (16, 1) mesh (FSDP only): rank 0's
    tensor-core flops times 16 equal the unsharded step's, counted on
    meta tensors the same way, within 1%."""
    rec, whole = runs["fsdp"]["rec"], runs["fsdp"]["whole"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 16
    assert abs(16 * rec["tensor_flops"] - whole) <= 0.01 * whole


def test_plan_only_accum_is_the_references(runs):
    """``--all --plan-only``: the same train cells planned, each with the
    reference's ``accum``; every other cell skipped."""
    def read(path):
        out = {}
        for name in os.listdir(path):
            with open(os.path.join(path, name)) as f:
                rec = json.load(f)
            out[rec["cell"]] = (rec["status"], rec.get("accum"))
        return out

    ref, port = read(runs["plans"]["repro"]), read(runs["plans"]["repro_torch"])
    assert ref == port
    planned = [v for v in port.values() if v[0] == "planned"]
    assert len(planned) == 2 * len(ARCH_NAMES)
    assert all(a in (8, 16) for _, a in planned)
