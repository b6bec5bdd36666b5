"""The production dry run: every (arch × shape) cell counted on the
production meshes, one rank's share of it (the counterpart of
``repro.launch.dryrun``, flag for flag).

The reference forces 512 host devices, lowers and compiles each cell's
step on the (16, 16) or (2, 16, 16) mesh and reads XLA's cost and memory
analysis.  The port has no compiler to ask: it joins a ``"fake"`` process
group of 512 ranks as rank 0 (``launch/mesh.init_fake``, whose
collectives move nothing), builds rank 0's blocks of the parameters, the
optimizer state, the batch and the caches on the meta device (no
storage: ``lm.init_params(device="meta")``, ``data.input_specs``, the
specs of ``launch/sharding``), and runs the cell's step once, eagerly,
under ``analysis/roofline.count_costs`` with the kernel wrappers taking
their plain versions on meta tensors (``kernels/build.plain_on_meta``):

* a train cell runs one ``train/sharded.make_sharded_train_step`` with
  the acc plan's ``accum`` (``train/autotune.choose_plan`` over a
  ``MeshExecutor`` of the mesh), with ``--seq-shard`` (Megatron-SP: the
  residual's sequence over 'model' between blocks) and ``--moe-ff2d``
  (the experts' hidden dim over ('data', 'model'), never gathered) as
  the step's levers; prefill and decode cells ignore both, as the
  reference's do;
* a prefill cell one ``serve/engine.make_prefill_step`` over FSDP
  weights; a decode cell one ``make_decode_step`` at the cache's last
  position (``--serve-no-fsdp``: the weights without their 'data'
  split).

Each cell writes one JSON: ``RooflineReport.to_dict()`` (flops, bytes
and the collectives' wire bytes of rank 0, over the H100's rates),
``status``, ``accum``, ``seconds``, ``tensor_flops`` (the products on
the tensor cores, of ``flops_per_device``), ``argument_bytes`` (the blocks
passed in), ``peak_memory_bytes`` (the most bytes of tensors the step
made and held at once, counted storage by storage) and ``fits``
(arguments plus peak within the H100's 80 GB), ``attention``: the
self-attention blocks' rule over 'model' (``sharding.attention_rule``:
"split" where the q and kv heads both divide it, "kv_shared" where the
q heads do and each rank reads one kv head, "head_dim" on a decode
cell whose heads do not divide but whose rotary pairs do, else "whole":
every model rank runs the block whole, 'data' still splitting its
leaves; None for an arch with no self-attention), ``cache_seq``: the
mesh axis a decode cell's K/V caches hold their sequence on (None,
'data' when the batch does not split over the batch axes, 'model' under
``--cache-seq-model``), and ``seq_shard`` / ``moe_ff2d``: whether the
cell's step ran those levers.  It is a count made on meta tensors, not
a measurement.

Every block kind splits over 'model' by its own flag of
``sharding.tp_plan`` or runs whole; a decode cell's caches are rank 0's
blocks by ``cache_specs`` (recurrent states in the local layout too),
and a sequence on a mesh axis runs the sequence-split decode
(``models/attention.py``).

A cell's status: ``skipped`` (the reference's ``shape_applicable``
reason, or a plan-only run's non-train cell), ``planned``
(``--plan-only``), ``ok`` or ``error``; only ``error`` fails the run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single --out /tmp/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from .. import tree
from ..analysis import roofline
from ..configs import ARCH_NAMES, SHAPES, get_config, get_shape, \
    shape_applicable
from ..core.acc import AdaptiveCoreChunk
from ..core.adaptive import adaptive
from ..core.executor import MeshExecutor
from ..core.hardware import H100_MEMORY_BYTES
from ..data import input_specs
from ..kernels import build
from ..models import flags, lm
from ..optim import adamw
from ..serve import engine as serve_engine
from ..train import autotune, sharded
from . import mesh as mesh_lib
from . import sharding

DEFAULT_OUT = "runs/dryrun"
WORLD = 512
_meshes: dict[bool, mesh_lib.Mesh] = {}


def _mesh(multi_pod: bool):
    """(the production mesh, its name, its chips), made once per process
    on the fake group."""
    mesh_lib.init_fake(WORLD)
    if multi_pod not in _meshes:
        _meshes[multi_pod] = mesh_lib.make_production_mesh(
            multi_pod=multi_pod)
    return _meshes[multi_pod], ("multi" if multi_pod else "single"), \
        (512 if multi_pod else 256)


def _serve_cfg(cfg):
    # serving: bf16 weights, no optimizer state
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def _long_window(cfg, shape):
    if shape.name == "long_500k" and cfg.long_context_window:
        return cfg.long_context_window
    return cfg.attn_window


def _nbytes(*trees) -> int:
    return sum(t.numel() * t.element_size()
               for tr in trees for t in tree.leaves(tr) if t is not None)


def _count(step, *args) -> roofline.Costs:
    with build.plain_on_meta():
        return roofline.count_costs(step, *args)


def count_train(cfg, shape, mesh, *, accum: int, attn_impl: str,
                remat: bool, moment_dtype: str = "float32",
                accum_dtype: str = "float32", moe_local: bool = False,
                bf16_params: bool = False, seq_shard: bool = False,
                moe_ff2d: bool = False) -> tuple[roofline.Costs, int]:
    """(the count of rank 0's sharded train step, its argument bytes)."""
    if bf16_params:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    opt_cfg = adamw.AdamWConfig(moment_dtype=moment_dtype,
                                master_weights=bf16_params)
    params = lm.init_params(0, cfg, device="meta",
                            dtype=lm.param_dtype(cfg))
    opt = adamw.init_state(params, opt_cfg)
    lp, lo = sharded.shard_train_state(params, opt, mesh, cfg=cfg,
                                       moe_ff2d=moe_ff2d)
    lb = sharded.shard_batch(input_specs(cfg, shape), mesh, accum)
    step = sharded.make_sharded_train_step(
        cfg, opt_cfg, mesh, accum=accum, attn_impl=attn_impl, remat=remat,
        accum_dtype=accum_dtype, seq_shard=seq_shard, moe_ff2d=moe_ff2d)
    # --moe-local: one dispatch group per batch rank, as the reference.
    with flags.moe_dispatch_groups(mesh_lib.n_data_replicas(mesh)
                                   if moe_local else None):
        costs = _count(step, lp, lo, lb)
    return costs, _nbytes(lp, lo, lb)


def _serve_params(cfg, mesh, *, no_fsdp: bool = False,
                  seq_over_model: bool = False, cached: bool = False):
    """(rank 0's blocks of the serving weights, the contexts over them):
    FSDP × TP by the training specs, or tensor parallel only
    (``seq_over_model``: the attention blocks whole; ``cached``: a decode
    cell's plan, whose attention may split its heads' dims)."""
    params = lm.init_params(0, cfg, device="meta")
    if no_fsdp:
        specs = sharding.serve_param_specs(cfg, params, mesh,
                                           seq_over_model=seq_over_model)
        cached = True
    else:
        specs = sharding.train_param_specs(
            cfg, params, mesh, seq_over_model=seq_over_model, cached=cached)
    tp, fsdp = sharded.contexts(cfg, mesh, specs,
                                seq_over_model=seq_over_model, cached=cached)
    return sharding.local_tree(params, specs, mesh), tp, fsdp


def count_prefill(cfg, shape, mesh, *, attn_impl: str
                  ) -> tuple[roofline.Costs, int]:
    cfg = _serve_cfg(cfg)
    lp, tp, fsdp = _serve_params(cfg, mesh)
    lb = sharded.shard_batch(input_specs(cfg, shape), mesh)
    step = serve_engine.make_prefill_step(
        cfg, window=_long_window(cfg, shape), attn_impl=attn_impl)

    @torch.no_grad()
    def run(params, batch):
        with flags.tensor_parallel(tp), flags.fsdp(fsdp):
            return step(params, batch)

    return _count(run, lp, lb), _nbytes(lp, lb)


def _cache_seq(cfg, shape, mesh, cache_seq_model: bool) -> str | None:
    """The mesh axis a decode cell's K/V caches hold their sequence on
    (``sharding.cache_seq_axis`` at the cell's cache length)."""
    window = _long_window(cfg, shape)
    return sharding.cache_seq_axis(
        cfg, mesh, shape.global_batch,
        min(window, shape.seq_len) if window else shape.seq_len,
        seq_over_model=cache_seq_model)


def count_decode(cfg, shape, mesh, *, serve_no_fsdp: bool = False,
                 cache_seq_model: bool = False
                 ) -> tuple[roofline.Costs, int]:
    """(the count of rank 0's decode step at the cache's last position,
    its argument bytes).  The caches are rank 0's blocks by
    ``cache_specs``: kv heads where attention splits, the recurrent
    states' heads or channels where their blocks split, and the K/V
    sequence on 'data' when the batch does not split over the batch axes
    (every batch rank then holds the whole batch) or on 'model' with
    ``cache_seq_model`` (the attention blocks whole)."""
    cfg = _serve_cfg(cfg)
    window = _long_window(cfg, shape)
    axis = _cache_seq(cfg, shape, mesh, cache_seq_model)
    lp, tp, fsdp = _serve_params(cfg, mesh, no_fsdp=serve_no_fsdp,
                                 seq_over_model=axis == "model", cached=True)
    batch = input_specs(cfg, shape)
    if shape.global_batch % mesh_lib.n_data_replicas(mesh):
        # The batch does not split: every batch rank holds all of it (and
        # so no MoE layer places its tokens across them).
        fsdp = dataclasses.replace(fsdp, batch=None, batch_size=1,
                                   batch_index=0)
    else:
        batch = sharded.shard_batch(batch, mesh)
    tokens = batch["tokens"]
    seq = None if axis is None else flags.SeqSplit(
        mesh.groups[axis], mesh.shape[axis], mesh.coord(axis))
    caches = lm.init_caches(cfg, tokens.shape[0], shape.seq_len,
                            window=window, device="meta", tp=tp,
                            seq_blocks=1 if seq is None else seq.size)
    feats = batch.get("frontend_feats")      # the cross_attn layers'
    step = serve_engine.make_decode_step(cfg, window=window, tp=tp, seq=seq)

    @torch.no_grad()
    def run(params, caches_, tokens_, feats_):
        with flags.fsdp(fsdp):
            return step(params, caches_, tokens_, shape.seq_len - 1, feats_)

    return _count(run, lp, caches, tokens, feats), \
        _nbytes(lp, caches, batch)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             out_dir: str, use_acc: bool = True, accum: int | None = None,
             attn_impl: str = "chunked", remat: bool = True,
             moment_dtype: str = "float32", accum_dtype: str = "float32",
             seq_shard: bool = False, cache_seq_model: bool = False,
             moe_local: bool = False, serve_no_fsdp: bool = False,
             bf16_params: bool = False, moe_ff2d: bool = False,
             verbose: bool = True, tag: str = "",
             acc: AdaptiveCoreChunk | None = None,
             plan_only: bool = False, mesh=None) -> dict:
    """One cell's record (module docstring), saved under ``out_dir``.
    ``mesh``: count on this mesh of the fake group instead of the
    production mesh named by ``multi_pod``."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = shape_applicable(cfg, shape)
    if mesh is None:
        mesh, mesh_name, chips = _mesh(multi_pod)
    else:
        mesh_name = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
        chips = mesh.size
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag
                                                      else "")

    def done(rec: dict, line: str) -> dict:
        rec = dict(cell=cell_id, **rec)
        _save(out_dir, cell_id, rec)
        if verbose:
            print(line)
        return rec

    if not ok:
        return done({"status": "skipped", "reason": reason},
                    f"SKIP  {arch:22s} {shape_name:12s} {mesh_name:6s} "
                    f"{reason}")
    if plan_only and shape.kind != "train":
        return done({"status": "skipped",
                     "reason": "plan-only runs cover train cells (acc plan)"},
                    f"SKIP  {arch:22s} {shape_name:12s} {mesh_name:6s} "
                    f"plan-only")
    t0 = time.time()
    try:
        if shape.kind == "train":
            if accum is None:
                if use_acc:
                    mexec = adaptive(
                        MeshExecutor(mesh, data_axes=("pod", "data")), acc)
                    accum = autotune.choose_plan(cfg, shape, mexec).accum
                else:
                    accum = 1
            if plan_only:
                return done({"status": "planned", "accum": accum,
                             "plan_s": time.time() - t0},
                            f"PLAN  {arch:22s} {shape_name:12s} "
                            f"{mesh_name:6s} accum={accum}")
            costs, arg_bytes = count_train(
                cfg, shape, mesh, accum=accum, attn_impl=attn_impl,
                remat=remat, moment_dtype=moment_dtype,
                accum_dtype=accum_dtype, moe_local=moe_local,
                bf16_params=bf16_params, seq_shard=seq_shard,
                moe_ff2d=moe_ff2d)
        elif shape.kind == "prefill":
            costs, arg_bytes = count_prefill(cfg, shape, mesh,
                                             attn_impl=attn_impl)
        else:
            costs, arg_bytes = count_decode(cfg, shape, mesh,
                                            serve_no_fsdp=serve_no_fsdp,
                                            cache_seq_model=cache_seq_model)
        seconds = time.time() - t0
        report = roofline.analyze(costs, cfg=cfg, shape=shape,
                                  mesh_name=mesh_name, chips=chips,
                                  argument_bytes=arg_bytes)
        rec = report.to_dict()
        seq_axis = _cache_seq(cfg, shape, mesh, cache_seq_model) \
            if shape.kind == "decode" else None
        plan = sharding.tp_plan(cfg, mesh,
                                seq_over_model=seq_axis == "model",
                                cached=shape.kind == "decode")
        train = shape.kind == "train"
        rec.update(status="ok", accum=accum, seconds=seconds,
                   cache_seq=seq_axis,
                   tensor_flops=costs.tensor_flops,
                   attention=plan.attn if set(cfg.layer_kinds())
                   & set(lm.ATTN_KINDS) else None,
                   seq_shard=seq_shard and train,
                   moe_ff2d=moe_ff2d and train,
                   fits=arg_bytes + costs.peak_bytes <= H100_MEMORY_BYTES,
                   kernels={k: dataclasses.asdict(w)
                            for k, w in costs.kernels.items()})
        return done(rec, f"OK    {roofline.format_row(report)}  "
                         f"(count {seconds:.0f}s, accum={accum})")
    except Exception as exc:  # noqa: BLE001 - report and continue the sweep
        return done({"status": "error",
                     "error": f"{type(exc).__name__}: {exc}",
                     "traceback": traceback.format_exc()},
                    f"FAIL  {arch:22s} {shape_name:12s} {mesh_name:6s} "
                    f"{type(exc).__name__}: {str(exc)[:160]}")


def _save(out_dir: str, cell_id: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(rec, f, indent=2, default=str)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-acc", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--attn-impl", default="chunked",
                    choices=["chunked", "naive", "flash"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--accum-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--seq-shard", action="store_true",
                    help="Megatron-SP activations: the residual's sequence "
                         "over 'model' between blocks (train cells)")
    ap.add_argument("--cache-seq-model", action="store_true",
                    help="decode KV cache's sequence over 'model' (the "
                         "attention blocks whole, the blocks merged by "
                         "their softmax statistics)")
    ap.add_argument("--moe-local", action="store_true",
                    help="group-local MoE dispatch (a group per batch "
                         "rank)")
    ap.add_argument("--moe-ff2d", action="store_true",
                    help="expert ff over both mesh axes, the weights never "
                         "gathered (train cells)")
    ap.add_argument("--bf16-params", action="store_true",
                    help="bf16 working params + sharded f32 master in the "
                         "optimizer (halves FSDP gather bytes)")
    ap.add_argument("--serve-no-fsdp", action="store_true",
                    help="decode: drop 'data' from weight specs (no "
                         "per-token FSDP gathers; weights must fit TP)")
    ap.add_argument("--plan-only", action="store_true",
                    help="acc plans only, no count (fast)")
    ap.add_argument("--explain-decisions", action="store_true",
                    help="dump the ExecutionModel decision trace and "
                         "write it to <out>/decision_trace.txt")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    # One acc object (one calibration cache, one ExecutionModel engine)
    # for the whole sweep, so every cell's plan lands in one trace.
    acc = AdaptiveCoreChunk()
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape_name, mp, out_dir=args.out,
                               use_acc=not args.no_acc, accum=args.accum,
                               attn_impl=args.attn_impl,
                               remat=not args.no_remat,
                               moment_dtype=args.moment_dtype,
                               accum_dtype=args.accum_dtype,
                               seq_shard=args.seq_shard,
                               cache_seq_model=args.cache_seq_model,
                               moe_local=args.moe_local,
                               serve_no_fsdp=args.serve_no_fsdp,
                               bf16_params=args.bf16_params,
                               moe_ff2d=args.moe_ff2d,
                               tag=args.tag, acc=acc,
                               plan_only=args.plan_only)
                n_ok += rec["status"] in ("ok", "planned")
                n_skip += rec["status"] == "skipped"
                n_fail += rec["status"] == "error"
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} failed")
    if args.explain_decisions:
        from ..core.model import ExecutionModel

        text = ExecutionModel.of(acc.cache).explain()
        os.makedirs(args.out, exist_ok=True)
        trace_path = os.path.join(args.out, "decision_trace.txt")
        with open(trace_path, "w") as f:
            f.write(text + "\n")
        print(text)
        print(f"decision trace written to {trace_path}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
