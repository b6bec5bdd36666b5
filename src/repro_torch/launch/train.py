"""Training entry point (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 3 --device cpu

Runs on the CUDA card unless ``--device cpu``; with no card it raises.
acc-planned microbatching (``--accum`` overrides the plan), AdamW on f32
master weights, and the fault-tolerant trainer with periodic
checkpoints.  Every norm runs kernel 1 forward and backward on the card.
``--kernel-autotune`` measures kernel 1's forward warps per block (the
store is the acc calibrations'; serving reads the same winners) and
prints the reference's searches/reused line.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from .. import tree
from ..configs import ARCH_NAMES, get_config
from ..configs.base import ShapeConfig
from ..core import strict
from ..core.acc import AdaptiveCoreChunk
from ..core.adaptive import adaptive
from ..core.calibration import CalibrationCache
from ..core.executor import MeshExecutor
from ..core.model import ExecutionModel
from ..data import make_batch
from ..device import resolve_device
from ..models import flags, lm
from ..optim import AdamWConfig, adamw
from ..runtime import FaultTolerantTrainer
from ..train import choose_plan, make_kernel_tuner, make_train_step
from . import mesh as mesh_lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_NAMES), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=None,
                    help="grad-accum microbatches (default: acc decides)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"),
                    help="checkpoint directory; a run resumes from the "
                         "latest checkpoint in it")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-cal-cache", action="store_true",
                    help="do not persist T0/t_iter calibrations to disk")
    ap.add_argument("--cal-cache-dir", default=None,
                    help="calibration cache directory (default: "
                         "$REPRO_CAL_CACHE_DIR or ~/.cache/repro-torch-acc)")
    ap.add_argument("--kernel-autotune", action="store_true",
                    help="measured kernel plans for the model-layer "
                         "kernels (kernel 1's forward warps per block), "
                         "kept in the calibration store")
    ap.add_argument("--explain-decisions", action="store_true",
                    help="dump the ExecutionModel decision trace (the "
                         "train plan with its policy and inputs)")
    ap.add_argument("--strict", action="store_true",
                    help="strict mode (as REPRO_STRICT=1): each train step "
                         "raises on any implicit device->host "
                         "synchronisation")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    if args.strict:
        strict.enable()
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    params = lm.init_params(args.seed, cfg, device=device,
                            dtype=lm.param_dtype(cfg))
    n_params = sum(p.numel() for p in tree.leaves(params))
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M device={where}")

    cache = CalibrationCache() if args.no_cal_cache \
        else CalibrationCache.persistent(args.cal_cache_dir)
    accum = args.accum
    if accum is None:
        # acc decision over this process's devices; calibrations persist
        mexec = adaptive(MeshExecutor(mesh_lib.make_host_mesh(device)),
                         AdaptiveCoreChunk(cache=cache))
        plan = choose_plan(cfg, ShapeConfig("cli", args.seq, args.batch,
                                            "train"), mexec)
        accum = plan.accum
        print(f"acc plan: data_parallel={plan.data_parallel} accum={accum} "
              f"microbatch={plan.microbatch} "
              f"(N_C raw {plan.decision.n_cores_unclamped:.1f})")

    opt_state = adamw.init_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=args.lr), accum=accum,
                              remat=True)

    def data_iter():
        i = 0
        while True:
            yield make_batch(cfg, args.batch, args.seq, kind="train",
                             seed=i, device=device)
            i += 1

    trainer = FaultTolerantTrainer(step_fn, args.ckpt,
                                   save_every=args.save_every)
    # The same store serving reads: the measured plans are shared.
    tuner = make_kernel_tuner(cache) if args.kernel_autotune else None
    t0 = time.perf_counter()
    with flags.kernel_tuner(tuner):
        params, opt_state, log = trainer.run(params, opt_state, data_iter(),
                                             num_steps=args.steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for i, m in enumerate(log):
        if i % args.log_every == 0 or i == len(log) - 1:
            print(f"step {i:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f}")
    tok_s = args.batch * args.seq * len(log) / dt
    print(f"done: {len(log)} steps in {dt:.1f}s ({tok_s:.0f} tok/s)")
    if tuner is not None:
        print(f"kernel autotune: {tuner.searches} measured searches, "
              f"{tuner.cache_hits} persisted winners reused")
    if args.explain_decisions:
        print(ExecutionModel.of(cache).explain())
    if not args.no_cal_cache:
        cache.save()


if __name__ == "__main__":
    main()
