"""End-to-end training example on the PyTorch port (the counterpart of
examples/train_lm.py): a reduced-family model for a few hundred steps
with acc microbatching, fault-tolerant checkpointing and a (simulated)
mid-run failure.  Runs on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu [--steps 200]
"""
import argparse
import os
import shutil
import tempfile
import time

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime import FaultTolerantTrainer, SimulatedFailure
from repro_torch.train import make_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen3-0.6b")
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--device", default="cuda")
ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                               "repro_torch_example_ckpt"))
args = ap.parse_args()

shutil.rmtree(args.ckpt, ignore_errors=True)
cfg = get_config(args.arch).reduced()
params = lm.init_params(0, cfg, device=args.device, dtype=lm.param_dtype(cfg))
opt_state = adamw.init_state(params)
n = sum(p.numel() for p in tree.leaves(params))
print(f"training reduced {cfg.name}: {n/1e6:.2f}M params, "
      f"{args.steps} steps, batch {args.batch}x{args.seq}")

step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3), accum=2, remat=True)


def data_iter():
    # small fixed corpus (4 batches, cycled): the loss drop demonstrates a
    # working end-to-end optimisation path (memorisation)
    corpus = [make_batch(cfg, args.batch, args.seq, kind="train", seed=i,
                         device=args.device) for i in range(4)]
    i = 0
    while True:
        yield corpus[i % len(corpus)]
        i += 1


# inject one failure at 60% to demonstrate checkpoint/restart
fail_at = {int(args.steps * 0.6)}


def failure_hook(step):
    if step in fail_at:
        fail_at.discard(step)
        print(f"!! simulated node failure at step {step} — recovering")
        raise SimulatedFailure(str(step))


trainer = FaultTolerantTrainer(step_fn, args.ckpt, save_every=25,
                               failure_hook=failure_hook)
t0 = time.time()
params, opt_state, log = trainer.run(params, opt_state, data_iter(),
                                     num_steps=args.steps)
dt = time.time() - t0
for i in range(0, len(log), max(len(log) // 10, 1)):
    print(f"  step {i:4d}: loss {log[i]['loss']:.4f}")
print(f"  step {len(log)-1:4d}: loss {log[-1]['loss']:.4f}")
print(f"done in {dt:.1f}s "
      f"({args.batch*args.seq*len(log)/dt:.0f} tok/s incl. restart)")
assert log[-1]["loss"] < log[0]["loss"], "loss should improve"
