"""Quickstart on the PyTorch port (the counterpart of
examples/quickstart.py): the adaptive core/chunk executor in one page.
Runs on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import algorithms as alg
from repro_torch.algorithms import detail
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import (AdaptiveCoreChunk, HostParallelExecutor,
                              SequentialExecutor, adaptive, par, seq,
                              when_all)
from repro_torch.core.executor import MeshExecutor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import lm
from repro_torch.serve import ServeScheduler
from repro_torch.train.autotune import choose_plan

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--n", type=int, default=1_000_000)
args = ap.parse_args()
dev = torch.device(args.device)

# 1. A parallel algorithm with an execution policy — the C++17 API shape.
#    A CUDA tensor runs the hand-written kernels, a CPU tensor the CPU.
x = torch.from_numpy(np.random.rand(args.n).astype(np.float32)).to(dev)
d_seq = alg.adjacent_difference(seq, x)

# 2a. v2, one word: wrap any executor in adaptive() and the paper's
#     Overhead-Law model (measure_iteration / processing_units_count /
#     get_chunk_size) runs behind the executor — no extra arguments.
host = HostParallelExecutor()
d_v2 = alg.adjacent_difference(par.on(adaptive(host)), x)
torch.testing.assert_close(d_v2, d_seq, rtol=1e-5, atol=0)

# 2b. Equivalent spelled with an explicit execution-parameters object
#     (.with_ is executor-property sugar: prefer(with_params, policy, acc)).
acc = AdaptiveCoreChunk(efficiency=0.95, chunks_per_core=8)
policy = par.on(host).with_(acc)
d_acc = alg.adjacent_difference(policy, x)
torch.testing.assert_close(d_acc, d_seq, rtol=1e-5, atol=0)

# 2c. The executors themselves are asynchronous: futures + continuations.
#     Each thunk reads one element back to the host (off any hot path).
f = host.async_execute(lambda: float(x[0]))
g = host.then_execute(lambda v: v * 2, f)
outs = when_all(host.bulk_async_execute(
    lambda c: float(x[c.start]), detail.make_chunks(8, 2))).result()
assert g.result() == float(x[0]) * 2 and len(outs) == 4

# 3. Inspect the decision the model made for this workload.
t_iter = acc.measure_iteration(
    host, lambda s, n: alg.adjacent_difference(seq, x[s:s + n]),
    x.shape[0], key="demo")
decision = acc.decide(host, t_iter, x.shape[0])
print(f"T0 (measured empty-task)   : {decision.t0*1e6:9.2f} us")
print(f"t_iter (measured)          : {decision.t_iter*1e9:9.3f} ns/elem")
print(f"N_C  (Eq. 7, clamped)      : {decision.n_cores}")
print(f"chunk (Eq. 10, T_m floor)  : {decision.chunk_elems} elems "
      f"({decision.n_chunks} chunks)")
print(f"predicted speedup          : {decision.predicted_speedup:5.2f}x "
      f"@ {decision.predicted_efficiency*100:.0f}% efficiency")

# 4. The same model drives the LM stack: microbatching for a train step.
cfg = get_config("qwen3-0.6b")
plan = choose_plan(cfg, ShapeConfig("demo", 4096, 256, "train"),
                   adaptive(MeshExecutor(make_host_mesh(dev))))
print(f"\nLM autotune for {cfg.name} @ train_4k: "
      f"data_parallel={plan.data_parallel}, accum={plan.accum}, "
      f"microbatch={plan.microbatch} seqs")

# 5. The same decision drives serving: the continuous-batching scheduler
#    picks per-tick batch width and prefill chunk from the queued tokens,
#    and every chunk it runs is timed back into the calibration cache.
scfg = get_config("qwen3-0.6b").reduced()
sched = ServeScheduler(scfg, lm.init_params(0, scfg, device=dev),
                       n_slots=2, max_len=48,
                       executor=adaptive(SequentialExecutor()), device=dev)
rids = [sched.submit(np.arange(1 + 7 * i, 13 + 7 * i) % scfg.vocab_size,
                     max_new_tokens=4) for i in range(3)]
outs = sched.run_until_idle()
print(f"\nserved {len(rids)} requests (2 slots) in {len(sched.trace)} "
      f"ticks: {[len(outs[r]) for r in rids]} tokens each")
print("adaptive chunk per tick:",
      [rec.chunk for rec in sched.trace if rec.prefill_ops])
