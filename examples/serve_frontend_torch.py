"""Front-end example on the PyTorch port (the counterpart of
examples/serve_frontend.py): the asyncio serving surface in one tour —
streaming consumers, a mid-stream cancellation, a deadline shed, and
backpressure, all over one scheduler with adaptive admission.  Runs on
the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/serve_frontend_torch.py [--device cpu]
"""
import argparse
import asyncio
import time

from repro_torch.configs import get_config
from repro_torch.core.acc import AdaptiveCoreChunk
from repro_torch.core.adaptive import adaptive
from repro_torch.core.executor import SequentialExecutor
from repro_torch.data import make_batch
from repro_torch.models import lm
from repro_torch.serve import ServeFrontend, ServeScheduler

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = get_config("qwen3-0.6b").reduced()
params = lm.init_params(0, cfg, device=args.device)
sched = ServeScheduler(cfg, params, n_slots=2, max_len=64,
                       executor=adaptive(SequentialExecutor(),
                                         AdaptiveCoreChunk()),
                       dispatch_depth="auto", admission="adaptive",
                       device=args.device)
sched.warmup()
# Prompts stay on the host: the scheduler keeps every prompt there.
prompts = make_batch(cfg, 3, 16, kind="prefill", seed=0,
                     device="cpu")["tokens"]


async def stream_all(fe, stream, label):
    toks = []
    async for tok in stream:
        toks.append(tok)
    rec = stream.record
    ttft_ms = 0.0 if rec.first_token_at is None \
        else (rec.first_token_at - rec.submitted_at) * 1e3
    print(f"  [{label}] {rec.status}: {len(toks)} tokens "
          f"(ttft {ttft_ms:.0f}ms)")
    return toks


async def main():
    async with ServeFrontend(sched, max_queue=4) as fe:
        # 1. Two concurrent streaming requests.
        s0 = await fe.submit(prompts[0], 12)
        s1 = await fe.submit(prompts[1][:9], 12)

        # 2. A consumer that walks away after 3 tokens: the cancel
        #    releases the cache slot mid-generation.
        s2 = await fe.submit(prompts[2][:6], 48)

        async def impatient():
            got = 0
            async for _tok in s2:
                got += 1
                if got >= 3:
                    await s2.cancel()
            print(f"  [cancel] walked away after {got} tokens "
                  f"-> {s2.record.status}")

        # 3. A request whose deadline already passed: shed before its
        #    prefill burns a slot (enforce_deadlines is on by default).
        dead = await fe.submit(prompts[0][:8], 8,
                               deadline=time.monotonic() - 1.0)

        async def doomed():
            async for _tok in dead:
                pass
            print(f"  [deadline] {dead.record.status} "
                  f"(missed={dead.record.missed})")

        await asyncio.gather(stream_all(fe, s0, "stream-0"),
                             stream_all(fe, s1, "stream-1"),
                             impatient(), doomed())
        print("  stats:", fe.stats())

print(f"[{cfg.name}] asyncio front end: 2 streams + 1 cancel + 1 shed")
asyncio.run(main())
print(f"  slot pool intact: allocations={sched.pool.allocations}, "
      f"free={sched.pool.free_slots()}/2")
