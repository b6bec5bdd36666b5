"""Kernel 1's backward (``src/repro_torch/kernels/csrc/rmsnorm.cu``)
against variants of its design, on one NVIDIA card.

    python3 scripts/bwd_variants.py [--out build/bwd_variants/results.jsonl]

Each variant is the kernel's source with one tuning constant changed
(``VARIANTS``), compiled by ``nvcc`` with the port's flags into
``build/bwd_variants/`` (one process each, all started together), loaded
in place of the kernel's library, held against the plain version (phase
8a's tolerances and its two-call bit check) and timed with
``chip_smoke.time_ms`` (CUDA events, L2 flushed before each call).  The
unchanged source runs first and last, so drift between the two shows.
Each record gives the plan the build took (``rmsnorm.bwd_plan``) and the
registers ``ptxas`` gave ``norm_bwd_rows`` (least and most over its
instantiations).

A further build with ``-DREPRO_BWD_STAMPS`` records, for every block of
a call, the card's %globaltimer at the kernel's stamp points (see the
source); the ``stamps`` records give each point's least, median and
greatest time after the first block started, in µs, as medians over
five calls, beside the same calls' event times (each call queued
behind a spin, as ``chip_smoke.time_ms`` does, so the span is the card's).

Prints one JSON object a line and writes the same lines to ``--out``;
exits non-zero if a build fails or a variant disagrees with the plain
version.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "rmsnorm.cu"
OUT_DIR = ROOT / "build" / "bwd_variants"

# name -> {source text: replacement}; each text must occur once.
VARIANTS = {
    "base": {},
    # 256 threads holding 32 row elements each (the same 8192 widths in
    # registers); the 512-thread row layout no longer exists.
    "threads256x32": {
        "kBwdThreads = 512;": "kBwdThreads = 256;",
        "kBwdRegElems = 16;": "kBwdRegElems = 32;",
        "    case 512: return launch_rows<T, 512, VPT, false>(a, plan, st);\n": "",
    },
    "stages2": {"kBwdMaxStages = 4;": "kBwdMaxStages = 2;"},
    # Calls of at most 64 KB run in one block; these move the threshold.
    "one_block_never": {"kBwdSmallCall = 64 << 10;": "kBwdSmallCall = 0;"},
    "one_block_256k": {"kBwdSmallCall = 64 << 10;":
                       "kBwdSmallCall = 256 << 10;"},
}
STAMPS = "stamps"
POINTS = ("start", "gamma in smem", "first stage", "rows done",
          "partial written", "ticket", "all counted", "slice written")

# (entry, rows or (B, S, Hq, Hkv), d, dtype name)
CASES = (
    ("rms", 4096, 1024, "bfloat16"), ("add", 4096, 1024, "bfloat16"),
    ("rms", 8192, 1024, "bfloat16"), ("qk", (8, 512, 16, 8), 128, "bfloat16"),
    ("rms", 4096, 2560, "bfloat16"), ("rms", 4096, 6144, "bfloat16"),
    ("rms", 4096, 1024, "float32"),
    ("rms", 8, 1024, "bfloat16"), ("rms", 8, 2048, "bfloat16"),
    ("rms", 8, 4096, "bfloat16"), ("rms", 8, 6144, "bfloat16"),
    ("add", 8, 6144, "bfloat16"),
)
STAMP_CASES = (
    ("rms", 4096, 1024, "bfloat16"), ("add", 4096, 1024, "bfloat16"),
    ("rms", 8192, 1024, "bfloat16"), ("rms", 4096, 2560, "bfloat16"),
    ("rms", 4096, 6144, "bfloat16"), ("rms", 8, 6144, "bfloat16"),
)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 1e-2)}


def _sources() -> dict[str, tuple[pathlib.Path, list[str]]]:
    """Each build's source file and extra nvcc flags."""
    text = SRC.read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, subs in VARIANTS.items():
        body = text
        for old, new in subs.items():
            if body.count(old) != 1:
                cs.fail(f"variant {name}: {old!r} occurs "
                        f"{body.count(old)} times in {SRC.name}")
            body = body.replace(old, new)
        path = OUT_DIR / f"{name}.cu"
        path.write_text(body)
        out[name] = (path, [])
    path = OUT_DIR / f"{STAMPS}.cu"
    path.write_text(text)
    out[STAMPS] = (path, ["-DREPRO_BWD_STAMPS"])
    return out


def _build() -> dict[str, tuple[pathlib.Path, tuple[int, int]]]:
    """Every build at once; {name: (library, registers of norm_bwd_rows
    (least, most))}."""
    from repro_torch.kernels import build

    nvcc = build._nvcc()
    procs = {}
    for name, (src, extra) in _sources().items():
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", *extra, "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"nvcc failed on the {name} build:\n{log[-4000:]}")
        regs, fn = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and "norm_bwd_rowsI" in fn:
                regs.append(int(m.group(1)))
        out[name] = (lib, (min(regs), max(regs)) if regs else (0, 0))
    return out


def _use(path: pathlib.Path) -> ctypes.CDLL:
    """Load ``path`` as kernel 1's library for the wrappers."""
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as krms

    lib = ctypes.CDLL(str(path))
    build._libs["rmsnorm"] = lib
    krms._lib.cache_clear()
    return lib


def _inputs(torch, case, gen):
    """(name, the wrapper's call, the plain version's call, work, plan
    arguments) for one case, inputs drawn on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import common as cm

    entry, rows, d, dname = case
    dtype = getattr(torch, dname)
    dev = torch.device("cuda")

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    if entry == "qk":
        b, length, hq, hkv = rows
        q, k = draw(b, length, hq, d), draw(b, length, hkv, d)
        dq, dk = draw(b, length, hq, d), draw(b, length, hkv, d)
        gq = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        gk = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        pos = torch.arange(length, device=dev).expand(b, length)
        cos, sin = cm.rope_angles(pos, d, get_config("qwen3-0.6b").rope_theta)
        args = (q, k, gq, gk, cos, sin, dq, dk)
        return (f"qk B={b} S={length} Hq={hq} Hkv={hkv} D={d} {dname}",
                lambda: krms.qk_norm_rope_bwd(*args, eps=1e-6),
                lambda: krms.qk_norm_rope_bwd_ref(*args, 1e-6),
                krms.qk_norm_rope_bwd_work(*args),
                (b * length, d, dtype, dict(heads=(hq, hkv), rope=True)))
    x, dy = draw(rows, d), draw(rows, d)
    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    if entry == "add":
        ds = draw(rows, d)
        return (f"add {rows}x{d} {dname}",
                lambda: krms.add_rmsnorm_bwd(x, g, dy, ds, eps=1e-6),
                lambda: krms.add_rmsnorm_bwd_ref(x, g, dy, ds, 1e-6),
                krms.add_rmsnorm_bwd_work(x, g, dy, ds),
                (rows, d, dtype, dict(residual=True)))
    return (f"rms {rows}x{d} {dname}",
            lambda: krms.rmsnorm_bwd(x, g, dy, eps=1e-6),
            lambda: krms.rmsnorm_bwd_ref(x, g, dy, 1e-6),
            krms.rmsnorm_bwd_work(x, g, dy),
            (rows, d, dtype, {}))


def _timed(torch, variant, regs, flush) -> list[dict]:
    from repro_torch.kernels import rmsnorm as krms

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for case in CASES:
        name, fn, ref, work, (tokens, d, dtype, kw) = _inputs(torch, case, gen)
        outs, outs2, refs = fn(), fn(), ref()
        atol, rtol = TOL[case[3]]
        errs = [cs.within(torch, o, r, atol, rtol)
                for o, r in zip(outs, refs, strict=True)]
        rec = dict(variant=variant, case=name,
                   ok=all(ok for ok, _ in errs),
                   err=max(e for _, e in errs),
                   bits=all(torch.equal(a, b)
                            for a, b in zip(outs, outs2, strict=True)),
                   us=1e3 * cs.time_ms(torch, fn, flush=flush),
                   bound_us=1e3 * cs.work_bound(work)[0],
                   plan=krms.bwd_plan(tokens, d, dtype, **kw),
                   registers=regs)
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def _stamps(torch, lib, flush) -> list[dict]:
    """Per case, with and without the L2 flush: each stamp point's
    (least, median, greatest) µs after the first block's start over the
    blocks, as medians over five calls; the calls' event µs."""
    from repro_torch.kernels import rmsnorm as krms

    fn_stamps = lib.repro_rmsnorm_bwd_stamps
    fn_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for case in STAMP_CASES:
        name, fn, _, _, (tokens, d, dtype, kw) = _inputs(torch, case, gen)
        blocks = krms.bwd_plan(tokens, d, dtype, **kw)["blocks"]
        for flushed in (True, False):
            fn()
            buf = (ctypes.c_ulonglong * (8 * blocks))()
            if fn_stamps(buf, blocks):        # clears the warm call's
                cs.fail("repro_rmsnorm_bwd_stamps failed")
            per_point = {p: [] for p in POINTS}
            events = []
            for _ in range(5):
                if flushed:
                    flush()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(2_000_000)   # as chip_smoke.time_ms
                start.record()
                fn()
                end.record()
                end.synchronize()
                events.append(1e3 * start.elapsed_time(end))
                if fn_stamps(buf, blocks):
                    cs.fail("repro_rmsnorm_bwd_stamps failed")
                rows = [list(buf[8 * b: 8 * b + 8]) for b in range(blocks)]
                t0 = min(r[0] for r in rows)
                for i, p in enumerate(POINTS):
                    vals = [(r[i] - t0) / 1e3 for r in rows if r[i]]
                    if vals:
                        per_point[p].append((min(vals),
                                             statistics.median(vals),
                                             max(vals)))
            rec = dict(variant=STAMPS, case=name, flushed=flushed,
                       blocks=blocks, event_us=events,
                       us_min_med_max={
                           p: [round(statistics.median(v[j] for v in vs), 2)
                               for j in range(3)]
                           for p, vs in per_point.items() if vs})
            out.append(rec)
            print(json.dumps(rec), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT_DIR / "results.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("bwd_variants needs a CUDA card")
    print(cs._card_line(), flush=True)
    built = _build()
    scratch = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    records = []
    for variant in [*VARIANTS, "base"]:
        lib, regs = built[variant]
        _use(lib)
        records += _timed(torch, variant, regs, flush)
    records += _stamps(torch, _use(built[STAMPS][0]), flush)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    bad = [(r["variant"], r["case"]) for r in records
           if "ok" in r and not (r["ok"] and r["bits"])]
    if bad:
        cs.fail(f"variants that disagree with the plain version or over "
                f"two calls: {bad}")


if __name__ == "__main__":
    main()
