"""Registers, spills and shared memory of each instantiation of the
attention kernels (2 and 3: ``flash_attention.cu`` and
``paged_attention.cu``, which share ``flash_attention.cuh``), on the
machine with the card (it needs ``nvcc``; no card is used).

    python3 scripts/kernel_registers.py [--out build/kernel_registers.jsonl]
        [--csrc DIR]

Each source is compiled with the port's own flags
(``kernels/build.NVCC_FLAGS``) plus ``-Xptxas -v`` into
``build/kernel_registers/``, one ``nvcc`` process each, both started
together.  For every entry function ``ptxas`` reports, one JSON
object a line: the source, the function's name (demangled with
``cu++filt`` or ``c++filt`` where the toolkit has one), its registers,
spill stores and loads, stack frame and static shared memory, in bytes.
The same lines go to ``--out``.  ``--csrc`` compiles another tree's
sources (a parent commit's ``src/repro_torch/kernels/csrc``) with these
flags, to compare two trees' instantiations.  Exits non-zero if a build
fails.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

OUT_DIR = ROOT / "build" / "kernel_registers"


def _demangle(names: list[str]) -> list[str]:
    """``names`` demangled by the toolkit's filter, else as they are."""
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    cuda = pathlib.Path(build._nvcc()).parent / "cu++filt"
    if cuda.exists():
        tool = str(cuda)
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else names


def parse(log: str) -> list[dict]:
    """One record per entry function in ``ptxas -v``'s output."""
    recs: list[dict] = []
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1)}
            recs.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(s.group(1)) if s else 0
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT_DIR.parent /
                                         "kernel_registers.jsonl"))
    ap.add_argument("--csrc", default=str(build.CSRC),
                    help="the directory of the sources (default: this "
                         "tree's)")
    args = ap.parse_args(argv)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for stem in ("flash_attention", "paged_attention"):
        src = pathlib.Path(args.csrc) / f"{stem}.cu"
        procs[stem] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(OUT_DIR / f"lib{stem}-{os.getpid()}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, failed = [], []
    for stem, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on {stem}.cu:\n{log[-4000:]}")
            continue
        recs = parse(log)
        for rec, name in zip(recs, _demangle([r["function"] for r in recs]),
                             strict=True):
            lines.append(json.dumps({"source": f"{stem}.cu", **rec,
                                     "function": name}))
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text("".join(f"{x}\n" for x in lines))
    for x in lines:
        print(x, flush=True)
    if failed:
        print("\n".join(failed), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
