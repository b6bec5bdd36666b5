"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, importing the port
leaves JAX unloaded, and with no card the entry points refuse to run
instead of falling back to the CPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.append(node.module)
    return names


def _port_files() -> list[pathlib.Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), name) for f in files
           for name in _imports(f) if name.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys\n"
            "import repro_torch, repro_torch.bridge, repro_torch.core, "
            "repro_torch.kernels.build, repro_torch.kernels.rmsnorm, "
            "repro_torch.kernels.flash_attention, repro_torch.models, "
            "repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.algorithms, repro_torch.kernels.ops, "
            "repro_torch.kernels.autotune, repro_torch.serve.frontend, "
            "repro_torch.serve.loadgen, repro_torch.serve.kv_cache, "
            "repro_torch.optim, repro_torch.train, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.runtime, "
            "repro_torch.launch.train, repro_torch.core.simmachine\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_card_means_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import (PagedKVCachePool, ServeScheduler,
                                   SlotKVCachePool)

    cfg = get_config("qwen3-0.6b").reduced()
    params = lm.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeScheduler(cfg, params, n_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotKVCachePool(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCachePool(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeScheduler(cfg, params, n_slots=2, max_len=16, paged=True,
                       speculate=2, dispatch_depth=2, admission="adaptive")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(0, cfg)


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
