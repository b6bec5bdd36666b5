"""Load the JAX package's parameters into the port.

``from_reference`` takes the pytree that ``repro.models.lm.init_params``
returns, with every leaf already turned into a numpy array by the caller
(this module imports nothing of JAX or of the JAX package), and returns
the port's parameter dict: the stacked ``blocks/pos0`` leaves are
unstacked into one dict per layer, weights are cast once to the compute
dtype, and norm gains keep the parameter dtype.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .configs.base import ArchConfig
from .device import resolve_device
from .models import lm


def _convert(tree: Any, cd: torch.dtype, pd: torch.dtype,
             dev: torch.device, index: int | None = None) -> Any:
    if isinstance(tree, dict):
        out = {}
        for name, sub in tree.items():
            if isinstance(sub, dict):
                out[name] = _convert(sub, cd, pd, dev, index)
            else:
                arr = np.asarray(sub)
                if index is not None:
                    arr = arr[index]
                dtype = pd if name == "g" else cd
                out[name] = torch.from_numpy(
                    np.array(arr, dtype=np.float32)).to(
                        device=dev, dtype=dtype)
        return out
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def from_reference(arrays: dict, cfg: ArchConfig, *,
                   device: str | torch.device = "cuda") -> dict:
    """Port parameters from the JAX package's ``init_params`` pytree
    (leaves as numpy arrays)."""
    lm.check_ported(cfg)
    dev = resolve_device(device)
    cd, pd = lm.compute_dtype(cfg), lm.param_dtype(cfg)
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    params: dict[str, Any] = {
        "embed": _convert(arrays["embed"], cd, pd, dev),
        "final_norm": _convert(arrays["final_norm"], cd, pd, dev),
    }
    if "lm_head" in arrays:
        params["lm_head"] = _convert(arrays["lm_head"], cd, pd, dev)
    layers = []
    for layer in range(cfg.n_layers):
        if layer < n_groups * period:
            g, i = divmod(layer, period)
            layers.append(_convert(arrays["blocks"][f"pos{i}"], cd, pd,
                                   dev, index=g))
        else:
            layers.append(_convert(arrays["tail"][layer - n_groups * period],
                                   cd, pd, dev))
    params["layers"] = layers
    return params
