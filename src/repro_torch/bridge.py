"""Load the JAX package's parameters into the port.

``from_reference`` takes the pytree that ``repro.models.lm.init_params``
returns, with every leaf already turned into a numpy array by the caller
(this module imports nothing of JAX or of the JAX package), and returns
the port's parameter dict: the stacked ``blocks/pos{i}`` leaves of the
pattern groups are unstacked into one dict per layer (a MoE layer's
stacked experts, (G, E, d, ff), become (E, d, ff); a ``mamba2`` layer's
``mamba`` leaves and a ``shared_attn`` layer's ``proj`` the same way),
the layers past the last whole group come from ``tail``, the hybrid
family's ``shared_block`` is converted once, weights are cast once to
the compute dtype (or to ``dtype``: the f32 masters a training run
keeps), and the nodes of ``lm.KEEP_PARAM_DTYPE`` keep the parameter
dtype: the reference computes the router and the Mamba2 block's
per-head and conv parameters in f32 from its f32 weights, and a router
rounded to bf16 would rank other experts.
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
                out[name] = _convert(sub, pd if name in lm.KEEP_PARAM_DTYPE
                                     else cd, pd, dev, index)
            else:
                arr = np.asarray(sub)
                if index is not None:
                    arr = arr[index]
                dtype = pd if name in lm.KEEP_PARAM_DTYPE else cd
                out[name] = torch.from_numpy(
                    np.array(arr, dtype=np.float32)).to(
                        device=dev, dtype=dtype)
        return out
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def from_reference(arrays: dict, cfg: ArchConfig, *,
                   device: str | torch.device = "cuda",
                   dtype: torch.dtype | None = None) -> dict:
    """Port parameters from the JAX package's ``init_params`` pytree
    (leaves as numpy arrays); weights in ``dtype``, the compute dtype by
    default."""
    lm.check_ported(cfg)
    dev = resolve_device(device)
    cd, pd = dtype or lm.compute_dtype(cfg), lm.param_dtype(cfg)
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    params: dict[str, Any] = {
        "embed": _convert(arrays["embed"], cd, pd, dev),
        "final_norm": _convert(arrays["final_norm"], cd, pd, dev),
    }
    if "lm_head" in arrays:
        params["lm_head"] = _convert(arrays["lm_head"], cd, pd, dev)
    if "shared_block" in arrays:
        params["shared_block"] = _convert(arrays["shared_block"], cd, pd,
                                          dev)
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
