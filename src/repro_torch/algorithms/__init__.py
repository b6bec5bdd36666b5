"""HPX-style parallel algorithms over PyTorch tensors, driven by execution
policies and the adaptive core/chunk execution-parameters object (the
paper's acc).  A CUDA tensor runs on the card — the default operators'
chunk bodies are the hand-written kernels of ``repro_torch.kernels`` —
and a CPU tensor on the CPU."""
from .adjacent_difference import adjacent_difference
from .for_each import copy, fill, for_each, generate, transform
from .reduce import (all_of, any_of, count_if, max_element, min_element,
                     none_of, reduce, transform_reduce)
from .scan import exclusive_scan, inclusive_scan
from .stencil import artificial_work, stencil3

__all__ = [
    "transform", "for_each", "copy", "fill", "generate",
    "reduce", "transform_reduce", "count_if", "all_of", "any_of", "none_of",
    "min_element", "max_element",
    "inclusive_scan", "exclusive_scan",
    "adjacent_difference", "stencil3", "artificial_work",
]
