"""Weight bridge: a JAX parameter pytree, as numpy arrays, into the port's
modules under the same names and layouts.

A nested dict ``{"layers": {"wq": ...}, "final_norm": ...}`` maps to the
module parameters ``layers.wq``, ``final_norm``, and a list's entries to
their indices (``subs.0.mid.1``, as ``nn.ModuleList`` names them): the
port's modules register their parameters under the JAX tree's keys, so the
flattened names agree.
A JAX ``QuantWeight`` leaf (a NamedTuple ``(q, scale)``) flattens to
``<name>.q`` and ``<name>.scale``, the parameters of the port's
``ops.quant.QuantWeight``: a JAX ``quantize_tree(params)`` loads into a port
model on which ``quantize_tree_`` ran, int8 as int8 and f32 as f32.
JAX bfloat16 reaches numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses; such arrays pass through float32, which holds
every bfloat16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def to_tensor(x) -> torch.Tensor:
    """numpy-convertible array -> CPU tensor of the same dtype; ml_dtypes
    bfloat16 becomes torch.bfloat16 through float32; a tensor as it is."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)  # a copy: arrays from jax.device_get are read-only


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a.b.c": leaf}; a list -> one entry per index
    ({"subs": [{"mid": [w0, w1]}]} -> "subs.0.mid.1", the names of an
    ``nn.ModuleList``/``nn.ParameterList``); a NamedTuple leaf (a JAX
    ``QuantWeight``) -> one entry per field, {"a.b.q": ..., "a.b.scale": ...}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


@torch.no_grad()
def load_tree_(module: nn.Module, tree: Any) -> nn.Module:
    """Copy every leaf of ``tree`` into the parameter of ``module`` with the
    same dotted name, converting to the parameter's dtype and device. The
    two name sets must be equal and every shape must match. A
    ``QuantWeight`` of the module is filled as it is: its int8 ``q`` and
    f32 ``scale`` from the tree's."""
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"tree/module names differ: only in tree {sorted(set(flat) - set(params))}, "
                       f"only in module {sorted(set(params) - set(flat))}")
    for name, p in params.items():
        src = to_tensor(flat[name])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {tuple(src.shape)} != module {tuple(p.shape)}")
        p.copy_(src)
    return module
