"""The device mesh and the sharding rules, over ``torch.distributed``.

Ports ``mosstts_tpu/parallel/mesh.py``: ``make_mesh`` (a ``("data",
"model")`` mesh, ``dcn`` slices included), the parameter spec tables of the
three families and the codec, ``spec_for_path``, ``shard_params``,
``kv_cache_spec`` and ``batch_spec``.

The calling model is SPMD: one process per device (NCCL, one rank per GPU,
under ``torchrun``; gloo on the CPU in the tests), every rank making the
same calls with the same arguments. A spec is a tuple with one entry per
dimension of a parameter: an axis name (the dimension is split over that
axis, rank ``i`` of it holding the ``i``-th contiguous block) or None. A
parameter no spec names is replicated.

``shard_params`` replaces each named parameter by this rank's block, in
place, and records on every submodule the mesh axes (``collectives.axis_of``)
and the split dimensions (``collectives.sharded_dims``), from which the
forward passes take their collectives (``nn/qwen3.py``, ``models/*.py``).
Attention splits by heads in contiguous blocks, so each query group keeps
its KV head: the port requires ``num_key_value_heads % model == 0`` (JAX's
GSPMD may also split inside a head). The KV caches (L, B, KV, S, hd) of a
sharded model hold ``KV / model`` heads per rank (``nn.qwen3.rank_config``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..ops.collectives import Axis

Spec = Tuple[Optional[str], ...]
REPLICATED: Spec = ()


def _init_default_group(device: str) -> None:
    """The default process group from ``torchrun``'s environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), unless one exists: NCCL with
    this rank's GPU bound on ``"cuda"`` (its communicator is made at once),
    gloo on ``"cpu"``. An existing group of another backend raises: the
    card never runs gloo."""
    want = "nccl" if device == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise ValueError(f"the default process group is {have}; a {device} mesh needs {want}")
        return
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo")


def make_mesh(data: Optional[int] = None, model: Optional[int] = None, dcn: int = 1,
              device: str = "cuda"):
    """Ports ``mosstts_tpu.parallel.mesh.make_mesh``: a ``DeviceMesh`` of
    the world's ranks with dimensions ``("data", "model")``, rank ``d *
    model + m`` at (d, m). A missing size takes the rest of the world
    (neither: ``model`` = world). ``dcn > 1`` is the cross-slice mesh:
    ``dcn`` slices of ``data // dcn x model`` ranks, slice-major, so each
    model-axis group lies inside one contiguous block of ranks and only the
    data (gradient) collectives cross slices."""
    from torch.distributed.device_mesh import DeviceMesh

    _init_default_group(device)
    n = dist.get_world_size()
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if dcn > 1 and data % dcn != 0:
        raise ValueError(f"data={data} not divisible by dcn={dcn}: the cross-slice axis "
                         "replicates the model dimension per slice")
    # slice-major order: (dcn, data // dcn, model) collapsed on its first two
    # axes is the row-major (data, model) order of the ranks
    ranks = torch.arange(n).reshape(dcn, data // dcn, model).reshape(data, model)
    return DeviceMesh(device, ranks, mesh_dim_names=("data", "model"))


def mesh_axis(mesh, name: str) -> Axis:
    """``name`` of ``mesh`` as this rank sees it."""
    return Axis(name, mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)),
                mesh.get_local_rank(name))


def qwen3_param_specs() -> dict:
    """Attention heads and FFN columns split on 'model', ``wo``/``w_down``
    by rows; the norms replicated; the embedding by vocab rows."""
    col, row = (None, None, "model"), (None, "model", None)
    return {
        "layers": {
            "ln1": REPLICATED, "ln2": REPLICATED,
            "wq": col, "wk": col, "wv": col, "wo": row,
            "q_norm": REPLICATED, "k_norm": REPLICATED,
            "w_gate": col, "w_up": col, "w_down": row,
        },
        "final_norm": REPLICATED,
        "embed": ("model", None),
    }


def delay_param_specs() -> dict:
    return {
        "backbone": qwen3_param_specs(),
        "audio_emb": ("model", None, None),  # the codebooks
        "text_head": (None, "model"),  # vocab columns
        "audio_heads": ("model", None, None),
    }


def _no_embed() -> dict:
    return {k: v for k, v in qwen3_param_specs().items() if k != "embed"}


def local_param_specs() -> dict:
    mlp = {"gate": (None, "model"), "up": (None, "model"), "down": ("model", None)}
    return {
        "text_emb": ("model", None),
        "audio_emb": ("model", None, None),
        "backbone": _no_embed(),
        "local": _no_embed(),
        "mlp_in": mlp,
        "mlp_out_text": mlp,
        "mlp_out_audio": {"gate": (None, None, "model"), "up": (None, None, "model"),
                          "down": (None, "model", None)},
        "ln_text": REPLICATED, "ln_audio": REPLICATED,
        "text_head": (None, "model"),
        "audio_heads": ("model", None, None),
    }


def realtime_param_specs() -> dict:
    return {
        "text_emb": ("model", None),
        "audio_emb": ("model", None, None),
        "backbone": _no_embed(),
        "local": _no_embed(),
        "local_emb": ("model", None, None),
        "local_heads": ("model", None, None),
    }


def codec_param_specs() -> dict:
    return {
        "enc_in": (None, "model"),
        "encoder": _no_embed(),
        "enc_out": (None, None),
        "rvq": {"codebooks": ("model", None, None)},
        "dec_in": (None, "model"),
        "decoder": _no_embed(),
        "dec_out_norm": REPLICATED,
        "dec_out": ("model", None),
    }


def spec_for_path(specs, path) -> Spec:
    """Walk a (possibly partial) spec tree along a parameter's dotted name
    (a str or its parts); anything not covered is replicated. The int8
    parts of a quantized weight (``wq.q``, ``wq.scale``) take the weight's
    spec: ``q`` as it is, ``scale`` without the ``in`` dimension."""
    parts = path.split(".") if isinstance(path, str) else list(path)
    node = specs
    for i, key in enumerate(parts):
        if isinstance(node, tuple):
            rest = parts[i:]
            if rest == ["q"]:
                return node
            if rest == ["scale"] and len(node) >= 2:
                return node[:-2] + node[-1:]
            return REPLICATED
        if not isinstance(node, dict) or key not in node:
            return REPLICATED
        node = node[key]
    return node if isinstance(node, tuple) else REPLICATED


@torch.no_grad()
def shard_params(module: nn.Module, mesh, specs) -> nn.Module:
    """Ports ``mosstts_tpu.parallel.mesh.shard_params``, in place: every
    parameter a spec splits is replaced by this rank's contiguous block
    (a dimension must divide by its axis' size); the rest stays replicated.
    Every submodule records the mesh's axes and its split dimensions. A
    parameter already sharded is left as it is, and one whose axes all have
    one rank keeps its tensor (the block is the whole). Returns
    ``module``."""
    axes = {name: mesh_axis(mesh, name) for name in mesh.mesh_dim_names}
    for mod_name, mod in list(module.named_modules()):
        dims_of = dict(getattr(mod, "_mesh_dims", {}))
        for name, p in list(mod.named_parameters(recurse=False)):
            if name in dims_of:
                continue
            full = f"{mod_name}.{name}" if mod_name else name
            spec = spec_for_path(specs, full)
            dims = {}
            block = p.data
            for d, axis in enumerate(spec):
                if axis is None:
                    continue
                if axis not in axes:
                    raise ValueError(f"{full}: spec axis {axis!r} is not in the mesh "
                                     f"{mesh.mesh_dim_names}")
                ax = axes[axis]
                if block.shape[d] % ax.size:
                    raise ValueError(f"{full}: dimension {d} ({block.shape[d]}) does not divide "
                                     f"over {axis}={ax.size}")
                n = block.shape[d] // ax.size
                block = block.narrow(d, ax.index * n, n)
                dims[d] = axis
            if dims:
                if block.shape != p.shape:
                    mod._parameters[name] = nn.Parameter(block.clone(),
                                                         requires_grad=p.requires_grad)
                dims_of[name] = dims
        mod._mesh_axes = axes
        mod._mesh_dims = dims_of
        if hasattr(mod, "_repitch"):  # a QuantWeight's q keeps its padded rows
            mod._repitch()
    return module


def kv_cache_spec() -> Spec:
    """(L, B, KV, S, hd): the batch on 'data', the KV heads on 'model'."""
    return (None, "data", "model", None, None)


def batch_spec() -> Spec:
    return ("data",)
