"""Checkpoint ingestion: safetensors shards -> the port's parameter modules.

Ports ``mosstts_tpu/utils/hf_loader.py``: ``load_safetensors_dir``,
``qwen3_params_from_state_dict`` and ``stack_rows``, with the same name
table, into the port's stacked-layer layout (weights (in, out), stacked on a
leading L axis, as ``nn/qwen3.py`` keeps them).

The port reads the safetensors format itself, whether or not the
``safetensors`` package is installed: an 8-byte little-endian header length,
a JSON header (each tensor's dtype, shape and byte range), then the raw
bytes, which ``torch.frombuffer`` views in place over a copy-on-write memory
map (BF16, F16, F32, F64, I8, U8, I16, U16, I32, I64, BOOL). The JAX
package's ``safetensors.numpy`` reader cannot read the released bf16 shards
(numpy has no bfloat16). ``save_safetensors`` is the inverse, for
``utils/save.py`` and the codec.

Loading builds no host copy of the model: ``load_safetensors_dir`` returns a
lazy mapping over the shards' memory maps, and each tensor goes to the
device as it lies in the file (one contiguous copy), to be transposed, cast
and written into its slot of the already-built module there
(``copy_into_``). A name table (``Entry``) lists, per parameter of a module,
the reference's tensor name or names; ``fill_from_state_dict_`` follows it to
load and ``state_dict_from_params`` the other way, to write a directory in
the reference's layout from the port's weights.
"""
from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..core.config import Qwen3Config
from .convert import to_tensor

_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
    "U16": torch.uint16, "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile(Mapping):
    """One ``.safetensors`` file: name -> CPU tensor, a view of the file's
    bytes through a copy-on-write memory map (nothing is read until a
    tensor's values are)."""

    def __init__(self, path):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata = header.pop("__metadata__", None)
        self._header = header
        self._base = 8 + n

    def __getitem__(self, name: str) -> torch.Tensor:
        info = self._header[name]
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        return torch.frombuffer(self._map, dtype=dtype, count=count,
                                offset=self._base + begin).reshape(shape)

    def __iter__(self) -> Iterator[str]:
        return iter(self._header)

    def __len__(self) -> int:
        return len(self._header)


class SafetensorsDir(Mapping):
    """Every tensor of a checkpoint directory's shards, by name, read lazily."""

    def __init__(self, files: List[SafetensorsFile]):
        self._where: Dict[str, SafetensorsFile] = {}
        for f in files:
            for name in f:
                self._where[name] = f

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name][name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def load_safetensors_dir(path) -> SafetensorsDir:
    """Ports ``mosstts_tpu.utils.hf_loader.load_safetensors_dir``: the shards
    ``model.safetensors.index.json`` names, else every ``*.safetensors`` file
    in the directory, as one lazy mapping."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"no checkpoint directory at {str(path)!r}")
    index = path / "model.safetensors.index.json"
    if index.exists():
        with open(index) as f:
            files = [path / s for s in sorted(set(json.load(f)["weight_map"].values()))]
    else:
        files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors shard in {str(path)!r}")
    return SafetensorsDir([SafetensorsFile(f) for f in files])


def save_safetensors(tensors: Mapping[str, torch.Tensor], path, metadata=None) -> None:
    """Write ``tensors`` to one ``.safetensors`` file: the header padded with
    spaces to a multiple of 8 bytes, then each tensor's bytes in C order,
    the widest dtypes first (so every tensor starts aligned to its element
    size), with no gap, as the format requires."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, offset = {}, 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: safetensors has no dtype for {t.dtype}")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().tobytes())


@torch.no_grad()
def copy_into_(dst: torch.Tensor, src, *, transpose: bool = False) -> None:
    """``dst`` <- ``src`` (its transpose with ``transpose``), cast to
    ``dst``'s dtype: the source's bytes go to ``dst``'s device as they lie
    (one contiguous copy), and the transpose and the cast run there."""
    t = to_tensor(src)
    if t.device != dst.device:
        t = t.to(dst.device)
    if transpose:
        t = t.mT
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not fit {tuple(dst.shape)}")
    dst.copy_(t)


class Entry(NamedTuple):
    """One parameter of a module (``dst``, a dotted name) and the reference
    tensor(s) it comes from: ``src``, or with ``n`` the ``n`` tensors
    ``src.format(i=start + j)`` stacked on a leading axis; ``transpose``
    for a torch ``nn.Linear`` weight (out, in)."""

    dst: str
    src: str
    n: Optional[int] = None
    transpose: bool = False
    start: int = 0


# per layer i: (ours, the reference's, transposed)
_QWEN3_LAYER = (
    ("ln1", "input_layernorm.weight", False),
    ("ln2", "post_attention_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("q_norm", "self_attn.q_norm.weight", False),
    ("k_norm", "self_attn.k_norm.weight", False),
    ("w_gate", "mlp.gate_proj.weight", True),
    ("w_up", "mlp.up_proj.weight", True),
    ("w_down", "mlp.down_proj.weight", True),
)


def qwen3_table(cfg: Qwen3Config, *, prefix: str = "", dst: str = "",
                with_embed: bool = True) -> List[Entry]:
    """The name table of ``mosstts_tpu.utils.hf_loader.qwen3_params_from_state_dict``
    (per layer i)::

      {p}embed_tokens.weight                    -> embed
      {p}layers.{i}.input_layernorm.weight      -> layers.ln1[i]
      {p}layers.{i}.self_attn.q_proj.weight^T   -> layers.wq[i]
      {p}layers.{i}.self_attn.k_proj.weight^T   -> layers.wk[i]
      {p}layers.{i}.self_attn.v_proj.weight^T   -> layers.wv[i]
      {p}layers.{i}.self_attn.o_proj.weight^T   -> layers.wo[i]
      {p}layers.{i}.self_attn.q_norm.weight     -> layers.q_norm[i]
      {p}layers.{i}.self_attn.k_norm.weight     -> layers.k_norm[i]
      {p}layers.{i}.post_attention_layernorm.weight -> layers.ln2[i]
      {p}layers.{i}.mlp.gate_proj.weight^T      -> layers.w_gate[i]
      {p}layers.{i}.mlp.up_proj.weight^T        -> layers.w_up[i]
      {p}layers.{i}.mlp.down_proj.weight^T      -> layers.w_down[i]
      {p}norm.weight                            -> final_norm

    ``dst`` prefixes our names (the backbone's place in a model)."""
    L = cfg.num_hidden_layers
    table = [Entry(f"{dst}layers.{ours}", f"{prefix}layers.{{i}}.{theirs}", L, t)
             for ours, theirs, t in _QWEN3_LAYER]
    table.append(Entry(f"{dst}final_norm", f"{prefix}norm.weight"))
    if with_embed:
        table.append(Entry(f"{dst}embed", f"{prefix}embed_tokens.weight"))
    return table


@torch.no_grad()
def fill_from_state_dict_(module: nn.Module, sd: Mapping, table: List[Entry]) -> nn.Module:
    """Copy the reference tensors ``table`` names from ``sd`` (tensors or
    numpy arrays, e.g. a ``load_safetensors_dir``) into ``module``'s
    parameters in place, tensor by tensor. Every parameter of ``module``
    must be in the table."""
    params = dict(module.named_parameters())
    missing = set(params) - {e.dst for e in table}
    if missing:
        raise KeyError(f"no reference name for {sorted(missing)}")
    for e in table:
        p = params[e.dst]
        if e.n is None:
            copy_into_(p, sd[e.src], transpose=e.transpose)
            continue
        if p.shape[0] != e.n:
            raise ValueError(f"{e.dst}: {e.n} tensors for a stack of {p.shape[0]}")
        for j in range(e.n):
            copy_into_(p[j], sd[e.src.format(i=e.start + j)], transpose=e.transpose)
    return module


@torch.no_grad()
def state_dict_from_params(module: nn.Module, table: List[Entry]
                           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The inverse of ``fill_from_state_dict_``: (reference name, CPU tensor
    in the reference's layout) for every tensor ``table`` names, one at a
    time (to write a checkpoint directory in the reference's layout)."""
    params = dict(module.named_parameters())
    for e in table:
        p = params[e.dst]
        rows = [(e.src, p)] if e.n is None else [
            (e.src.format(i=e.start + j), p[j]) for j in range(e.n)]
        for name, t in rows:
            yield name, (t.mT if e.transpose else t).contiguous().cpu()


def qwen3_params_from_state_dict(sd: Mapping, cfg: Qwen3Config, *, prefix: str = "",
                                 dtype=torch.bfloat16, with_embed: bool = True,
                                 device="cuda"):
    """Ports ``mosstts_tpu.utils.hf_loader.qwen3_params_from_state_dict``:
    an HF Qwen3Model state dict (names under ``prefix``) into a new
    ``Qwen3Params`` on ``device`` in ``dtype``, through ``qwen3_table`` and
    ``fill_from_state_dict_``. ``embed`` is read when ``with_embed`` and
    the dict holds it."""
    from ..nn.qwen3 import Qwen3Params

    with_embed = with_embed and (prefix + "embed_tokens.weight") in sd
    params = Qwen3Params(cfg, dtype=dtype, device=device, with_embed=with_embed)
    return fill_from_state_dict_(params, sd, qwen3_table(cfg, prefix=prefix,
                                                         with_embed=with_embed))


def stack_rows(sd: Mapping, fmt: str, n: int, *, transpose: bool = False,
               dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """Ports ``mosstts_tpu.utils.hf_loader.stack_rows``: the ``n`` same-shaped
    tensors ``sd[fmt.format(i=i)]`` (transposed with ``transpose``) stacked
    on a new leading axis of a tensor on ``device`` in ``dtype``, each
    copied into its row with ``copy_into_``."""
    first = to_tensor(sd[fmt.format(i=0)])
    out = torch.empty((n,) + tuple(first.mT.shape if transpose else first.shape),
                      dtype=dtype, device=device)
    for i in range(n):
        copy_into_(out[i], sd[fmt.format(i=i)], transpose=transpose)
    return out
