"""Weight-only int8 quantization for serving.

Ports ``mosstts_tpu/ops/quant.py``: ``QuantWeight``, ``quantize_weight``,
``is_quantized``, ``dequantize``, ``MATMUL_KEYS``, ``random_quantized_like``,
``quantize_tree`` (here ``quantize_tree_``, in place) and ``take_weight``.

A matmul weight (..., in, out) becomes int8 values ``q`` with one float32
scale per output channel, ``scale`` (..., out): w ~= q * scale. Decode steps
stream the weights, so int8 halves the bytes of the device cost that
dominates them. ``ops.basic.dense`` and the Delay audio heads compute
``(x @ q) * scale`` with float32 accumulation: the W8A16 kernel of
``ops/kernels/w8_gemm.py`` on the card, its plain version on the CPU.

``QuantWeight`` is an ``nn.Module`` holding ``q`` and ``scale`` as
parameters (``requires_grad=False``), so a quantized weight named ``wq``
appears as ``wq.q`` and ``wq.scale`` in ``named_parameters()``, the names
that ``utils.convert`` gives a JAX ``QuantWeight`` leaf. Indexing a stacked
weight gives a ``QuantView`` of one layer or head: ``q[i]`` and ``scale[i]``
together (JAX's ``take_weight`` keeps the same pairing), views with no copy.

A weight whose ``out`` is not a multiple of 16 (the 1025-wide Delay audio
heads) keeps ``q`` as the (..., in, out) view of a buffer whose rows are
padded to the next multiple of 16 bytes, so the W8A16 kernel reads its rows
with 16-byte loads (+1.5% of the heads' bytes at 8B). Names, shapes and
values are unchanged (``state_dict``, ``named_parameters``, the bridge);
the pad is restored after a move, a copy or an unpickle (``.to()`` and
``deepcopy`` would otherwise make ``q`` contiguous).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .collectives import axis_of, reduce, sharded_dims

# weight names eligible for quantization (2-D+ matmul operands; embeddings
# are gathers and norms are tiny: those stay in their float dtype)
MATMUL_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
     "text_head", "audio_heads", "local_heads", "gate", "up", "down",
     "enc_in", "enc_out", "dec_in", "dec_out"}
)


class _QuantShape:
    """What callers probe on a weight, answered from ``q``. ``dtype`` is the
    activation dtype int8 serving computes in (bf16), as JAX's
    ``QuantWeight.dtype``."""

    __slots__ = ()

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def device(self) -> torch.device:
        return self.q.device


class QuantView(_QuantShape):
    """One slice of a ``QuantWeight``: int8 ``q`` (..., in, out) and its f32
    ``scale`` (..., out), both views."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale


ROW_PITCH = 16  # bytes: q's rows lie a multiple of this apart (the W8A16 kernel's loads)


def pitched(q: torch.Tensor) -> torch.Tensor:
    """``q`` (..., in, out) itself if its rows are contiguous and a multiple
    of ``ROW_PITCH`` bytes apart, else a copy of it in a buffer whose rows
    are padded (with zeros) to the next multiple, as the (..., in, out)
    view of that buffer."""
    if q.stride(-1) == 1 and all(st % ROW_PITCH == 0 for st in q.stride()[:-1]):
        return q
    n = q.shape[-1]
    buf = torch.zeros(q.shape[:-1] + (n + -n % ROW_PITCH,), dtype=q.dtype, device=q.device)
    buf[..., :n].copy_(q)
    return buf[..., :n]


class QuantWeight(_QuantShape, nn.Module):
    """Ports ``mosstts_tpu.ops.quant.QuantWeight``: int8 ``q`` (..., in, out)
    and f32 per-output-channel ``scale`` (..., out) as module parameters;
    ``q``'s rows at a ``ROW_PITCH`` multiple (``pitched``)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(f"QuantWeight: q {q.dtype} must be int8, scale {scale.dtype} f32")
        if tuple(scale.shape) != tuple(q.shape[:-2]) + (q.shape[-1],):
            raise ValueError(f"QuantWeight: scale {tuple(scale.shape)} does not match "
                             f"q {tuple(q.shape)}")
        self.q = nn.Parameter(pitched(q), requires_grad=False)
        self.scale = nn.Parameter(scale, requires_grad=False)
        self._views: dict = {}

    def _repitch(self) -> None:
        q = self._parameters["q"]
        p = pitched(q.data)
        if p is not q.data:
            self._parameters["q"] = nn.Parameter(p, requires_grad=False)

    def _apply(self, fn, recurse=True):
        """A move or cast (``.to()``) copies a padded ``q`` contiguous: pad
        it again."""
        super()._apply(fn, recurse)
        self._repitch()
        return self

    def __setstate__(self, state):
        """``deepcopy`` and unpickling copy a padded ``q`` contiguous: pad
        it again."""
        super().__setstate__(state)
        self._repitch()

    def __getitem__(self, i) -> QuantView:
        """``q[i]`` and ``scale[i]`` as a ``QuantView``. Integer indices are
        cached (the backbone indexes every layer's weights on every step);
        the cache is keyed on the storage, so a copy into place keeps it
        and a move to another device or dtype drops it."""
        if not isinstance(i, int):
            return QuantView(self.q[i], self.scale[i])
        q, scale = self._parameters["q"], self._parameters["scale"]  # no Module.__getattr__
        key = (i, q.data_ptr(), scale.data_ptr())
        view = self._views.get(key)
        if view is None:
            if len(self._views) > 4 * q.shape[0]:
                self._views.clear()
            view = self._views[key] = QuantView(q[i], scale[i])
        return view


def quantize_weight(w: torch.Tensor, in_axis=None) -> QuantWeight:
    """Ports ``mosstts_tpu.ops.quant.quantize_weight``: the absmax over the
    ``in`` axis (-2) over 127, floored at 1e-8; values rounded half to even
    (``torch.round``, as ``jnp.round``) and clipped to +-127. The divisor
    127 is a tensor: on CUDA, PyTorch multiplies by the reciprocal of a
    Python-number divisor, which can land one ulp from the division JAX
    does. ``in_axis`` (a ``ops.collectives.Axis``): ``w`` is this
    rank's block of rows of a weight split over that axis (row-parallel);
    the absmax is taken over the whole ``in`` dimension (an ``all_reduce``
    of the maxima), as JAX quantizes the whole sharded array."""
    wf = w.float()
    amax = reduce(wf.abs().amax(dim=-2), in_axis, op=dist.ReduceOp.MAX)
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-8)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return QuantWeight(q, scale)


def is_quantized(w) -> bool:
    """Ports ``mosstts_tpu.ops.quant.is_quantized``."""
    return isinstance(w, (QuantWeight, QuantView))


def dequantize(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Ports ``mosstts_tpu.ops.quant.dequantize``."""
    return (w.q.float() * w.scale[..., None, :]).to(dtype)


def take_weight(w, idx: int, axis: int = 0):
    """Ports ``mosstts_tpu.ops.quant.take_weight``: one slice of a stacked,
    possibly quantized weight, ``q`` and ``scale`` together."""
    if is_quantized(w):
        return QuantView(w.q.select(axis, idx), w.scale.select(axis, idx))
    return w.select(axis, idx)


def _eligible(name: str, p: torch.Tensor) -> bool:
    return name in MATMUL_KEYS and p.ndim >= 2


@torch.no_grad()
def quantize_tree_(module: nn.Module) -> nn.Module:
    """Ports ``mosstts_tpu.ops.quant.quantize_tree``, in place: every
    parameter named in ``MATMUL_KEYS`` with ndim >= 2 becomes a
    ``QuantWeight`` and its float tensor is freed. A stacked weight is
    quantized one leading slice at a time, so the float temporaries stay the
    size of one layer. On a tensor-parallel shard (``parallel/mesh.py``) a
    weight split by rows takes the scales of its whole ``in`` dimension
    (``quantize_weight(in_axis=)``), so the int8 weights equal one device's.
    Returns ``module``."""
    for mod in list(module.modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            if isinstance(mod, QuantWeight) or not _eligible(name, p):
                continue
            dims = sharded_dims(mod, name)
            in_axis = axis_of(mod, dims[p.ndim - 2]) if p.ndim - 2 in dims else None
            lead = p.shape[:-2]
            q = torch.empty(p.shape, dtype=torch.int8, device=p.device)
            scale = torch.empty(lead + p.shape[-1:], dtype=torch.float32, device=p.device)
            flat_p = p.reshape((-1,) + p.shape[-2:])
            flat_q, flat_s = q.view((-1,) + p.shape[-2:]), scale.view(-1, p.shape[-1])
            for i in range(flat_p.shape[0]):
                qi = quantize_weight(flat_p[i], in_axis)
                flat_q[i].copy_(qi.q)
                flat_s[i].copy_(qi.scale)
            delattr(mod, name)  # drops the module's reference to the float tensor
            del p, flat_p
            qw = QuantWeight(q, scale)
            if hasattr(mod, "_mesh_axes"):  # q split as the weight was, scale without ``in``
                qw._mesh_axes = mod._mesh_axes
                qw._mesh_dims = {"q": dims, "scale": {
                    d - (d > q.ndim - 2): a for d, a in dims.items() if d != q.ndim - 2}}
            setattr(mod, name, qw)
    return module


@torch.no_grad()
def random_quantized_like(module: nn.Module, *, generator: torch.Generator, device,
                          dtype=torch.bfloat16, std: float = 0.02) -> nn.Module:
    """Ports ``mosstts_tpu.ops.quant.random_quantized_like``: give ``module``
    (built on any device, ``"meta"`` for a model that would not fit in
    float) random parameters directly in the int8 serving layout on
    ``device``, with no float master copy. Every ``MATMUL_KEYS`` leaf
    becomes a ``QuantWeight`` of int8 values uniform in [-127, 127] and the
    fixed scale ``std * 4 / 127`` (an N(0, std^2) weight's absmax); every
    other leaf is drawn N(0, std) in ``dtype``, as in JAX. Benchmark-only:
    the values are random. Returns ``module``."""
    for mod in list(module.modules()):
        for name, p in list(mod.named_parameters(recurse=False)):
            if isinstance(mod, QuantWeight):
                continue
            delattr(mod, name)
            if _eligible(name, p):
                q = torch.empty(p.shape, dtype=torch.int8, device=device)
                q.random_(-127, 128, generator=generator)
                scale = torch.full(p.shape[:-2] + p.shape[-1:], std * 4.0 / 127.0,
                                   dtype=torch.float32, device=device)
                setattr(mod, name, QuantWeight(q, scale))
            else:
                leaf = torch.empty(p.shape, dtype=torch.float32, device=device)
                leaf.normal_(0.0, std, generator=generator)
                setattr(mod, name, nn.Parameter(leaf.to(dtype), requires_grad=False))
    return module
