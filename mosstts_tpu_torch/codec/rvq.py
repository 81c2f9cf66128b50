"""Residual vector quantization (32 levels x 1024 entries).

Ports ``mosstts_tpu/codec/rvq.py``: ``init_rvq_params``, ``rvq_encode`` and
``rvq_decode``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class RVQParams(nn.Module):
    """Ports the ``init_rvq_params`` pytree: ``codebooks`` (n_q, K, dim)."""

    def __init__(self, n_q: int, codebook_size: int, dim: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.codebooks = nn.Parameter(
            torch.empty((n_q, codebook_size, dim), dtype=dtype, device=device),
            requires_grad=False)


@torch.no_grad()
def fill_rvq_params_(params: RVQParams, generator: torch.Generator) -> RVQParams:
    """Initialise in place: unit normals scaled by 0.5**level, so deeper
    residual levels start smaller."""
    for lvl in range(params.codebooks.shape[0]):
        params.codebooks[lvl].normal_(0.0, 0.5 ** lvl, generator=generator)
    return params


def init_rvq_params(n_q: int, codebook_size: int, dim: int, *, generator: torch.Generator,
                    dtype=torch.float32, device=None) -> RVQParams:
    """Ports ``mosstts_tpu.codec.rvq.init_rvq_params``, drawing on ``device``."""
    return fill_rvq_params_(RVQParams(n_q, codebook_size, dim, dtype=dtype, device=device),
                            generator)


@torch.no_grad()
def rvq_encode(params: RVQParams, latents: torch.Tensor,
               num_quantizers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ports ``mosstts_tpu.codec.rvq.rvq_encode``: latents (B, T, dim) ->
    codes (NQ, B, T) int32 and the quantized latents (B, T, dim) float32.

    Level by level, the argmin of ``|c|^2 - 2 r.c`` over the codebook (the
    squared distance without ``|r|^2``) in float32, then the residual loses
    the chosen entry. The dot products are taken in float64 and rounded once
    to float32: no matmul precision setting (TF32) reaches them, and the
    card rounds them as the CPU does, so the argmin differs between the two
    only where two distances tie in float32."""
    books = params.codebooks[:num_quantizers].float()  # (NQ, K, dim)
    residual = latents.float()
    codes = []
    for book in books:
        dots = torch.matmul(residual.double(), book.double().T).float()  # (B, T, K)
        dist = (book * book).sum(-1) - 2.0 * dots
        idx = dist.argmin(-1)  # the first of equal minima, as jnp.argmin
        codes.append(idx.to(torch.int32))
        residual = residual - book[idx]
    return torch.stack(codes), latents.float() - residual


def rvq_decode(params: RVQParams, codes: torch.Tensor) -> torch.Tensor:
    """Ports ``mosstts_tpu.codec.rvq.rvq_decode``: codes (NQ, B, T) -> (B, T,
    dim) float32 sum of codebook vectors, accumulated level by level."""
    books = params.codebooks[: codes.shape[0]].float()
    out = torch.zeros(tuple(codes.shape[1:]) + (books.shape[-1],), dtype=torch.float32,
                      device=codes.device)
    for lvl in range(codes.shape[0]):
        out = out + books[lvl][codes[lvl].long()]
    return out
