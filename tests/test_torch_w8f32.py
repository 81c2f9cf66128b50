"""``w8_gemm.w8f32_gemm``'s arithmetic on the CPU: the F32X3 mode of the
ring kernel (``csrc/w8_gemm.cu``), W8A16's function with float32
activations, as the JAX package's ``dense`` computes it on a
``QuantWeight`` (``mosstts_tpu/ops/basic.py:28-30``) for the int8 codec's
encoder.

* The split (``split3_bf16``, the plain version of ``ring::split3``): three
  bf16 terms, each rounded to nearest (an independent numpy transcription
  of round-to-nearest-even on the bits agrees), sum to x exactly wherever
  the last term stays a normal bf16 (|x| >= 2**-110) and within 2**-24 |x|
  + 2**-134 everywhere (below 2**-110 bf16's subnormal step 2**-133 bounds
  the remainder); inf and NaN stay inf and NaN.
* The three-term product, walked as the kernel sums it (k16 steps over
  the consumer warps, the three terms of a step lo first into one f32
  accumulator, the warps in warp order, the cluster's ranks in rank order,
  then the scale), against the plain version and against JAX's ``dense`` at
  ``jax_default_matmul_precision="highest"``, within ``1e-5 * sum|x||q|
  scale + 1e-6``, at ``codec_1p6b()``'s products cut 8x in K and N and M in
  (1, 5, 6, 12, 50, 100); the encoder runs 100-frame chunks, M = 100 a wave.
* ``gemm_plan(mode=F32X3)``: every split of K whole ring tiles and none
  empty, at most ``MAX_CLUSTER`` blocks a cluster, the instantiation's
  shared memory within an H100 SM.

The card tests (``tests/test_torch_parallel_cuda.py``) hold the kernel
against the plain version, and through an identity weight its terms'
sum against x bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.ops import basic as jbasic
from mosstts_tpu.ops import quant as jq
from mosstts_tpu_torch.ops.kernels import w8_gemm
from mosstts_tpu_torch.tools import kernel_inputs
from torch_f32_families import FAMILIES, family

def _rne_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (as float32) by round-to-nearest-even on the bits;
    NaN stays NaN."""
    b = x.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), r)


@pytest.mark.parametrize("name", FAMILIES)
def test_split3_terms_sum_to_x(name):
    x = family(name)
    hi, mid, lo = w8_gemm.split3_bf16(torch.from_numpy(x))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    err = (total - torch.from_numpy(x).double()).abs().numpy()
    ax = np.abs(x.astype(np.float64))
    assert np.isfinite(total.numpy()).all()
    assert (err <= 2.0 ** -24 * ax + 2.0 ** -134).all(), float(err.max())
    assert (err[ax >= 2.0 ** -110] == 0).all()  # exact where lo is a normal bf16
    # each term is the nearest bf16 of what is left, as cvt.rn.bf16.f32 rounds
    h = hi.float().numpy()
    over = np.isinf(_rne_bf16(x))  # a finite x past bf16's largest keeps its truncation
    want_hi = np.where(over, (x.view(np.uint32) & 0xFFFF0000).view(np.float32), _rne_bf16(x))
    np.testing.assert_array_equal(h, want_hi)
    r = x - h
    np.testing.assert_array_equal(mid.float().numpy(), _rne_bf16(r))
    np.testing.assert_array_equal(lo.float().numpy(), _rne_bf16(r - mid.float().numpy()))


def test_split3_keeps_inf_and_nan():
    x = torch.tensor([np.inf, -np.inf, np.nan, 1.0, -0.0], dtype=torch.float32)
    hi, mid, lo = w8_gemm.split3_bf16(x)
    total = hi.float() + mid.float() + lo.float()
    assert total[0] == np.inf and total[1] == -np.inf and torch.isnan(total[2])
    assert float(total[3]) == 1.0 and float(total[4]) == 0.0
    assert (mid[:3] == 0).all() and (lo[:3] == 0).all()


def _walk(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, plan) -> torch.Tensor:
    """The F32X3 kernel's sums in f32 for every column at once: per rank of
    the cluster its k tiles, each tile's k16 steps spread over the WK
    consumer warps, the warps summed in warp order, the ranks from 0 in
    rank order, then the scale. Each step's terms lo, mid, hi are added
    in turn to one accumulator."""
    wk = w8_gemm.F32_VARIANTS[plan.variant][4]
    bk = plan.bk
    ksw = bk // 16 // wk
    terms = [t.float() for t in w8_gemm.split3_bf16(x)][::-1]  # lo, mid, hi
    K = x.shape[1]
    qf = q.float()
    total = torch.zeros(x.shape[0], q.shape[1])
    for s in range(plan.splits):
        kb = s * plan.k_tiles // plan.splits * bk
        ke = min(K, (s + 1) * plan.k_tiles // plan.splits * bk)
        warps = torch.zeros(wk, x.shape[0], q.shape[1])
        for k0 in range(kb, ke, bk):
            for step in range(bk // 16):
                a, b = k0 + 16 * step, min(ke, k0 + 16 * step + 16)
                if a >= b:
                    continue
                for t in terms:
                    warps[step // ksw] += t[:, a:b] @ qf[a:b]
        part = warps[0]
        for i in range(1, wk):
            part = part + warps[i]
        total = total + part
    return total * scale


def _codec_shapes():
    """``codec_1p6b()``'s products with float32 activations, K and N cut 8x."""
    return [(name, K // 8, N // 8) for name, K, N in kernel_inputs.codec_f32_shapes()]


@pytest.mark.parametrize("M", [1, 5, 6, 12, 50, 100])
@pytest.mark.parametrize("name,K,N", _codec_shapes())
def test_three_term_product_matches_plain_and_jax(name, K, N, M):
    rng = np.random.default_rng(K * 7 + N + M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[:, ::17] *= 1e3  # a spread of magnitudes in every row
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    q, s = torch.tensor(np.asarray(jw.q)), torch.tensor(np.asarray(jw.scale))
    xt = torch.from_numpy(x)
    plan = w8_gemm.gemm_plan(M, K, N, 1, 132, mode=w8_gemm.F32X3)
    got = _walk(xt, q, s, plan)
    ref = w8_gemm.w8a16_gemm_ref(xt, q, s, torch.float32)
    absref = w8_gemm.w8a16_gemm_ref(xt.abs(), q.abs(), s, torch.float32)
    bound = 1e-5 * absref + 1e-6
    assert bool(((got - ref).abs() <= bound).all()), float((got - ref).abs().max())
    # the wrapper on CPU tensors is the plain version
    torch.testing.assert_close(w8_gemm.w8f32_gemm(xt, q, s), ref, rtol=0, atol=0)
    with jax.default_matmul_precision("highest"):
        want = torch.tensor(np.asarray(jbasic.dense(jnp.asarray(x), jw)))
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


def _smem(spec) -> int:
    """``ring::Cfg::SMEM`` of an F32X3 instantiation: its ring (the weight
    tile in rows padded by 16 bytes, three bf16 x tiles in rows padded by 8
    elements) or its consumer warps' partial tiles."""
    mt, bn, _, _, wk, stages = spec[:6]
    bk = w8_gemm.STAGE_W // bn
    ring = stages * (bk * (bn + 16) + 3 * 16 * mt * (bk + 8) * 2)
    return max(ring, wk * 16 * mt * (bn + 1) * 4)


@pytest.mark.parametrize("M,K,N", [(50, 1536, 6144), (50, 6144, 1536), (1, 1920, 1536),
                                   (1000, 1536, 6144), (7, 33, 129), (3, 32, 16)])
def test_f32x3_plan_splits_k_into_whole_nonempty_slices(M, K, N):
    p = w8_gemm.gemm_plan(M, K, N, 1, 132, mode=w8_gemm.F32X3)
    spec = w8_gemm.F32_VARIANTS[p.variant]
    assert (p.mt, p.bn, p.bk) == (spec[0], spec[1], w8_gemm.STAGE_W // spec[1])
    blocks = (p.tiles + p.tail_blocks) * p.row_tiles
    assert p.splits == 1 or blocks * p.splits <= 132  # a split only within one wave
    assert p.row_tiles == -(-M // (16 * p.mt)) and (M > 16) == (p.mt > 1)
    assert 1 <= p.splits <= w8_gemm.MAX_CLUSTER and p.k_tiles == -(-K // p.bk)
    covered = np.zeros(p.k_tiles, np.int64)
    for s in range(p.splits):  # ring_kernel's k_begin, k_end
        span = covered[s * p.k_tiles // p.splits:(s + 1) * p.k_tiles // p.splits]
        assert span.size > 0
        span += 1
    assert (covered == 1).all()
    assert p.tiles * p.bn >= N > (p.tiles - 1) * p.bn or p.tail_blocks == 1
    # an H100 block's shared memory, and MINB blocks an SM in its 228 KB
    smem = _smem(spec)
    assert smem <= 232448 and spec[7] * (smem + 1024 + 128) <= 233472
    assert (p.bk // 16) % spec[4] == 0 and spec[0] % spec[2] == 0 and (p.bn // 32) % spec[3] == 0
