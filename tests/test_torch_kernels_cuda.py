"""The CUDA kernels of ``mosstts_tpu_torch`` against their plain PyTorch
versions, on the card. They skip without one: a CUDA kernel has no CPU mode
(the plain versions are held against the JAX package by
tests/test_torch_ops.py, tests/test_torch_kvcache.py and
tests/test_torch_gemm.py).

This file imports no JAX, so it runs on the machine with the card, which has
none; tests/conftest.py imports JAX, so skip it there:

    python3 -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance, elementwise: two ulps of the output dtype at the reference's
magnitude, plus 1e-5. Both versions compute in float32 from the same inputs
and round once, so they differ by summation order and at most one rounding
step.
"""
import numpy as np
import pytest
import torch

from mosstts_tpu_torch.nn.qwen3 import _quantize_kv_block
from mosstts_tpu_torch.ops.kernels import decode_attn, flash, paged_attn, w8_gemm

ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _assert_close(out, ref, dtype, rows=None):
    err = (out.float() - ref.float()).abs()
    bound = 2 * ULP[dtype] * ref.float().abs() + 1e-5
    if rows is not None:
        err, bound = err[rows], bound[rows]
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,kv_major,window", [(128, True, None), (64, False, 9),
                                                (256, True, None)])
def test_flash_kernel_matches_plain(dtype, hd, kv_major, window):
    _need_card()
    rng = np.random.default_rng(hd)
    B, T, H, KV, S, q_start = 3, 70, 8, 2, 96, 11
    g = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
    q = g(B, T, H, hd)
    k, v = (g(B, KV, S, hd), g(B, KV, S, hd)) if kv_major else (g(B, S, KV, hd), g(B, S, KV, hd))
    valid = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    for b, pad in enumerate((0, 4, 13)):  # left padding
        valid[b, pad:q_start + T] = True
    kw = dict(scale=hd ** -0.5, window=window, kv_major=kv_major)
    launches = flash.LAUNCHES
    out = flash.flash_attention(q, k, v, valid, q_start, **kw)
    ref = flash.flash_attention_ref(q, k, v, valid, q_start, **kw)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == launches + 1
    _assert_close(out, ref, dtype, rows=valid[:, q_start:q_start + T])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("attend", [1, 37, 256, 300])
def test_decode_kernel_matches_plain(dtype, attend):
    _need_card()
    rng = np.random.default_rng(attend)
    g = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
    q, kc, vc = g(4, 32, 128), g(3, 4, 8, 512, 128), g(3, 4, 8, 512, 128)
    valid = torch.tensor(rng.random((4, 512)) < 0.7).cuda()
    launches = decode_attn.LAUNCHES
    out = decode_attn.decode_attention(q, kc, vc, valid, 2, scale=128 ** -0.5, attend_len=attend)
    ref = decode_attn.decode_attention_ref(q, kc, vc, valid, 2, scale=128 ** -0.5,
                                           attend_len=attend)
    torch.cuda.synchronize()
    assert decode_attn.LAUNCHES == launches + 1
    _assert_close(out, ref, dtype)


@pytest.mark.cuda
def test_decode_kernel_with_no_valid_slot_averages_like_plain():
    _need_card()
    rng = np.random.default_rng(0)
    g = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda()
    q, kc, vc = g(2, 4, 64), g(2, 2, 2, 80, 64), g(2, 2, 2, 80, 64)
    valid = torch.zeros((2, 80), dtype=torch.bool, device="cuda")
    out = decode_attn.decode_attention(q, kc, vc, valid, 1, scale=0.125, attend_len=70)
    ref = decode_attn.decode_attention_ref(q, kc, vc, valid, 1, scale=0.125, attend_len=70)
    torch.cuda.synchronize()
    _assert_close(out, ref, torch.float32)


@pytest.mark.cuda
def test_decode_kernel_raises_on_an_unsupported_group():
    """Eight query heads per KV head is past the kernel's MAX_GROUP: the
    wrapper raises rather than run the plain version on the card."""
    _need_card()
    q = torch.zeros((1, 16, 128), device="cuda")
    kc = torch.zeros((1, 1, 2, 64, 128), device="cuda")
    valid = torch.ones((1, 64), dtype=torch.bool, device="cuda")
    launches = decode_attn.LAUNCHES
    with pytest.raises(ValueError, match="not supported"):
        decode_attn.decode_attention(q, kc, kc, valid, 0, scale=0.1, attend_len=64)
    assert decode_attn.LAUNCHES == launches


def _q8(x):
    """int8 values and f32 scales of a (..., hd) cache, as the cache write
    stores them."""
    L, B, KV, S, hd = x.shape
    q, sc = _quantize_kv_block(x.reshape(L * B, KV, S, hd))
    return q.reshape(x.shape), sc.reshape(x.shape[:4])


def _paged(seed, kc, page, n_alloc):
    """A shuffled pool holding the (L, B, KV, S, hd) cache, the first
    ``n_alloc`` logical pages of each row allocated and the rest on a
    poisoned trash page 0."""
    B, S = kc.shape[1], kc.shape[3]
    mp = S // page
    perm = np.random.default_rng(seed).permutation(np.arange(1, 1 + B * mp)).reshape(B, mp)
    perm[:, n_alloc:] = 0
    table = torch.tensor(perm, dtype=torch.int32, device=kc.device)
    return paged_attn.scatter_pages(kc, table, 1 + B * mp, 1e4), table


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("attend", [1, 37, 256, 512])
def test_decode_q8_kernel_matches_plain(dtype, attend):
    _need_card()
    rng = np.random.default_rng(attend)
    g = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda()
    q = g(4, 32, 128).to(dtype)
    (kq, ks), (vq, vs) = _q8(g(3, 4, 8, 512, 128)), _q8(g(3, 4, 8, 512, 128))
    valid = torch.tensor(rng.random((4, 512)) < 0.7).cuda()
    args = (q, kq, ks, vq, vs, valid, 2)
    launches = decode_attn.LAUNCHES_Q8
    out = decode_attn.decode_attention_q8(*args, scale=128 ** -0.5, attend_len=attend)
    ref = decode_attn.decode_attention_q8_ref(*args, scale=128 ** -0.5, attend_len=attend)
    torch.cuda.synchronize()
    assert decode_attn.LAUNCHES_Q8 == launches + 1
    _assert_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page,attend,n_alloc", [(128, 256, 4), (32, 512, 9), (64, 128, 2)])
def test_paged_kernels_match_plain(dtype, quant, page, attend, n_alloc):
    _need_card()
    rng = np.random.default_rng(page + attend)
    g = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda()
    q, kc, vc = g(3, 32, 128).to(dtype), g(2, 3, 8, 512, 128), g(2, 3, 8, 512, 128)
    valid = torch.tensor(rng.random((3, 512)) < 0.7).cuda()
    valid[:, n_alloc * page:] = False  # slots on the trash page
    if quant:
        kp, table = _paged(page, kc, page, n_alloc)
        vp, _ = _paged(page, vc, page, n_alloc)
        (kq, ks), (vq, vs) = _q8(kp), _q8(vp)
        args = (q, kq, ks, vq, vs, table, valid, 1)
        kernel, plain, mod_count = (paged_attn.paged_decode_attention_q8,
                                    paged_attn.paged_decode_attention_q8_ref, "LAUNCHES_Q8")
    else:
        kp, table = _paged(page, kc.to(dtype), page, n_alloc)
        vp, _ = _paged(page, vc.to(dtype), page, n_alloc)
        args = (q, kp, vp, table, valid, 1)
        kernel, plain, mod_count = (paged_attn.paged_decode_attention,
                                    paged_attn.paged_decode_attention_ref, "LAUNCHES")
    launches = getattr(paged_attn, mod_count)
    out = kernel(*args, scale=128 ** -0.5, attend_len=attend)
    ref = plain(*args, scale=128 ** -0.5, attend_len=attend)
    torch.cuda.synchronize()
    assert getattr(paged_attn, mod_count) == launches + 1
    assert bool(torch.isfinite(out).all())
    _assert_close(out, ref, dtype)


@pytest.mark.cuda
def test_paged_kernel_raises_on_a_ragged_attend():
    """The JAX kernel asserts attend_len % P == 0; the wrapper raises."""
    _need_card()
    q = torch.zeros((1, 4, 128), device="cuda")
    pool = torch.zeros((1, 3, 2, 64, 128), device="cuda")
    table = torch.ones((1, 2), dtype=torch.int32, device="cuda")
    valid = torch.ones((1, 128), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="multiple of the page size"):
        paged_attn.paged_decode_attention(q, pool, pool, table, valid, 0, scale=0.1,
                                          attend_len=100)


@pytest.mark.cuda
def test_prefill_on_the_card_never_takes_the_plain_path():
    """On CUDA tensors every linear-slot prefill goes to the flash wrapper,
    which raises on a head dim the kernel does not take (16 here) instead
    of running the plain attention silently."""
    _need_card()
    from mosstts_tpu_torch.core.config import tiny_qwen3
    from mosstts_tpu_torch.nn import qwen3 as tq

    cfg = tiny_qwen3()
    params = tq.init_qwen3_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                                  device="cuda", with_embed=False)
    cache = tq.init_kv_cache(cfg, 1, 32, dtype=torch.float32, device="cuda")
    x = torch.zeros((1, 8, cfg.hidden_size), device="cuda")
    pos = torch.arange(8, dtype=torch.int32, device="cuda")[None]
    with pytest.raises(ValueError, match="head_dim 16"):
        tq.qwen3_forward(params, cfg, x, positions=pos, cache=cache, cache_offset=0,
                         kv_valid=torch.ones((1, 32), dtype=torch.bool, device="cuda"))


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(1)
    t = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32))
    q, k, v = t(2, 5, 4, 64), t(2, 2, 9, 64), t(2, 2, 9, 64)
    valid = torch.ones((2, 9), dtype=torch.bool)
    counts = (flash.LAUNCHES, decode_attn.LAUNCHES)
    out = flash.flash_attention(q, k, v, valid, 3, scale=0.125, kv_major=True)
    torch.testing.assert_close(out, flash.flash_attention_ref(q, k, v, valid, 3, scale=0.125,
                                                              kv_major=True), rtol=0, atol=0)
    kc = t(3, 2, 2, 9, 64)
    out = decode_attn.decode_attention(q[:, 0], kc, kc, valid, 1, scale=0.125, attend_len=7)
    torch.testing.assert_close(out, decode_attn.decode_attention_ref(
        q[:, 0], kc, kc, valid, 1, scale=0.125, attend_len=7), rtol=0, atol=0)
    assert (flash.LAUNCHES, decode_attn.LAUNCHES) == counts

    # the int8 and paged wrappers, on CPU tensors, with no launch counted
    kq = torch.tensor(rng.integers(-127, 128, size=(3, 2, 2, 8, 64)), dtype=torch.int8)
    ks = torch.tensor(rng.random((3, 2, 2, 8)), dtype=torch.float32)
    qd = q[:, 0]
    counts = (decode_attn.LAUNCHES_Q8, paged_attn.LAUNCHES, paged_attn.LAUNCHES_Q8)
    out = decode_attn.decode_attention_q8(qd, kq, ks, kq, ks, valid, 1, scale=0.125, attend_len=8)
    torch.testing.assert_close(out, decode_attn.decode_attention_q8_ref(
        qd, kq, ks, kq, ks, valid, 1, scale=0.125, attend_len=8), rtol=0, atol=0)
    pool = torch.tensor(rng.integers(-127, 128, size=(3, 3, 2, 4, 64)), dtype=torch.int8)
    pscale = torch.tensor(rng.random((3, 3, 2, 4)), dtype=torch.float32)
    table = torch.tensor([[1, 0], [2, 1]], dtype=torch.int32)  # 3 pages of 4 slots
    out = paged_attn.paged_decode_attention(qd, pool.float(), pool.float(), table, valid, 0,
                                            scale=0.125, attend_len=8)
    torch.testing.assert_close(out, paged_attn.paged_decode_attention_ref(
        qd, pool.float(), pool.float(), table, valid, 0, scale=0.125, attend_len=8),
        rtol=0, atol=0)
    out = paged_attn.paged_decode_attention_q8(qd, pool, pscale, pool, pscale, table, valid, 2,
                                               scale=0.125, attend_len=8)
    torch.testing.assert_close(out, paged_attn.paged_decode_attention_q8_ref(
        qd, pool, pscale, pool, pscale, table, valid, 2, scale=0.125, attend_len=8),
        rtol=0, atol=0)
    assert (decode_attn.LAUNCHES_Q8, paged_attn.LAUNCHES, paged_attn.LAUNCHES_Q8) == counts


# ---------------------- int8-weight GEMMs (csrc/w8_gemm.cu) ----------------------

def _gemm_close(out, ref, absref, dtype):
    """Kernel vs plain for the GEMMs: both sum exact products in float32 in
    another order (within 1e-4 of the sum of the terms' magnitudes,
    ``absref``), and a bf16 output may round one ulp apart. Relative to the
    result alone would be wrong where the sum cancels to near zero."""
    err = (out.float() - ref.float()).abs()
    ulp = ULP[dtype] if dtype == torch.bfloat16 else 0.0
    bound = ulp * ref.float().abs() + 1e-4 * absref + 1e-6
    assert bool((err <= bound).all()), float(err.max())


def _int8(rng, *shape):
    return torch.tensor(rng.integers(-127, 128, size=shape).astype(np.int8)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,count", [(1, 256, 512, 1), (16, 4096, 1024, 1), (5, 512, 1025, 4),
                                         (40, 192, 96, 1), (640, 1024, 384, 1),
                                         (16, 4096, 12288, 1), (4, 4096, 1025, 32)])
def test_w8a16_kernel_matches_plain(out_dtype, M, K, N, count):
    """Decode (M <= 16, split K) and prefill (M > 16) tiles, ragged N (the
    1025-wide audio heads, byte loads), a stack of heads, and the 8B
    ``w_gate`` and audio-stack shapes."""
    _need_card()
    rng = np.random.default_rng(M + N)
    x = torch.tensor(rng.normal(size=(M, K)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = _int8(rng, *((count, K, N) if count > 1 else (K, N)))
    s = torch.tensor(rng.uniform(1e-3, 2e-2, size=q.shape[:-2] + (N,)).astype(np.float32)).cuda()
    launches = w8_gemm.LAUNCHES_W8A16
    out = w8_gemm.w8a16_gemm(x, q, s, out_dtype)
    ref = w8_gemm.w8a16_gemm_ref(x, q, s, out_dtype)
    absref = w8_gemm.w8a16_gemm_ref(x.abs(), q.abs(), s, torch.float32)
    torch.cuda.synchronize()
    assert w8_gemm.LAUNCHES_W8A16 == launches + 1
    assert out.shape == ref.shape and out.dtype == out_dtype
    _gemm_close(out, ref, absref, out_dtype)


@pytest.mark.cuda
def test_w8a16_reads_a_layer_of_the_stack_in_place():
    _need_card()
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(3, 256)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = _int8(rng, 4, 256, 128)
    s = torch.tensor(rng.uniform(1e-3, 2e-2, size=(4, 128)).astype(np.float32)).cuda()
    for li in (0, 3):
        out = w8_gemm.w8a16_gemm(x, q[li], s[li])
        ref = w8_gemm.w8a16_gemm_ref(x, q[li], s[li], torch.bfloat16)
        absref = w8_gemm.w8a16_gemm_ref(x.abs(), q[li].abs(), s[li], torch.float32)
        _gemm_close(out, ref, absref, torch.bfloat16)


@pytest.mark.cuda
def test_w8a16_leading_dims_and_shared_split_k_scratch():
    """A contiguous x (..., K) goes in as its rows (a strided one raises).
    Split-K launches on one stream share one scratch, inside a CUDA graph
    too: two products captured back to back replay to their eager results."""
    _need_card()
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(2, 3, 4096)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = _int8(rng, 2, 4096, 1024)
    s = torch.tensor(rng.uniform(1e-3, 2e-2, size=(2, 1024)).astype(np.float32)).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        w8_gemm.w8a16_gemm(x[:, 1:], q[0], s[0])
    eager = [w8_gemm.w8a16_gemm(x, q[i], s[i]) for i in (0, 1)]  # M = 6: split K
    for i in (0, 1):
        assert eager[i].shape == (2, 3, 1024)
        _gemm_close(eager[i], w8_gemm.w8a16_gemm_ref(x, q[i], s[i], torch.bfloat16),
                    w8_gemm.w8a16_gemm_ref(x.abs(), q[i].abs(), s[i], torch.float32),
                    torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in (0, 1):
            w8_gemm.w8a16_gemm(x, q[i], s[i])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [w8_gemm.w8a16_gemm(x, q[i], s[i]) for i in (0, 1)]
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(8, 256, 512), (1, 512, 1024), (128, 4096, 12288)])
def test_w8a8_kernel_matches_plain(M, K, N):
    _need_card()
    rng = np.random.default_rng(K)
    x = torch.tensor(rng.normal(size=(M, K)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = _int8(rng, K, N)
    s = torch.tensor(rng.uniform(1e-3, 2e-2, size=(N,)).astype(np.float32)).cuda()
    launches = w8_gemm.LAUNCHES_W8A8
    out = w8_gemm.w8a8_gemm(x, q, s)
    ref = w8_gemm.w8a8_gemm_ref(x, q, s)
    x8, xs = w8_gemm.quant_rows(x)
    absref = w8_gemm.w8a16_gemm_ref(x8.abs().to(torch.bfloat16), q.abs(), s, torch.float32) * xs
    torch.cuda.synchronize()
    assert w8_gemm.LAUNCHES_W8A8 == launches + 1
    _gemm_close(out, ref, absref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,N", [(4, 64, 24 * 16), (16, 512, 1000), (64, 4096, 12288)])
def test_int4_kernel_matches_plain(M, D, N):
    _need_card()
    rng = np.random.default_rng(D)
    x = torch.tensor(rng.normal(size=(M, D)).astype(np.float32)).cuda().to(torch.bfloat16)
    packed = torch.tensor(rng.integers(-128, 128, size=(D // 2, N)).astype(np.int8)).cuda()
    launches = w8_gemm.LAUNCHES_INT4
    out = w8_gemm.int4_gemm(x, packed)
    ref = w8_gemm.int4_gemm_ref(x, packed)
    lo, hi = w8_gemm.unpack_int4(packed)
    xa = x.float().abs()
    absref = xa[:, :D // 2] @ lo.float().abs() + xa[:, D // 2:] @ hi.float().abs()
    torch.cuda.synchronize()
    assert w8_gemm.LAUNCHES_INT4 == launches + 1
    _gemm_close(out, ref, absref, torch.float32)


@pytest.mark.cuda
def test_int8_dense_and_heads_on_the_card():
    """``dense`` on an int8 weight with bf16 activations is one W8A16 launch;
    with f32 activations it raises. The stacked audio heads are one launch
    for all of them, with f32 logits."""
    _need_card()
    from mosstts_tpu_torch.models.delay import _audio_head_logits
    from mosstts_tpu_torch.ops.basic import dense
    from mosstts_tpu_torch.ops.quant import quantize_weight

    rng = np.random.default_rng(3)
    w = quantize_weight(torch.tensor(rng.normal(size=(2, 128, 256)).astype(np.float32)).cuda())
    x = torch.tensor(rng.normal(size=(2, 3, 128)).astype(np.float32)).cuda()
    launches = w8_gemm.LAUNCHES_W8A16
    y = dense(x.to(torch.bfloat16), w[1])
    assert y.shape == (2, 3, 256) and y.dtype == torch.bfloat16
    assert w8_gemm.LAUNCHES_W8A16 == launches + 1
    with pytest.raises(TypeError, match="bf16 activations"):
        dense(x, w[1])
    heads = quantize_weight(torch.tensor(rng.normal(size=(32, 128, 1025)).astype(np.float32)).cuda())
    launches = w8_gemm.LAUNCHES_W8A16
    logits = _audio_head_logits(x.to(torch.bfloat16), heads)
    torch.cuda.synchronize()
    assert w8_gemm.LAUNCHES_W8A16 == launches + 1
    assert logits.shape == (2, 3, 32, 1025) and logits.dtype == torch.float32
    ref = w8_gemm.w8a16_gemm_ref(x.reshape(6, 128).to(torch.bfloat16), heads.q, heads.scale,
                                 torch.float32).reshape(2, 3, 32, 1025)
    absref = w8_gemm.w8a16_gemm_ref(x.reshape(6, 128).abs().to(torch.bfloat16), heads.q.abs(),
                                    heads.scale, torch.float32).reshape(2, 3, 32, 1025)
    _gemm_close(logits, ref, absref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("attend", [37, 256, 512])
def test_decode_q8t_kernel_matches_plain(sdt, dtype, attend):
    _need_card()
    rng = np.random.default_rng(attend)
    g = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda()
    q = g(4, 32, 128).to(dtype)
    (kq, ks), (vq, vs) = _q8(g(3, 4, 8, 512, 128)), _q8(g(3, 4, 8, 512, 128))
    valid = torch.tensor(rng.random((4, 512)) < 0.7).cuda()
    args = (q, kq, ks.to(sdt), vq, vs.to(sdt), valid, 2)
    launches = decode_attn.LAUNCHES_Q8T
    out = decode_attn.decode_attention_q8t(*args, scale=128 ** -0.5, attend_len=attend)
    ref = decode_attn.decode_attention_q8t_ref(*args, scale=128 ** -0.5, attend_len=attend)
    torch.cuda.synchronize()
    assert decode_attn.LAUNCHES_Q8T == launches + 1
    _assert_close(out, ref, dtype)
