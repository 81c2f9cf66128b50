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
from mosstts_tpu_torch.tools import kernel_inputs

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
    1025-wide audio heads unpadded, byte loads), a stack of heads, and the
    8B ``w_gate`` and audio-stack shapes."""
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
    Split-K launches keep their partials in the cluster's shared memory (no
    scratch): two products captured back to back in a CUDA graph replay to
    their eager results."""
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
@pytest.mark.parametrize("M", [1, 5, 16, 17, 64, 96, 128, 640])
@pytest.mark.parametrize("N,padded", [(1024, False), (1025, True), (1025, False), (4096, False)])
def test_w8a16_stack_repeats_bit_for_bit(M, N, padded):
    """A stack of 32 weights at every row tile (M = 1-640), N a multiple of
    16, 1025 at a 16-byte row pitch (``QuantWeight``'s layout: 16-byte
    loads and the packed remainder columns) and 1025 unpadded (byte loads,
    counted in ``LAUNCHES_W8A16_BYTES``): the plain version's result, one
    launch per call, and the same bits in two eager calls and a CUDA-graph
    replay."""
    _need_card()
    from mosstts_tpu_torch.ops.quant import pitched

    rng = np.random.default_rng(M * 7 + N + padded)
    K, count = 512, 32
    x = torch.tensor(rng.normal(size=(M, K)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = _int8(rng, count, K, N)
    if padded:
        q = pitched(q)
        assert q.stride(-2) == 1040 and not q.is_contiguous()
    s = torch.tensor(rng.uniform(1e-3, 2e-2, size=(count, N)).astype(np.float32)).cuda()
    launches, byte_launches = w8_gemm.LAUNCHES_W8A16, w8_gemm.LAUNCHES_W8A16_BYTES
    first = w8_gemm.w8a16_gemm(x, q, s, torch.float32)
    assert w8_gemm.LAUNCHES_W8A16 == launches + 1
    assert w8_gemm.LAUNCHES_W8A16_BYTES == byte_launches + (N % 16 != 0 and not padded)
    second = w8_gemm.w8a16_gemm(x, q, s, torch.float32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8_gemm.w8a16_gemm(x, q, s, torch.float32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = w8_gemm.w8a16_gemm(x, q, s, torch.float32)
    graph.replay()
    torch.cuda.synchronize()
    _gemm_close(first, w8_gemm.w8a16_gemm_ref(x, q, s, torch.float32),
                w8_gemm.w8a16_gemm_ref(x.abs(), q.abs(), s, torch.float32), torch.float32)
    assert torch.equal(first, second) and torch.equal(first, replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,count", [(1, 4096, 1024, 1), (16, 4096, 12288, 1),
                                         (16, 4096, 1025, 32), (96, 4096, 4096, 1),
                                         (640, 1024, 4096, 1)])
def test_w8a16_is_one_device_kernel_per_call(M, K, N, count):
    """Split K is summed inside the launch: one device kernel per call,
    no reduce pass (``torch.profiler``'s device events, in a
    ``profile_step.device_profile`` session, whose opening burst of
    throwaway kernels takes the records a session can lose)."""
    _need_card()
    from mosstts_tpu_torch.ops.quant import quantize_weight
    from mosstts_tpu_torch.tools.profile_step import device_profile

    rng = np.random.default_rng(M + N)
    x = torch.tensor(rng.normal(size=(M, K)).astype(np.float32)).cuda().to(torch.bfloat16)
    w = quantize_weight(torch.tensor(rng.normal(size=((count,) if count > 1 else ()) + (K, N))
                                     .astype(np.float32)).cuda())
    w8_gemm.w8a16_gemm(x, w.q, w.scale)  # plan cached, library loaded
    torch.cuda.synchronize()
    with device_profile(cpu=True) as prof:
        for _ in range(3):
            w8_gemm.w8a16_gemm(x, w.q, w.scale)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if "mosstts" in e.key]
    assert sum(e.count for e in kernels) == 3, (
        [(e.key[:80], e.count) for e in device],
        [(e.key, e.count) for e in events if "Launch" in e.key])
    assert all("ring_kernel" in e.key for e in kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,M", [("w8a8", 16), ("w8a8", 128), ("int4", 1), ("int4", 64)])
def test_w8a8_and_int4_are_one_gemm_kernel_per_call(mode, M):
    """The split of K is summed inside the launch: a W8A8 call is its row
    quantization and one ``ring_kernel``, an int4 call one ``ring_kernel``,
    no reduce pass, in a ``profile_step.device_profile`` session (as the
    W8A16 test above)."""
    _need_card()
    from mosstts_tpu_torch.tools.profile_step import device_profile

    rng = np.random.default_rng(M)
    x = torch.tensor(rng.normal(size=(M, 4096)).astype(np.float32)).cuda().to(torch.bfloat16)
    if mode == "w8a8":
        q = _int8(rng, 4096, 4096)
        s = torch.tensor(rng.uniform(1e-3, 2e-2, size=(4096,)).astype(np.float32)).cuda()
        call = (lambda: w8_gemm.w8a8_gemm(x, q, s))
    else:
        q = _int8(rng, 2048, 4096)
        call = (lambda: w8_gemm.int4_gemm(x, q))
    call()  # plan cached, library loaded
    torch.cuda.synchronize()
    with device_profile(cpu=True) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "mosstts" in e.key}
    ring = sum(c for k, c in kernels.items() if "ring_kernel" in k)
    quant = sum(c for k, c in kernels.items() if "quant_rows_kernel" in k)
    rows_pass = mode == "w8a8"
    assert (ring, quant, sum(kernels.values())) == (3, 3 * rows_pass, 3 + 3 * rows_pass), kernels


@pytest.mark.cuda
def test_w8a16_unaligned_rows_take_the_byte_path():
    """Rows whose pitch or address is not a multiple of 16 bytes take the
    byte-loaded form of the kernel (the wrapper's documented rule) and agree
    with the plain version; an aligned view of the same buffer takes 16-byte
    loads."""
    _need_card()
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.normal(size=(4, 256)).astype(np.float32)).cuda().to(torch.bfloat16)
    buf = _int8(rng, 256, 224)  # rows 224 bytes apart
    s = torch.tensor(rng.uniform(1e-3, 2e-2, size=(192,)).astype(np.float32)).cuda()
    for q, byte_path in ((buf[:, 8:], True), (buf[:, 1:193], True), (buf[:, 16:], False)):
        q = q[:, :192]
        before = w8_gemm.LAUNCHES_W8A16_BYTES
        out = w8_gemm.w8a16_gemm(x, q, s)
        torch.cuda.synchronize()
        assert w8_gemm.LAUNCHES_W8A16_BYTES == before + byte_path
        _gemm_close(out, w8_gemm.w8a16_gemm_ref(x, q, s, torch.bfloat16),
                    w8_gemm.w8a16_gemm_ref(x.abs(), q.abs(), s, torch.float32), torch.bfloat16)


GEMM_TOOL_SHAPES = [(1, 512, 1024, 1), (8, 256, 512, 1), (16, 4096, 1024, 1), (96, 1024, 1000, 1),
                    (128, 4096, 12288, 1), (200, 512, 384, 1), (16, 512, 1000, 3),
                    (40, 256, 512, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,count", GEMM_TOOL_SHAPES)
def test_w8a8_kernel_matches_plain(M, K, N, count):
    """Decode, one row tile up to 128 rows (the tool's B=128 at its (4096,
    12288)) and several beyond, a stack of weights, an N that is no
    multiple of the column tile or of 16 (byte loads): the plain version's
    result from two device kernels (a captured call's graph holds two
    kernel nodes), the row quantization and one product."""
    _need_card()
    rng = np.random.default_rng(K + M + count)
    x = torch.tensor(rng.normal(size=(M, K)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = _int8(rng, *((count, K, N) if count > 1 else (K, N)))
    s = torch.tensor(rng.uniform(1e-3, 2e-2, size=q.shape[:-2] + (N,)).astype(np.float32)).cuda()
    launches = w8_gemm.LAUNCHES_W8A8
    out = w8_gemm.w8a8_gemm(x, q, s)
    assert w8_gemm.LAUNCHES_W8A8 == launches + 1
    assert kernel_inputs.graph_kernels(lambda: w8_gemm.w8a8_gemm(x, q, s)) == (2, 2)
    ref = w8_gemm.w8a8_gemm_ref(x, q, s)
    x8, xs = w8_gemm.quant_rows(x)
    qa = q.abs() if count > 1 else q.abs()[None]
    absref = torch.stack([w8_gemm.w8a16_gemm_ref(x8.abs().to(torch.bfloat16), qa[i],
                                                 s.reshape(-1, N)[i], torch.float32) * xs
                          for i in range(count)], 1).reshape(ref.shape)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    _gemm_close(out, ref, absref, torch.float32)


def _int4_ref(x, packed):
    """The plain int4 product of each weight of a stack, (M, count, N)."""
    stack = packed if packed.dim() == 3 else packed[None]
    D = x.shape[1]
    lo, hi = w8_gemm.unpack_int4(stack)
    xa = x.float().abs()
    ref = torch.stack([w8_gemm.int4_gemm_ref(x, p) for p in stack], 1)
    absref = torch.stack([xa[:, :D // 2] @ lo[i].float().abs() + xa[:, D // 2:] @ hi[i].float().abs()
                          for i in range(len(stack))], 1)
    return (ref, absref) if packed.dim() == 3 else (ref[:, 0], absref[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,N,count", [(4, 64, 384, 1)] + [(M, 2 * K, N, c) for M, K, N, c
                                                             in GEMM_TOOL_SHAPES if M != 128]
                         + [(64, 4096, 12288, 1), (128, 1024, 512, 1)])
def test_int4_kernel_matches_plain(M, D, N, count):
    """As the W8A8 test, and the tool's B=64 at (2048, 12288) packed: one
    device kernel (one kernel node in a captured call's graph)."""
    _need_card()
    rng = np.random.default_rng(D + M + count)
    x = torch.tensor(rng.normal(size=(M, D)).astype(np.float32)).cuda().to(torch.bfloat16)
    packed = torch.tensor(rng.integers(-128, 128, size=((count,) if count > 1 else ()) + (D // 2, N))
                          .astype(np.int8)).cuda()
    launches = w8_gemm.LAUNCHES_INT4
    out = w8_gemm.int4_gemm(x, packed)
    assert w8_gemm.LAUNCHES_INT4 == launches + 1
    assert kernel_inputs.graph_kernels(lambda: w8_gemm.int4_gemm(x, packed)) == (1, 1)
    ref, absref = _int4_ref(x, packed)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    _gemm_close(out, ref, absref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [16, 128])
def test_w8a8_and_int4_replay_in_a_graph(M):
    """Two different products of each mode, split K (the clusters' partials
    in shared memory, no scratch) and not, captured back to back in one
    CUDA graph: each replays to its eager result bit for bit, twice."""
    _need_card()
    rng = np.random.default_rng(M)
    x = torch.tensor(rng.normal(size=(M, 4096)).astype(np.float32)).cuda().to(torch.bfloat16)
    q = [_int8(rng, 2048 * (i + 1), 1024 * (2 - i)) for i in (0, 1)]
    s = [torch.tensor(rng.uniform(1e-3, 2e-2, size=(1024 * (2 - i),)).astype(np.float32)).cuda()
         for i in (0, 1)]
    xs = [x[:, :2048], x]
    calls = [lambda: w8_gemm.w8a8_gemm(xs[0], q[0], s[0]),
             lambda: w8_gemm.w8a8_gemm(xs[1], q[1], s[1]),
             lambda: w8_gemm.int4_gemm(xs[1], q[0]),
             lambda: w8_gemm.int4_gemm(xs[0], q[1][:1024])]
    splits = [w8_gemm.gemm_plan(M, 2048 * (i + 1), 1024 * (2 - i), 1, 132, mode=w8_gemm.W8A8)
              .splits for i in (0, 1)]
    assert max(splits) > 1
    eager = [f() for f in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [f() for f in calls]
    for _ in range(2):
        for g in got:
            g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(got, eager):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_int8_dense_and_heads_on_the_card():
    """``dense`` on an int8 weight with bf16 activations is one W8A16 launch;
    with f32 activations one ``w8f32_gemm`` call (the F32X3 mode), equal to
    the call itself; with other types it raises. The stacked audio heads are
    one launch for all of them, with f32 logits."""
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
    launches = w8_gemm.LAUNCHES_W8F32
    y32 = dense(x, w[1])
    assert w8_gemm.LAUNCHES_W8F32 == launches + 1 and y32.dtype == torch.float32
    torch.testing.assert_close(y32, w8_gemm.w8f32_gemm(x, w[1].q, w[1].scale), rtol=0, atol=0)
    with pytest.raises(TypeError, match="bf16 or float32 activations"):
        dense(x.half(), w[1])
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


# ------------- the redesigned attention kernels at their edges -------------

def _bf16(rng, *shape):
    return torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda().to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_major", [False, True])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 63, 64, 65, 160, 480])
def test_flash_tensor_core_tile_edges(T, kv_major):
    """bf16 flash (the tensor-core body) at the edges of its 64-row query
    tile (16 rows of each of G=4 heads) and its 64-slot K/V tile: S is not a
    multiple of 64, q_start is 37 (a host int for even T, a device int32 for
    odd T), rows are left-padded; k/v are the prompt's own (B, S, KV, hd) or
    kv-major over 1024 cache slots."""
    _need_card()
    rng = np.random.default_rng(T)
    B, H, KV, hd, q_start = 2, 8, 2, 128, 37
    S = 1024 if kv_major else q_start + T
    q = _bf16(rng, B, T, H, hd)
    k, v = (_bf16(rng, B, KV, S, hd) if kv_major else _bf16(rng, B, S, KV, hd) for _ in "kv")
    valid = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    for b, pad in enumerate((0, 5)):
        valid[b, pad:q_start + T] = True
    qs = q_start if T % 2 == 0 else torch.tensor([q_start], dtype=torch.int32, device="cuda")
    kw = dict(scale=hd ** -0.5, kv_major=kv_major)
    launches = flash.LAUNCHES
    out = flash.flash_attention(q, k, v, valid, qs, **kw)
    ref = flash.flash_attention_ref(q, k, v, valid, q_start, **kw)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == launches + 1
    _assert_close(out, ref, torch.bfloat16, rows=valid[:, q_start:q_start + T])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,H,KV,window", [(64, 8, 2, None), (64, 12, 4, 20), (128, 32, 8, 50),
                                            (128, 12, 4, None), (256, 8, 2, None),
                                            (256, 4, 2, 33)])
def test_flash_head_dims_groups_and_windows(dtype, hd, H, KV, window):
    """Every head dim in both bodies (bf16: tensor cores; f32: CUDA cores),
    G = 4 and G = 3 (a 64-row tile then splits a query's heads), sliding
    windows (the bf16 walk starts at the first tile any row sees), kv-major
    over 300 slots, T = 97, q_start 111 on the device."""
    _need_card()
    rng = np.random.default_rng(hd + H)
    B, T, S, q_start = 2, 97, 300, 111
    g = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
    q, k, v = g(B, T, H, hd), g(B, KV, S, hd), g(B, KV, S, hd)
    valid = torch.zeros((B, S), dtype=torch.bool, device="cuda")
    valid[0, 3:q_start + T] = True
    valid[1, 60:q_start + T] = True
    qs = torch.tensor([q_start], dtype=torch.int32, device="cuda")
    kw = dict(scale=hd ** -0.5, window=window, kv_major=True)
    out = flash.flash_attention(q, k, v, valid, qs, **kw)
    ref = flash.flash_attention_ref(q, k, v, valid, q_start, **kw)
    torch.cuda.synchronize()
    _assert_close(out, ref, dtype, rows=valid[:, q_start:q_start + T])


def _page_size(attend):
    """The largest page of at most 128 slots that divides ``attend``."""
    return next(p for p in (128, 64, 32, 16, 8, 4, 2, 1) if attend % p == 0)


_DECODE_CASE = {}


def _decode_case(B, P):
    """bf16 (L=2, B, KV=8, 1024, hd=128) caches, their int8 form, and both
    laid into a shuffled pool of P-slot pages in which odd rows leave every
    other logical page on the poisoned trash page 0 (kv_valid masks those
    slots). Cached: the edge tests share one case per (B, P)."""
    key = (B, P)
    if key not in _DECODE_CASE:
        _DECODE_CASE.clear()
        rng = np.random.default_rng(B * 1000 + P)
        S, mp = 1024, 1024 // P
        kc, vc = _bf16(rng, 2, B, 8, S, 128), _bf16(rng, 2, B, 8, S, 128)
        valid = torch.tensor(rng.random((B, S)) < 0.7).cuda()
        valid[:, 0] = True
        perm = rng.permutation(np.arange(1, 1 + B * mp)).reshape(B, mp)
        for b in range(1, B, 2):
            perm[b, 1::2] = 0
            valid[b].view(mp, P)[1::2] = False
        table = torch.tensor(perm, dtype=torch.int32, device="cuda")
        (kq, ks), (vq, vs) = _q8(kc), _q8(vc)
        pool = lambda x, fill: paged_attn.scatter_pages(x, table, 1 + B * mp, fill)
        q = _bf16(rng, B, 32, 128)
        _DECODE_CASE[key] = dict(
            decode=(decode_attn.decode_attention, decode_attn.decode_attention_ref,
                    (q, kc, vc, valid, 1)),
            decode_q8=(decode_attn.decode_attention_q8, decode_attn.decode_attention_q8_ref,
                       (q, kq, ks, vq, vs, valid, 1)),
            decode_q8t=(decode_attn.decode_attention_q8t, decode_attn.decode_attention_q8t_ref,
                        (q, kq, ks.to(torch.bfloat16), vq, vs.to(torch.bfloat16), valid, 1)),
            paged=(paged_attn.paged_decode_attention, paged_attn.paged_decode_attention_ref,
                   (q, pool(kc, 1e4), pool(vc, 1e4), table, valid, 1)),
            paged_q8=(paged_attn.paged_decode_attention_q8,
                      paged_attn.paged_decode_attention_q8_ref,
                      (q, pool(kq, 127), pool(ks, 1e4), pool(vq, 127), pool(vs, 1e4), table,
                       valid, 1)),
        )
    return _DECODE_CASE[key]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["decode", "decode_q8", "decode_q8t", "paged", "paged_q8"])
@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("attend", [1, 31, 32, 33, 255, 257, 1024])
def test_decode_kernels_at_cluster_edges(variant, B, attend):
    """The five decode kernels (one clustered launch each) at ragged attend
    lengths: one slot, a chunk short of, at and past a 32-slot block step,
    clusters of 1-8 blocks whose last rank is partly empty, the whole cache;
    batch 1 (8 clusters), 4 and 16; paged at the largest page size dividing
    attend_len, with attended pages on the poisoned trash page."""
    _need_card()
    kernel, plain, args = _decode_case(B, _page_size(attend))[variant]
    out = kernel(*args, scale=128 ** -0.5, attend_len=attend)
    ref = plain(*args, scale=128 ** -0.5, attend_len=attend)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _assert_close(out, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["decode", "decode_q8", "decode_q8t", "paged", "paged_q8",
                                     "flash"])
def test_attention_kernels_repeat_bit_for_bit(variant):
    """The same inputs twice give bit-equal outputs (the cluster merge reads
    its ranks in a fixed order; nothing is atomic), eagerly and replayed
    from a CUDA graph."""
    _need_card()
    if variant == "flash":
        rng = np.random.default_rng(9)
        q, k, v = _bf16(rng, 4, 160, 32, 128), _bf16(rng, 4, 8, 512, 128), _bf16(rng, 4, 8, 512, 128)
        valid = torch.ones((4, 512), dtype=torch.bool, device="cuda")
        valid[1, :17] = False
        fn = lambda: flash.flash_attention(q, k, v, valid, 0, scale=128 ** -0.5, kv_major=True)
    else:
        kernel, _, args = _decode_case(16, 128)[variant]
        fn = lambda: kernel(*args, scale=128 ** -0.5, attend_len=1024)
    first, second = fn(), fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, replayed)
