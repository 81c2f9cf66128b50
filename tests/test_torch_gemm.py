"""The plain versions of the int8-weight GEMM kernels (``ops/kernels/w8_gemm``)
and of ``decode_attention_q8t`` against the JAX package and the JAX tools
on CPU (the CUDA kernels themselves are held against these plain versions
by ``tests/test_torch_kernels_cuda.py`` on the card).

* W8A16 against JAX ``dense`` and ``_audio_head_logits`` on a
  ``QuantWeight`` (f32: summation order only, 1e-5).
* The port's ``tools/tune_mm8.py`` walks against the JAX tool's ``mm8``,
  ``mm8_omajor`` and ``mm8_w8a8`` in interpret mode (the JAX tool is loaded
  by path: ``tools/`` is no package).
* int4 against a numpy transcription of ``tools/probe_int4.py::_mm4_kernel``.
* ``decode_attention_q8t`` against JAX's in interpret mode, scales packed by
  ``pack_kv_scales``, within 0.02 (the JAX test's bf16 tolerance,
  ``tests/test_decode_attn.py:243``: the TPU kernel rounds q and p to bf16,
  the port does not), and with f32 scales against an exact float64
  reference within 1e-5.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.models import delay as jd
from mosstts_tpu.ops import basic as jbasic
from mosstts_tpu.ops import quant as jq
from mosstts_tpu.ops.pallas import decode_attn as jda
from mosstts_tpu_torch.ops import quant as tq
from mosstts_tpu_torch.ops.kernels import decode_attn, w8_gemm
from mosstts_tpu_torch.tools import probe_int4, tune_mm8

REPO = Path(__file__).resolve().parent.parent


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("stacked", [False, True])
def test_w8a16_plain_matches_jax_dense_and_heads(stacked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    shape = (3, 64, 40) if stacked else (64, 40)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(torch.tensor(w))
    got = w8_gemm.w8a16_gemm(torch.tensor(x), tw.q, tw.scale, torch.float32)
    if stacked:
        want = np.asarray(jd._audio_head_logits(jnp.asarray(x)[None], jw))[0]  # (5, 3, 40)
    else:
        want = np.asarray(jbasic.dense(jnp.asarray(x), jw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stacked", [False, True])
def test_w8a16_plain_takes_leading_dims(stacked):
    """x (B, T, K) gives (B, T, N), or (B, T, count, N) for a stack, as JAX's
    ``dense`` and ``_audio_head_logits`` do on a (B, T, D) hidden state."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((3, 64, 40) if stacked else (64, 40)).astype(np.float32) * 0.05
    jw, tw = jq.quantize_weight(jnp.asarray(w)), tq.quantize_weight(torch.tensor(w))
    got = w8_gemm.w8a16_gemm(torch.tensor(x), tw.q, tw.scale, torch.float32)
    want = np.asarray((jd._audio_head_logits if stacked else jbasic.dense)(jnp.asarray(x), jw))
    assert got.shape == want.shape == ((2, 3, 3, 40) if stacked else (2, 3, 40))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("walk", ["mm8", "mm8_omajor", "mm8_w8a8"])
def test_tune_mm8_walks_match_the_jax_tool(walk):
    tool = _jax_tool("tune_mm8")
    L, D, O, B = 2, 256, 512, 8
    rng = np.random.default_rng(4)
    w8 = rng.integers(-127, 128, (L, D, O)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, (L, O)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((B, D)), jnp.bfloat16)
    jargs = (x, jnp.asarray(w8), jnp.asarray(scale))
    if walk == "mm8":
        want = tool.mm8(*jargs, td=128, to=128, interpret=True)(*jargs)
    elif walk == "mm8_omajor":
        want = tool.mm8_omajor(*jargs, to=128, interpret=True)(*jargs)
    else:
        want = tool.mm8_w8a8(*jargs, td=128, to=128, interpret=True)(*jargs)
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    got = getattr(tune_mm8, walk)(xt, torch.tensor(w8), torch.tensor(scale))
    want = np.asarray(want)
    assert got.shape == want.shape == (B, L)
    # both sum exact products in f32 in another order; tanh -> bf16 between
    # layers may round one value a bf16 ulp apart
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2 * np.abs(want).max())
    ref = tune_mm8.xla_ref(xt, torch.tensor(w8), torch.tensor(scale))
    if walk != "mm8_w8a8":
        torch.testing.assert_close(got, ref, rtol=0, atol=0)  # one plain version on the CPU


def _mm4_numpy(x: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """``tools/probe_int4.py::_mm4_kernel`` over the whole array at once."""
    pk = packed.astype(np.int32)
    lo = np.bitwise_and(pk, 15)
    lo = lo - 16 * (lo >> 3)
    hi = np.bitwise_and(pk >> 4, 15)
    hi = hi - 16 * (hi >> 3)
    h = packed.shape[0]
    xf = x.astype(np.float64)
    return (xf[:, :h] @ lo.astype(np.float64) + xf[:, h:] @ hi.astype(np.float64))


def test_int4_plain_matches_the_probe_kernel():
    rng = np.random.default_rng(5)
    packed = rng.integers(-128, 128, (32, 24)).astype(np.int8)
    x = torch.tensor(rng.standard_normal((4, 64)).astype(np.float32)).to(torch.bfloat16)
    got = w8_gemm.int4_gemm(x, torch.tensor(packed))
    want = _mm4_numpy(x.float().numpy(), packed)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    lo, hi = w8_gemm.unpack_int4(torch.tensor(np.array([[0x7F, -1, 0x08, -128]], np.int8)))
    assert lo.tolist() == [[-1, -1, -8, 0]] and hi.tolist() == [[7, -1, 0, -8]]
    # the probe's walk over stacked layers
    stack = torch.tensor(rng.integers(-128, 128, (3, 32, 24)).astype(np.int8))
    walk = probe_int4.walk_p4(x, stack)
    want = sum(_mm4_numpy(x.float().numpy(), s.numpy()) for s in stack)
    np.testing.assert_allclose(walk.numpy(), want, rtol=1e-5, atol=1e-4)


def test_w8a8_quant_rows_matches_the_jax_tool():
    rng = np.random.default_rng(6)
    h = rng.standard_normal((4, 64)).astype(np.float32)
    h[2] = 0.0  # the 1e-8 floor
    hb = torch.tensor(h).to(torch.bfloat16)
    jh = jnp.asarray(hb.float().numpy(), jnp.bfloat16)
    m = jnp.max(jnp.abs(jh.astype(jnp.float32)), axis=1, keepdims=True)
    s = jnp.maximum(m, 1e-8) / 127.0
    q8 = jnp.clip(jnp.round(jh.astype(jnp.float32) / s), -127, 127).astype(jnp.int8)
    t8, ts = w8_gemm.quant_rows(hb)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(q8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_q8t_plain_matches_jax(sdt):
    """Against JAX's ``decode_attention_q8t`` (interpret mode, scales packed
    by ``pack_kv_scales``) within 0.02, the JAX test's bf16 tolerance: the
    TPU kernel rounds q and p to bf16 whatever the scales' dtype, the port
    does not. With f32 scales also against an exact float64 dequantize-then-
    attend within 1e-5, and equal to ``decode_attention_q8``'s plain version."""
    rng = np.random.default_rng(7)
    L, B, KV, S, hd, H = 2, 2, 2, 256, 64, 4
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((L, B, KV, S, hd)).astype(np.float32)
    vc = rng.standard_normal((L, B, KV, S, hd)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    valid[:, 0] = True

    def quant(c):
        sc = np.maximum(np.abs(c).max(-1), 1e-8) / 127.0
        return np.clip(np.round(c / sc[..., None]), -127, 127).astype(np.int8), sc.astype(np.float32)

    (kq, ks), (vq, vs) = quant(kc), quant(vc)
    jdt = getattr(jnp, sdt)
    want = jda.decode_attention_q8t(
        jnp.asarray(q), jnp.asarray(kq), jda.pack_kv_scales(jnp.asarray(ks), 128, dtype=jdt),
        jnp.asarray(vq), jda.pack_kv_scales(jnp.asarray(vs), 128, dtype=jdt),
        jnp.asarray(valid), jnp.int32(1), scale=hd ** -0.5, attend_len=256, block_s=128,
        interpret=True)
    tdt = getattr(torch, sdt)
    args = (torch.tensor(q), torch.tensor(kq), torch.tensor(ks).to(tdt), torch.tensor(vq),
            torch.tensor(vs).to(tdt), torch.tensor(valid), 1)
    launches = decode_attn.LAUNCHES_Q8T
    got = decode_attn.decode_attention_q8t(*args, scale=hd ** -0.5, attend_len=256)
    assert decode_attn.LAUNCHES_Q8T == launches  # CPU tensors: the plain version
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 0.02
    if sdt == "bfloat16":
        return
    k = kq[1].astype(np.float64) * ks[1][..., None]  # (B, KV, S, hd)
    v = vq[1].astype(np.float64) * vs[1][..., None]
    qg = q.astype(np.float64).reshape(B, KV, H // KV, hd) * hd ** -0.5
    sc = np.where(valid[:, None, None], np.einsum("bkgh,bksh->bkgs", qg, k), -1e30)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    exact = np.einsum("bkgs,bksh->bkgh", p / p.sum(-1, keepdims=True), v).reshape(B, H, hd)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, decode_attn.decode_attention_q8_ref(
        *args, scale=hd ** -0.5, attend_len=256), rtol=0, atol=0)


def test_cpu_gemm_wrappers_take_the_plain_versions():
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((3, 32)).astype(np.float32)).to(torch.bfloat16)
    q = torch.tensor(rng.integers(-127, 128, (2, 32, 16)).astype(np.int8))
    s = torch.tensor(rng.uniform(0.001, 0.02, (2, 16)).astype(np.float32))
    counts = (w8_gemm.LAUNCHES_W8A16, w8_gemm.LAUNCHES_W8A8, w8_gemm.LAUNCHES_INT4)
    torch.testing.assert_close(w8_gemm.w8a16_gemm(x, q, s, torch.float32),
                               w8_gemm.w8a16_gemm_ref(x, q, s, torch.float32), rtol=0, atol=0)
    torch.testing.assert_close(w8_gemm.w8a8_gemm(x, q[0], s[0]),
                               w8_gemm.w8a8_gemm_ref(x, q[0], s[0]), rtol=0, atol=0)
    packed = q[0, :16]  # x's 32 columns are two halves of 16
    torch.testing.assert_close(w8_gemm.int4_gemm(x, packed), w8_gemm.int4_gemm_ref(x, packed),
                               rtol=0, atol=0)
    assert (w8_gemm.LAUNCHES_W8A16, w8_gemm.LAUNCHES_W8A8, w8_gemm.LAUNCHES_INT4) == counts
    # split-K sizing: enough blocks for two waves, at most 16 ways, whole k tiles
    assert w8_gemm.split_k(16, 4096, 96, 132) == (3, 1408)
    assert w8_gemm.split_k(1, 4096, 8, 132) == (16, 256)
    assert w8_gemm.split_k(640, 4096, 960, 132) == (1, 4096)
