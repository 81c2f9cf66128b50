"""The port's parallel paths and W8A16's float32-activation mode on the
card. They skip without one (the CPU tests hold the same paths against JAX
in gloo processes: ``tests/test_torch_parallel_*.py``).

* One NCCL rank (a group of world size 1 in this process): a small float32
  ``DelayEngine`` and a 2-slot ``DelayBatchServer`` with
  ``mesh=make_mesh(data=1, model=1)``, graphs on, equal the unsharded ones
  bit for bit, greedy, and their steps' collectives run inside the
  replayed graphs.
* Two NCCL ranks, spawned (skips unless two cards are visible): the same
  engine tensor-parallel over both cards, its greedy grids equal to the
  unsharded engine's.
* ``w8f32_gemm`` (the ring kernel's F32X3 mode) against its plain version
  at ``codec_1p6b()``'s shapes and a few ragged ones, bit-equal over two
  calls, at most two device kernels a call; ``dense`` sends float32
  activations to it. Through an identity weight its output is the sum of
  x's three bf16 terms bit for bit (x itself wherever the last term is a
  normal bf16), over the CPU tests' five input families and inf and NaN.
* ``delay_decode_step(text_lazy=True)`` captured into a CUDA graph (a
  condition kernel and an IF node per branch) equals the eager lazy step
  and the full path, replayed from states that take each branch; the
  condition kernel equals its plain version.

This file imports no JAX:

    python3 -m pytest --noconftest tests/test_torch_parallel_cuda.py -q
"""
import copy
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mosstts_tpu_torch.core.config import DelayConfig, tiny_qwen3
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models.delay import init_delay_params, make_sampling
from mosstts_tpu_torch.ops.kernels import launches, w8_gemm
from torch_f32_families import FAMILIES, family

pytestmark = pytest.mark.cuda

CFG = DelayConfig(language_config=tiny_qwen3(hidden_size=256, intermediate_size=512,
                                             num_attention_heads=4, num_key_value_heads=2,
                                             head_dim=128), n_vq=4)
GREEDY = dict(max_new_tokens=12, text_temperature=0.0, audio_temperature=0.0)


def _need_cards(n: int = 1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPU(s)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _address() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _params(device="cuda"):
    return init_delay_params(CFG, generator=torch.Generator(device=device).manual_seed(3),
                             dtype=torch.float32, device=device)


def _prompts(B=3, T=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (B, T, CFG.channels)).astype(np.int64)
    ids[:, 1, 0] = CFG.im_start_token_id
    ids[:, -1, 0] = CFG.audio_assistant_gen_slot_token_id
    return ids


@pytest.fixture
def one_rank():
    _need_cards()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=_address(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    yield
    dist.destroy_process_group()


def test_one_rank_engine_and_server_equal_unsharded(one_rank):
    from mosstts_tpu_torch.parallel.mesh import make_mesh

    params = _params()
    mesh = make_mesh(data=1, model=1, device="cuda")
    solo = DelayEngine(params, CFG, dtype=torch.float32, cache_bucket=64)
    tp = DelayEngine(copy.deepcopy(params), CFG, dtype=torch.float32, cache_bucket=64, mesh=mesh)
    ids = _prompts()
    for od in (False, True):
        launches.reset()
        got = tp.generate(ids, on_device=od, **GREEDY)
        torch.cuda.synchronize()
        assert launches.IN_GRAPHS["nccl"] > 0 and launches.IN_GRAPHS["decode"] > 0
        want = solo.generate(ids, on_device=od, **GREEDY)
        for (a, ga), (b, gb) in zip(got, want):
            assert a == b
            np.testing.assert_array_equal(ga, gb)

    def serve(p, m):
        server = DelayBatchServer(p, CFG, slots=2, cache_len=128, out_capacity=32,
                                  prompt_bucket=32, dtype=torch.float32, mesh=m,
                                  sampling=make_sampling(text_temperature=0.0,
                                                         audio_temperature=0.0, device="cuda"))
        rids = [server.submit(g, max_new_tokens=10) for g in _prompts(4, 20, seed=1)]
        done = {c.request_id: c for c in server.run()}
        return [done[r].tokens for r in rids]

    for a, b in zip(serve(copy.deepcopy(params), mesh), serve(params, None)):
        np.testing.assert_array_equal(a, b)


def _two_rank_body(rank, address, ids, out_path):
    from mosstts_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=address, rank=rank, world_size=2,
                            device_id=torch.device("cuda", rank))
    eng = DelayEngine(_params(), CFG, dtype=torch.float32, cache_bucket=64,
                      mesh=make_mesh(data=1, model=2, device="cuda"))
    got = eng.generate(ids, **GREEDY)
    if rank == 0:
        torch.save(got, out_path)
    dist.barrier()
    dist.destroy_process_group()


def test_two_ranks_tensor_parallel_engine(tmp_path):
    _need_cards(2)
    ids = _prompts()
    out = tmp_path / "tp2.pt"
    torch.multiprocessing.spawn(_two_rank_body, args=(_address(), ids, str(out)), nprocs=2)
    got = torch.load(out, weights_only=False)
    want = DelayEngine(_params(), CFG, dtype=torch.float32, cache_bucket=64).generate(ids, **GREEDY)
    for (a, ga), (b, gb) in zip(got, want):
        assert a == b
        np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("K,N,M", [(1536, 6144, 50), (6144, 1536, 50), (1920, 1536, 1),
                                   (1536, 256, 7), (100, 70, 65), (33, 129, 130),
                                   (1536, 6144, 5), (1536, 1536, 6), (1536, 512, 16),
                                   (6144, 1536, 17), (1536, 6144, 64), (1920, 1536, 65)])
def test_w8f32_gemm_matches_plain(K, N, M):
    """The F32X3 mode against the plain version, within 1e-5 of the sum of
    the terms' magnitudes; two calls give the same bits; a call is at most
    two device kernels (the prologue that splits x, then the product)."""
    _need_cards()
    from mosstts_tpu_torch.tools.kernel_inputs import graph_kernels

    g = torch.Generator(device="cuda").manual_seed(K + N + M)
    q = torch.empty((K, N), dtype=torch.int8, device="cuda").random_(-127, 128, generator=g)
    scale = torch.rand((N,), generator=g, device="cuda") * 0.02 + 1e-3
    x = torch.randn((M, K), generator=g, device="cuda")
    before = w8_gemm.LAUNCHES_W8F32
    out = w8_gemm.w8f32_gemm(x, q, scale)
    assert w8_gemm.LAUNCHES_W8F32 == before + 1
    ref = w8_gemm.w8a16_gemm_ref(x, q, scale, torch.float32)
    absref = w8_gemm.w8a16_gemm_ref(x.abs(), q.abs(), scale, torch.float32)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    assert bool(((out - ref).abs() <= 1e-5 * absref + 1e-6).all())
    assert torch.equal(w8_gemm.w8f32_gemm(x, q, scale), out)
    kernels, nodes = graph_kernels(lambda: w8_gemm.w8f32_gemm(x, q, scale))
    assert kernels == nodes and 1 <= kernels <= 2
    # dense() sends float32 activations there, a layer of a stack in place
    from mosstts_tpu_torch.ops.basic import dense
    from mosstts_tpu_torch.ops.quant import QuantView

    stack = torch.stack([q, q])
    view = QuantView(stack[1], torch.stack([scale, scale])[1])
    np.testing.assert_array_equal(dense(x, view).cpu().numpy(), out.cpu().numpy())
    with pytest.raises(TypeError):
        dense(x.half(), view)


@pytest.mark.parametrize("M", [5, 6, 100])
@pytest.mark.parametrize("name", FAMILIES + ["nonfinite"])
def test_w8f32_gemm_terms_sum_to_x_exactly(name, M):
    """With q the identity (K = N, scale 1) each output is one x value times
    1 through its three terms, so the kernel must return hi + mid + lo of
    ``split3_bf16`` exactly: x itself wherever lo is a normal bf16. A term
    the device split gets wrong or the product leaves out shows here at
    zero tolerance, where the 1e-5 bound of the test above cannot see it.
    An inf meets zeros in the other columns: its row is NaN but at the
    inf's own column, as the float32 product x @ I is."""
    _need_cards()
    K = 1536
    if name == "nonfinite":
        x = np.random.default_rng(7).standard_normal((M, K)).astype(np.float32)
        x[0, 3], x[1, 700], x[M - 1, K - 1] = np.inf, -np.inf, np.nan
    else:
        x = family(name, M * K).reshape(M, K)
    xt = torch.from_numpy(x)
    hi, mid, lo = w8_gemm.split3_bf16(xt)
    want = (hi.double() + mid.double() + lo.double()).float()
    normal = np.isfinite(x) & (np.abs(x) >= 2.0 ** -110)
    np.testing.assert_array_equal(want.numpy()[normal], x[normal])
    if name == "nonfinite":
        want[[0, 1, M - 1]] = float("nan")
        want[0, 3], want[1, 700] = float("inf"), float("-inf")
    eye = torch.eye(K, dtype=torch.int8, device="cuda")
    out = w8_gemm.w8f32_gemm(xt.cuda(), eye, torch.ones(K, device="cuda")).cpu()
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)


def test_text_lazy_condition_kernel_matches_plain():
    """text_lazy's condition kernel (``graph_loop.lazy_cond``) decides as
    its plain version, ``any(sampling_text & ~is_audio)``, and counts the
    branch it picks."""
    _need_cards()
    from mosstts_tpu_torch.ops.kernels import graph_loop

    rng = np.random.default_rng(5)
    counts = graph_loop.lazy_counts("cuda")
    for B in (1, 3, 16, 300):
        for p in (0.0, 0.1, 1.0):
            st = torch.from_numpy(rng.random(B) < 0.5)
            ia = torch.from_numpy(rng.random(B) >= p)  # p: a row's chance to be out of audio
            before = counts[:2].cpu()
            want = graph_loop.lazy_cond_plain(st, ia)
            assert graph_loop.lazy_cond(st.cuda(), ia.cuda()) is want
            assert torch.equal(counts[:2].cpu() - before, torch.tensor([int(want), int(not want)],
                                                                       dtype=torch.int32))


def test_text_lazy_graph_equals_eager_and_full():
    """``delay_decode_step(text_lazy=True)`` captured into one CUDA graph
    (a condition kernel, then an IF node per branch) and replayed from a
    state with a row in free text (the full head) and then from one with
    every row in an audio block (the two columns): 6 replays from each give
    the eager lazy steps' and the full path's greedy frames bit for bit,
    and the device counters say each branch ran."""
    _need_cards()
    from mosstts_tpu_torch.engine.step_graph import STEP_FIELDS, GraphSteps, copy_state_, zero_state
    from mosstts_tpu_torch.models.delay import delay_decode_step, delay_prefill
    from mosstts_tpu_torch.ops.kernels import graph_loop
    from mosstts_tpu_torch.ops.sampling import row_keys

    params = _params()
    greedy = make_sampling(text_temperature=0.0, audio_temperature=0.0, device="cuda")

    def prefilled(free_text):
        ids = _prompts()  # every row in an open audio block (test_torch_text_lazy.py's prompt)
        ids[:, 4, 0] = CFG.audio_start_token_id
        if free_text:
            ids[2, -1, 0] = 100
        return delay_prefill(params, CFG, torch.as_tensor(ids, device="cuda"),
                             torch.ones(ids.shape[:2], dtype=torch.bool, device="cuda"),
                             max_new_tokens=16, cache_len=128, rng=row_keys(1, 3).cuda(),
                             sampling=greedy, dtype=torch.float32)

    state = zero_state(CFG, 3, 128, 16, dtype=torch.float32, kv_quant=False, device="cuda")

    def lazy_step():
        new = delay_decode_step(params, CFG, state, greedy, attend_len=128, text_lazy=True)
        for name in STEP_FIELDS:
            getattr(state, name).copy_(getattr(new, name))

    graphs = GraphSteps(params, "text_head", "cuda")
    with torch.no_grad():
        copy_state_(state, prefilled(True))
        graphs.warm(lazy_step)
        graph, _ = graphs.capture(lazy_step)
        counts = graph_loop.lazy_counts("cuda")
        for free_text in (True, False):
            copy_state_(state, prefilled(free_text))
            before = counts[:2].cpu()
            for _ in range(6):
                graph.replay()
            ran = counts[:2].cpu() - before
            assert int(ran.sum()) == 6 and int(ran[0 if free_text else 1]) >= 1
            for lazy in (True, False):
                st = prefilled(free_text)
                for _ in range(6):
                    st = delay_decode_step(params, CFG, st, greedy, attend_len=128,
                                           text_lazy=lazy)
                assert torch.equal(st.out, state.out) and torch.equal(st.cur_ids, state.cur_ids)
