"""The serving pool on the card while other threads use the card; skips
without one (CUDA graphs and the kernels have no CPU mode; the CPU half is
``tests/test_torch_serving.py``).

Four callers submit greedy requests to a 4-slot ``DelayServingPool`` of a
small float32 model (2 layers, width 256, n_vq=4) at once, while two other
threads run the codec's encode and decode on the card in a loop, as the
HTTP handlers do: in one case eagerly (``graphs=False``, a decode of the
whole length in one chunk: the codec's launches beside a live capture, as a
key no warmup named runs them), in the other as replays of the graphs its
``warmup`` captured before the pool started (a server's codec: it captures
nothing mid-serve). The pool's decode thread captures the CUDA graph of each
attend bucket (256, then 512) when the batch first reaches it, and the
prefill graph of each prompt bucket at its second admission (the four
prompts fall in two buckets, so one at least); every capture is held open
for a while so that codec work certainly runs inside it
(``engine/step_graph.py``: thread-local capture mode, one capture at a
time). Then:
- every codec iteration gives the bits of that thread's first one;
- each caller's grid equals the same request through ``DelayEngine.generate``
  alone (float32 with TF32 off: the two batch sizes round alike here; at 8B
  width in bf16 they do not, see ``chip_smoke.py`` phase 8);
- the decode kernel ran inside replayed graphs and flash once per layer of
  each admission, inside replayed prefill graphs from a bucket's second
  admission on.

This file imports no JAX, so it runs on the machine with the card:

    python3 -m pytest --noconftest tests/test_torch_serving_cuda.py -q
"""
import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from mosstts_tpu_torch.codec.model import MossAudioTokenizer
from mosstts_tpu_torch.core.config import CodecConfig, DelayConfig, tiny_qwen3
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.models.delay import make_sampling
from mosstts_tpu_torch.ops.kernels import launches
from mosstts_tpu_torch.serve.pool import DelayServingPool

CFG = DelayConfig(language_config=tiny_qwen3(hidden_size=256, intermediate_size=512,
                                             num_attention_heads=4, num_key_value_heads=2,
                                             head_dim=64), n_vq=4)
CODEC = CodecConfig(n_q=8, codebook_size=1024, codebook_dim=16, hidden_size=64,
                    intermediate_size=128, num_encoder_layers=2, num_decoder_layers=2,
                    num_attention_heads=4, num_key_value_heads=4, head_dim=16,
                    causal_context=32)
L = CFG.language_config.num_hidden_layers
GREEDY = dict(text_temperature=0.0, audio_temperature=0.0)
NEW = 96  # new frames per request: prompts of 150-190 rows cross attend 256
WAIT = 600


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the kernels have no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _grids(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = rng.integers(0, 1000, (int(rng.integers(150, 190)), CFG.channels))
        g[:, 1:] = rng.integers(0, 1024, g[:, 1:].shape)
        g[-1, 0] = CFG.audio_assistant_gen_slot_token_id
        out.append(g)
    return out


@pytest.mark.parametrize("codec_mode", ["eager", "replay"])
def test_pool_captures_while_handlers_run_the_codec(card, monkeypatch, codec_mode):
    engine = DelayEngine.random_init(seed=0, config=CFG, dtype=torch.float32, device="cuda")
    codec = MossAudioTokenizer.random_init(seed=1, config=CODEC, device="cuda")
    if codec_mode == "eager":
        codec = MossAudioTokenizer(codec.params, CODEC, graphs=False)
    else:
        codec.warmup(decode_levels=CODEC.n_q)  # as a server's codec: its chunks replay graphs
    chunk = {"eager": dict(chunk_duration=None), "replay": {}}[codec_mode]
    grids = _grids(4, 2)

    # hold every capture open for a while, and note when
    captures = []
    real_graph = torch.cuda.graph

    @contextlib.contextmanager
    def held_graph(*args, **kw):
        with real_graph(*args, **kw):
            t0 = time.monotonic()
            time.sleep(0.5)
            yield
        captures.append((t0, time.monotonic()))

    monkeypatch.setattr(torch.cuda, "graph", held_graph)

    stop = threading.Event()
    codec_ops, errors = [], []
    wav = np.random.default_rng(3).standard_normal(48000).astype(np.float32) * 0.1
    codes = np.random.default_rng(4).integers(0, 1024, (CODEC.n_q, 1, 25))

    def codec_loop(kind):
        try:
            first = None
            while not stop.is_set():
                t0 = time.monotonic()
                if kind == "encode":
                    out = codec.batch_encode([wav]).audio_codes
                else:
                    out = codec.decode(codes, **chunk).audio
                codec_ops.append((t0, time.monotonic()))
                if first is None:
                    first = out
                assert np.array_equal(out, first), f"codec {kind} changed under concurrency"
        except Exception as e:  # surfaced in the main thread
            errors.append(e)

    pool = DelayServingPool(engine.params, CFG, slots=4, cache_len=1024, out_capacity=128,
                            prompt_bucket=32, dtype=torch.float32,
                            sampling=make_sampling(**GREEDY, device="cuda"))
    workers = [threading.Thread(target=codec_loop, args=(k,)) for k in ("encode", "decode")]
    results = {}
    try:
        for w in workers:
            w.start()
        deadline = time.monotonic() + WAIT
        while len(codec_ops) < 2 and not errors and time.monotonic() < deadline:
            time.sleep(0.01)  # both loops are on the card
        launches.reset()

        def call(i):
            try:
                results[i] = pool.generate(grids[i][None], max_new_tokens=NEW, timeout=WAIT,
                                           **GREEDY)[0]
            except Exception as e:
                errors.append(e)

        callers = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for c in callers:
            c.start()
        for c in callers:
            c.join(timeout=WAIT)
        assert not any(c.is_alive() for c in callers)
        torch.cuda.current_stream().synchronize()
        codec_counts = dict(codec.chunks.counts)
        counts = launches.read()
        in_graphs = dict(launches.IN_GRAPHS)
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=WAIT)
        pool.close()
    assert not errors, errors
    assert not any(w.is_alive() for w in workers)

    # the pool captured attend 256 and 512 and the prefill of each prompt
    # bucket admitted twice, and codec work ran inside each capture
    assert sorted(k[0] for k in pool.server._steps.keys) == [256, 512]
    per_bucket = np.bincount([-(-len(g) // 32) for g in grids])
    prefill_keys = pool.server._prefills.keys
    assert sorted(k[0] // 32 for k in prefill_keys) == list(np.nonzero(per_bucket >= 2)[0])
    assert prefill_keys and len(captures) == 2 + len(prefill_keys)  # none by the codec
    for t0, t1 in captures:
        assert any(s < t1 and e > t0 for s, e in codec_ops), (t0, t1)
    assert codec_counts["capture"] == 0
    if codec_mode == "replay":
        assert codec_counts["replay"] > 0 and codec_counts["eager"] == 0
    else:
        assert codec_counts["eager"] > 0 and codec_counts["replay"] == 0

    # every decode step replayed a graph; flash ran for every admission, in a
    # replayed prefill graph from each bucket's second admission on
    steps = pool.server.total_steps
    assert counts["decode"] >= L * steps and in_graphs["decode"] >= L * (steps - 2)
    assert counts["flash"] == L * 4
    assert in_graphs["flash"] == L * int(np.maximum(per_bucket - 1, 0).sum())

    for i, g in enumerate(grids):
        solo = engine.generate(g[None], max_new_tokens=NEW, **GREEDY)[0]
        start, toks = results[i]
        assert start == solo[0]
        T = min(len(toks), len(solo[1]))
        np.testing.assert_array_equal(toks[:T], solo[1][:T], err_msg=f"caller {i}")
