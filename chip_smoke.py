#!/usr/bin/env python3
"""Drive the PyTorch port's Delay, Realtime and Local TTS paths once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and exits non-zero:

1. device: the card's name and power limit; TF32 off (the bf16 products at
   PyTorch's defaults: ``ops.basic.dense`` does not read the
   reduced-precision reduction flag).
2. build: nvcc builds the CUDA kernels from ``mosstts_tpu_torch/csrc``, one
   process per source, all started together; ``ptxas -v``'s registers,
   shared memory and spills of the flash and decode kernels and of every
   instantiation of the int8-weight GEMM (``ring_kernel``: W8A16, W8A8,
   INT4) and W8A8's row quantization.
3. kernels: each kernel against its plain PyTorch version at the main
   paths' shapes (max error within tolerance; device time per call, from
   CUDA-graph replays so that host launch cost is left out; the plain
   version's time; ``F.scaled_dot_product_attention``'s where that one call
   computes the same function; the least time the card could take, from the
   bytes and operations this call's data needs). Flash at B=4 T=160 over
   512 cache slots, the server's B=1 admissions (T=64/96, own k/v and over
   1024 slots) and a 480-token prompt; decode at B=4, at the server's B=16
   (attend 256/512/1024) and at B=1, each with SDPA's time. Then the backbone and a
   greedy generate of a small float32 model on the card (kernels) against
   the same model on the CPU (plain versions).
3b. a 2-slot ``DelayBatchServer`` of that small model, 4 greedy requests:
   linear and paged grids on the card equal the CPU's, and on the card
   paged equals linear for the f32 and the int8 cache; on the card each
   mode, warmed up, serves through ``run`` and ``run_events`` with equal
   grids, every warm admission splicing inside its graph (no eager row
   copy, ``splice_audit``; phases 5, 9a and 9b check the same).
3c. the device loops' kernels: JAX's threefry key split and the fused
   Gumbel-max categorical (``csrc/threefry.cu``) against their plain
   versions bit for bit at the 16-slot samplers' shapes, with their times,
   the plain versions', the earlier B-launch ``torch.rand`` draw's and the
   bounds; the loop condition of each kind, the drain's admission and
   collect, an 8B cache lane's row copy, the Realtime admission's row
   scatter at 1.7B width with its padding rows dropped (and
   ``index_copy_`` at the real rows), the fed text column and text_lazy's
   condition kernel (``csrc/graph_loop.cu``) against theirs; one step of a
   2000-step loop graph over a one-kernel body.
4. solo path at MOSS-TTS 8B width (``delay_8b()``, random bf16 weights made
   on the card, the ``codec_1p6b()`` codec in f32): three ``synthesize``
   requests and one greedy batch-4 ``DelayEngine.generate``; 4b the same
   batch with ``on_device=True``: one loop-graph launch per attend segment
   (JAX's ``delay_generate_on_device`` segments), the first frame equal
   to ``on_device=False``'s (the modes attend other buckets at some steps;
   7a holds each mode frame for frame against its eager steps), its host
   waits.
5. continuous batching at the same width, reusing phase 4's weights: a
   16-slot ``DelayBatchServer`` serves 24 sampled requests (8 admitted
   mid-flight) in each cache mode: linear bf16, linear int8, paged bf16,
   paged int8.
6. int8 weights at the same width: phase 4's engine keeps one batch-4
   prefill's logits in bf16, is quantized in place (``engine.quantize()``;
   the audio stack at a 16-byte row pitch), a short greedy int8
   ``generate`` under ``torch.profiler`` shows one device kernel per W8A16
   call, and its int8 logits for the same prefill must agree with the same int8
   model computed by the plain versions on the card, and stay correlated
   with the bf16 logits (``phase_int8`` says why not as closely as the
   2-layer check of phase 3); then phase 4's solo requests and phase 5's
   server in the linear bf16 and the paged int8 KV modes run on the int8
   weights, every matmul through the W8A16 kernel, none on byte loads.
7. CUDA graphs against eager decode steps at the same width, in two parts:
   7a on phase 4's bf16 weights (before phase 6 quantizes them), 7b on the
   int8 weights after phase 6. Each part: ``generate`` at B = 1 and 4 with
   ``on_device`` False and True, greedy and sampled with the seeds s1, s2,
   s1, on the engine (graph replays) and on an eager engine over the same
   weights (``graphs=False``): every grid equal bit for bit, s1's grid twice;
   then ``tools/profile_step``'s decode step eager against graph at B = 1
   and 16 (step wall, device time, kernels, idle share, peak memory). 7b
   also serves phase 5's 24 requests in the linear bf16 and the paged int8
   KV modes (a 20-page pool that forces preemptions) with graph and with
   eager steps: the completions must be equal.
8. voice cloning and the serving front end at the same width, after 7b, on
   the int8 weights: 8a encodes a 4 s wave (a seeded sine sweep plus noise,
   written with ``write_wav``) with the ``codec_1p6b()`` codec: with the
   first 2 of its 22 encoder layers (full width) the card's codes against
   the CPU's on the same weights, and at all 22 layers 1 s chunks against
   one shot on the card; a frame may differ only where the first differing
   level's two entries tie within 1e-4 relative; the encode time per
   second of audio. The codec's chunk programs are CUDA graphs
   (``engine/step_graph.CodecChunks``), captured by ``demo_backend``'s
   warmup (batch 1, 100 frames): the encode and a 100-frame decode each one
   replay, equal bit for bit to the same chunk run eagerly
   (``graphs=False``), both ways' wall and device ms and kernels, the
   graph's kernel nodes and its memory pool's bytes; the 1 s chunks go
   through a key captured on use, equal to eager's. 8b serves 7 requests
   at once through the port's
   ``ThreadingHTTPServer`` in this process with ``--pool-slots 16``
   (linear bf16 KV): four ``/tts`` Clone requests with that wave (audio
   greedy), one two-speaker ``/ttsd``, one ``/voice_gen`` and one
   ``/sound_effect``, 96-128 new frames each: every response a WAV of the
   samples its grid decodes to, each request's seconds, ``/metrics``' TTFA
   and RTF; flash, the decode kernel and W8A16 ran, the last two inside
   replayed graphs; the codec captured no graph mid-serve. 8c sends the
   four Clone prompts, greedy in text and
   audio, through that pool at once and through ``engine.generate`` alone:
   at 8B width the two batch sizes round differently (B=16 against B=1
   reductions and GEMM plans, the pool's prompt bucket), so the grids part
   after a few frames; the first frame must agree and the first differing
   frame is logged. 8d holds the same prompts equal bit for bit, pool
   against solo, on a small float32 model with the same 33 channels.
9. prefill graphs and the event and drain loops at the same width, on the
   int8 weights: 9a the engine's prefills at B=1 T=200 and B=4, greedy
   and seeds s1, s2, s1 (also in 7a on the bf16 weights), and a 16-slot
   server's admissions at buckets 64 and 96 (seeded, sampled), graph
   against eager: every field of the state, the cache and the keys
   equal, and the completions after the splice; the
   warm admission of a 200-row prompt and the warm time to the first frame
   at B=1 T=200, graph against eager (median of 9, host clock and device
   time), and the static admission state's bytes. 9b serves phase 5's 24
   requests through ``run``, ``run_events`` and ``run_drain`` (linear bf16
   KV) and ``run``, ``run_events`` (paged int8 KV): frames/s, ms per step,
   dispatches, loop-graph launches (one per event block and per drain
   segment) and host waits per request, and the first frame that differs
   from ``run``'s (the first must agree). 9c runs the JAX tests' loads on
   the small f32 model: ``run_events`` and ``run_drain`` equal ``run`` on
   the card bit for bit, the card's ``run_events`` and sampled
   ``run_drain`` equal the CPU's frame for frame and step for step (no
   frame past an EOS), and the greedy grids equal the CPU's.
10. the Realtime family at MOSS-TTS-Realtime 1.7B width (``RealtimeConfig()``:
   the 28-layer Qwen3-1.7B backbone, the 4-layer depth transformer, 16
   codebooks; random bf16 weights made on the card, after the 8B model is
   released). First flash (GQA group 2: a second turn at q_start 208 over
   the first turn's cache with a left-pad hole between the turns, and a
   batch-8 admission), decode (the depth transformer's 16-slot cache at
   attend 16, B = 1 and 8; the backbone's at B = 8) and W8A16 (the 1.7B
   matrices and one head of the stacked local heads, M = 1 and 8) against
   their plain versions, with their times, SDPA's or
   ``torch._weight_int8pack_mm``'s, and bounds. 10a: ``RealtimeEngine`` on
   ``bench.py``'s load (4-row turn grids, 160 text tokens, 64 frames) at
   B = 1 and 8: greedy frames through the frame graphs equal an eager
   engine's bit for bit, seeds s1, s2, s1 give equal, different, equal
   frames (s1 eager equal too), a second turn on each kept cache equal;
   then a first turn and a later turn whose prefill graphs were captured
   replay them (no flash or W8A16 launch outside a graph) and equal the
   eager engine's; ms per frame (wall and device), realtime multiple, the
   time to the first frame through the prefill graph and eagerly (median of
   5, wall and device); then ``quantize()`` (parameter bytes before and
   after) and all again on int8 weights. 10b: a ``RealtimeBatchServer`` (8
   slots, cache 1024, prompt bucket 16, poll every 8, temperature 0.8) on
   the int8 weights, warmed up (the admission graphs of buckets 16 and 32
   at k = 1-8 captured), serves ``bench.py``'s 24 conversations through
   ``run`` and ``run_events`` (each event block one loop-graph launch, its
   text fed per frame on the card): useful frames/s, ms per step, host
   waits and loop launches per conversation, the first frame differing
   from ``run``'s, every admission a replay (no flash, W8A16 or splice row
   copy launch outside a graph); then on that server and an eager one, admissions of
   k = 1, 2, 4 and 8 at bucket 32 and of k = 1 at buckets 64 and 160 (not
   warmed): states equal, one replay each at bucket 32, eager with nothing
   captured at the others, warm admission times both ways; on a small float32 model a 2-slot server's greedy streams
   equal the solo engine's, card and CPU. 10c: a ``RealtimeStreamingSession``
   and ``AudioStreamDecoder`` on the ``codec_1p6b()`` codec (its warmup
   captures the stream's 4-frame decode chunk), fed by
   ``RealtimeTextStreamBridge`` from word deltas (time to the first wave
   chunk, the wave's length against its frames; every codec chunk a
   replay, and the same pushes through an eager codec give the same
   chunks bit for bit; one 4-frame chunk's wall and device ms both ways),
   then three concurrent
   pooled ``POST /stream`` requests to the HTTP server in this process
   (``--rt-pool-slots 4``), the third with a longer user turn: status,
   headers, TTFA, samples, the pool's admissions by bucket (eager,
   replayed), and no admission graph captured after the pool's warmup.
11. checkpoints, then the Local family at MossTTSLocal 1.7B width
   (``LocalConfig(qwen3_1p7b(), n_vq=32)``: the 28-layer backbone, a 4-layer
   depth transformer of width 1536 without rotary embeddings, 32 codebooks;
   random bf16 weights made on the card after the Realtime model is
   released). First flash (the engine's B = 64 prefill, the server's
   admission), decode (the depth transformer's 33-slot cache at attend 1,
   17 and 33, B = 1, 8 and 64; the backbone's at B = 64) and W8A16 (the
   depth transformer's, the adapters' and the heads' shapes, M = 1 and 64)
   against their plain versions, with their times, yardsticks and bounds.
   11a: directories in the reference's HF layout (1 GB bf16 shards with an
   index, ``tools/hf_checkpoint.py``) written from random full-width
   models, Local 1.7B with 4 of its 28 backbone layers, Delay 8B and
   Realtime 1.7B with 2, loaded onto the card through
   ``load_{local,delay,realtime}_checkpoint`` (seconds and GB/s): every
   tensor equal to its source bit for bit, and greedy frames of the loaded
   model equal to the source's; ``save_model``/``load_model`` of the Local
   model and the ``codec_1p6b()`` codec's ``save_pretrained``/
   ``from_pretrained`` round trips equal bit for bit. The Delay and Realtime
   directories then get the tokenizer fixture's files
   (``tools/tokenizer_fixture.py``: a byte-level BPE in Qwen3's layout) and
   load through ``load_delay_backend``/``load_realtime_backend``: the
   tokenizer is ``Qwen2BPETokenizer``, not the byte fallback, and the ids
   and decodes committed in ``tools/tokenizer_fixture_expected.json``
   (computed through ``transformers``) come out bit for bit; one
   mixed-script ``synthesize`` request puts the committed prompt text ids
   into the Delay engine, and a Realtime turn, its reply sent in word
   deltas through ``TextDeltaTokenizer``, holds the committed prompt ids and
   releases the committed ids; the tokenizer's load seconds, encode us per
   1,000 characters (cold, cached) and a ``TextDeltaTokenizer``'s total
   encode ms over a 2,000-character reply in word deltas (host times, with
   the card's line). 11b: ``LocalEngine``
   on ``bench.py:279-310``'s load (128-row grids with an ``audio_start``
   row) at B = 1, 8 and 64, in bf16 and then after ``quantize()``: greedy
   frames through the frame graphs equal an eager engine's bit for bit,
   seeds s1, s2, s1 give equal, different, equal grids (and greedy grids
   after a replayed prefill equal eager's), ``n_vq_for_inference=8``
   zero-fills channels 9-32; ms per frame (wall, the median of 3
   ``generate`` calls; replays by CUDA events; kernel time under the
   profiler), kernels and launches per frame, realtime multiple, the time
   to the first frame through the prefill graph (a replay with no flash or
   W8A16 launch outside it) and eagerly (median of 5, wall and device),
   parameter bytes before and after ``quantize()``. 11c:
   a ``LocalBatchServer`` (8 slots, cache 512, prompt bucket 32, greedy) on
   the int8 weights, warmed up (the admission graphs of buckets 32 and 64
   captured), serves ``bench.py:581-603``'s 24 requests through ``run`` and
   ``run_events`` (each event block one loop-graph launch): useful
   frames/s, ms per step, host waits and loop launches per request, the
   first frame differing from ``run``'s, every admission a replay, its
   splice inside; then on that server and an eager one, a
   60-row admission (bucket 64) and a 100-row one (bucket 128, not warmed):
   states equal, one replay at bucket 64, eager with nothing captured at
   128, warm admission times both ways; on a small float32 model a 2-slot server's greedy grids equal the
   solo engine's, card and CPU.
12. training (``train/``, ``codec/train.py``), float32, AdamW unless named.
   No kernel of ``ops/kernels`` is on the training path (no Pallas kernel is
   on JAX's: its no-cache forward takes the XLA attention): the launch
   counts are set to 0 before each full-width trainer and must read 0
   after it. 12a: the small Delay, Local and Realtime trainers
   (``train.trainer.tiny_config``) and a small codec trainer, plain and
   adversarial, run 3 steps on the card and on the CPU from the same
   parameters: each step's loss within rel 1e-4 and gradient norm within
   1e-3, the parameters after them within ||d|| / ||p|| 1e-4. 12b: at full
   width, random weights made on the card, one synthetic batch repeated
   (``synthetic_tts_batch``, T = 256), warmup 1, peak lr 1e-4: Local 1.7B
   (``LocalConfig(qwen3_1p7b(), n_vq=32)``, B = 3, the largest that fits
   with remat off after phases 1-11) and Realtime 1.7B (``RealtimeConfig()``,
   B = 8) at full
   depth, Delay at 8B width with 4 of its 36 layers (B = 8), 4 steps with
   remat off then 4 with it on;
   ``codec_1p6b()`` on 1 s clips (B = 4), 4 AdamW steps, then one
   Adafactor step and one adversarial step: ms a step (CUDA events, the
   median from the second step), tokens/s (frames/s for the codec), peak
   memory, first and last loss (finite, and the last below the first).
   12c: the Local 1.7B trainer saved in the serving format, read back
   with ``load_model`` bit for bit, and its greedy ``LocalEngine`` frames
   equal the trainer's own parameters'.
13. parallelism over ``torch.distributed`` (``parallel/``), the int8 codec
   and ``text_lazy``. 13a: flash (B = 4, T = 160, kv-major over 512
   slots), decode (B = 1, 4, 16 at attend 256, 300 and 1024, each with its
   ``decode_plan``) and W8A16 (M = 1, 16) at one rank's shapes of tensor
   parallelism 2 and 4 at 8B width (H = 16 / 8, KV = 4 / 2, the weights'
   column or row blocks, the heads' vocab and codebook blocks) against
   their plain versions; W8A16's float32-activation mode (``w8f32_gemm``,
   the ring kernel's F32X3 mode) at ``codec_1p6b()``'s shapes, M = 200,
   100 (the encoder's 100-frame chunks of two waves and one), 50, 12 and 1,
   against plain and bit-equal over two calls, with its time, its
   device kernels a call, plain time, a yardstick (the f32 ``torch.matmul``
   over weights dequantized outside the timing), ``torch._weight_int8pack_mm``
   with float32 activations and scales where it takes them, its bound (three
   bf16 products or the bytes) and the f32 bound (one f32 product). 13b: one rank per card
   (``torch.cuda.device_count()``, at most 4; ranks after the first in
   spawned processes; NCCL through ``tcp://localhost``), the 8B model
   (random bf16 weights) in a ``DelayEngine`` and a 16-slot
   ``DelayBatchServer`` with ``mesh=make_mesh(data=1, model=n)``, graphs
   on, against the same weights unsharded, bf16 and then after
   ``quantize()``: greedy grids (batch-4 ``generate``, both loops; 16
   greedy requests) equal bit for bit at n = 1 (first frames at n > 1),
   the collectives counted inside the replayed graphs. 13c: one Delay
   trainer step at 8B width with 4 layers (B = 2, T = 64) with ``mesh=``
   and with ``pipeline=(make_pp_mesh(n), 2)``, and one Local and one
   Realtime step at 1.7B width with 2 backbone layers with ``mesh=``
   (Realtime's data-parallel, B = 2n: its spec table admits no model axis
   of 2 or more), each loss within rel 1e-5 of the unsharded trainer's, no
   kernel of ``ops/kernels`` launched. 13d:
   ``codec_1p6b()`` with int8 weights (``quantize_tree_``) encodes and
   decodes phase 8a's 4 s wave on the card (its encoder through
   ``w8f32_gemm``, its decoder through W8A16, every launch inside the
   codec's chunk graphs, which its warmup captured; equal bit for bit to
   the same chunks eagerly, both ways' times): mean relative deviation
   from the float32 codec below 0.5 (JAX's test's bound), and with 2 of
   22 layers the card's codes against the CPU's (near ties only) and its
   wave within two bf16 ulps of the peak of the CPU's. 13e: greedy frames
   with ``text_lazy`` on a small float32 model equal the full path's; the
   lazy step captured as one graph (a condition kernel and an IF node per
   branch) replays from states that take each branch, equal to the eager
   lazy steps, and the branch counts are printed. W8A16's float32
   mode is the tenth entry of the kernels line, its launches 13d's; the
   W8A16 and float32-mode entries carry 13d's launches inside the codec's
   graphs (``in_codec_graphs``).
14. the Gradio demos' handlers (``serve/gradio_apps.py``'s factories,
   plain functions of a backend: no gradio is needed). 14a, after 9c, on
   phase 4's backend (int8 weights): the four Delay demos' handlers (TTS
   Direct with duration control, TTS Clone from phase 8's 4 s wave, TTSD
   with two speakers cloned from it, VoiceGenerator, SoundEffect at 2 s; 40
   new frames, SoundEffect its duration's budget), each called with values
   shaped like the UI's once (its graphs captured), then in the order
   handler, pipeline, pipeline, handler (the same call straight to its
   pipeline function, same seed): finite float32 waves at 24 kHz, the five
   waves of a call within 1e-4; each timed call's wall and the handler's
   own time outside its pipeline call; the codec's chunks replay its graphs
   (batch-2 encodes run eagerly), none captured. 14b,
   in phase 10 after 10c: the Realtime demo's handler on the int8 1.7B
   engine and ``codec_1p6b()`` with the demo's defaults (chunk 12, no
   prebuffer), the turn ended at 96 frames: more than one finite chunk at
   the codec's rate, the last yield ``done | <metrics json>`` with a TTFA;
   the time to the first chunk and the chunks; every codec chunk a replay.
Phases 4-6, 8, 9, 10, 11 and 14 run the package's default: every decode step a
CUDA-graph replay, and every prefill one from its key's second use (or a
server's ``warmup``) on (``engine/step_graph.py``). The kernels' launch
counts are set to 0 just before phases 4, 6, 8b, each server mode and each
loop of 9b, each engine batch, server loop and the concurrent streams of 10,
each engine batch and server loop of 11, 14a and 14b, and read just after,
and must show every prefill and every decode step went through the kernels;
a graph's launches count once per replay (``ops/kernels/launches.py``), and
flash, the decode kernels and W8A16 must have run inside replayed graphs.
Phase 3 adds the int8-weight GEMMs (W8A16 at the 8B decode and prefill shapes, each shape's times in the
kernels line; W8A8 and int4 at their tools' shapes, with ``torch._int_mm``
and ``torch._weight_int4pack_mm`` as their yardsticks, each tool's walk
driven once) and ``decode_attention_q8t`` (bf16
and f32 scales), and a small int8-weight model, card against CPU, and its
int8 against its bf16 weights on the card and on the CPU
(``tests/test_quant.py``'s thresholds, at the rows with a clear argmax).

Each phase's wall time is printed on a line of its own when the next
begins. Then one JSON line with the kernels' numbers, the nvidia-smi line,
and the result line ``{"ok": true, "device": {...}}``. Without a CUDA device the
script raises before printing any result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import itertools
import json
import re
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from mosstts_tpu_torch.codec.model import MossAudioTokenizer  # noqa: E402
from mosstts_tpu_torch.codec.train import CodecTrainer, synthetic_audio_batch  # noqa: E402
from mosstts_tpu_torch.core.config import (  # noqa: E402
    CodecConfig, DelayConfig, LocalConfig, RealtimeConfig, RealtimeLocalConfig, codec_1p6b,
    delay_8b, qwen3_1p7b, qwen3_8b, tiny_qwen3)
from mosstts_tpu_torch.engine.batch_server import DelayBatchServer  # noqa: E402
from mosstts_tpu_torch.engine.delay_engine import DelayEngine, attend_bucket  # noqa: E402
from mosstts_tpu_torch.engine.local_batch_server import LocalBatchServer  # noqa: E402
from mosstts_tpu_torch.engine.local_engine import LocalEngine  # noqa: E402
from mosstts_tpu_torch.engine.realtime_batch_server import RealtimeBatchServer  # noqa: E402
from mosstts_tpu_torch.engine.realtime_engine import RealtimeEngine  # noqa: E402
from mosstts_tpu_torch.engine.streaming import (  # noqa: E402
    AudioStreamDecoder, AudioTokenCache, RealtimeStreamingSession, RealtimeTextStreamBridge,
    TextDeltaTokenizer)
from mosstts_tpu_torch.models.delay import make_sampling  # noqa: E402
from mosstts_tpu_torch.models.delay import delay_forward, init_delay_params  # noqa: E402
from mosstts_tpu_torch.models.local import init_local_params  # noqa: E402
from mosstts_tpu_torch.models.realtime import init_realtime_params, make_rt_sampling  # noqa: E402
from mosstts_tpu_torch.nn import qwen3  # noqa: E402
from mosstts_tpu_torch.ops.kernels import _build, decode_attn, flash, paged_attn, w8_gemm  # noqa: E402
from mosstts_tpu_torch.ops.kernels import launches as kernel_launches  # noqa: E402
from mosstts_tpu_torch.ops.quant import is_quantized, pitched  # noqa: E402
from mosstts_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mosstts_tpu_torch.parallel.pipeline import make_pp_mesh  # noqa: E402
from mosstts_tpu_torch.processing.delay_processor import DelayProcessor  # noqa: E402
from mosstts_tpu_torch.processing.realtime_processor import RealtimeProcessor  # noqa: E402
from mosstts_tpu_torch.processing.bpe import Qwen2BPETokenizer  # noqa: E402
from mosstts_tpu_torch.processing.tokenizer import (  # noqa: E402
    ByteFallbackTokenizer, load_tokenizer)
from mosstts_tpu_torch.serve import gradio_apps, http_server, pipelines  # noqa: E402
from mosstts_tpu_torch.serve.backend import load_delay_backend, load_realtime_backend  # noqa: E402
from mosstts_tpu_torch.serve.pipelines import demo_backend, synthesize  # noqa: E402
from mosstts_tpu_torch.tools import probe_int4, profile_step, tune_mm8  # noqa: E402
# warm admissions and first frames timed each way (the median is kept)
from mosstts_tpu_torch.tools.admission_path import N as TIMED_N  # noqa: E402
from mosstts_tpu_torch.tools.admission_path import prompt_grid, timed  # noqa: E402
from mosstts_tpu_torch.tools.kernel_inputs import (  # noqa: E402
    GEMM_8B, bound, card_line, codec_f32_shapes, decode_bound, decode_inputs, gemm_bound,
    graph_kernels, graph_nodes, time_ms)
from mosstts_tpu_torch.tools.hf_checkpoint import same_params, write_hf_checkpoint  # noqa: E402
from mosstts_tpu_torch.tools.kernel_times import int4_library  # noqa: E402
from mosstts_tpu_torch.tools.pool_vs_solo import first_divergence  # noqa: E402
from mosstts_tpu_torch.tools import tokenizer_fixture  # noqa: E402
from mosstts_tpu_torch.train.trainer import TTSTrainer, synthetic_tts_batch, tiny_config  # noqa: E402
from mosstts_tpu_torch.utils.audio import read_wav, write_wav  # noqa: E402
from mosstts_tpu_torch.utils.convert import load_tree_  # noqa: E402
from mosstts_tpu_torch.utils.checkpoints import (  # noqa: E402
    delay_table, load_delay_checkpoint, load_local_checkpoint, load_realtime_checkpoint,
    local_table, realtime_table)
from mosstts_tpu_torch.utils.save import load_model, save_model  # noqa: E402

DEV = "cuda"
L8, B8, KV8, S8, HD8, H8 = 36, 4, 8, 512, 128, 32  # 8B layers / heads; batch 4, cache 512
BS, SS, PS = 16, 1024, 128  # the server's batch, capacity and page size at 8B width
# Tolerance, kernel vs plain, elementwise in bf16: both compute in f32 from the
# same bf16 inputs and round once to bf16, so their f32 results differ only
# by summation order (~1e-6) and may round one bf16 ulp (2^-7 relative)
# apart. Allow two ulps at the reference's magnitude plus 1e-5 for the
# summation error of results near zero.
REL_TOL, ABS_TOL = 2.0 ** -6, 1e-5


_PHASE = {"name": None, "t": 0.0, "start": time.perf_counter()}


def log(msg: str) -> None:
    """Print a line; a line that opens a phase ("phase N: ...") first
    prints the wall time of the phase before it on a line of its own."""
    m = re.match(r"phase (\w+)[: ]", msg)
    if m and m.group(1) != _PHASE["name"]:
        phase_wall()
        _PHASE.update(name=m.group(1), t=time.perf_counter())
    print(msg, flush=True)


def phase_wall() -> None:
    """The wall time of the phase under way, on a line of its own."""
    if _PHASE["name"] is not None:
        now = time.perf_counter()
        print(f"  wall of phase {_PHASE['name']}: {now - _PHASE['t']:.1f} s "
              f"({now - _PHASE['start']:.1f} s since the start)", flush=True)


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, rows=None) -> float:
    err = (out.float() - ref.float()).abs()
    bound = REL_TOL * ref.float().abs() + ABS_TOL
    if rows is not None:
        err, bound = err[rows], bound[rows]
    worst = float(err.max())
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: kernel disagrees with plain version, max abs err {worst}")
    log(f"  {name}: max_abs_err={worst:.3e} (tol {REL_TOL:.4g}*|ref|+{ABS_TOL:g})")
    return worst


def library_ms(fn, n: int = 36) -> float | None:
    """Device time of the one PyTorch call that computes the same function,
    or None (with the reason logged) where this PyTorch build refuses it."""
    try:
        return time_ms(fn, n=n)
    except RuntimeError as e:
        log(f"  (library call refused: {str(e).splitlines()[0]})")
        return None


def fmt_ms(ms) -> str:
    return "refused" if ms is None else f"{ms:.4f} ms"


def flash_shape(label: str, q, k, v, valid, q_start, *, kv_major: bool, rows, n_layers: int = 1,
                layer=None) -> dict:
    """Flash at one shape: kernel against plain (every layer in ``layer``'s
    first and last pick), then device times of the kernel, the plain
    version and ``F.scaled_dot_product_attention`` (the same causal,
    left-pad mask as one boolean mask; k/v handed to it kv-major, the layout
    it takes, made once outside the timing), and the bound. ``layer(i)``
    picks call i's k/v (rotating cache layers keeps L2 cold, as a prefill
    over a cache finds it); without it every call reads ``k``, ``v``."""
    pick = layer or (lambda i: (k, v))
    H, hd = q.shape[2:]
    KV = pick(0)[0].shape[1 if kv_major else 2]
    scale = hd ** -0.5
    qs_int = int(q_start)
    err = 0.0
    for li in sorted({0, n_layers - 1}):
        args = (q, *pick(li), valid, q_start)
        out = flash.flash_attention(*args, scale=scale, kv_major=kv_major)
        ref = flash.flash_attention_ref(*args, scale=scale, kv_major=kv_major)
        err = max(err, check_close(f"flash {label} layer={li}", out, ref, rows))
    ms = time_ms(lambda i: flash.flash_attention(q, *pick(i), valid, q_start, scale=scale,
                                                 kv_major=kv_major))
    plain_ms = time_ms(lambda i: flash.flash_attention_ref(q, *pick(i), valid, q_start,
                                                           scale=scale, kv_major=kv_major))
    B, T = q.shape[:2]
    S = valid.shape[1]
    qpos = qs_int + torch.arange(T, device=DEV)
    mask = (torch.arange(S, device=DEV)[None, :] <= qpos[:, None])[None] & valid[:, None, :]
    qt = q.transpose(1, 2)
    if kv_major:
        lib_pick = pick
    else:  # (B, S, KV, hd) -> (B, KV, S, hd), once
        kt, vt = (x.transpose(1, 2).contiguous() for x in pick(0))
        lib_pick = lambda i: (kt, vt)
    lib_ms = library_ms(lambda i: F.scaled_dot_product_attention(
        qt, *lib_pick(i), attn_mask=mask[:, None], scale=scale, enable_gqa=True))
    # bound: the keys some real query needs (valid, before the last query)
    # read once, q read and the output written once, kv_valid read; 4 * hd
    # operations per (real query, key) pair
    pairs = float((mask & rows[:, :, None]).sum())
    keys = float(valid[:, :qs_int + T].sum())
    bd = bound(2 * keys * KV * hd * 2 + 2 * q.numel() * 2 + valid.numel(),
               4 * hd * H * pairs, torch.bfloat16)
    log(f"  flash {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {fmt_ms(lib_ms)}, "
        f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd)


def phase_kernels() -> dict:
    g = torch.Generator(device=DEV).manual_seed(0)
    bf = torch.bfloat16
    kc = torch.randn((L8, B8, KV8, S8, HD8), generator=g, device=DEV).to(bf)
    vc = torch.randn((L8, B8, KV8, S8, HD8), generator=g, device=DEV).to(bf)
    scale = HD8 ** -0.5

    # flash: B=4 left-padded prompts of T=160, kv-major over cache layers;
    # the timed shape (PR 1's) is q_start 0
    T = 160
    q = torch.randn((B8, T, H8, HD8), generator=g, device=DEV).to(bf)
    flash_shapes = []
    for q_start, pads in ((192, (0, 0, 5, 9)), (0, (0, 17, 40, 95))):
        valid = torch.zeros((B8, S8), dtype=torch.bool, device=DEV)
        for b, p in enumerate(pads):
            valid[b, p:q_start + T] = True
        flash_shapes.append(flash_shape(
            f"B={B8} T={T} q_start={q_start} kv-major S={S8}", q, None, None, valid, q_start,
            kv_major=True, rows=valid[:, q_start:q_start + T], n_layers=L8,
            layer=lambda i: (kc[i % L8], vc[i % L8])))
    flash_main = flash_shapes.pop()
    # the server's admissions: one left-padded prompt of T=64 or 96 rows at
    # batch 1 and q_start 0 (a tensor, as qwen3_forward passes it); the
    # int8 caches attend the prompt's own (B, T, KV, hd) k/v, the bf16 ones
    # a kv-major linear cache of the server's 1024 slots. k/v were written
    # just before (L2 warm), as in the prefill
    zero = torch.zeros((), dtype=torch.int32, device=DEV)
    kc1, vc1 = (torch.randn((1, KV8, SS, HD8), generator=g, device=DEV).to(bf) for _ in "kv")
    for T1 in (64, 96):
        q1 = torch.randn((1, T1, H8, HD8), generator=g, device=DEV).to(bf)
        k1, v1 = (torch.randn((1, T1, KV8, HD8), generator=g, device=DEV).to(bf) for _ in "kv")
        valid1 = torch.zeros((1, SS), dtype=torch.bool, device=DEV)
        valid1[0, 11:T1] = True
        for kv_major, k_all, v_all, valid_all in (
                (False, k1, v1, valid1[:, :T1]),
                (True, kc1, vc1, valid1)):
            flash_shapes.append(flash_shape(
                f"B=1 T={T1} " + (f"kv-major S={SS}" if kv_major else "own k/v"), q1, k_all,
                v_all, valid_all, zero, kv_major=kv_major, rows=valid1[:, :T1]))
    # a longer prompt: B=1, T=480, kv-major over the 512-slot cache layers
    q480 = torch.randn((1, 480, H8, HD8), generator=g, device=DEV).to(bf)
    valid480 = torch.zeros((1, S8), dtype=torch.bool, device=DEV)
    valid480[0, 7:480] = True
    flash_shapes.append(flash_shape(
        f"B=1 T=480 kv-major S={S8}", q480, None, None, valid480, 0, kv_major=True,
        rows=valid480[:, :480], n_layers=L8, layer=lambda i: (kc[i % L8, :1], vc[i % L8, :1])))
    flash_err = max(r["max_abs_err"] for r in (flash_main, *flash_shapes))

    # decode: one token per row over the same cache; ragged attend lengths
    qd = torch.randn((B8, H8, HD8), generator=g, device=DEV).to(bf)
    valid = torch.rand((B8, S8), generator=g, device=DEV) < 0.7
    valid[:, 0] = True
    decode_err, decode_ms, decode_plain_ms = 0.0, {}, {}
    for a in (256, 512, 300):
        for li in (0, 35):
            args = (qd, kc, vc, valid, li)
            out = decode_attn.decode_attention(*args, scale=scale, attend_len=a)
            ref = decode_attn.decode_attention_ref(*args, scale=scale, attend_len=a)
            decode_err = max(decode_err, check_close(f"decode attend={a} layer={li}", out, ref))
        decode_ms[a] = time_ms(lambda i: decode_attn.decode_attention(
            qd, kc, vc, valid, i % L8, scale=scale, attend_len=a))
        decode_plain_ms[a] = time_ms(lambda i: decode_attn.decode_attention_ref(
            qd, kc, vc, valid, i % L8, scale=scale, attend_len=a))
        log(f"  decode B={B8} attend={a}: kernel {decode_ms[a]:.4f} ms")
        log(f"  decode B={B8} attend={a}: plain {decode_plain_ms[a]:.4f} ms")
    decode_lib_ms = decode_sdpa_ms(qd, kc, vc, valid, 256)
    decode_bd = decode_bound(qd, valid, 256, KV8, HD8 * 2)
    log(f"  decode B={B8} attend=256: sdpa {fmt_ms(decode_lib_ms)}")
    log(f"  decode B={B8} attend=256: bound {decode_bd['bound_ms']:.5f} ms "
        f"({decode_bd['bound_by']})")
    torch.cuda.synchronize()
    main = {k: flash_main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    return {
        "flash": dict(max_abs_err=flash_err, **main, shapes=[flash_main, *flash_shapes]),
        "decode": dict(max_abs_err=decode_err, ms=decode_ms[256], plain_ms=decode_plain_ms[256],
                       library_ms=decode_lib_ms, **decode_bd,
                       shapes=[dict(shape=f"B={B8} attend=256 of {tuple(kc.shape)}",
                                    ms=decode_ms[256], plain_ms=decode_plain_ms[256],
                                    library_ms=decode_lib_ms, **decode_bd)]),
    }


def decode_sdpa_ms(q, kc, vc, valid, attend: int):
    """``F.scaled_dot_product_attention`` over the first ``attend`` slots of
    layer i % 36 on call i: the same function as ``decode_attention``."""
    return library_ms(lambda i: F.scaled_dot_product_attention(
        q[:, :, None], kc[i % L8, :, :, :attend], vc[i % L8, :, :, :attend],
        attn_mask=valid[:, None, None, :attend], scale=HD8 ** -0.5, enable_gqa=True))


def phase_kernels_server() -> dict:
    """The four decode kernels at the server's 8B shapes
    (``tools/kernel_inputs.decode_inputs``): B=16 rows, KV=8, H=32, hd=128,
    capacity 1024, attend 256, 512 and 1024; int8 values and scales from the
    port's cache quantizer; a shuffled page table with P=128 whose rows
    leave 0-3 tail pages unallocated (on the poisoned trash page 0, masked
    by kv_valid). The linear bf16 kernel has SDPA's time and the bound at
    every attend length, and is held and timed at B=1 attend 256 (the solo
    path's batch) too; its numbers come back as ``decode_b16`` (B=16,
    attend 256, with every shape in ``shapes``)."""
    scale = HD8 ** -0.5
    q, valid, kernels = decode_inputs(BS, seed=1)
    numbers, decode_shapes = {}, []
    kc, vc = kernels["decode"][2](0)[1:3]
    for name, (kernel, plain, args, row_bytes, extra) in kernels.items():
        err, ms, plain_ms = 0.0, {}, {}
        for a in (256, 512, 1024):
            for li in (0, L8 - 1):
                out = kernel(*args(li), scale=scale, attend_len=a)
                ref = plain(*args(li), scale=scale, attend_len=a)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{name}: non-finite output")
                err = max(err, check_close(f"{name} B={BS} attend={a} layer={li}", out, ref))
            ms[a] = time_ms(lambda i: kernel(*args(i % L8), scale=scale, attend_len=a))
            plain_ms[a] = time_ms(lambda i: plain(*args(i % L8), scale=scale, attend_len=a))
            log(f"  {name} B={BS} attend={a}: kernel {ms[a]:.4f} ms")
            log(f"  {name} B={BS} attend={a}: plain {plain_ms[a]:.4f} ms")
            if name == "decode":  # one call computes the same function
                lib = decode_sdpa_ms(q, kc, vc, valid, a)
                bd = decode_bound(q, valid, a, KV8, row_bytes, extra)
                log(f"  {name} B={BS} attend={a}: sdpa {fmt_ms(lib)}, bound "
                    f"{bd['bound_ms']:.5f} ms ({bd['bound_by']})")
                decode_shapes.append(dict(shape=f"B={BS} attend={a} of {tuple(kc.shape)}",
                                          ms=ms[a], plain_ms=plain_ms[a], library_ms=lib, **bd))
        bd = decode_bound(q, valid, 256, KV8, row_bytes, extra)
        log(f"  {name} B={BS} attend=256: bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
        numbers[name] = dict(max_abs_err=err, ms=ms[256], plain_ms=plain_ms[256],
                             library_ms=None, **bd)
    numbers["decode"]["library_ms"] = decode_shapes[0]["library_ms"]
    numbers["decode"]["shapes"] = decode_shapes
    numbers["decode_b16"] = numbers.pop("decode")
    del q, valid, kernels, kc, vc
    torch.cuda.empty_cache()

    # the solo path's batch: B=1, attend 256
    q, valid, kernels = decode_inputs(1, seed=2)
    kernel, plain, args, row_bytes, extra = kernels["decode"]
    err = 0.0
    for li in (0, L8 - 1):
        err = max(err, check_close(f"decode B=1 attend=256 layer={li}",
                                   kernel(*args(li), scale=scale, attend_len=256),
                                   plain(*args(li), scale=scale, attend_len=256)))
    ms = time_ms(lambda i: kernel(*args(i % L8), scale=scale, attend_len=256))
    plain_ms = time_ms(lambda i: plain(*args(i % L8), scale=scale, attend_len=256))
    kc, vc = args(0)[1:3]
    lib = decode_sdpa_ms(q, kc, vc, valid, 256)
    bd = decode_bound(q, valid, 256, KV8, row_bytes, extra)
    log(f"  decode B=1 attend=256: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{fmt_ms(lib)}, bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
    numbers["decode_b16"]["max_abs_err"] = max(numbers["decode_b16"]["max_abs_err"], err)
    numbers["decode_b16"]["shapes"].append(dict(
        shape=f"B=1 attend=256 of {tuple(kc.shape)}", ms=ms, plain_ms=plain_ms,
        library_ms=lib, **bd))
    del q, valid, kernels, kc, vc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return numbers


def host_ms(fn, n: int = 20) -> float:
    """Host-clock time per call of ``fn`` ending in a synchronisation (a
    plain version whose control flow reads the card, which no graph can
    capture), median of ``n``."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


# the samplers' shapes on the 8B server: 16 rows, 3 keys a step, the text
# top-k 50 and the 32 audio heads' top-k 25
SAMPLER_SHAPES = (("text", (BS, 50)), ("audio", (BS, 32, 25)), ("text B=4", (4, 50)))
INT32_OPS_PER_S = 67e12  # the card's 32-bit CUDA-core peak (float32's, no tensor cores)
HASH_OPS = 96  # 32-bit operations of one threefry2x32: 20 rounds of add, rotate, xor + keys


def rand_path(logits: torch.Tensor) -> torch.Tensor:
    """The port's earlier draw, the yardstick of the fused categorical: one
    ``torch.rand`` launch per row (a generator each), then the clamp, log,
    log, subtract and argmax."""
    u = torch.stack([torch.rand(logits.shape[1:], device=logits.device)
                     for _ in range(logits.shape[0])])
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def phase_kernels_sampling() -> dict:
    """3c: the kernels this port adds for JAX's device loops. The threefry
    key split and the fused Gumbel-max categorical (``csrc/threefry.cu``)
    against their plain versions (``ops.sampling``) bit for bit at the
    samplers' shapes, with device time per call, the plain version's, the
    earlier B-launch ``torch.rand`` draw's (yardstick) and the bound; then
    the loop-control kernels (``csrc/graph_loop.cu``: the loop condition of
    each kind, the drain's admission and collect, the row copy, the fed
    column) against their plain versions, and their times."""
    from mosstts_tpu_torch.ops import sampling
    from mosstts_tpu_torch.ops.kernels import graph_loop as gl, threefry

    numbers = {}
    keys = sampling.row_keys(3, BS).to(DEV)
    got, ref = threefry.split(keys, 3), sampling.split(keys, 3)
    if not torch.equal(got, ref):
        raise AssertionError("threefry split: kernel != plain")
    ms = time_ms(lambda i: threefry.split(keys, 3))
    plain = time_ms(lambda i: sampling.split(keys, 3))
    t_b = (BS * 16 + BS * 3 * 16) / 3.35e12 * 1e3  # keys read once, split keys written once
    t_o = BS * 3 * HASH_OPS / INT32_OPS_PER_S * 1e3
    bd = dict(bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")
    log(f"  threefry split B={BS} n=3: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bd['bound_ms']:.3e} ms ({bd['bound_by']}), equal bit for bit")
    numbers["threefry_split"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None,
                                     **bd, shapes=[f"keys ({BS}, 2) -> ({BS}, 3, 2)"])
    shapes, worst = [], 0
    g = torch.Generator(device=DEV).manual_seed(11)
    for label, shape in SAMPLER_SHAPES:
        k = keys[:shape[0]]
        logits = torch.randn(shape, generator=g, device=DEV) * 3
        got, ref = threefry.categorical(k, logits), sampling.categorical_plain(k, logits)
        worst = max(worst, int((got != ref).sum()))
        ms = time_ms(lambda i: threefry.categorical(k, logits))
        plain = time_ms(lambda i: sampling.categorical_plain(k, logits))
        yard = time_ms(lambda i: rand_path(logits))
        n = logits.numel()
        t_b = (n * 4 + shape[0] * 16 + n // shape[-1] * 8) / 3.35e12 * 1e3
        t_o = n * (HASH_OPS + 40) / INT32_OPS_PER_S * 1e3  # + two logf, add, compare
        bd = dict(bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")
        log(f"  categorical {label} {tuple(shape)}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"B-launch torch.rand path {yard:.4f} ms, bound {bd['bound_ms']:.3e} ms "
            f"({bd['bound_by']}); indices differing from plain: {int((got != ref).sum())}")
        shapes.append(dict(shape=f"{label} {tuple(shape)}", ms=ms, plain_ms=plain,
                           rand_path_ms=yard, **bd))
    if worst:
        raise AssertionError(f"fused categorical: {worst} indices differ from plain")
    numbers["categorical"] = dict(max_abs_err=0.0, library_ms=None, shapes=shapes,
                                  **{k: shapes[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                                               "bound_by")})

    # the loop condition, each kind, against plain
    def t(x, dt=torch.int32):
        return torch.tensor(x, dtype=dt, device=DEV)

    flags, step = t([0] * (BS - 1) + [1], torch.bool), t(list(range(BS)))
    watch, budget = t([1] * BS), t([9] * (BS - 1) + [3])
    active, pos = t([1] * 8 + [0] * (BS - 8), torch.bool), t([300] * BS)
    cases = [(gl.GENERATE, 0, 8, dict(flags=flags, step=step)),
             (gl.GENERATE, 0, 0, dict(flags=flags, step=step)),
             (gl.EVENT, 2, 9, dict(flags=flags, watch=watch, budget=budget)),
             (gl.EVENT, 3, 9, dict(flags=flags, watch=watch, budget=budget)),
             (gl.BLOCK, 3, 4, {}), (gl.DRAIN, 5, 99, dict(active=active, pos=pos, attend=512)),
             (gl.DRAIN, 5, 99, dict(active=active, pos=pos, attend=256))]
    for kind, i, limit, kw in cases:
        ctrl = t([i, limit, 0, 3, 3, 0, 0, 0])
        gl.loop_cond(gl.cond_args(kind, ctrl, **kw), False, DEV)
        want = gl.loop_cond_plain(kind, i, limit, qi=3, qn=3, **{
            k: (v.bool() if k == "watch" else v) for k, v in kw.items()})
        if bool(ctrl[gl.COND]) is not want:
            raise AssertionError(f"loop condition kind {kind} i={i}: kernel != plain")
    # one iteration of a loop graph whose body is one tiny kernel: the
    # condition kernel's share of a loop step
    x = torch.zeros(BS, dtype=torch.int32, device=DEV)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    body = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(body, stream=side):
        x.add_(1)
    ctrl = t([0, 2000, 0, 0, 0, 0, 0, 0])
    ex = gl.build_loop(body.raw_cuda_graph(), gl.cond_args(
        gl.EVENT, ctrl, flags=torch.zeros(BS, dtype=torch.bool, device=DEV), watch=watch,
        budget=t([1 << 30] * BS)))
    runs = []
    for _ in range(5):
        ctrl.zero_()
        ctrl[gl.LIMIT] = 2000
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        gl.launch(ex, DEV)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / 2000)
    gl.destroy(ex)
    ms = float(np.median(runs))
    if int(ctrl[gl.I]) != 2000:
        raise AssertionError(f"a 2000-step loop graph ran {int(ctrl[gl.I])} steps")
    plain = host_ms(lambda: gl.loop_cond_plain(gl.EVENT, 3, 9, flags=flags,
                                               watch=watch.bool(), budget=budget))
    t_b = BS * (1 + 4 + 4) / 3.35e12 * 1e3
    numbers["loop_cond"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None,
                                bound_ms=t_b, bound_by="bytes")
    log(f"  loop condition (7 cases of the 4 kinds == plain); one step of a 2000-step loop "
        f"graph over a one-kernel body: {ms * 1e3:.2f} us (the condition kernel, the body's "
        f"kernel and the WHILE node's relaunch); plain condition (host read) {plain:.4f} ms")

    # the drain's admission and collect, and the row copy and fed column
    ctrl = t([0, 99, 0, 0, 2, 0, 0, 0])
    slots, nq, row = 4, 2, 96 * 33
    act = t([1, 0, 1, 0], torch.bool)
    rid, bud = t([1, 0, 0, 0]), t([9, 1 << 30, 7, 1 << 30])  # slots 0, 2: requests 1, 0
    qb, qbud, qk = t([1, 0]), t([40, 30]), t([[1, 2], [3, 4]], torch.int64)
    small_rng = torch.zeros((1, 2), dtype=torch.int64, device=DEV)
    samp = [(torch.zeros(slots, device=DEV), t([0.5, 0.7], torch.float32),
             torch.zeros((), device=DEV)),
            (torch.zeros(slots, dtype=torch.bool, device=DEV), t([1, 0], torch.bool),
             torch.zeros((), dtype=torch.bool, device=DEV))]
    stop, stp = t([0, 0, 1, 0], torch.bool), t([9, 0, 3, 0])
    out = torch.randint(0, 1000, (slots, row), device=DEV, dtype=torch.int32)
    res, rst = torch.zeros((nq + 1, row), dtype=torch.int32, device=DEV), t([0] * (nq + 1))
    plain_state = [x.clone() for x in (act, rid, bud, small_rng, samp[0][0], samp[0][2],
                                       samp[1][0], samp[1][2], res, rst)]
    pctrl = ctrl.cpu().numpy()
    P = gl.MAX_SAMP
    dargs = gl.DrainArgs(
        ctrl=ctrl.data_ptr(), slots=slots, n_buckets=0, active=act.data_ptr(),
        slot_rid=rid.data_ptr(), budget=bud.data_ptr(), qbucket=qb.data_ptr(),
        qbudget=qbud.data_ptr(), qkeys=qk.data_ptr(), small_rng=small_rng.data_ptr(),
        handles=0, n_f32=1, n_u8=1,
        f_dst=(gl.ctypes.c_void_p * P)(samp[0][0].data_ptr()),
        f_src=(gl.ctypes.c_void_p * P)(samp[0][1].data_ptr()),
        f_pre=(gl.ctypes.c_void_p * P)(samp[0][2].data_ptr()),
        u_dst=(gl.ctypes.c_void_p * P)(samp[1][0].data_ptr()),
        u_src=(gl.ctypes.c_void_p * P)(samp[1][1].data_ptr()),
        u_pre=(gl.ctypes.c_void_p * P)(samp[1][2].data_ptr()),
        is_stopping=stop.data_ptr(), step=stp.data_ptr(), out=out.data_ptr(),
        results=res.data_ptr(), rsteps=rst.data_ptr(), out_row=row)
    gl.drain_admit(dargs, DEV)
    gl.drain_collect(dargs, DEV)
    pa, prid, pbud, prng, pf, pfp, pu, pup, pres, prst = plain_state
    gl.drain_admit_plain(pctrl, pa, prid, pbud, qb.cpu().numpy(), qbud, qk, prng,
                         [(pf, samp[0][1], pfp), (pu, samp[1][1], pup)])
    gl.drain_collect_plain(pa, stop, stp, pbud, prid, out, pres, prst)
    kernel_side = (act, rid, bud, small_rng, samp[0][0], samp[0][2], samp[1][0], samp[1][2],
                   res, rst)
    if not all(torch.equal(a, b) for a, b in zip(kernel_side, plain_state)) or \
            not np.array_equal(ctrl.cpu().numpy(), pctrl):
        raise AssertionError("drain admission/collect: kernel != plain")
    admit_ms = time_ms(lambda i: gl.drain_admit(dargs, DEV))
    collect_ms = time_ms(lambda i: gl.drain_collect(dargs, DEV))
    admit_plain = host_ms(lambda: gl.drain_admit_plain(
        pctrl, pa, prid, pbud, qb.cpu().numpy(), qbud, qk, prng, []))
    collect_plain = host_ms(lambda: gl.drain_collect_plain(pa, stop, stp, pbud, prid, out,
                                                           pres, prst))
    numbers["drain_admit"] = dict(max_abs_err=0.0, ms=admit_ms, plain_ms=admit_plain,
                                  library_ms=None, bound_ms=slots * 1 * 2 / 3.35e12 * 1e3,
                                  bound_by="bytes")
    numbers["drain_collect"] = dict(max_abs_err=0.0, ms=collect_ms, plain_ms=collect_plain,
                                    library_ms=None,
                                    bound_ms=2 * row * 4 / 3.35e12 * 1e3, bound_by="bytes")
    # the splice's copy: a (36, 16, 8, 1024, 128) bf16 cache lane from a batch-1 cache
    big = torch.zeros((36, BS, 8, 1024, 128), dtype=torch.bfloat16, device=DEV)
    small = torch.randn((36, 1, 8, 1024, 128), generator=g, device=DEV).bfloat16()
    cctrl = t([0, 0, 0, 0, 0, 5, 0, 0])
    table = gl.seg_table([gl.Part(big, small, dst_word=gl.SLOT, dst_axis=1, src_axis=1)], DEV)
    gl.copy_rows(table, cctrl, blocks=264)
    want = torch.zeros_like(big)
    want[:, 5] = small[:, 0]
    if not torch.equal(big, want):
        raise AssertionError("row copy: kernel != plain")
    copy_ms = time_ms(lambda i: gl.copy_rows(table, cctrl, blocks=264), n=8)
    copy_plain = time_ms(lambda i: big[:, 5].copy_(small[:, 0]), n=8)
    # the library call: index_copy_ at a slot index that lies on the card
    slot = torch.tensor([5], dtype=torch.int64, device=DEV)
    big.zero_()
    big.index_copy_(1, slot, small)
    if not torch.equal(big, want):
        raise AssertionError("row copy: index_copy_ != plain")
    copy_lib = library_ms(lambda i: big.index_copy_(1, slot, small), n=8)
    lane = small.numel() * 2
    lane_8b = dict(ms=copy_ms, plain_ms=copy_plain, library_ms=copy_lib,
                   bound_ms=2 * lane / 3.35e12 * 1e3, bound_by="bytes")
    del big, small, want
    # the same kernel as the Realtime admission's scatter: kb = 8 rows of a
    # 128-slot admission state into slots of a 1024-slot cache at the 1.7B
    # width, the 3 padding rows at index `slots` dropped (JAX's mode="drop");
    # against its plain version and index_copy_ at the 5 real rows, on the card
    lc = RealtimeConfig().language_config
    Lr, KVr, hdr, A = lc.num_hidden_layers, lc.num_key_value_heads, lc.head_dim, 128
    rows = t([6, 1, 3, 0, 4, 8, 8, 8])
    small = torch.randn((Lr, 8, KVr, A, hdr), generator=g, device=DEV).bfloat16()
    bigs = [torch.zeros((Lr, 8, KVr, SS, hdr), dtype=torch.bfloat16, device=DEV)
            for _ in range(3)]
    scatters = [[gl.Part(b[:, :, :, :A], small[:, i:i + 1], dst_word=i, dst_axis=1, src_axis=1)
                 for i in range(8)] for b in bigs]
    scatter = gl.RowCopy(scatters[0], rows)
    scatter()
    gl.copy_rows_plain(scatters[1], rows)
    real = rows[:5].long()
    bigs[2][:, :, :, :A].index_copy_(1, real, small[:, :5])
    if not (torch.equal(bigs[0], bigs[1]) and torch.equal(bigs[0], bigs[2])):
        raise AssertionError("row scatter with dropped rows: kernel != plain")
    scatter_ms = time_ms(lambda i: scatter(), n=8)
    scatter_plain = host_ms(lambda: gl.copy_rows_plain(scatters[1], rows), n=5)
    scatter_lib = library_ms(lambda i: bigs[2][:, :, :, :A].index_copy_(1, real, small[:, :5]),
                             n=8)
    moved = 2 * 5 * small[:, 0].numel() * 2  # 5 rows read once and written once
    numbers["row_copy"] = dict(
        max_abs_err=0.0, ms=scatter_ms, plain_ms=scatter_plain, library_ms=scatter_lib,
        bound_ms=moved / 3.35e12 * 1e3, bound_by="bytes", lane_8b=lane_8b,
        shapes=[f"scatter of 8 rows (3 dropped) of ({Lr}, 8, {KVr}, {A}, {hdr}) bf16 into "
                f"({Lr}, 8, {KVr}, {SS}, {hdr})", "8B cache lane (36, 16, 8, 1024, 128) bf16"])
    del bigs, small, scatters, scatter
    # text_lazy's condition kernel against its plain version at the server's
    # 16 rows: none, one and every row in free text
    lazy_cases = []
    for free in ([], [5], list(range(BS))):
        st_rows, audio = torch.ones(BS, dtype=torch.bool, device=DEV), \
            torch.ones(BS, dtype=torch.bool, device=DEV)
        audio[free] = False
        lazy_cases.append((st_rows, audio))
        if gl.lazy_cond(st_rows, audio) is not gl.lazy_cond_plain(st_rows, audio):
            raise AssertionError(f"text_lazy condition, rows {free} in free text: kernel != plain")
    st_rows, audio = lazy_cases[1]
    lazy_ms = time_ms(lambda i: gl.lazy_cond_launch(st_rows, audio))
    lazy_plain = host_ms(lambda: gl.lazy_cond_plain(st_rows, audio))
    numbers["lazy_cond"] = dict(max_abs_err=0.0, ms=lazy_ms, plain_ms=lazy_plain,
                                library_ms=None, bound_ms=2 * BS / 3.35e12 * 1e3,
                                bound_by="bytes")
    log(f"  row scatter of 8 admission rows at 1.7B width, 3 dropped: kernel {scatter_ms:.4f} "
        f"ms, plain {scatter_plain:.4f} ms, library index_copy_ at the 5 rows "
        f"{fmt_ms(scatter_lib)}, bound {numbers['row_copy']['bound_ms']:.4f} ms (bytes), "
        f"== plain; text_lazy condition (3 cases == plain) {lazy_ms * 1e3:.2f} us, plain "
        f"{lazy_plain:.4f} ms")
    staged = torch.randint(0, 1000, (BS, 128), device=DEV)
    dst = torch.zeros(BS, dtype=torch.int64, device=DEV)
    fctrl = t([7, 0, 0, 0, 0, 0, 0, 0])
    gl.feed(staged, dst, fctrl)
    if not torch.equal(dst, staged[:, 7]):
        raise AssertionError("fed column: kernel != plain")
    feed_ms = time_ms(lambda i: gl.feed(staged, dst, fctrl))
    feed_plain = time_ms(lambda i: dst.copy_(staged[:, 7]))
    # the library call: index_select at the column the control word holds
    col, picked = fctrl[gl.I:gl.I + 1], torch.zeros((BS, 1), dtype=torch.int64, device=DEV)
    torch.index_select(staged, 1, col, out=picked)
    if not torch.equal(picked[:, 0], staged[:, 7]):
        raise AssertionError("fed column: index_select != plain")
    feed_lib = library_ms(lambda i: torch.index_select(staged, 1, col, out=picked))
    numbers["feed"] = dict(max_abs_err=0.0, ms=feed_ms, plain_ms=feed_plain, library_ms=feed_lib,
                           bound_ms=2 * BS * 8 / 3.35e12 * 1e3, bound_by="bytes")
    log(f"  drain admission {admit_ms:.4f} ms (plain {admit_plain:.4f}), collect "
        f"{collect_ms:.4f} ms (plain {collect_plain:.4f}), a {lane / 2**20:.0f} MiB cache-lane "
        f"copy {copy_ms:.4f} ms (plain copy_ {copy_plain:.4f}, library index_copy_ "
        f"{fmt_ms(copy_lib)}), fed column {feed_ms:.4f} ms (plain {feed_plain:.4f}, library "
        f"index_select {fmt_ms(feed_lib)}): each == plain")
    torch.cuda.empty_cache()
    return numbers


def phase_small_reference() -> None:
    """A small float32 model (head dim 128, so the kernels dispatch) on the
    card against the same weights on the CPU, where the plain versions run."""
    cfg = DelayConfig(language_config=tiny_qwen3(
        hidden_size=256, intermediate_size=512, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128), n_vq=4)
    cpu_backend = demo_backend(cfg, seed=1, dtype=torch.float32, device="cpu", cache_bucket=64)
    cpu, proc = cpu_backend.engine, cpu_backend.processor
    gpu = DelayEngine(copy.deepcopy(cpu.params).to(DEV), cfg, dtype=torch.float32,
                      device=DEV, cache_bucket=64)
    lc = cfg.language_config
    rng = np.random.default_rng(0)
    B, T, S = 2, 40, 64
    x = torch.tensor(rng.normal(size=(B, T, lc.hidden_size)).astype(np.float32))
    valid = torch.zeros((B, S), dtype=torch.bool)
    valid[0, :T], valid[1, 9:T] = True, True
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    outs = {}
    for dev, eng in (("cpu", cpu), (DEV, gpu)):
        cache = qwen3.init_kv_cache(lc, B, S, dtype=torch.float32, device=dev)
        h, _ = qwen3.qwen3_forward(eng.params.backbone, lc, x.to(dev), positions=pos.to(dev),
                                   kv_valid=valid.to(dev), cache=cache, cache_offset=0)
        v1 = valid.clone()
        v1[:, T] = True
        h1, _ = qwen3.qwen3_forward(
            eng.params.backbone, lc, x[:, -1:].to(dev) * 0.5, kv_valid=v1.to(dev),
            positions=torch.full((B, 1), T, dtype=torch.int32, device=dev), cache=cache,
            cache_offset=torch.tensor(T, dtype=torch.int32, device=dev), attend_len=T + 8)
        outs[dev] = (h.cpu(), h1.cpu())
    rows = valid[:, :T]
    err = max(float((outs[DEV][0] - outs["cpu"][0]).abs()[rows].max()),
              float((outs[DEV][1] - outs["cpu"][1]).abs().max()))
    if not err <= 1e-4:  # float32 on both sides: summation order only
        raise AssertionError(f"small backbone, card vs CPU: max abs err {err}")
    log(f"  small f32 backbone prefill+decode, card (kernels) vs CPU (plain): "
        f"max_abs_err={err:.3e} (tol 1e-4)")

    codes = rng.integers(0, 1024, size=(7, cfg.n_vq))
    convs = [[proc.build_user_message(text=t), proc.build_assistant_message([codes[:n]])]
             for t, n in (("one", 7), ("a longer second prompt", 4))]
    batch = proc(convs, mode="continuation")
    kw = dict(max_new_tokens=24, text_temperature=0.0, audio_temperature=0.0)
    a = cpu.generate(batch["input_ids"], batch["attention_mask"], **kw)
    b = gpu.generate(batch["input_ids"], batch["attention_mask"], **kw)
    for (la, ga), (lb, gb) in zip(a, b):
        if la != lb or not np.array_equal(ga, gb):
            raise AssertionError("small greedy generate: card grid differs from CPU grid")
    log(f"  small f32 greedy generate (B=2, continuation, 24 frames): card grid == CPU grid")


SMALL_CFG = DelayConfig(language_config=tiny_qwen3(
    hidden_size=256, intermediate_size=512, num_attention_heads=4, num_key_value_heads=2,
    head_dim=128), n_vq=4)


def phase_small_server() -> None:
    """A 2-slot server of the small f32 model (head dim 128, so the kernels
    dispatch) with the same weights on the card and on the CPU: 4 greedy
    continuation requests, two admitted mid-flight. The page pool is the
    default 60% of the linear footprint, so pages are recycled. On the card
    each cache mode warms up its prompt buckets and serves through ``run``
    and ``run_events``: every warm admission splices inside its graph
    (``splice_audit``), and both loops' grids equal."""
    cfg = SMALL_CFG
    cpu_backend = demo_backend(cfg, seed=2, dtype=torch.float32, device="cpu")
    cpu_params, proc = cpu_backend.engine.params, cpu_backend.processor
    gpu_params = copy.deepcopy(cpu_params).to(DEV)
    rng = np.random.default_rng(3)
    grids = []
    for i in range(4):
        codes = rng.integers(0, 1024, size=(6, cfg.n_vq))
        conv = [proc.build_user_message(text=f"server request {i}"),
                proc.build_assistant_message([codes])]
        grids.append(proc([conv], mode="continuation")["input_ids"][0])

    def serve(params, dev, loop="run", **mode):
        srv = DelayBatchServer(params, cfg, slots=2, cache_len=256, out_capacity=64,
                               prompt_bucket=32, dtype=torch.float32, page_size=64,
                               sampling=make_sampling(text_temperature=0.0,
                                                      audio_temperature=0.0, device=dev),
                               **mode)
        spliced = None
        if dev != "cpu":
            srv.warmup(prompt_lens=(32, 64), attend_upto=256)
        rids = [srv.submit(g, max_new_tokens=24) for g in grids]
        with contextlib.ExitStack() as stack:
            if dev != "cpu":
                spliced = stack.enter_context(splice_audit(srv, "_prefill_into"))
            done = {c.request_id: c for c in getattr(srv, loop)(max_steps=1000)}
        if sorted(done) != sorted(rids):
            raise AssertionError(f"small server {mode}: requests {rids}, completed {sorted(done)}")
        if spliced is not None and not spliced["warm"]:
            raise AssertionError(f"small server {mode} {loop}: no warm admission")
        return [(done[r].start_length, done[r].tokens) for r in rids], srv.total_preemptions, \
            spliced

    def same(a, b) -> bool:
        return all(la == lb and np.array_equal(ga, gb) for (la, ga), (lb, gb) in zip(a, b))

    results = {}
    for name, mode in (("linear", {}), ("paged", dict(paged=True)),
                       ("linear int8", dict(kv_quant=True)),
                       ("paged int8", dict(paged=True, kv_quant=True))):
        results[name] = serve(gpu_params, DEV, **mode)
        events = serve(gpu_params, DEV, "run_events", **mode)
        if not same(results[name][0], events[0]):
            raise AssertionError(f"small server on the card, {name}: run_events grids differ "
                                 f"from run's")
        log(f"  small server on the card ({name}): run_events grids == run grids; warm "
            f"admissions spliced inside their graphs, none eagerly: run {results[name][2]}, "
            f"run_events {events[2]}")
    for name in ("linear", "paged"):
        cpu = serve(cpu_params, "cpu", **({"paged": True} if name == "paged" else {}))
        if not same(results[name][0], cpu[0]):
            raise AssertionError(f"small f32 server, {name}: card grids differ from CPU grids")
        log(f"  small f32 server ({name}, 2 slots, 4 greedy requests): card grids == CPU grids")
    for lin, pag in (("linear", "paged"), ("linear int8", "paged int8")):
        if not same(results[lin][0], results[pag][0]):
            raise AssertionError(f"small server on the card: {pag} grids differ from {lin}")
        log(f"  small server on the card: {pag} grids == {lin} grids "
            f"({results[pag][1]} preemptions)")


# Tolerance, GEMM kernel vs plain: both sum exact products in float32, in
# another order (the difference stays far under 1e-4 of the sum of the terms'
# magnitudes, ``absref``), and a bf16 output may round one ulp (2^-7) apart.
# Relative to the result alone would fail where a sum cancels to near zero.
GEMM_TOL = 1e-4


def check_gemm(name: str, out, ref, absref) -> float:
    err = (out.float() - ref.float()).abs()
    ulp = 2.0 ** -7 if out.dtype == torch.bfloat16 else 0.0
    worst = float(err.max())
    if not bool((err <= ulp * ref.float().abs() + GEMM_TOL * absref + 1e-6).all()):
        raise AssertionError(f"{name}: kernel disagrees with plain version, max abs err {worst}")
    log(f"  {name}: max_abs_err={worst:.3e} (tol {ulp:g}*|ref|+{GEMM_TOL:g}*sum|terms|+1e-6)")
    return worst


def library_agrees(name: str, x, w, w_lib) -> None:
    """Log how far ``torch._weight_int8pack_mm`` on the library's layout
    ``w_lib`` lies from the plain W8A16 version on ``w``: the same int8
    values, but the library rounds the scales and its output to bf16, so
    this is a reading of the yardstick, not a check of a kernel."""
    got = torch._weight_int8pack_mm(x, *w_lib).float()
    ref = w8_gemm.w8a16_gemm_ref(x, *w, torch.float32).reshape(got.shape)
    rel = float((got - ref).abs().max() / ref.abs().max())
    log(f"  {name}: torch._weight_int8pack_mm vs plain W8A16, max abs difference {rel:.2e} "
        f"of the largest output (its scales and output in bf16)")


def phase_kernels_gemm() -> dict:
    """The int8-weight GEMMs. W8A16 at the 8B model's decode (M = 1, 16) and
    prefill (M = 96, 640) shapes over random int8 layer stacks (36 layers of
    each backbone weight, so call i reads layer i % 36 cold from device
    memory, as a decode step does), the text head and the 32-head audio stack
    (f32 out); beside each, PyTorch's own int8 weight-only GEMM
    ``torch._weight_int8pack_mm`` on the same int8 values (the yardstick:
    its CUDA op takes the weights as (N, K), transposed once outside the
    timing, and the scales and the output in x's dtype, bf16), and the bf16
    ``torch.matmul`` of the same shape, what the bf16 path pays. W8A16 with
    unit scales, W8A8 and int4 at their tools' shapes
    (``tools/probe_int4.py``, ``tools/tune_mm8.py``), with
    ``torch._weight_int8pack_mm``, ``torch._int_mm`` and
    ``torch._weight_int4pack_mm`` (``kernel_times.int4_library``, checked
    against int4's plain version first) as yardsticks;
    each tool's walk is then driven once with the counts at 0, and those
    are their launches. ``decode_attention_q8t`` runs one call per layer of
    an 8B step at the server's B=16 with bf16 scales, for its launches (its
    kernel checks are in ``phase_kernels_server``)."""
    g = torch.Generator(device=DEV).manual_seed(5)
    bf = torch.bfloat16
    numbers, err16, shapes = {}, 0.0, []
    w8_gemm.LAUNCHES_W8A16_BYTES = 0
    for name, K, N, count, out_dtype in GEMM_8B:
        L = 1 if name.endswith("head") or count else L8
        shape = ((count,) if count else (L,)) + (K, N)
        q = torch.empty(shape, dtype=torch.int8, device=DEV).random_(-127, 128, generator=g)
        sc = torch.rand(shape[:-2] + (N,), generator=g, device=DEV) * 0.019 + 0.001
        # the bf16 weights of the same shape; enough layers to leave L2 cold
        nb = 1 if count or L == 1 else min(L8, max(2, -(-200_000_000 // (K * N * 2))))
        wb = torch.randn((nb, count or 1, K, N) if count else (nb, K, N), generator=g,
                         device=DEV).to(bf)
        # the library's layout: (N, K) int8 (the audio stack as one (count * N, K)
        # weight, so one call), bf16 scales
        qt = (q.permute(0, 2, 1).reshape(count * N, K) if count else q.transpose(1, 2)).contiguous()
        sb = sc.reshape(-1).to(bf)
        if count:  # one call over the whole stack, in QuantWeight's layout (16-byte row pitch)
            q = pitched(q)
            pick, lib_pick = (lambda i: (q, sc)), (lambda i: (qt, sb))
        else:
            pick = (lambda i, q=q, sc=sc, L=L: (q[i % L], sc[i % L]))
            lib_pick = (lambda i, L=L: (qt[i % L], sb.view(L, N)[i % L]))
        Ms = (1, 16) + ((96, 640) if name in ("wq", "wk", "w_gate", "w_down") else ())
        for M in Ms:
            x = torch.randn((M, K), generator=g, device=DEV).to(bf)
            for li in ((0, L - 1) if L > 1 else (0,)):
                qi, si = pick(li)
                out = w8_gemm.w8a16_gemm(x, qi, si, out_dtype)
                ref = w8_gemm.w8a16_gemm_ref(x, qi, si, out_dtype)
                absref = w8_gemm.w8a16_gemm_ref(x.abs(), qi.abs(), si, torch.float32)
                err16 = max(err16, check_gemm(f"w8a16 {name} M={M} layer={li}", out, ref, absref))
                del out, ref, absref
            n = 36 if qi.numel() < 2e8 else 8
            ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, *pick(i), out_dtype), n=n)
            plain_ms = time_ms(lambda i: w8_gemm.w8a16_gemm_ref(x, *pick(i), out_dtype), n=n)
            if count:
                bf16_ms = time_ms(lambda i: torch.bmm(x.expand(count, M, K), wb[0],
                                                      out_dtype=torch.float32), n=n)
            else:
                bf16_ms = time_ms(lambda i: torch.matmul(x, wb[i % nb]), n=n)
            lib_ms = library_ms(lambda i: torch._weight_int8pack_mm(x, *lib_pick(i)),
                                n=n if M <= 16 else 8)
            bd = gemm_bound(M, K, N, count=count or 1,
                            out_bytes=4 if out_dtype == torch.float32 else 2)
            log(f"  w8a16 {name} M={M} K={K} N={N}{f' x{count}' if count else ''}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch._weight_int8pack_mm "
                f"{fmt_ms(lib_ms)}, bf16 matmul (what the bf16 path pays) {bf16_ms:.4f} ms, "
                f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']}), "
                f"{(count or 1) * K * N / ms / 1e6:.0f} GB/s of int8 weights")
            if lib_ms is not None and M == 16:
                library_agrees(f"w8a16 {name} M={M}", x, pick(0), lib_pick(0))
            shapes.append(dict(shape=f"{name} M={M}", ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bf16_matmul_ms=bf16_ms, **bd))
            if name == "w_gate" and M == 16:
                numbers["w8a16"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd)
        del q, sc, wb, qt, sb
        torch.cuda.empty_cache()
    if w8_gemm.LAUNCHES_W8A16_BYTES:
        raise AssertionError(f"W8A16 took byte loads {w8_gemm.LAUNCHES_W8A16_BYTES} times at the "
                             "8B shapes (the audio stack at a 16-byte row pitch included)")
    numbers["w8a16"].update(max_abs_err=err16, shapes=shapes)

    # W8A8 at tools/tune_mm8.py's defaults: B=128, 16 layers of (4096, 12288)
    x, w8, scale = tune_mm8.make_inputs(128, 16, 4096, 12288)
    err = 0.0
    for li in (0, 15):
        out = w8_gemm.w8a8_gemm(x, w8[li], scale[li])
        ref = w8_gemm.w8a8_gemm_ref(x, w8[li], scale[li])
        x8, xs = w8_gemm.quant_rows(x)
        absref = w8_gemm.w8a16_gemm_ref(x8.abs().to(bf), w8[li].abs(), scale[li],
                                        torch.float32) * xs
        err = max(err, check_gemm(f"w8a8 B=128 layer={li}", out, ref, absref))
    ms = time_ms(lambda i: w8_gemm.w8a8_gemm(x, w8[i % 16], scale[i % 16]))
    plain_ms = time_ms(lambda i: w8_gemm.w8a8_gemm_ref(x, w8[i % 16], scale[i % 16]), n=8)
    x8 = w8_gemm.quant_rows(x)[0]
    lib_ms = library_ms(lambda i: torch._int_mm(x8, w8[i % 16]))
    bd = gemm_bound(128, 4096, 12288, out_bytes=4, ops_dtype=torch.int8)
    log(f"  w8a8 B=128 D=4096 O=12288: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch._int_mm {fmt_ms(lib_ms)}, bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
    numbers["w8a8"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd)
    reset_counts()
    walk = tune_mm8.mm8_w8a8(x, w8, scale)
    launches = read_counts()
    rel = tune_mm8.rel_err(walk, tune_mm8.xla_ref(x, w8, scale))
    log(f"  tools/tune_mm8 mm8_w8a8 walk (16 layers): {launches['w8a8']} launches; "
        f"max rel difference from the plain W8A16 walk {rel:.2e} (not a check: the tool's "
        f"tanh chain amplifies any rounding difference from layer to layer)")
    numbers["w8a8"]["launches"] = launches["w8a8"]
    del x, w8, scale, x8
    torch.cuda.empty_cache()

    # tools/probe_int4.py's shapes: B=64, D=4096, O=12288, 16 layers. Its
    # mm8_pallas is W8A16 with unit scales and f32 output
    x, w8, packed = probe_int4.make_inputs()
    ones = torch.ones(12288, device=DEV)
    w8t = w8.transpose(1, 2).contiguous()
    ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, w8[i % 16], ones, torch.float32))
    lib_ms = library_ms(lambda i: torch._weight_int8pack_mm(x, w8t[i % 16], ones.to(bf)))
    bd = gemm_bound(64, 4096, 12288, scale=False, out_bytes=4)
    log(f"  w8a16 unit scales (mm8_pallas) B=64 D=4096 O=12288: kernel {ms:.4f} ms, "
        f"torch._weight_int8pack_mm {fmt_ms(lib_ms)}, bound {bd['bound_ms']:.5f} ms "
        f"({bd['bound_by']})")
    del w8, w8t
    err = 0.0
    for li in (0, 15):
        out = w8_gemm.int4_gemm(x, packed[li])
        ref = w8_gemm.int4_gemm_ref(x, packed[li])
        lo, hi = w8_gemm.unpack_int4(packed[li])
        xa = x.float().abs()
        absref = xa[:, :2048] @ lo.float().abs() + xa[:, 2048:] @ hi.float().abs()
        err = max(err, check_gemm(f"int4 B=64 layer={li}", out, ref, absref))
    ms = time_ms(lambda i: w8_gemm.int4_gemm(x, packed[i % 16]))
    plain_ms = time_ms(lambda i: w8_gemm.int4_gemm_ref(x, packed[i % 16]), n=8)
    lib, note = int4_library(x, packed)
    log(f"  int4 B=64 torch._weight_int4pack_mm (groups of 128, scale 1, zero 0): {note}")
    lib_ms = library_ms(lib) if lib is not None else None
    del lib
    bd = gemm_bound(64, 4096, 12288, w_bytes=0.5, scale=False, out_bytes=4)
    log(f"  int4 B=64 D=4096 O=12288: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch._weight_int4pack_mm {fmt_ms(lib_ms)}, bound {bd['bound_ms']:.5f} ms "
        f"({bd['bound_by']})")
    numbers["int4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bd)
    reset_counts()
    walk = probe_int4.walk_p4(x, packed)
    launches = read_counts()
    rel = tune_mm8.rel_err(walk, probe_int4.walk_plain4(x, packed))
    if not rel < 1e-5:
        raise AssertionError(f"tools/probe_int4 int4 walk disagrees with plain: {rel}")
    log(f"  tools/probe_int4 walk_p4 (16 layers): {launches['int4']} launches, "
        f"max rel err vs plain {rel:.2e}")
    numbers["int4"]["launches"] = launches["int4"]
    del x, packed
    torch.cuda.empty_cache()

    # decode_attention_q8t: one call per layer of an 8B step, bf16 scales
    q, valid, kernels = decode_inputs(BS, seed=2)
    _, _, args, _, _ = kernels["decode_q8t_bf16"]
    reset_counts()
    for li in range(L8):
        decode_attn.decode_attention_q8t(*args(li), scale=HD8 ** -0.5, attend_len=256)
    numbers["q8t_launches"] = read_counts()["decode_q8t"]
    log(f"  decode_attention_q8t, one call per layer at B={BS}, attend 256: "
        f"{numbers['q8t_launches']} launches")
    del q, valid, kernels
    torch.cuda.empty_cache()
    return numbers


def phase_small_int8() -> None:
    """The small model (head dim 128) in bf16 with int8 weights, prefill
    logits on the card (the W8A16 kernel, flash) against the same model on
    the CPU (plain versions). Tolerance: both round to bf16 at the same
    points but sum in other orders, so values may differ by a few bf16 ulps
    that the layers carry on; on the CPU the same model with f32 against
    bf16 activations differs by 0.84% of the largest logit, correlation
    0.99997. Allow 2% of the largest logit and correlation >= 0.9999.

    Then int8 against bf16 weights, on the card and on the CPU, with the
    thresholds of ``tests/test_quant.py`` (argmax agreement > 0.95,
    correlation > 0.999), the agreement counted at the rows with a clear
    argmax (``logit_agreement``): with 152k random logits per row many rows
    are near-ties, and which of them flip depends on the summation order
    (all rows, text: 0.9494 on an NVIDIA H100 and 0.9448 on the CPU of the
    same machine, for the same model and inputs). All rows are logged."""
    cfg = SMALL_CFG
    cpu = demo_backend(cfg, seed=4, dtype=torch.bfloat16, device="cpu").engine
    cpu_bf16 = copy.deepcopy(cpu.params)
    bf16_params = copy.deepcopy(cpu.params).to(DEV)
    cpu.quantize()
    gpu_params = copy.deepcopy(cpu.params).to(DEV)
    if not is_quantized(gpu_params.backbone.layers.wq) or gpu_params.text_head.device.type != "cuda":
        raise AssertionError("small int8 model: weights did not move to the card quantized")
    rng = np.random.default_rng(0)
    B, T, S = 8, 60, 64  # ~420 real positions, so one argmax flip moves agreement 0.24%
    ids = torch.tensor(rng.integers(0, 1000, (B, T, cfg.channels)))
    ids[..., 1:] = torch.tensor(rng.integers(0, 1024, (B, T, cfg.n_vq)))
    valid = torch.zeros((B, S), dtype=torch.bool)
    for b, pad in enumerate(rng.integers(0, 16, B)):
        valid[b, pad:T] = True
    pos = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    outs = {}
    launches = w8_gemm.LAUNCHES_W8A16
    for key, dev, params in (("cpu", "cpu", cpu.params), ("card", DEV, gpu_params),
                             ("card bf16", DEV, bf16_params), ("cpu bf16", "cpu", cpu_bf16)):
        cache = qwen3.init_kv_cache(cfg.language_config, B, S, dtype=torch.bfloat16, device=dev)
        t, a, _ = delay_forward(params, cfg, ids.to(dev), positions=pos.to(dev),
                                kv_valid=valid.to(dev), cache=cache, cache_offset=0)
        outs[key] = (t.cpu(), a[..., :-1].cpu())
    if w8_gemm.LAUNCHES_W8A16 - launches < 7 * cfg.language_config.num_hidden_layers + 2:
        raise AssertionError("small int8 model: the card's forward did not go through W8A16")
    rows = valid[:, :T]
    # the JAX package's own check of int8 weights (tests/test_quant.py:36-41),
    # int8 against bf16 weights of this 2-layer model; argmax agreement
    # counted at the clear rows (``logit_agreement``), all rows logged
    for where, i8, b16 in (("card", "card", "card bf16"), ("CPU", "cpu", "cpu bf16")):
        stats = [logit_agreement(outs[i8][i][rows], outs[b16][i][rows]) for i in (0, 1)]
        if not (min(st[1] for st in stats) > 0.95 and stats[0][2] > 0.999):
            raise AssertionError(f"small model, int8 vs bf16 weights on the {where}: (agreement, "
                                 f"at clear rows, correlation) text {stats[0]}, audio {stats[1]}")
        log(f"  small model, int8 vs bf16 weights on the {where}: argmax agreement at all rows "
            f"text {stats[0][0]:.4f}, audio {stats[1][0]:.4f}; at clear rows {stats[0][1]:.4f}, "
            f"{stats[1][1]:.4f} (> 0.95); correlation text {stats[0][2]:.6f} (> 0.999), audio "
            f"{stats[1][2]:.6f}")
    for i, what in ((0, "text"), (1, "audio")):
        got, ref = outs["card"][i][rows], outs["cpu"][i][rows]
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        corr = float(np.corrcoef(got.flatten().numpy(), ref.flatten().numpy())[0, 1])
        if not (err <= 0.02 * top and corr >= 0.9999):
            raise AssertionError(f"small int8 model {what} logits, card vs CPU: max abs err "
                                 f"{err} of {top}, correlation {corr}")
        log(f"  small int8-weight bf16 model, {what} logits card (kernels) vs CPU (plain): "
            f"max_abs_err={err:.3e} of max {top:.3f} (tol 2%), correlation {corr:.6f} "
            f"(tol 0.9999)")


# kernel name -> (module, attribute) of its launch count (the byte-load count
# of W8A16 is a share of its launches, not a kernel)
COUNTERS = {k: v for k, v in kernel_launches.COUNTERS.items() if k != "w8a16_bytes"}
# kernels no serving path runs, as in the JAX package: their launches come
# from phase 3's drive of the path that does run them (a tool's walk, or
# decode_attention_q8t once per layer)
OFF_PATH = ("decode_q8t", "w8a8", "int4")
# what only phase 13 runs: W8A16's float32-activation mode (the int8 codec),
# and text_lazy's condition kernel (no engine turns text_lazy on, as in JAX)
PHASE13 = ("w8f32", "lazy_cond")


# kernels the main paths launch inside replayed CUDA graphs (flash in the
# prefill graphs from a key's second use on, the others in the decode steps')
IN_GRAPHS = ("flash", "decode", "decode_q8", "paged", "paged_q8", "w8a16")


def reset_counts() -> None:
    """Every wrapper's count and every count of launches inside replayed
    graphs to 0."""
    kernel_launches.reset()


def read_counts() -> dict:
    """Each kernel's launches since ``reset_counts``, and under ``"graphs"``
    how many of them ran inside replayed CUDA graphs."""
    torch.cuda.synchronize()
    counts = {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}
    counts["graphs"] = {name: kernel_launches.IN_GRAPHS[name] for name in COUNTERS}
    return counts


def read_collectives() -> dict:
    """The collectives a sharded model issued since ``reset_counts``
    (``launches.COLLECTIVES``), and how many of them ran inside replayed
    CUDA graphs."""
    (name, (mod, attr)), = kernel_launches.COLLECTIVES.items()
    return {name: getattr(mod, attr), "in_graphs": kernel_launches.IN_GRAPHS[name]}


def drive_solo(backend, label: str):
    """Three ``synthesize`` requests and one greedy batch-4 ``generate`` on
    ``backend`` at 8B width, with the launch counts set to 0 just before and
    read just after. Returns (counts, prefills, decode steps)."""
    cfg = backend.engine.config
    engine, proc = backend.engine, backend.processor
    calls = []
    generate = engine.generate

    def recorded_generate(input_ids, attention_mask=None, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(input_ids, attention_mask, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        frames = out[0][1].shape[0] - out[0][0]  # generated frames (first from the prefill)
        calls.append(dict(batch=len(out), prompt=int(np.shape(input_ids)[1]),
                          frames=int(frames), wall_s=wall))
        return out

    engine.generate = recorded_generate
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    for i, (text, seed) in enumerate((("Hello from the port on a GPU.", 1),
                                      ("The quick brown fox jumps over the lazy dog.", 2),
                                      ("Speech synthesis at eight billion parameters.", 3))):
        t = time.perf_counter()
        sr, wav, _ = synthesize(backend, text, max_new_tokens=112, seed=seed)
        if not (wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()):
            raise AssertionError(f"{label} synthesize #{i}: bad waveform {wav.shape}")
        c = calls[-1]
        log(f"  {label} synthesize #{i}: prompt {c['prompt']} tokens, {c['frames']} frames, "
            f"wave {wav.size / sr:.2f} s at {sr} Hz, request {time.perf_counter() - t:.2f} s, "
            f"generate {c['wall_s']:.2f} s ({(c['frames'] - 1) / c['wall_s']:.1f} decode steps/s, "
            f"{c['wall_s'] / max(c['frames'] - 1, 1) * 1e3:.1f} ms/step)")

    batch = four_prompts(proc)
    out = engine.generate(batch["input_ids"], batch["attention_mask"], max_new_tokens=96,
                          text_temperature=0.0, audio_temperature=0.0)
    for start, grid in out:
        if grid.shape != (start + calls[-1]["frames"], cfg.channels) or grid.min() < 0:
            raise AssertionError(f"{label}: bad grid {grid.shape}")
    c = calls[-1]
    log(f"  {label} generate B=4 greedy: prompt {c['prompt']} tokens, {c['frames']} frames/row, "
        f"{c['wall_s']:.2f} s ({(c['frames'] - 1) / c['wall_s']:.1f} decode steps/s, "
        f"{c['wall_s'] / max(c['frames'] - 1, 1) * 1e3:.1f} ms/step)")
    torch.cuda.synchronize()
    counts = read_counts()
    del engine.generate  # back to the class's method
    prefills = len(calls)
    steps = sum(c["frames"] - 1 for c in calls)
    L = cfg.language_config.num_hidden_layers
    if counts["flash"] < L * prefills or counts["decode"] < L * steps:
        raise AssertionError(f"{label}: launch counts {counts} below {L} x {prefills} prefills / "
                             f"{L} x {steps} decode steps")
    log(f"  {label} launches: flash {counts['flash']} for {prefills} prefills (>= {L} each), "
        f"decode {counts['decode']} for {steps} decode steps (>= {L} each)")
    log(f"  {label} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, prefills, steps


def four_prompts(proc):
    prompts = ["Hi.", "A longer second prompt for the batch.", "Third.",
               "The fourth and longest prompt of this batch of four requests."]
    batch = proc([[proc.build_user_message(text=p)] for p in prompts], mode="generation")
    if batch["attention_mask"].all():
        raise AssertionError("expected left-padded prompts")
    return batch


def phase_main_path():
    cfg = delay_8b()
    t0 = time.perf_counter()
    backend = demo_backend(cfg, codec_1p6b(), seed=0, dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    log(f"  init on card: delay_8b bf16 + codec_1p6b f32 in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    counts, _, _ = drive_solo(backend, "bf16")
    return counts, backend, on_device_segments(backend)


def on_device_segments(backend) -> dict:
    """4b: the batch-4 greedy ``generate`` with ``on_device=True``: JAX's
    segment loop, each attend segment one launch of a loop graph (the
    condition read on the card after every step) and one read of the
    flags, one launch per segment; its first frame equal to
    ``on_device=False``'s (7a holds each mode frame for frame against its
    eager steps). Returns the launch counts of the call alone."""
    engine, proc = backend.engine, backend.processor
    batch = four_prompts(proc)
    kw = dict(max_new_tokens=96, text_temperature=0.0, audio_temperature=0.0)
    host = engine.generate(batch["input_ids"], batch["attention_mask"], **kw)
    (steps,) = engine._steps.values()
    before = steps._loop.launches if steps._loop is not None else 0
    reset_counts()
    with host_waits() as waits:
        torch.cuda.synchronize()
        t = time.perf_counter()
        dev = engine.generate(batch["input_ids"], batch["attention_mask"], on_device=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counts = read_counts()
    launched = steps._loop.launches - before
    T = batch["input_ids"].shape[1]
    cache_len = -(-(T + kw["max_new_tokens"] + 1) // engine.cache_bucket) * engine.cache_bucket
    n, segments = 1, 0  # JAX's segments (delay_engine.py:221-229) while no row stops
    while n < kw["max_new_tokens"]:
        attend = attend_bucket(T + n + 2, engine.cache_bucket, cache_len)
        n, segments = min(attend - T - 1, kw["max_new_tokens"]), segments + 1
    frames = dev[0][1].shape[0] - dev[0][0]
    if frames == kw["max_new_tokens"] and launched != segments:
        raise AssertionError(f"on_device: {launched} loop-graph launches for {segments} segments")
    # the two modes attend other buckets at some steps (JAX's loops: T + n + 2
    # against T + n + 1), which round otherwise at 8B: only the first frame
    # must agree (7a holds each mode's graphs against its eager steps)
    firsts = [first_divergence(a, b) for a, b in zip(dev, host)]
    if 0 in firsts:
        raise AssertionError("on_device=True's first frame differs from on_device=False's")
    log(f"  bf16 generate B=4 greedy on_device=True: {frames} frames in {wall:.2f} s "
        f"({wall / max(frames - 1, 1) * 1e3:.1f} ms/step), {launched} loop-graph launches for "
        f"{segments} attend segments, {waits[0]} host waits; first frame differing from "
        f"on_device=False's: {firsts}")
    return counts


SERVER_MODES = (  # name, DelayBatchServer options, the decode kernel it runs
    ("linear bf16", {}, "decode"),
    ("linear int8", dict(kv_quant=True), "decode_q8"),
    ("paged bf16", dict(paged=True), "paged"),
    ("paged int8", dict(paged=True, kv_quant=True), "paged_q8"),
)


def server_traffic(cfg, n: int = 24, seed: int = 0):
    """The JAX benchmark's batch-server load (``bench.py:684-696``): random
    prompt grids of 48-96 rows ending in the gen-slot token, budgets drawn
    from 48-96 frames."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        T = int(rng.integers(48, 96))
        grid = rng.integers(0, 1000, (T, cfg.channels))
        grid[:, 1:] = rng.integers(0, 1024, (T, cfg.n_vq))
        grid[-1, 0] = cfg.audio_assistant_gen_slot_token_id
        prompts.append(grid)
    return prompts, [int(x) for x in rng.integers(48, 96, n)]


def phase_server(params, modes=SERVER_MODES, label: str = "", w8_per_pass: int = 0) -> dict:
    """``DelayBatchServer(slots=16, cache_len=1024, out_capacity=128,
    prompt_bucket=32, page_size=128)`` over phase 4's 8B weights, one cache
    mode at a time: 24 requests into 16 slots, sampled at text and audio
    temperature 1.7, audio top-p 0.8. With ``w8_per_pass`` (int8 weights)
    every prefill and decode step must also launch the W8A16 kernel at
    least that many times."""
    cfg = delay_8b()
    L = cfg.language_config.num_hidden_layers
    prompts, budgets = server_traffic(cfg)
    counts = {}
    for name, mode, kernel in modes:
        name = f"{label}{name}"
        server = DelayBatchServer(
            params, cfg, slots=BS, cache_len=SS, out_capacity=128, prompt_bucket=32,
            page_size=PS, dtype=torch.bfloat16,
            sampling=make_sampling(text_temperature=1.7, audio_temperature=1.7,
                                   audio_top_p=0.8, device=DEV), **mode)
        t = time.perf_counter()
        server.warmup(prompt_lens=(64, 96), attend_upto=256)
        warm_s = time.perf_counter() - t
        server.total_steps, server.util_sum, server.total_preemptions = 0, 0.0, 0
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        rids = {server.submit(g, max_new_tokens=n): n for g, n in zip(prompts, budgets)}
        with splice_audit(server, "_prefill_into") as spliced:
            done = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        mode_counts = read_counts()
        if sorted(c.request_id for c in done) != sorted(rids):
            raise AssertionError(f"server {name}: {len(done)} of {len(rids)} requests completed")
        for c in done:
            if (c.tokens.ndim != 2 or c.tokens.shape[1] != cfg.channels
                    or c.tokens.shape[0] != c.start_length + c.steps or c.tokens.min() < 0
                    or not 0 < c.steps <= rids[c.request_id]):
                raise AssertionError(f"server {name}: malformed grid {c.tokens.shape}, "
                                     f"{c.steps} steps for budget {rids[c.request_id]}")
        steps, admissions = server.total_steps, len(rids) + server.total_preemptions
        if (mode_counts[kernel] < L * steps or mode_counts["flash"] < L * admissions
                or mode_counts["w8a16"] < w8_per_pass * (steps + admissions)):
            raise AssertionError(f"server {name}: launch counts {mode_counts} below {L} x "
                                 f"{steps} steps ({kernel}) / {L} x {admissions} prefills (flash)"
                                 f" / {w8_per_pass} x {steps + admissions} passes (w8a16)")
        frames = sum(min(c.steps, rids[c.request_id]) for c in done)
        kv_bytes = sum(t.numel() * t.element_size() for t in server.state.cache if t.ndim > 2)
        log(f"  server {name}: {len(done)} requests, {steps} steps, {frames} frames in "
            f"{wall:.2f} s = {frames / wall:.1f} frames/s ({wall / steps * 1e3:.1f} ms/step), "
            f"mean utilization {server.util_sum / steps:.3f}, "
            f"{server.total_preemptions} preemptions, KV cache {kv_bytes / 2**30:.3f} GiB, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"(warmup {warm_s:.2f} s)")
        log(f"  server {name}: admissions {spliced['warm']} warm (prefill and splice one "
            f"replay, no eager row copy), {spliced['eager']} eager (unwarmed buckets)")
        log(f"  server {name}: launches {kernel} {mode_counts[kernel]} (>= {L} x {steps}), "
            f"flash {mode_counts['flash']} (>= {L} x {admissions})"
            + (f", w8a16 {mode_counts['w8a16']} (>= {w8_per_pass} x {steps + admissions})"
               if w8_per_pass else ""))
        counts[name] = mode_counts
        del server, done
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


@contextlib.contextmanager
def plain_w8a16():
    """Within: every int8 dense layer and head computes through the W8A16
    kernel's plain version, on the card (the reference for phase 6)."""
    kernel = w8_gemm.w8a16_gemm
    w8_gemm.w8a16_gemm = w8_gemm.w8a16_gemm_ref
    try:
        yield
    finally:
        w8_gemm.w8a16_gemm = kernel


CLEAR = 0.1  # a clear argmax: top-1 above top-2 by this share of the row's logit std


def logit_agreement(got, ref):
    """(argmax agreement at all rows, at the rows where ``ref``'s argmax is
    clear, correlation) of two (..., V) logit tensors. With random weights
    many rows are near-ties that any rounding decides (the top two of 1025
    or 152k Gaussian logits lie ~0.2-0.3 std apart on average); a clear row
    has its top two ``CLEAR`` std apart."""
    got, ref = got.float(), ref.float()
    same = got.argmax(-1) == ref.argmax(-1)
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > CLEAR * ref.std(dim=-1)
    corr = float(torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]))[0, 1])
    return float(same.float().mean()), float(same[clear].float().mean()), corr


def phase_int8(backend):
    """Phase 6 on phase 4's engine: the bf16 logits of one batch-4 prefill,
    ``engine.quantize()`` in place, and the int8 logits of the same prefill
    (kernels) held against the same int8 model through the plain versions
    and against the bf16 logits; then the solo requests and the server in
    two KV modes on the int8 weights. Every prefill and decode step runs 7
    W8A16 launches per layer plus one for the text head and one for the 32
    audio heads.

    The logit checks run at full width over the first 2 of the 36 layers
    (the depth of the JAX package's own check, ``tests/test_quant.py``):
    int8 against bf16 weights with its thresholds (argmax agreement > 0.95
    at all rows, as there, and at the rows with a clear argmax,
    ``logit_agreement``; correlation > 0.999), kernels against plain versions within argmax
    agreement > 0.99 there, correlation > 0.9999: summing in another order
    alone moves 2-layer logits by ~1e-5 of correlation at width 1024 on the
    CPU, more at 4096 (the first run here measured 0.99996, NVIDIA H100).
    Over all 36 layers of random
    weights a difference grows from layer to layer, whatever its source:
    the first runs of this phase measured, on an NVIDIA H100, int8 against
    bf16 argmax agreement 0.497 (text) / 0.844 (audio), correlation 0.9964,
    and the kernels against the plain versions (a bf16 rounding apart here
    and there) 0.848 / 0.940, correlation 0.99973. Those are logged, with
    only a text correlation > 0.99 required."""
    engine, proc = backend.engine, backend.processor
    cfg = engine.config
    per_pass = 7 * cfg.language_config.num_hidden_layers + 2
    cut = dataclasses.replace(cfg, language_config=dataclasses.replace(
        cfg.language_config, num_hidden_layers=2))
    batch = four_prompts(proc)
    ids = torch.as_tensor(batch["input_ids"], device=DEV)
    mask = torch.as_tensor(batch["attention_mask"], device=DEV)
    B, T, _ = ids.shape

    def prefill_logits(c):  # the model of config c: the first c's layers of the 36
        cache = qwen3.init_kv_cache(c.language_config, B, 256, dtype=torch.bfloat16, device=DEV)
        valid = torch.zeros((B, 256), dtype=torch.bool, device=DEV)
        valid[:, :T] = mask
        pos = torch.arange(T, dtype=torch.int32, device=DEV)[None].expand(B, T)
        t, a, _ = delay_forward(engine.params, c, ids, positions=pos, kv_valid=valid,
                                cache=cache, cache_offset=0)
        return t[mask], a[mask][..., :-1]  # real positions; the masked pad column dropped

    bf16 = {d: prefill_logits(c) for d, c in ((2, cut), (36, cfg))}
    bf16_bytes = param_bytes(engine.params)
    t0 = time.perf_counter()
    engine.quantize()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    int8_bytes = param_bytes(engine.params)
    log(f"  engine.quantize() in {quant_s:.2f} s: Delay parameters {bf16_bytes / 1e9:.2f} GB "
        f"(bf16) -> {int8_bytes / 1e9:.2f} GB (int8 matmul weights), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    if engine.params.audio_heads.q.stride(-2) % 16:
        raise AssertionError(f"the int8 audio stack is not at a 16-byte row pitch "
                             f"{engine.params.audio_heads.q.stride()}")
    w8_gemm.LAUNCHES_W8A16_BYTES = 0
    w8a16_one_kernel(engine, proc)
    reset_counts()
    kern = {d: prefill_logits(c) for d, c in ((2, cut), (36, cfg))}
    if read_counts()["w8a16"] < per_pass:
        raise AssertionError("int8 prefill did not go through the W8A16 kernel")
    with plain_w8a16():
        plain = {d: prefill_logits(c) for d, c in ((2, cut), (36, cfg))}
    n = int(mask.sum())
    for d in (2, 36):
        rows = {}
        for what, got, ref in (("int8 kernels vs plain versions", kern[d], plain[d]),
                               ("int8 (kernels) vs bf16", kern[d], bf16[d]),
                               ("int8 (plain versions) vs bf16", plain[d], bf16[d])):
            rows[what] = [logit_agreement(got[i], ref[i]) for i in (0, 1)]
            (at, ct, rt), (aa, ca, ra) = rows[what]
            log(f"  {what}, prefill logits over {d} layers (B={B}, T={T}, {n} positions): "
                f"argmax agreement text {at:.4f}, audio {aa:.4f}; at clear rows {ct:.4f}, "
                f"{ca:.4f}; correlation text {rt:.7f}, audio {ra:.7f}")
        k, b = rows["int8 kernels vs plain versions"], rows["int8 (kernels) vs bf16"]
        if d == 2 and not (min(k[0][1], k[1][1]) > 0.99 and k[0][2] > 0.9999):
            raise AssertionError(f"2 layers, int8 kernels vs plain versions: {rows}")
        if d == 2 and not (min(b[0][0], b[1][0], b[0][1], b[1][1]) > 0.95 and b[0][2] > 0.999):
            raise AssertionError(f"2 layers, int8 vs bf16 weights: {rows}")
        if not min(r[0][2] for r in rows.values()) > 0.99:
            raise AssertionError(f"{d} layers: a text correlation under 0.99: {rows}")
    log("  checked: 2 layers, kernels vs plain argmax at clear rows > 0.99, correlation > "
        "0.9999; int8 vs bf16 argmax at all and at clear rows > 0.95, correlation > 0.999; "
        "36 layers, text correlation > 0.99")
    del bf16, kern, plain
    torch.cuda.empty_cache()

    counts, prefills, steps = drive_solo(backend, "int8")
    if counts["w8a16"] < per_pass * (prefills + steps):
        raise AssertionError(f"int8 solo: {counts['w8a16']} W8A16 launches below {per_pass} x "
                             f"({prefills} prefills + {steps} decode steps)")
    log(f"  int8 launches: w8a16 {counts['w8a16']} (>= {per_pass} x ({prefills} prefills + "
        f"{steps} decode steps))")
    gc.collect()
    torch.cuda.empty_cache()
    server_counts = phase_server(engine.params, modes=(SERVER_MODES[0], SERVER_MODES[3]),
                                 label="int8 weights, ", w8_per_pass=per_pass)
    if w8_gemm.LAUNCHES_W8A16_BYTES:
        raise AssertionError(f"{w8_gemm.LAUNCHES_W8A16_BYTES} W8A16 launches on the int8 serving "
                             "paths took byte loads")
    log("  every W8A16 launch of phase 6 read its weights with 16-byte loads (the audio stack "
        f"at row pitch {engine.params.audio_heads.q.stride(-2)} bytes)")
    return counts, server_counts


def w8a16_one_kernel(engine, proc) -> None:
    """A short greedy int8 ``generate`` (prefill and 3 decode steps) under
    ``torch.profiler``: the device kernels of ``csrc/w8_gemm.cu`` equal the
    W8A16 launches counted, all of them the one-launch ``ring_kernel`` (the
    split-K sum stays inside it: no reduce pass). The session is
    ``profile_step.device_profile``'s, whose opening burst of throwaway
    kernels takes the records a session can lose."""
    batch = four_prompts(proc)
    before = w8_gemm.LAUNCHES_W8A16
    with profile_step.device_profile() as prof:
        engine.generate(batch["input_ids"], batch["attention_mask"], max_new_tokens=4,
                        text_temperature=0.0, audio_temperature=0.0)
        torch.cuda.synchronize()
    launches = w8_gemm.LAUNCHES_W8A16 - before
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "mosstts::w8::" in e.key]
    kernels = sum(e.count for e in evts)
    if kernels != launches or not launches or any("ring_kernel" not in e.key for e in evts):
        raise AssertionError(f"int8 generate: {launches} W8A16 launches, device kernels "
                             f"{[(e.key[:80], e.count) for e in evts]}")
    log(f"  int8 generate (prefill + 3 steps) under torch.profiler: {launches} W8A16 launches, "
        f"{kernels} device kernels of w8_gemm.cu, all ring_kernel (no split-K reduce pass)")


SOLO_NEW = 48  # new frames of each generate in phase 7
SEEDS = (1, 2, 1)  # s1, s2, s1: the third sampled call must repeat the first


def same_grids(a, b) -> bool:
    return len(a) == len(b) and all(sa == sb and np.array_equal(ga, gb)
                                    for (sa, ga), (sb, gb) in zip(a, b))


def solo_graphs_vs_eager(engine, proc, label: str) -> None:
    """``generate`` at B = 1 and 4, ``on_device`` False and True, greedy and
    sampled with the seeds s1, s2, s1, on ``engine`` (its decode steps CUDA
    graph replays) and on an eager engine over the same weights: every grid
    equal bit for bit, the third sampled call equal to the first, the
    second different. Logs both engines' decode steps per second."""
    eager = DelayEngine(engine.params, engine.config, dtype=engine.dtype,
                        cache_bucket=engine.cache_bucket, graphs=False)
    batches = ((1, proc([[proc.build_user_message(text="One row through the graphs.")]],
                        mode="generation")), (4, four_prompts(proc)))
    calls = [("greedy", dict(text_temperature=0.0, audio_temperature=0.0))] + [
        (f"seed {s}", dict(seed=s, text_temperature=1.5, audio_temperature=1.7)) for s in SEEDS]
    torch.cuda.reset_peak_memory_stats()
    for B, batch in batches:
        for on_device in (False, True):
            sampled, walls = [], {"graph": 0.0, "eager": 0.0}
            steps = 0
            for what, kw in calls:
                out = {}
                for name, eng in (("graph", engine), ("eager", eager)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out[name] = eng.generate(batch["input_ids"], batch["attention_mask"],
                                             max_new_tokens=SOLO_NEW, on_device=on_device, **kw)
                    torch.cuda.synchronize()
                    walls[name] += time.perf_counter() - t
                if not same_grids(out["graph"], out["eager"]):
                    raise AssertionError(f"{label} B={B} on_device={on_device} {what}: graph "
                                         "steps gave other tokens than eager steps")
                steps += out["graph"][0][1].shape[0] - out["graph"][0][0] - 1
                if what != "greedy":
                    sampled.append(out["graph"])
            if not same_grids(sampled[0], sampled[2]) or same_grids(sampled[0], sampled[1]):
                raise AssertionError(f"{label} B={B} on_device={on_device}: seeds s1, s2, s1 "
                                     "did not give s1's grid twice and s2's apart")
            log(f"  {label} generate B={B} on_device={on_device}: greedy and seeds s1, s2, s1, "
                f"graph grids == eager grids, s1 repeats; {steps} decode steps, graph "
                f"{steps / walls['graph']:.1f} steps/s, eager {steps / walls['eager']:.1f} "
                f"steps/s (prefill included)")
    log(f"  {label} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with "
        f"both engines' static states and graphs held; graphs held: "
        f"{sum(len(st.keys) for st in engine._steps.values())}")
    del eager
    engine_memory(engine, label)


def engine_memory(engine, label: str) -> None:
    """What ``engine`` holds besides its weights after a phase: its one
    static decode state (the KV cache and the other buffers) and its graphs'
    memory pool, read as the device memory allocated and reserved that
    dropping them frees. Raises if it holds more than one state."""
    if len(engine._steps) > 1:
        raise AssertionError(f"{label}: the engine holds {len(engine._steps)} decode states")
    ((key, steps),) = engine._steps.items()
    kv = sum(t.nbytes for t in steps.state.cache)
    state = kv + sum(t.nbytes for t in steps.state[1:] if isinstance(t, torch.Tensor))
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    graphs = len(steps.keys)
    engine._steps.clear()
    del steps
    gc.collect()
    torch.cuda.empty_cache()
    freed = [(a - b) / 2**30 for a, b in zip(held, (torch.cuda.memory_allocated(),
                                                    torch.cuda.memory_reserved()))]
    log(f"  {label} engine memory after the phase: one decode state (B, cache_len, kv_quant) = "
        f"{key}, KV cache {kv / 2**30:.3f} GiB, state {state / 2**30:.3f} GiB, {graphs} graphs; "
        f"dropping it frees {freed[0]:.3f} GiB allocated, {freed[1]:.3f} GiB reserved")


def server_graphs_vs_eager(params, label: str) -> None:
    """Phase 5's 24 requests in the linear bf16 and the paged int8 KV modes,
    served with CUDA-graph steps and with eager steps: the completions must
    be equal. 8 requests are admitted mid-flight, and the paged pool of 20
    pages (a slot needs 2 at the end of most requests) forces preemptions."""
    cfg = delay_8b()
    prompts, budgets = server_traffic(cfg)
    for name, mode in (("linear bf16", {}),
                       ("paged int8", dict(paged=True, kv_quant=True, num_pages=21))):
        res = {}
        for graphs in (True, False):
            server = DelayBatchServer(
                params, cfg, slots=BS, cache_len=SS, out_capacity=128, prompt_bucket=32,
                page_size=PS, dtype=torch.bfloat16, graphs=graphs,
                sampling=make_sampling(text_temperature=1.7, audio_temperature=1.7,
                                       audio_top_p=0.8, device=DEV), **mode)
            server.warmup(prompt_lens=(64, 96), attend_upto=256)
            server.total_steps, server.total_preemptions = 0, 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            for g, n in zip(prompts, budgets):
                server.submit(g, max_new_tokens=n)
            done = sorted(server.run(), key=lambda c: c.request_id)
            torch.cuda.synchronize()
            res[graphs] = (done, server.total_steps, server.total_preemptions,
                           time.perf_counter() - t)
            del server
            gc.collect()
            torch.cuda.empty_cache()
        (got, steps, pre, wall), (ref, steps_e, pre_e, wall_e) = res[True], res[False]
        if len(got) != len(prompts) or [c.request_id for c in got] != [c.request_id for c in ref]:
            raise AssertionError(f"{label} server {name}: {len(got)} / {len(ref)} completions")
        for a, b in zip(got, ref):
            if a.steps != b.steps or not np.array_equal(a.tokens, b.tokens):
                raise AssertionError(f"{label} server {name}: request {a.request_id} differs "
                                     "between graph and eager steps")
        if (steps, pre) != (steps_e, pre_e) or (mode.get("paged") and not pre):
            raise AssertionError(f"{label} server {name}: steps {steps}/{steps_e}, "
                                 f"preemptions {pre}/{pre_e}")
        frames = sum(c.steps for c in got)
        log(f"  {label} server {name}: 24 requests (8 mid-flight), {pre} preemptions, {steps} "
            f"steps; graph completions == eager completions; graph {frames / wall:.1f} "
            f"frames/s ({wall / steps * 1e3:.2f} ms/step), eager {frames / wall_e:.1f} frames/s "
            f"({wall_e / steps * 1e3:.2f} ms/step)")


def step_times(engine, label: str) -> list:
    """``tools/profile_step``'s decode step, eager against CUDA graph, at
    B = 1 and 16 (prompt 200, cache 512, attend 256): step wall (host
    clock), device time and kernels per step (``torch.profiler``), idle
    share, peak device memory."""
    args = SimpleNamespace(prompt=200, cache=512, attend=256, steps=16, top=4)
    rows = []
    for B in (1, 16):
        for graphs in (False, True):
            r = profile_step.profile_batch(engine, B, args, None, graphs)
            rows.append(dict(weights=label, **{k: r[k] for k in (
                "batch", "steps", "step_wall_ms", "step_device_ms", "kernels_per_step",
                "idle_share", "peak_gib")}))
            log(f"  {label} decode step B={B} {r['steps']}: wall {r['step_wall_ms']:.3f} ms, "
                f"device {r['step_device_ms']:.3f} ms, {r['kernels_per_step']:.0f} device "
                f"kernels, idle share {r['idle_share']:.3f}, peak {r['peak_gib']:.2f} GiB")
            if graphs and r["step_device_ms"] <= 0:
                raise AssertionError(f"{label} B={B}: the profiler saw no device time in "
                                     "graph steps")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 8
PHASE8_NEW = 112  # new frames of each front-end request (96-128)
NEAR_TIE = 1e-4  # relative gap of two squared RVQ distances that counts as a tie
CLONE_TEXTS = ("The first cloned voice reads this sentence.",
               "A second request in the same voice, a little longer than the first one.",
               "Third.",
               "The fourth clone request speaks the last line of this test.")


def sweep_wav(seconds: float, seed: int, sr: int = 24000) -> np.ndarray:
    """A reference voice from ``seed``: a 120-520 Hz sine sweep plus noise."""
    t = np.arange(int(sr * seconds)) / sr
    freq = 120.0 + 400.0 * t / seconds
    noise = np.random.default_rng(seed).standard_normal(t.size)
    return (0.3 * np.sin(2 * np.pi * np.cumsum(freq) / sr) + 0.05 * noise).astype(np.float32)


@contextlib.contextmanager
def rvq_inputs():
    """Within: every latent block the codec's encoder hands to ``rvq_encode``
    is kept (on the CPU, float32) in the yielded list."""
    from mosstts_tpu_torch.codec import model as codec_model

    seen, real = [], codec_model.rvq_encode

    def kept(params, lat, nq):
        seen.append(lat.detach().float().cpu())
        return real(params, lat, nq)

    codec_model.rvq_encode = kept
    try:
        yield seen
    finally:
        codec_model.rvq_encode = real


def code_mismatches(label: str, got, ref, lat, books) -> int:
    """Frames whose codes differ between ``got`` and ``ref`` (NQ, B, T). At
    the first level where a frame differs, the two chosen entries' squared
    distances from ``ref``'s residual (float64, from the latents ``lat`` (B,
    T, D) that ``ref`` was encoded from) must tie within ``NEAR_TIE``
    relative; the later levels follow from that one."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        raise AssertionError(f"{label}: code shapes {got.shape} and {ref.shape}")
    books = books.double()
    frames = np.argwhere((got != ref).any(axis=0))
    worst = 0.0
    for b, t in frames:
        lvl = int(np.nonzero(got[:, b, t] != ref[:, b, t])[0][0])
        r = lat[b, t].double() - sum(books[j][int(ref[j, b, t])] for j in range(lvl))
        d = ((r[None] - books[lvl]) ** 2).sum(-1)
        da, db = float(d[int(ref[lvl, b, t])]), float(d[int(got[lvl, b, t])])
        gap = abs(da - db) / max(da, db, 1e-30)
        worst = max(worst, gap)
        if gap > NEAR_TIE:
            raise AssertionError(f"{label}: frame {t} of row {b} differs from level {lvl} on, "
                                 f"squared distances {da} and {db} (gap {gap:.3e} relative, "
                                 f"a tie is under {NEAR_TIE})")
    log(f"  {label}: {len(frames)} of {ref.shape[1] * ref.shape[2]} frames differ"
        + (f", each first at a near tie (largest gap {worst:.2e} relative)" if len(frames) else ""))
    return len(frames)


def cpu_encoder_copy(params, cfg):
    """The encode half of ``params`` for config ``cfg`` (its first
    ``cfg.num_encoder_layers`` layers) as a float32 CodecParams on the CPU."""
    from mosstts_tpu_torch.codec.model import CodecParams

    card = dict(params.named_parameters())
    cpu = CodecParams(cfg)
    with torch.no_grad():
        for name, dst in cpu.named_parameters():
            src = card[name]
            dst.copy_(src[: dst.shape[0]] if src.shape != dst.shape else src)
    return cpu


def codec_graphs_vs_eager(label: str, graph, eager, calls) -> list:
    """Each ``(what, key, run)`` of ``calls``: ``run(codec)`` (host arrays)
    through ``graph``, whose chunks replay its captured graph at ``key``,
    and through ``eager`` (``graphs=False``, the same weights), equal bit
    for bit; each way's wall (median of 5, host clock) and device ms and
    kernels (one call under the profiler, ``profile_step.call_times``), the
    graph's kernel nodes (the launches of one chunk) and its memory pool's
    bytes."""
    from mosstts_tpu_torch.engine.step_graph import pool_bytes

    rows = []
    for what, key, run in calls:
        before = dict(graph.chunks.counts)
        got, ref = run(graph), run(eager)
        if not np.array_equal(got, ref):
            raise AssertionError(f"{label} {what}: the graph's output differs from eager's")
        counts = {k: v - before[k] for k, v in graph.chunks.counts.items()}
        found = graph.chunks.graph_of(key)
        if found is None or counts["eager"] or not counts["replay"]:
            raise AssertionError(f"{label} {what}: not a replay of the graph at {key}: {counts}")
        g = profile_step.call_times(lambda: run(graph))
        e = profile_step.call_times(lambda: run(eager))
        nbytes = pool_bytes(found[1])
        row = dict(what=what, key=str(key), chunks=counts["replay"], graph=g, eager=e,
                   graph_kernels=graph_nodes(found[0])[0], pool_bytes=nbytes)
        rows.append(row)
        log(f"  {label} {what}: graph == eager bit for bit; {counts['replay']} chunk(s); wall "
            f"graph {g['wall_ms']:.3f} / eager {e['wall_ms']:.3f} ms, device {g['device_ms']:.3f}"
            f" / {e['device_ms']:.3f} ms, kernels {g['kernels']} / {e['kernels']} "
            f"({row['graph_kernels']} kernel nodes a chunk), the key's pool "
            + ("not measured" if nbytes is None else f"{nbytes / 2**20:.1f} MiB"))
    return rows


@contextlib.contextmanager
def codec_chunks(label: str, codec, eager_ok: bool = False):
    """Within: ``codec``'s chunks; after, they are logged, and none may have
    been captured (a server's codec captures only in its warmup), nor, unless
    ``eager_ok``, run eagerly (a key the warmup did not capture)."""
    before, got = dict(codec.chunks.counts), {}
    yield got
    got.update({k: v - before[k] for k, v in codec.chunks.counts.items()})
    log(f"  {label}: codec chunks {got}")
    if got["capture"] or not got["replay"] or (got["eager"] and not eager_ok):
        raise AssertionError(f"{label}: the codec's chunks were not all replays of graphs its "
                             f"warmup captured: {got}")


def phase_codec_encode(codec, wav: np.ndarray) -> dict:
    """Phase 8a: ``codec_1p6b()`` encode of a 4 s wave on the card. With the
    first 2 of 22 encoder layers (full width), the card's codes against the
    CPU's on the same weights; at all 22 layers, the warmed graphs (encode
    and a 100-frame decode, one replay a chunk) against the same chunks
    eagerly, bit for bit, with their times, 1 s chunks (a key captured on
    use) against eager and against one-shot, and the encode time per second
    of audio."""
    from mosstts_tpu_torch.codec.model import MossAudioTokenizer

    cfg = codec.config
    seconds = wav.size / cfg.sampling_rate
    cut = dataclasses.replace(cfg, num_encoder_layers=2, num_decoder_layers=1)
    with rvq_inputs() as lat_cpu:
        cpu_codes = MossAudioTokenizer(cpu_encoder_copy(codec.params, cut), cut).encode(wav)
    card_codes = MossAudioTokenizer(codec.params, cut).encode(wav)
    n_q, T = cfg.n_q, int(np.ceil(wav.size / cfg.hop))
    if card_codes.audio_codes.shape != (n_q, 1, T):
        raise AssertionError(f"encode: codes {card_codes.audio_codes.shape}, want {(n_q, 1, T)}")
    np.testing.assert_array_equal(card_codes.audio_codes_lengths, [T])
    books = codec.params.rvq.codebooks.detach().cpu()
    out = {"frames": T, "levels": n_q}
    out["card_vs_cpu"] = code_mismatches(
        "encode, 2 of 22 layers, card vs CPU", card_codes.audio_codes, cpu_codes.audio_codes,
        lat_cpu[0][:, :T], books)

    # a replay calls no Python: rvq_encode's inputs come from an eager codec
    eager = MossAudioTokenizer(codec.params, cfg, graphs=False)
    with rvq_inputs() as lat_card:
        one = eager.encode(wav)
    f32 = cfg.n_q, torch.float32
    codes = np.random.default_rng(1).integers(0, cfg.codebook_size, (n_q, 1, 100))
    out["graphs"] = codec_graphs_vs_eager("8a f32 codec_1p6b", codec, eager, [
        ("encode of the 4 s wave", ("encode", 1, 100) + f32,
         lambda c: c.encode(wav).audio_codes),
        ("decode of 100 frames", ("decode", 1, 100) + f32,
         lambda c: c._decode_array(codes, 100))])
    on_use = MossAudioTokenizer(codec.params, cfg)  # captures its 12-frame key on use
    chunked = on_use.encode(wav, chunk_duration=1.0)  # chunks of 12 frames, the last padded
    if not (np.array_equal(chunked.audio_codes, eager.encode(wav, chunk_duration=1.0).audio_codes)
            and on_use.chunks.counts == dict(eager=1, capture=1, replay=3)):
        raise AssertionError(f"8a 1 s chunks: the graph differs from eager's or did not replay "
                             f"({on_use.chunks.counts})")
    out["chunked_vs_oneshot"] = code_mismatches(
        "encode, 22 layers on the card, 1 s chunks (replays) vs one-shot", chunked.audio_codes,
        one.audio_codes, lat_card[0][:, :T], books)
    wall = out["graphs"][0]["graph"]["wall_ms"]
    out["encode_ms_per_audio_s"] = wall / seconds
    log(f"  encode of {seconds:.1f} s ({T} frames x {n_q} levels), codec_1p6b f32, 22 layers, "
        f"one graph replay: {wall:.2f} ms (median of 5) = {out['encode_ms_per_audio_s']:.2f} ms "
        f"per second of audio (eager {out['graphs'][0]['eager']['wall_ms']:.2f} ms)")
    del on_use
    return out


def expected_samples(proc, start: int, grid: np.ndarray) -> int:
    """The wave length ``processor.decode`` gives for this generated grid:
    its de-delayed non-pad segments at one hop a frame, less the
    continuation-prefix trim (``DelayProcessor._parse_audio``)."""
    codes = grid[:, 1:]
    if codes.shape[0] < codes.shape[1]:
        return 0
    codes = proc.apply_de_delay_pattern(codes)
    idx = np.nonzero(~(codes == proc.config.audio_pad_code).all(axis=1))[0]
    if not len(idx):
        return 0
    hop = proc.audio_tokenizer.config.hop
    lens = [len(s) * hop for s in np.split(idx, np.nonzero(np.diff(idx) != 1)[0] + 1)]
    if start > 0:
        ratio = max(0.0, min(start / (lens[0] // hop), 1.0))
        if ratio >= 1.0:
            lens = lens[1:]
        elif ratio > 0.0:
            lens[0] -= int(lens[0] * ratio)
    return sum(lens)


def post(url: str, body: dict, timeout: float = 600):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def phase_front_end(backend, wav_path: str):
    """Phase 8b: the port's HTTP server in this process, ``--pool-slots 16``
    (linear bf16 KV) over the 8B backend, serving at once four ``/tts``
    Clone requests with the wave (audio greedy), one two-speaker ``/ttsd``,
    one ``/voice_gen`` and one ``/sound_effect``, each bounded to 96-128 new
    frames (top-k 25 for all, the pool's width, so all go through the pool).
    Every response must be a WAV of the length its grid decodes to; flash,
    the decode kernel and W8A16 must have run, the decode kernel and W8A16
    inside replayed graphs. Returns (launch counts, the pool, the Clone
    requests' pool calls)."""
    import base64
    import threading
    import urllib.request
    import wave
    from http.server import ThreadingHTTPServer

    from mosstts_tpu_torch.serve import http_server as hs
    from mosstts_tpu_torch.serve.pool import DelayServingPool

    cfg, proc = backend.engine.config, backend.processor
    L = cfg.language_config.num_hidden_layers
    ref = base64.b64encode(Path(wav_path).read_bytes()).decode()
    bodies = [("/tts", dict(text=text, mode="Clone", reference_b64=ref, temperature=0.0,
                            max_new_tokens=PHASE8_NEW, seed=i))
              for i, text in enumerate(CLONE_TEXTS)]
    bodies += [("/ttsd", dict(dialogue="[S1]Good morning, how did you sleep? [S2]Very well, "
                                       "thank you. [S1]Then let us begin.",
                              max_new_tokens=PHASE8_NEW, top_k=25, seed=5)),
               ("/voice_gen", dict(text="A voice designed from an instruction.",
                                   instruction="a warm, low, slow voice",
                                   max_new_tokens=PHASE8_NEW, top_k=25, seed=6)),
               ("/sound_effect", dict(ambient="rain on a tin roof", seconds=2.0, top_k=25,
                                      seed=7))]

    calls, real_generate = [], DelayServingPool.generate

    def recorded(self, input_ids, attention_mask=None, **kw):
        out = real_generate(self, input_ids, attention_mask, **kw)
        calls.append(dict(ids=input_ids, mask=attention_mask, kw=kw, out=out))
        return out

    DelayServingPool.generate = recorded
    hs._STATE.update(args=SimpleNamespace(model_path=None, codec_path=None, device=DEV,
                                          dtype="bfloat16", pool_slots=16),
                     backend=backend, pool=None, last_metrics=None)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), hs.Handler)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    serve = threading.Thread(target=srv.serve_forever, daemon=True)
    serve.start()
    results, errors = {}, []

    def fetch(i, route, body):
        try:
            t = time.perf_counter()
            with post(url + route, body) as r:
                data, status = r.read(), r.headers["X-Status"]
            results[i] = (route, time.perf_counter() - t, status, data)
        except Exception as e:  # surfaced below
            errors.append((route, e))

    try:
        reset_counts()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=fetch, args=(i, route, body))
                   for i, (route, body) in enumerate(bodies)]
        # the clones' encodes and the waves' decodes replay the codec graphs
        # the backend's warmup captured (batch 1, 100 frames); the TTSD
        # speakers' two-wave encode (batch 2) runs eagerly
        with codec_chunks("8b, the 7 requests", proc.audio_tokenizer, eager_ok=True):
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=900)
        wall = time.perf_counter() - t0
        counts = read_counts()
        if errors or any(c.is_alive() for c in clients):
            raise AssertionError(f"front end: failed requests {errors}")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        serve.join(timeout=60)
        DelayServingPool.generate = real_generate
        pool = hs._STATE["pool"]
        hs._STATE.update(backend=None, pool=None)
        backend.pool = None

    got = []
    for i in sorted(results):
        route, secs, status, data = results[i]
        with wave.open(io.BytesIO(data)) as w:
            if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, 24000):
                raise AssertionError(f"{route}: not a 24 kHz mono 16-bit WAV")
            got.append(w.getnframes())
        log(f"  {route}: {secs:.2f} s, {got[-1] / 24000:.2f} s of audio; {status}")
    want = sorted(expected_samples(proc, c["out"][0][0], c["out"][0][1]) for c in calls)
    if len(calls) != len(bodies) or sorted(got) != want or not all(want):
        raise AssertionError(f"front end: {len(calls)} pool calls for {len(bodies)} requests; "
                             f"WAV samples {sorted(got)}, grids decode to {want}")
    server = pool.server
    steps, admissions = server.total_steps, len(bodies) + server.total_preemptions
    frames = sum(c["out"][0][1].shape[0] - c["out"][0][0] for c in calls)
    log(f"  {len(bodies)} requests in {wall:.2f} s through the 16-slot pool: {steps} server steps, "
        f"{frames} frames; every WAV has the samples its grid decodes to; /metrics (last "
        f"request): TTFA {metrics.get('ttfa_s')} s, RTF {metrics.get('rtf_x')}x, "
        f"audio {metrics.get('audio_s')} s")
    g = counts["graphs"]
    if (counts["flash"] < L * admissions or counts["decode"] < L * steps or not g["decode"]
            or not g["w8a16"]):
        raise AssertionError(f"front end: launch counts {counts} for {admissions} admissions and "
                             f"{steps} steps")
    log(f"  launches: flash {counts['flash']} (>= {L} x {admissions}; {g['flash']} inside replayed "
        f"prefill graphs), decode {counts['decode']} "
        f"(>= {L} x {steps}; {g['decode']} inside replayed graphs), w8a16 {counts['w8a16']} "
        f"({g['w8a16']} inside replayed graphs)")
    clones = [c for c in calls if c["kw"]["audio_temperature"] == 0.0]
    if len(clones) != len(CLONE_TEXTS):
        raise AssertionError(f"front end: {len(clones)} greedy Clone calls reached the pool")
    return counts, pool, clones


def pool_vs_solo(pool, engine, clones, label: str, exact: bool) -> None:
    """The Clone requests' prompts, greedy in text and audio, through
    ``pool`` at once and through ``engine.generate`` one by one. ``exact``:
    the grids must be equal; else the pool's first frame (its admission
    prefill's) must be the engine's, and the first divergence is logged."""
    import threading

    greedy = dict(text_temperature=0.0, audio_temperature=0.0, max_new_tokens=PHASE8_NEW)
    pooled, errors = {}, []

    def call(i, c):
        try:
            pooled[i] = pool.generate(c["ids"], c["mask"], timeout=900, **greedy)[0]
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i, c)) for i, c in enumerate(clones)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or len(pooled) != len(clones):
        raise AssertionError(f"{label}: pool requests failed: {errors}")
    firsts = []
    for i, c in enumerate(clones):
        solo = engine.generate(c["ids"], c["mask"], **greedy)[0]
        first = first_divergence(pooled[i], solo)
        firsts.append(first)
        if pooled[i][0] != solo[0] or first == 0 or (exact and first is not None):
            raise AssertionError(f"{label}: Clone request {i}: pool start {pooled[i][0]}, solo "
                                 f"{solo[0]}; first differing frame {first}")
    frames = [p[1].shape[0] - p[0] for p in pooled.values()]
    log(f"  {label}: {len(clones)} greedy Clone prompts at once through the pool against "
        f"engine.generate alone: first differing frame per request {firsts} of {frames} "
        + ("(equal)" if exact else "(the first frame equal in each)"))


def phase_small_front_end(clones) -> None:
    """Phase 8d: the same Clone prompts, greedy, through a 4-slot pool and the
    solo engine of a small float32 model with the same 33 channels (width 256,
    2 layers): the grids must be equal bit for bit."""
    from mosstts_tpu_torch.serve.pool import DelayServingPool

    cfg = DelayConfig(language_config=tiny_qwen3(hidden_size=256, intermediate_size=512,
                                                 num_attention_heads=4, num_key_value_heads=2,
                                                 head_dim=64), n_vq=32)
    engine = DelayEngine.random_init(seed=3, config=cfg, dtype=torch.float32, device=DEV)
    pool = DelayServingPool(engine.params, cfg, slots=4, cache_len=1024, out_capacity=256,
                            dtype=torch.float32)
    try:
        pool_vs_solo(pool, engine, clones, "small f32 model", exact=True)
    finally:
        pool.close()


# ------------------------------------------------------------------ phase 9
HOT = dict(text_temperature=1.7, audio_temperature=1.7, audio_top_p=0.8)  # phase 5's sampling


def same_state(a, b) -> bool:
    """Every tensor of two ``DelayGenState``s (their caches' and keys too)
    equal bit for bit on the card."""
    ta = list(a.cache) + [t for t in a[1:] if isinstance(t, torch.Tensor)]
    tb = list(b.cache) + [t for t in b[1:] if isinstance(t, torch.Tensor)]
    return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


def prefill_graphs_vs_eager(engine, proc, label: str) -> None:
    """9a, the engine: prefills (``max_new_tokens=1``, no decode step) at
    B=1 T=200 and at B=4 (phase 4's prompts), greedy and seeds s1, s2, s1,
    on ``engine`` (the first use of a key eager, the second its capture and
    first replay, then replays) and on an eager engine over the same
    weights: every field of the static state, the cache and the rows'
    keys equal bit for bit after each. Then the time to the first
    frame at B=1 T=200, warm (prefill and one decode step), both ways."""
    eager = DelayEngine(engine.params, engine.config, dtype=engine.dtype,
                        cache_bucket=engine.cache_bucket, graphs=False)
    cfg = engine.config
    one = prompt_grid(cfg, 200, seed=9)[None]
    batches = ((1, one, np.ones((1, 200), bool)),
               (4, *(lambda b: (b["input_ids"], b["attention_mask"]))(four_prompts(proc))))
    calls = [dict(text_temperature=0.0, audio_temperature=0.0)] + [
        dict(seed=s, text_temperature=1.5, audio_temperature=1.7) for s in SEEDS]
    for B, ids, mask in batches:
        for i, kw in enumerate(calls):
            out = [e.generate(ids, mask, max_new_tokens=1, **kw) for e in (engine, eager)]
            states = [next(iter(e._steps.values())).state for e in (engine, eager)]
            if not same_grids(*out) or not same_state(*states):
                raise AssertionError(f"{label} prefill B={B} call {i}: the graph prefill's state "
                                     "differs from the eager prefill's")
        (prefills,) = engine._prefills.values()
        log(f"  {label} engine prefill B={B} T={ids.shape[1]}: greedy and seeds s1, s2, s1, the "
            f"state after each (cache, fields, keys) graph == eager; graphs held "
            f"{len(prefills.keys)}")
    ttff = {}
    for name, e in (("graph", engine), ("eager", eager)):
        ttff[name] = timed(lambda e=e: e.generate(one, max_new_tokens=2, text_temperature=0.0,
                                                  audio_temperature=0.0))
    log(f"  {label} time to the first frame, B=1 T=200 (prefill + one step), warm, median of "
        f"{TIMED_N}: graph {ttff['graph'][0]:.2f} ms wall / {ttff['graph'][1]:.2f} ms device, "
        f"eager {ttff['eager'][0]:.2f} ms wall / {ttff['eager'][1]:.2f} ms device")
    del eager
    gc.collect()
    torch.cuda.empty_cache()


def admission_graphs_vs_eager(params) -> None:
    """9a, the server: two 16-slot servers over the same weights, one with
    graphs and one eager, warmed up at the prompt buckets of phase 5's load
    (64 and 96) and of a 200-row prompt (224). Seeded sampled requests of
    60 and 90 rows are admitted into both (through the buckets' prefill
    graphs on the first): the batch-1 admission state (its key too) and
    the running state are equal after each admission,
    and so are the completions after the splice. Then a 200-row prompt's
    admission (prefill and splice), warm, both ways, and the bytes of the
    static batch-1 state."""
    cfg = delay_8b()
    servers = {}
    for name, graphs in (("graph", True), ("eager", False)):
        srv = DelayBatchServer(params, cfg, slots=BS, cache_len=SS, out_capacity=128,
                               prompt_bucket=32, dtype=torch.bfloat16, graphs=graphs,
                               sampling=make_sampling(**HOT, device=DEV))
        srv.warmup(prompt_lens=(64, 96, 200), attend_upto=256)
        servers[name] = srv
    g, e = servers["graph"], servers["eager"]
    if sorted(k[0] for k in g._prefills.keys) != [64, 96, 224]:
        raise AssertionError(f"warmup captured prefill graphs {g._prefills.keys}")
    audit = splice_audit(g, "_prefill_into")
    spliced = audit.__enter__()
    for slot, (T, seed) in enumerate(((60, 31), (90, 32), (60, 33), (90, 34))):
        grid = prompt_grid(cfg, T, seed)
        for srv in (g, e):
            srv.submit(grid, max_new_tokens=48, seed=seed)
            srv._admit(slot, srv._queue.pop(0))
        if not same_state(g._small, e._small) or not same_state(g.state, e.state):
            raise AssertionError(f"admission of {T} rows into slot {slot}: graph != eager")
    done = [sorted(s.run(), key=lambda c: c.request_id) for s in (g, e)]
    if [(c.steps, c.tokens.tobytes()) for c in done[0]] != \
            [(c.steps, c.tokens.tobytes()) for c in done[1]]:
        raise AssertionError("the completions after graph admissions differ from eager ones")
    log(f"  admissions at buckets 64 and 96, seeded sampled: the batch-1 state, its key "
        f"and the running state graph == eager after each; the {len(done[0])} "
        f"completions equal")
    grid = prompt_grid(cfg, 200, 35)
    walls = {}
    for name, srv in servers.items():
        def admit(srv=srv):  # as serving admits: from the queue into a free slot
            srv.submit(grid, max_new_tokens=48, seed=35)
            srv._admit(0, srv._queue.pop(0))

        admit()  # warm
        walls[name] = timed(admit)
        srv._active.clear()
    audit.__exit__(None, None, None)
    if spliced["eager"] or not spliced["warm"]:
        raise AssertionError(f"9a: warm admissions spliced eagerly: {spliced}")
    small = g._small
    kv = sum(t.nbytes for t in small.cache)
    rest = sum(t.nbytes for t in small[1:] if isinstance(t, torch.Tensor))
    log(f"  admission of a 200-row prompt (bucket 224: prefill + splice, one graph replay), "
        f"warm, median of {TIMED_N}: graph {walls['graph'][0]:.2f} ms wall / "
        f"{walls['graph'][1]:.2f} ms device, eager {walls['eager'][0]:.2f} ms wall / "
        f"{walls['eager'][1]:.2f} ms device; the graph server's {spliced['warm']} admissions "
        f"each spliced inside its replay, none eagerly")
    log(f"  static batch-1 admission state (cache_len {SS}, bf16 KV): KV cache {kv / 1e6:.1f} MB "
        f"+ {rest / 1e6:.3f} MB of other fields")
    del servers, g, e
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def host_waits():
    """Count the host's waits for the card: reads of a CUDA tensor to the
    host (``.cpu()``) and event synchronisations. Yields a one-item list."""
    n = [0]
    cpu, sync = torch.Tensor.cpu, torch.cuda.Event.synchronize

    def counted_cpu(self, *a, **k):
        n[0] += self.is_cuda
        return cpu(self, *a, **k)

    def counted_sync(self):
        n[0] += 1
        return sync(self)

    torch.Tensor.cpu, torch.cuda.Event.synchronize = counted_cpu, counted_sync
    try:
        yield n
    finally:
        torch.Tensor.cpu, torch.cuda.Event.synchronize = cpu, sync


@contextlib.contextmanager
def splice_audit(server, method: str):
    """Check every admission of ``server`` (its ``method``: the Delay
    server's ``_prefill_into``, the Realtime server's ``_prefill_group``)
    by how its splice ran: an admission whose prefill launched flash only
    inside a replayed graph (warm) launched the row copy inside that graph
    and never outside it; any other ran the same kernel eagerly. Yields the
    tally {warm, eager}. Reads only the host's counts: no wait."""
    tally = dict(warm=0, eager=0)
    inner = getattr(server, method)

    def audited(*args, **kw):
        before, graphs = kernel_launches.read(), dict(kernel_launches.IN_GRAPHS)
        out = inner(*args, **kw)
        d = {k: kernel_launches.read()[k] - before[k] for k in ("flash", "row_copy")}
        g = {k: kernel_launches.IN_GRAPHS[k] - graphs[k] for k in ("flash", "row_copy")}
        warm = d["flash"] == g["flash"] > 0
        if warm and not d["row_copy"] == g["row_copy"] >= 1:
            raise AssertionError(f"a warm admission launched its splice outside its graph: "
                                 f"{d} ({g} in graphs)")
        if not warm and not d["row_copy"] > g["row_copy"]:
            raise AssertionError(f"an eager admission did not splice by the row copy: {d}")
        tally["warm" if warm else "eager"] += 1
        return out

    setattr(server, method, audited)
    try:
        yield tally
    finally:
        delattr(server, method)


def loop_launches(server) -> int:
    """The launches of ``server``'s loop graphs (block, event and drain):
    one a block, an event block or a drain segment."""
    loop = server._steps._loop
    drains = getattr(server, "_drains", {})
    return (loop.launches if loop is not None else 0) + sum(d.launches for d in drains.values())


LOOP_MODES = (("linear bf16", {}, ("run", "run_events", "run_drain")),
              ("paged int8", dict(paged=True, kv_quant=True), ("run", "run_events")))


def loops_vs_run(params) -> list:
    """9b: phase 5's 24 requests on ``DelayBatchServer(slots=16,
    cache_len=1024, out_capacity=128, prompt_bucket=32)`` over the int8
    weights, through ``run``, ``run_events`` and (linear) ``run_drain``:
    useful frames/s, ms per server step, dispatches and host waits per
    request, and each completion's first frame that differs from ``run``'s
    (rows admitted at other times attend other buckets and round otherwise
    at 8B, so only the first frame must be equal). Each server first runs
    its loop once over the same prompts at 2 frames each, outside the timed
    window (the loop graphs' build; the drain's captures), and prints that
    set-up's wall apart. The launch counts are set to 0 just before each
    timed loop and read just after; returns them."""
    cfg = delay_8b()
    L = cfg.language_config.num_hidden_layers
    prompts, budgets = server_traffic(cfg)
    runs = []
    for name, mode, loops in LOOP_MODES:
        ref = None
        for loop in loops:
            server = DelayBatchServer(params, cfg, slots=BS, cache_len=SS, out_capacity=128,
                                      prompt_bucket=32, page_size=PS, dtype=torch.bfloat16,
                                      sampling=make_sampling(**HOT, device=DEV), **mode)
            server.warmup(prompt_lens=(64, 96), attend_upto=256)
            # the loop's own set-up, apart from the timed window: the same
            # prompts at 2 frames each build its loop graphs (the drain also
            # captures every attend bucket's step graph up to cache_len)
            t = time.perf_counter()
            for g in prompts:
                server.submit(g, max_new_tokens=2)
            getattr(server, loop)()
            torch.cuda.synchronize()
            setup = time.perf_counter() - t
            server.total_steps, server.total_preemptions, server.total_dispatches = 0, 0, 0
            launched = loop_launches(server)
            reset_counts()
            with host_waits() as waits, splice_audit(server, "_prefill_into") as spliced:
                t = time.perf_counter()
                rids = {server.submit(g, max_new_tokens=n): n for g, n in zip(prompts, budgets)}
                done = sorted(getattr(server, loop)(), key=lambda c: c.request_id)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            counts = read_counts()
            launched = loop_launches(server) - launched
            if loop != "run" and launched != server.total_dispatches:
                raise AssertionError(f"{name} {loop}: {launched} loop-graph launches for "
                                     f"{server.total_dispatches} dispatches (one each)")
            kernel = "paged_q8" if mode else "decode"
            steps, admissions = server.total_steps, len(rids) + server.total_preemptions
            if [c.request_id for c in done] != sorted(rids) or any(
                    c.tokens.shape != (c.start_length + c.steps, cfg.channels)
                    or not 0 < c.steps <= rids[c.request_id] for c in done):
                raise AssertionError(f"{name} {loop}: malformed completions")
            if (counts[kernel] < L * steps or counts["flash"] < L * admissions
                    or not counts["graphs"][kernel] or not counts["graphs"]["flash"]
                    or not counts["graphs"]["w8a16"]):
                raise AssertionError(f"{name} {loop}: launch counts {counts}")
            runs.append(counts)
            firsts = None
            if ref is None:
                ref = done
            else:
                firsts = [first_divergence((a.start_length, a.tokens), (b.start_length, b.tokens))
                          for a, b in zip(done, ref)]
                if 0 in firsts:
                    raise AssertionError(f"{name} {loop}: a first frame differs from run()'s")
            frames = sum(c.steps for c in done)
            log(f"  {name} {loop}: {frames} frames in {wall:.2f} s = {frames / wall:.1f} "
                f"frames/s, {steps} steps ({wall / steps * 1e3:.2f} ms/step), "
                f"{server.total_dispatches} dispatches, {launched} loop-graph launches "
                f"({launched / len(rids):.2f} per request), {waits[0] / len(rids):.1f} host waits "
                f"per request, {server.total_preemptions} preemptions, admissions "
                f"{spliced['warm']} warm / {spliced['eager']} eager (splice inside the graph / "
                f"the same kernel eagerly), set-up before the "
                f"window {setup:.2f} s; launches {kernel} "
                f"{counts[kernel]} ({counts['graphs'][kernel]} in graphs), flash "
                f"{counts['flash']} ({counts['graphs']['flash']} in graphs)"
                + ("" if firsts is None else f"; first differing frame against run(): {firsts}"))
            del server, done
            gc.collect()
            torch.cuda.empty_cache()
    return runs


def phase_small_loops() -> None:
    """9c: the same loops on the small f32 model on the card, with the JAX
    tests' load (``tests/test_batch_server.py:284-370``): five continuation
    requests with budgets 24, 9, 17, 31, 12 into 2 slots, greedy through
    ``run`` and ``run_events`` (linear and paged), and the drain test's
    prompts with its sampling overrides and seeds through ``run`` and
    ``run_drain``: equal to ``run()`` on the card bit for bit, and the
    greedy grids equal to the CPU's ``run()``."""
    cfg = SMALL_CFG
    cpu_backend = demo_backend(cfg, seed=2, dtype=torch.float32, device="cpu")
    cpu_params, proc = cpu_backend.engine.params, cpu_backend.processor
    gpu_params = copy.deepcopy(cpu_params).to(DEV)
    budgets = [24, 9, 17, 31, 12]
    overrides = [None, {"audio_temperature": 0.9, "audio_top_p": 0.8}, None,
                 {"text_temperature": 0.7}, None]
    seeds = [None, 7, None, 11, None]

    def grid(text, seed):
        codes = np.random.default_rng(seed).integers(0, 1024, (6, cfg.n_vq))
        conv = [proc.build_user_message(text=text), proc.build_assistant_message([codes])]
        return proc([conv], mode="continuation")["input_ids"][0]

    def serve(params, dev, loop, grids, cache_len, sampled=False, **mode):
        srv = DelayBatchServer(params, cfg, slots=2, cache_len=cache_len, out_capacity=64,
                               prompt_bucket=32, page_size=64, dtype=torch.float32,
                               sampling=make_sampling(text_temperature=0.0,
                                                      audio_temperature=0.0, device=dev),
                               **mode)
        rids = [srv.submit(g, max_new_tokens=n, sampling=o if sampled else None,
                           seed=s if sampled else None)
                for g, n, o, s in zip(grids, budgets, overrides, seeds)]
        done = {c.request_id: c for c in getattr(srv, loop)(max_steps=800)}
        if sorted(done) != rids:
            raise AssertionError(f"small {loop} {mode}: {sorted(done)} of {rids}")
        return [(done[r].start_length, done[r].steps, done[r].tokens.tobytes()) for r in rids]

    events = [grid(f"event wave {i}", 80 + i) for i in range(5)]
    drain = [grid(f"drain wave {i}" + " pad" * (6 * (i % 2)), 90 + i) for i in range(5)]
    for name, mode in (("linear", {}), ("paged", dict(paged=True))):
        ref = serve(gpu_params, DEV, "run", events, 256, **mode)
        card = serve(gpu_params, DEV, "run_events", events, 256, **mode)
        if card != ref:
            raise AssertionError(f"small f32 {name}: run_events differs from run on the card")
        if serve(cpu_params, "cpu", "run", events, 256, **mode) != ref:
            raise AssertionError(f"small f32 {name}: the card's grids differ from the CPU's")
        if serve(cpu_params, "cpu", "run_events", events, 256, **mode) != card:
            raise AssertionError(f"small f32 {name}: the card's run_events differs from the "
                                 "CPU's (steps or frames)")
        log(f"  small f32 server ({name}), 5 greedy requests, budgets {budgets}: run_events == "
            f"run on the card == run on the CPU; run_events on the card == on the CPU, frame "
            f"for frame and step for step: {[c[1] for c in card]}")
    ref = serve(gpu_params, DEV, "run", drain, 512, sampled=True)
    card = serve(gpu_params, DEV, "run_drain", drain, 512, sampled=True)
    if card != ref:
        raise AssertionError("small f32: run_drain with overrides and seeds differs from run")
    if serve(cpu_params, "cpu", "run_drain", drain, 512, sampled=True) != card:
        raise AssertionError("small f32: the card's sampled run_drain differs from the CPU's "
                             "(steps or frames)")
    greedy = serve(gpu_params, DEV, "run_drain", drain, 512)
    if greedy != serve(cpu_params, "cpu", "run", drain, 512):
        raise AssertionError("small f32: the card's greedy run_drain differs from the CPU's run")
    log(f"  small f32 server (linear), the drain test's 5 requests: run_drain == run on the card "
        f"with its overrides and seeds, == the CPU's run_drain frame for frame and step for "
        f"step {[c[1] for c in card]}; greedy run_drain on the card == run on the CPU")


# ----------------------------------------------------------------- phase 10
RT_FRAMES = 64  # frames per stream of the engine's timed load (bench.py's --steps default)
RT_CHECK = 24  # frames per stream of the graph-against-eager and seed checks
RT_SMALL = RealtimeConfig(  # a small float32 Realtime model whose heads the kernels take
    language_config=tiny_qwen3(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                               num_key_value_heads=2, head_dim=128),
    local_config=RealtimeLocalConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                                     num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                                     rvq=4, max_position_embeddings=5),
    rvq=4)
RT_GREEDY = dict(temperature=0.0, do_sample=False)


def rt_load(cfg, B: int, seed: int = 0, rows: int = 4, text: int = 160):
    """``bench.py:357-366``'s engine load: ``B`` turn grids of ``rows`` random
    rows and ``text`` random text tokens each."""
    rng = np.random.default_rng(seed)
    grids = []
    for _ in range(B):
        g = np.full((rows, 1 + cfg.rvq), cfg.audio_pad_token, np.int64)
        g[:, 0] = rng.integers(100, 1000, rows)
        g[:, 1:] = rng.integers(0, 1024, (rows, cfg.rvq))
        grids.append(g)
    return grids, [[int(t) for t in rng.integers(100, 1000, text)] for _ in range(B)]


def rt_same(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def rt_kernels() -> dict:
    """The three kernels of the Realtime path at its 1.7B shapes, each
    against its plain version, with its device time, the plain version's,
    the library call's where one computes the same function, and the
    bound: flash at GQA group 2 (16 heads over 8 KV heads) for a second
    turn at q_start 208 over the first turn's cache, with a left-pad hole
    between the turns, and for a batch-8 admission at q_start 0; decode over
    the depth transformer's 16-slot cache at attend 16 (B = 1, 8) and over
    the backbone's cache at B = 8; W8A16 at the backbone's and the depth
    transformer's (2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048)
    and one head of the stacked (16, 2048, 1027) local heads, at M = 1
    and 8."""
    g = torch.Generator(device=DEV).manual_seed(10)
    bf = torch.bfloat16
    lc = RealtimeConfig().language_config
    L, H, KV, hd = lc.num_hidden_layers, lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim
    scale = hd ** -0.5
    out = {}
    # flash: a second turn of T=64 at q_start 208 over a cache whose first
    # turn holds slots 3..199 (left pad 0..2), then the second turn's left
    # pad 200..207 (the hole), then its own rows
    S = 1024
    kc = torch.randn((L, 1, KV, S, hd), generator=g, device=DEV).to(bf)
    vc = torch.randn((L, 1, KV, S, hd), generator=g, device=DEV).to(bf)
    T, q0 = 64, 208
    q = torch.randn((1, T, H, hd), generator=g, device=DEV).to(bf)
    valid = torch.zeros((1, S), dtype=torch.bool, device=DEV)
    valid[0, 3:200] = True
    valid[0, q0:q0 + T] = True
    rows = valid[:, q0:q0 + T]
    flash_shapes = [flash_shape(f"1.7B second turn B=1 T={T} q_start={q0} hole 200-207 S={S}",
                                q, None, None, valid, torch.tensor(q0, dtype=torch.int32,
                                                                   device=DEV),
                                kv_major=True, rows=rows, n_layers=L,
                                layer=lambda i: (kc[i % L], vc[i % L]))]
    # a batch-8 admission: prompts of 16-31 rows left-padded to 32 at q_start 0
    kc8 = torch.randn((8, KV, S, hd), generator=g, device=DEV).to(bf)
    vc8 = torch.randn((8, KV, S, hd), generator=g, device=DEV).to(bf)
    q8 = torch.randn((8, 32, H, hd), generator=g, device=DEV).to(bf)
    valid8 = torch.zeros((8, S), dtype=torch.bool, device=DEV)
    for b, pad in enumerate((0, 3, 7, 11, 16, 1, 5, 9)):
        valid8[b, pad:32] = True
    flash_shapes.append(flash_shape(f"1.7B admission B=8 T=32 q_start=0 S={S}", q8, kc8, vc8,
                                    valid8, torch.zeros((), dtype=torch.int32, device=DEV),
                                    kv_major=True, rows=valid8[:, :32]))
    out["flash"] = dict(max_abs_err=max(r["max_abs_err"] for r in flash_shapes),
                        shapes=flash_shapes)

    # decode: the depth transformer's (4, B, 8, 16, 128) cache at attend 16,
    # i + 1 slots valid at depth step i; the backbone's (28, 8, 8, 1024, 128)
    dshapes, derr = [], 0.0
    loc = RealtimeConfig().local_config
    for label, Ld, B, Sd, attend, n_valid in (
            ("depth", loc.num_hidden_layers, 1, 16, 16, lambda b: 9),
            ("depth", loc.num_hidden_layers, 8, 16, 16, lambda b: 1 + 2 * b),
            ("backbone", L, 8, S, 256, lambda b: 100 + 20 * b)):
        kd = torch.randn((Ld, B, KV, Sd, hd), generator=g, device=DEV).to(bf)
        vd = torch.randn((Ld, B, KV, Sd, hd), generator=g, device=DEV).to(bf)
        qd = torch.randn((B, H, hd), generator=g, device=DEV).to(bf)
        vald = torch.zeros((B, Sd), dtype=torch.bool, device=DEV)
        for b in range(B):
            vald[b, :n_valid(b)] = True
        for li in (0, Ld - 1):
            args = (qd, kd, vd, vald, li)
            derr = max(derr, check_close(
                f"decode 1.7B {label} B={B} attend={attend} layer={li}",
                decode_attn.decode_attention(*args, scale=scale, attend_len=attend),
                decode_attn.decode_attention_ref(*args, scale=scale, attend_len=attend)))
        ms = time_ms(lambda i: decode_attn.decode_attention(qd, kd, vd, vald, i % Ld, scale=scale,
                                                             attend_len=attend))
        plain = time_ms(lambda i: decode_attn.decode_attention_ref(qd, kd, vd, vald, i % Ld,
                                                                   scale=scale, attend_len=attend))
        lib = library_ms(lambda i: F.scaled_dot_product_attention(
            qd[:, :, None], kd[i % Ld, :, :, :attend], vd[i % Ld, :, :, :attend],
            attn_mask=vald[:, None, None, :attend], scale=scale, enable_gqa=True))
        bd = decode_bound(qd, vald, attend, KV, hd * 2)
        log(f"  decode 1.7B {label} B={B} attend={attend} of {tuple(kd.shape)}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {fmt_ms(lib)}, bound "
            f"{bd['bound_ms']:.5f} ms ({bd['bound_by']})")
        dshapes.append(dict(shape=f"1.7B {label} B={B} attend={attend} of {tuple(kd.shape)}",
                            ms=ms, plain_ms=plain, library_ms=lib, **bd))
        del kd, vd
    out["decode"] = dict(max_abs_err=derr, shapes=dshapes)

    # W8A16: the 1.7B matmul shapes over 28-layer int8 stacks (call i reads
    # layer i % 28), and one head of the (16, 2048, 1027) local heads at a
    # time, in QuantWeight's layout (16-byte row pitch), f32 out
    wshapes, werr = [], 0.0
    w8_gemm.LAUNCHES_W8A16_BYTES = 0
    for name, K, N, count in (("wq/wo", 2048, 2048, 0), ("wk/wv", 2048, 1024, 0),
                              ("w_gate/w_up", 2048, 6144, 0), ("w_down", 6144, 2048, 0),
                              ("local head", 2048, 1027, 16)):
        n_stack = count or L
        qw = pitched(torch.empty((n_stack, K, N), dtype=torch.int8, device=DEV).random_(
            -127, 128, generator=g))
        sc = torch.rand((n_stack, N), generator=g, device=DEV) * 0.019 + 0.001
        out_dtype = torch.float32 if count else bf
        qt = qw.transpose(1, 2).contiguous()
        for M in (1, 8):
            x = torch.randn((M, K), generator=g, device=DEV).to(bf)
            for li in (0, n_stack - 1):
                o = w8_gemm.w8a16_gemm(x, qw[li], sc[li], out_dtype)
                ref = w8_gemm.w8a16_gemm_ref(x, qw[li], sc[li], out_dtype)
                absref = w8_gemm.w8a16_gemm_ref(x.abs(), qw[li].abs(), sc[li], torch.float32)
                werr = max(werr, check_gemm(f"w8a16 1.7B {name} M={M} layer={li}", o, ref,
                                            absref))
            ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, qw[i % n_stack], sc[i % n_stack],
                                                      out_dtype))
            plain = time_ms(lambda i: w8_gemm.w8a16_gemm_ref(x, qw[i % n_stack],
                                                             sc[i % n_stack], out_dtype))
            lib = library_ms(lambda i: torch._weight_int8pack_mm(x, qt[i % n_stack],
                                                                 sc[i % n_stack].to(bf)))
            bd = gemm_bound(M, K, N, out_bytes=4 if count else 2)
            log(f"  w8a16 1.7B {name} M={M} K={K} N={N}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, torch._weight_int8pack_mm {fmt_ms(lib)}, bound "
                f"{bd['bound_ms']:.5f} ms ({bd['bound_by']})")
            wshapes.append(dict(shape=f"1.7B {name} M={M}", ms=ms, plain_ms=plain,
                                library_ms=lib, **bd))
        del qw, sc, qt
    if w8_gemm.LAUNCHES_W8A16_BYTES:
        raise AssertionError(f"W8A16 took byte loads {w8_gemm.LAUNCHES_W8A16_BYTES} times at "
                             "the 1.7B shapes")
    out["w8a16"] = dict(max_abs_err=werr, shapes=wshapes)
    del kc, vc, kc8, vc8
    torch.cuda.empty_cache()
    return out


def rt_first_frame(engine, grids, text) -> tuple:
    """The time to the first frame of a new conversation on ``engine``,
    warm: ``prefill`` (the frame read to the host), median of 5, wall and
    device (CUDA events) in ms."""
    def first():
        engine.reset_generation_state(keep_cache=False)
        engine.prefill(grids, [x[:12] for x in text], **RT_GREEDY)

    first()  # warm: the key's graph captured (graph engine), eager state made
    return timed(first, n=5)


def rt_time(engine, eager, grids, text, label: str) -> dict:
    """The warm engine's load through ``generate`` (greedy, ``RT_FRAMES``
    frames): wall per frame, the streams' realtime multiple (frames / 12.5
    over the wall), the time to the first frame (a warm prefill, median of
    5, wall and device) through the prefill graph and through ``eager``
    (the same weights, graphs off), and the device time per frame
    (``device_profile`` over 8 enqueued frames)."""
    B = len(grids)
    engine.generate(grids, text, max_length=RT_FRAMES, **RT_GREEDY)  # warm: graphs captured
    torch.cuda.synchronize()
    t = time.perf_counter()
    frames = engine.generate(grids, text, max_length=RT_FRAMES, **RT_GREEDY)
    wall = time.perf_counter() - t
    n = len(engine.generated_tokens)  # frames per stream, the prefill's first included
    ttff = {"graph": rt_first_frame(engine, grids, text),
            "eager": rt_first_frame(eager, grids, text)}
    for _ in range(2):
        engine.step_async(None, **RT_GREEDY)
    reset_counts()
    with profile_step.device_profile() as prof:
        for _ in range(8):
            engine.step_async(None, **RT_GREEDY)
    per_frame = {k: v / 8 for k, v in read_counts()["graphs"].items() if v}
    evts = profile_step.device_events(prof)
    dev_ms = sum(e.self_device_time_total for e in evts) / 8 / 1e3
    kernels = sum(e.count for e in evts) / 8
    r = dict(weights=label, batch=B, frames=n, wall_s=wall, ms_per_frame=wall / n * 1e3,
             device_ms_per_frame=dev_ms, kernels_per_frame=kernels,
             realtime_per_stream=n / 12.5 / wall, realtime_total=B * n / 12.5 / wall,
             first_frame_ms=ttff["graph"][0], first_frame_device_ms=ttff["graph"][1],
             first_frame_eager_ms=ttff["eager"][0],
             first_frame_eager_device_ms=ttff["eager"][1], launches_per_frame=per_frame)
    log(f"  {label} B={B}: {n} frames in {wall:.3f} s ({r['ms_per_frame']:.2f} ms/frame wall, "
        f"{dev_ms:.2f} ms/frame device, {kernels:.0f} device kernels/frame), "
        f"{r['realtime_per_stream']:.2f}x realtime per stream, {r['realtime_total']:.2f}x total; "
        f"first frame (median of 5 warm prefills): graph {ttff['graph'][0]:.2f} ms wall / "
        f"{ttff['graph'][1]:.2f} ms device, eager {ttff['eager'][0]:.2f} ms wall / "
        f"{ttff['eager'][1]:.2f} ms device; kernel launches per frame, all in the replayed "
        f"graph: {per_frame}")
    if dev_ms <= 0 or not all(f.shape[1] == engine.config.rvq for f in frames):
        raise AssertionError(f"{label} B={B}: no device time or bad frames")
    return r


def rt_engine_phase(engine, label: str) -> tuple:
    """10a on ``engine`` (graph frames) and an eager engine over the same
    weights: at B = 1 and 8, greedy frames equal bit for bit, seeds s1, s2,
    s1 equal, different, equal (and s1 eager equal to s1 graph), a second
    turn on each kept cache equal (``RT_CHECK`` frames each), then the
    timings. Returns (launch counts of the graph engine's runs, timing
    rows)."""
    cfg = engine.config
    eager = RealtimeEngine(engine.params, cfg, dtype=engine.dtype, device=DEV,
                           max_length=engine.max_length, cache_len=engine.cache_len,
                           graphs=False)
    rows = []
    counts = []
    for B in (1, 8):
        grids, text = rt_load(cfg, B)
        reset_counts()
        g = engine.generate(grids, text, max_length=RT_CHECK, **RT_GREEDY)
        seeded = [engine.generate(grids, text, max_length=RT_CHECK, seed=s) for s in (1, 2, 1)]
        turn2, cursor = rt_second_turn(engine, cfg, B)
        counts.append(read_counts())
        e = eager.generate(grids, text, max_length=RT_CHECK, **RT_GREEDY)
        e1 = eager.generate(grids, text, max_length=RT_CHECK, seed=1)
        e_turn2 = rt_second_turn(eager, cfg, B)[0]
        if not rt_same(g, e) or not rt_same(turn2, e_turn2):
            raise AssertionError(f"{label} B={B}: graph frames differ from eager frames")
        if not (rt_same(seeded[0], seeded[2]) and rt_same(seeded[0], e1)
                and not rt_same(seeded[0], seeded[1])):
            raise AssertionError(f"{label} B={B}: seeds s1, s2, s1 not equal, different, equal")
        log(f"  {label} B={B}: greedy graph frames == eager ({sum(len(f) for f in g)} frames), "
            f"seeds s1 s2 s1 equal/different/equal (s1 eager equal), second turn prefilled at "
            f"cache slot {cursor} == eager")
        rt_prefill_replays(engine, grids, text, e, e_turn2, f"{label} B={B}")
        rows.append(rt_time(engine, eager, grids, text, label))
    log(f"  {label} engine prefills: {engine._prefills.counts} (graphs held: "
        f"{list(engine._prefills.keys)})")
    return counts, rows


def rt_prefill_replays(engine, grids, text, e, e_turn2, label: str) -> None:
    """A conversation's first turn and a later turn, each at a key seen
    twice before (their graphs captured): both prefills replay their graph,
    with no eager flash or W8A16 launch outside it, and the frames equal
    the eager engine's ``e`` (a greedy ``generate``) and ``e_turn2`` (the
    second turn after a ``generate`` with seed s1)."""
    cfg = engine.config
    engine.generate(grids, text, max_length=RT_CHECK, seed=1)
    rt_second_turn(engine, cfg, len(grids))  # the later turn's second use: its capture
    before = dict(engine._prefills.counts)
    reset_counts()
    first = engine.generate(grids, text, max_length=RT_CHECK, **RT_GREEDY)
    engine.generate(grids, text, max_length=RT_CHECK, seed=1)
    replayed, cursor = rt_second_turn(engine, cfg, len(grids))
    c = read_counts()
    if not (rt_same(first, e) and rt_same(replayed, e_turn2)):
        raise AssertionError(f"{label}: a replayed turn's frames differ from eager")
    after = engine._prefills.counts
    if not (after["replay"] - before["replay"] == 3 and after["eager"] == before["eager"]
            and c["flash"] == c["graphs"]["flash"] > 0
            and c["w8a16"] == c["graphs"]["w8a16"]):
        raise AssertionError(f"{label}: a warm prefill launched outside its graph: {c}, "
                             f"prefills {before} -> {after}")
    log(f"  {label}: two first turns and a later turn (prefilled at cache slot {cursor}) each "
        f"replayed one graph: flash {c['flash']} and W8A16 {c['w8a16']} launches, all in "
        f"replayed graphs; the turns' frames == eager")


def rt_second_turn(engine, cfg, B: int) -> list:
    """A second turn on the cache the last ``generate`` left: a new turn
    grid and prefix prefilled at the cursor (flash at q_start > 0, a
    left-pad hole between the turns), then 16 greedy frames. Returns the
    turn's frames per row and the slot where its prefill began."""
    engine.reset_generation_state(keep_cache=True)
    cursor = int(engine.state.cur_len)
    grids, text = rt_load(cfg, B, seed=7, rows=9, text=28)
    engine.prefill(grids, [x[:12] for x in text], **RT_GREEDY)
    engine.step_block([[x[12 + i] for x in text] for i in range(16)], **RT_GREEDY)
    return [np.stack([f[b] for f in engine.generated_tokens]) for b in range(B)], cursor


def rt_server_load(cfg, n: int = 24, seed: int = 0):
    """``bench.py:425-432``: ``n`` conversations of 4-11 grid rows and 80
    text tokens; budgets of 32-63 frames (``bench.py:498``)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        T = int(rng.integers(4, 12))
        g = np.full((T, 1 + cfg.rvq), cfg.audio_pad_token, np.int64)
        g[:, 0] = rng.integers(100, 1000, T)
        g[:, 1:] = rng.integers(0, 1024, (T, cfg.rvq))
        reqs.append((g, [int(t) for t in rng.integers(100, 1000, 80)]))
    return reqs, [int(x) for x in rng.integers(RT_FRAMES // 2, RT_FRAMES, n)]


def rt_server_phase(params, cfg) -> tuple:
    """10b: ``RealtimeBatchServer(slots=8, cache_len=1024, prompt_bucket=16,
    poll_every=8)`` at temperature 0.8 (``bench.py:434-438``), warmed up,
    serves the 24 conversations through ``run`` and through ``run_events``:
    useful frames/s (``min(steps, budget + 1)``, ``bench.py:450-455``), ms
    per frame step, host waits per conversation. Returns (counts, rows, the
    server)."""
    reqs, budgets = rt_server_load(cfg)
    server = RealtimeBatchServer(params, cfg, slots=8, cache_len=1024,
                                 max_frames=RT_FRAMES + 16, prompt_bucket=16, poll_every=8,
                                 sampling=make_rt_sampling(temperature=0.8))
    t = time.perf_counter()
    server.warmup(prompt_lens=(16, 32), attend_upto=256)
    torch.cuda.synchronize()
    log(f"  warmup (admission graphs at buckets 16/32 x k 1-8, frame graphs of attend "
        f"128/256): {time.perf_counter() - t:.2f} s, {len(server._steps.keys)} frame graphs, "
        f"{sum(len(a.prefills.keys) for a in server._admissions.values())} admission graphs")
    counts, rows, ref = [], [], None
    for run in ("run", "run_events"):
        # the same request ids in both runs: the same keys (sampled at 0.8)
        server._ids = itertools.count()
        rids = {server.submit(g, txt, max_new_tokens=n): n for (g, txt), n in zip(reqs, budgets)}
        steps0, launched = server.total_steps, loop_launches(server)
        reset_counts()
        with host_waits() as waits:
            torch.cuda.synchronize()
            t = time.perf_counter()
            done = getattr(server, run)()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts.append(read_counts())
        launched = loop_launches(server) - launched
        if sorted(c.request_id for c in done) != sorted(rids):
            raise AssertionError(f"server {run}: completions {len(done)} of {len(rids)}")
        useful = sum(min(c.steps, rids[c.request_id] + 1) for c in done)
        steps = server.total_steps - steps0
        if not all(c.frames.ndim == 2 and c.frames.shape[1] == cfg.rvq and
                   ((c.frames >= 0) & (c.frames < cfg.audio_vocab_size)).all() for c in done):
            raise AssertionError(f"server {run}: bad frames")
        done = sorted(done, key=lambda c: c.request_id)
        firsts = None if ref is None else [first_divergence((0, a.frames), (0, b.frames))
                                           for a, b in zip(done, ref)]
        ref = done if ref is None else ref
        r = dict(run=run, conversations=len(done), useful_frames=useful, wall_s=wall,
                 useful_frames_per_s=useful / wall, frame_steps=steps,
                 ms_per_step=wall / steps * 1e3, host_waits_per_conversation=waits[0] / len(done),
                 loop_launches_per_conversation=launched / len(done), first_differing=firsts)
        log(f"  server {run}: {len(done)} conversations, {useful} useful frames in {wall:.3f} s "
            f"= {r['useful_frames_per_s']:.1f} useful frames/s, {steps} frame steps "
            f"({r['ms_per_step']:.2f} ms/step), {r['host_waits_per_conversation']:.1f} host "
            f"waits and {launched / len(done):.2f} loop-graph launches per conversation"
            + ("" if firsts is None else f"; first frame differing from run's: {firsts}"))
        rows.append(r)
        c = counts[-1]
        if not (c["graphs"]["decode"] and c["graphs"]["w8a16"] and c["flash"]):
            raise AssertionError(f"server {run}: the frames did not run the kernels in "
                                 f"replayed graphs, or no admission ran flash: {c}")
        if not (c["flash"] == c["graphs"]["flash"] and c["w8a16"] == c["graphs"]["w8a16"]
                and c["row_copy"] == c["graphs"]["row_copy"] > 0):
            raise AssertionError(f"server {run}: an admission launched outside its graph: {c}")
    adm = {str(key): dict(a.prefills.counts)
           for key, a in sorted(server._admissions.items())}
    log(f"  admissions by (k, attend) bucket (eager first uses in warmup, replays in the "
        f"runs): {adm}; every flash, W8A16 and splice (row copy) launch of both runs inside "
        f"replayed graphs")
    return counts, rows, server


def state_diff(a, b) -> list:
    """Where two states differ: each field whose tensors differ, with the
    rows (dim 1 of the caches, dim 0 of the rest, the keys' included) that
    hold a difference."""
    out = []
    for i, (x, y) in enumerate(zip(a.cache, b.cache)):
        if not torch.equal(x, y):
            rows = (x != y).transpose(0, 1).reshape(x.shape[1], -1).any(1)
            out.append((f"cache[{i}]", rows.nonzero().flatten().tolist()))
    for name, x, y in zip(a._fields[1:], a[1:], b[1:]):
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            d = x != y
            rows = d.reshape(d.shape[0], -1).any(1) if d.ndim else d.reshape(1)
            out.append((name, rows.nonzero().flatten().tolist()))
    return out


def mirror_state(dst, src) -> None:
    """Copy every tensor of the state ``src`` (its cache's and keys too)
    into ``dst``: what ``same_state`` compares."""
    ta = list(dst.cache) + [t for t in dst[1:] if isinstance(t, torch.Tensor)]
    tb = list(src.cache) + [t for t in src[1:] if isinstance(t, torch.Tensor)]
    for x, y in zip(ta, tb, strict=True):
        x.copy_(y)


# 10b's admissions: (k, grid rows, prompt bucket) with 12 prefix tokens; the
# server's warmup named bucket 32 only of these: bucket 64 admits eagerly into
# the static state kept for attend 128, bucket 160 into a transient one
RT_ADMISSIONS = ((1, 16, 32), (2, 16, 32), (4, 16, 32), (8, 16, 32), (1, 40, 64), (1, 148, 160))


def rt_admissions(server, cfg) -> list:
    """10b, on ``rt_server_phase``'s server (graphs, warmed up at buckets 16
    and 32) and an eager one of the same shape warmed up at bucket 32: the
    admissions of ``RT_ADMISSIONS`` into idle slots, each from the same
    running state (copied over) and request ids in both: after each the running and the
    admission state (cache, masks, frames, cursors, the keys) equal; an admission of a warmed bucket is one replay with
    no flash or W8A16 launch outside it, one of another bucket runs eagerly
    and captures nothing (a server never captures mid-serve); then each
    admission timed warm both ways (median of 5, wall and device, the
    splice included). Returns the timing rows."""
    reqs, _ = rt_server_load(cfg, n=8, seed=5)
    eager = RealtimeBatchServer(server.params, cfg, slots=8, cache_len=1024,
                                max_frames=server.max_frames, prompt_bucket=16, graphs=False,
                                sampling=make_rt_sampling(temperature=0.8))
    eager.warmup(prompt_lens=(32,), attend_upto=128)
    servers = dict(graph=server, eager=eager)
    captured = {key: a.prefills.keys for key, a in server._admissions.items()}

    def admit(srv, k, n):  # as serving admits: queued requests into free slots, one group
        for g, txt in reqs[:k]:
            srv.submit(np.concatenate([g] * 40)[:n], txt, max_new_tokens=32)
        srv._fill_free_slots()

    def free(srv):
        for slot in list(srv._active):
            srv._free(slot)

    rows = []
    for k, n, Tb in RT_ADMISSIONS:
        warm = Tb == 32
        key = (k, server._admit_attend(Tb))
        free(server)
        free(eager)
        mirror_state(eager.state, server.state)
        for srv in servers.values():  # the same request ids, so the same seeds
            srv._ids = itertools.count(1000)
        kept = server._admissions.get(key)
        before = dict(kept.prefills.counts) if kept else None
        reset_counts()
        admit(server, k, n)
        c = read_counts()
        admit(eager, k, n)
        if not same_state(server.state, eager.state):
            raise AssertionError(f"admission of k={k} at bucket {Tb}: graph server's state != "
                                 f"eager's: {state_diff(server.state, eager.state)}")
        if kept and not same_state(kept.state, eager._admissions[key].state):
            raise AssertionError(f"admission of k={k} at bucket {Tb}: admission state != eager's: "
                                 f"{state_diff(kept.state, eager._admissions[key].state)}")
        runs = {name: kept.prefills.counts[name] - before[name] for name in before} if kept else {}
        if warm and not (c["flash"] == c["graphs"]["flash"] > 0
                         and c["w8a16"] == c["graphs"]["w8a16"] and runs["replay"] == 1
                         and c["row_copy"] == c["graphs"]["row_copy"] == 1):
            raise AssertionError(f"admission of k={k}: not one replay of its graph, the splice "
                                 f"inside: {c} {runs}")
        if not warm and not (c["flash"] > c["graphs"]["flash"] and c["row_copy"] == 1
                             and (not kept or runs == dict(eager=1, capture=0, replay=0))):
            raise AssertionError(f"admission of k={k} at bucket {Tb} (not warmed): not eager: "
                                 f"{c} {runs}")
        walls = {}
        for name, srv in servers.items():
            free(srv)
            walls[name] = timed(lambda srv=srv: (admit(srv, k, n), free(srv)), n=5)
        how = "a replay" if warm else ("eager into the kept state" if kept
                                       else "eager into a transient state")
        rows.append(dict(k=k, bucket=Tb, warmed=warm, graph_ms=walls["graph"][0],
                         graph_device_ms=walls["graph"][1], eager_ms=walls["eager"][0],
                         eager_device_ms=walls["eager"][1]))
        log(f"  admission of k={k} (bucket {Tb}, {how} on the graph server, splice included), "
            f"warm, median of 5: graph server {walls['graph'][0]:.2f} ms wall / "
            f"{walls['graph'][1]:.2f} ms device, eager {walls['eager'][0]:.2f} ms wall / "
            f"{walls['eager'][1]:.2f} ms device; state == eager's, flash {c['flash']} "
            f"({c['graphs']['flash']} in replays), W8A16 {c['w8a16']} "
            f"({c['graphs']['w8a16']} in replays) and splice {c['row_copy']} "
            f"({c['graphs']['row_copy']} in replays) launches")
    if {key: a.prefills.keys for key, a in server._admissions.items()} != captured:
        raise AssertionError("an admission of a bucket not warmed captured a graph mid-serve")
    st = server._admissions
    mb = sum(t.nbytes for a in st.values() for t in a.state.cache) / 1e6
    log(f"  static admission states kept by warmup ((k, attend) = {sorted(st)}): KV caches "
        f"{mb:.1f} MB, against {mb * 1024 / 128:.1f} MB at the server's cache_len 1024; no "
        f"admission of a bucket not warmed captured a graph or kept a state")
    del servers, eager
    return rows


def rt_small_server_vs_solo() -> None:
    """On the small float32 model: a 2-slot server's greedy streams (5
    conversations, mid-flight admissions) equal the solo engine's, on the
    card, and the card's equal the CPU's."""
    cfg = RT_SMALL
    gen = torch.Generator(device="cpu").manual_seed(3)
    cpu_params = init_realtime_params(cfg, generator=gen, dtype=torch.float32, device="cpu")
    proc = RealtimeProcessor(ByteFallbackTokenizer(), channels=cfg.rvq)
    rng = np.random.default_rng(1)
    load = [(proc.make_user_prompt(f"q{i}", rng.integers(0, 1024, (3 + i, cfg.rvq))),
             proc.tokenizer.encode("a reply of some length " * (i + 1))) for i in range(5)]
    budgets = [12, 20, 9, 15, 11]
    streams = {}
    for dev in ("cpu", DEV):
        params = copy.deepcopy(cpu_params).to(dev)
        server = RealtimeBatchServer(params, cfg, slots=2, cache_len=256, max_frames=48,
                                     prompt_bucket=32, dtype=torch.float32,
                                     sampling=make_rt_sampling(**RT_GREEDY))
        rids = [server.submit(g, t, max_new_tokens=n, prefill_text_len=4)
                for (g, t), n in zip(load, budgets)]
        done = {c.request_id: c.frames for c in server.run()}
        engine = RealtimeEngine(params, cfg, dtype=torch.float32, device=dev, cache_len=256,
                                max_length=64, prefill_bucket=32)
        for rid, (g, t), n in zip(rids, load, budgets):
            solo = engine.generate([g], [t], max_length=n - 1, prefill_text_len=4,
                                   **RT_GREEDY)[0]
            if not np.array_equal(done[rid], solo):
                raise AssertionError(f"small f32 {dev}: server stream {rid} != solo engine")
        streams[dev] = [done[r] for r in rids]
    if not rt_same(streams["cpu"], streams[DEV]):
        raise AssertionError("small f32: the card's server streams differ from the CPU's")
    log(f"  small f32 2-slot server, 5 greedy conversations: == solo engine on the card "
        f"and on the CPU, card == CPU ({sum(len(s) for s in streams[DEV])} frames)")


def rt_streaming_phase(engine, codec, proc, label: str, eager) -> dict:
    """10c: a ``RealtimeStreamingSession`` on ``engine`` and an
    ``AudioStreamDecoder`` on ``codec`` (chunks of 12 frames, the first of
    2, 2 frames of crossfade), fed by ``RealtimeTextStreamBridge`` with a
    text split into word deltas, the drain bounded at 96 frames: the time
    to the first wave chunk, and the wave's length against its frames. Every
    4-frame codec chunk (the flush's too) replays the graph ``codec``'s
    warmup captured, and the tokens the decoder took, pushed the same way
    into a decoder on ``eager`` (``graphs=False``, the same weights), give
    the same chunks bit for bit."""
    session = RealtimeStreamingSession(engine, proc, codec=codec, temperature=0.8)
    session.reset_turn(user_text="hello", user_audio_tokens=np.random.default_rng(0).integers(
        0, 1024, (8, engine.config.rvq)))
    decoder = AudioStreamDecoder(codec, chunk_frames=12, overlap_frames=2, first_chunk_frames=2)
    pushed, push = [], decoder.push_tokens
    decoder.push_tokens = lambda tokens: (pushed.append(np.array(tokens)), push(tokens))[1]
    bridge = RealtimeTextStreamBridge(session, decoder)
    words = ("the port streams audio while the text is still arriving, one delta at a "
             "time, as a language model would send it").split(" ")
    chunks, first = [], None
    torch.cuda.synchronize()
    t = time.perf_counter()
    with codec_chunks(f"10c streaming session ({label})", codec) as replays, \
            codec.streaming(batch_size=1):
        for w in words:
            for wav in bridge.push_text_delta(w + " "):
                first = first or time.perf_counter() - t
                chunks.append(wav)
        for wav in bridge.finish(max_frames=96):
            first = first or time.perf_counter() - t
            chunks.append(wav)
    wall = time.perf_counter() - t
    wave = np.concatenate(chunks)
    n = len(engine.generated_tokens)
    if not (np.isfinite(wave).all() and wave.size > 0 and first is not None):
        raise AssertionError(f"streaming: bad wave {wave.shape}")
    twin, again = AudioStreamDecoder(eager, chunk_frames=12, overlap_frames=2,
                                     first_chunk_frames=2), []
    with eager.streaming(batch_size=1):
        for tokens in pushed:
            twin.push_tokens(tokens)
            again += [w for w in twin.audio_chunks() if w.size]
        last = twin.flush()
        again += [last] if last is not None and last.size else []
    if len(again) != len(chunks) or not all(np.array_equal(a, b) for a, b in zip(again, chunks)):
        raise AssertionError(f"streaming ({label}): the replayed chunks differ from eager's")
    r = dict(run=label, frames=n, chunks=len(chunks), first_chunk_ms=first * 1e3, wall_s=wall,
             wave_s=wave.size / codec.sampling_rate, frames_s=n / 12.5,
             codec_replays=replays["replay"])
    log(f"  streaming session ({label}): {n} frames -> {len(chunks)} chunks, "
        f"{r['wave_s']:.2f} s of wave ({r['frames_s']:.2f} s of frames; frames trimmed at EOS "
        f"or past the codebooks do not sound), first chunk after {r['first_chunk_ms']:.1f} ms, "
        f"{wall:.2f} s in all; {replays['replay']} codec chunks, each a replay, equal to eager's "
        f"bit for bit")
    return r


def rt_http_phase(engine, proc, codec) -> tuple:
    """10c: the port's HTTP server in this process with ``--rt-pool-slots
    4`` serves three concurrent ``POST /stream`` requests (temperature 0.8,
    at most 48 frames), the third with a longer user turn (another prompt
    bucket): each a chunked PCM16 answer with the sample-rate and pooled
    headers and the TTFA in its chunks' extensions; the pool captures no
    admission graph after its warmup. Returns (launch counts, rows)."""
    from http.server import ThreadingHTTPServer
    import socket
    import threading

    hs = http_server
    hs._STATE["args"] = SimpleNamespace(model_path=None, codec_path=None, device=DEV,
                                        pool_slots=0, rt_pool_slots=4)
    hs._STATE["rt_backend"] = (engine, proc, codec)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), hs.Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def stream(i, out):
        user = "hi" if i < 3 else "tell me, in one sentence, what the weather is like today"
        body = json.dumps({"text": f"stream number {i} of three, sent at once.",
                           "user_text": user, "max_frames": 48, "seed": i}).encode()
        t = time.perf_counter()
        with socket.create_connection(("127.0.0.1", port), timeout=600) as sock:
            sock.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
                         b"\r\nContent-Length: %d\r\nConnection: close\r\n\r\n" % len(body)
                         + body)
            raw = b""
            while chunk := sock.recv(1 << 16):
                raw += chunk
        head, rest = raw.split(b"\r\n\r\n", 1)
        headers = dict(x.split(": ", 1) for x in head.decode().split("\r\n")[1:])
        exts, n = [], 0
        while True:
            line, rest = rest.split(b"\r\n", 1)
            size, _, ext = line.decode().partition(";")
            if int(size, 16) == 0:
                break
            exts.append(ext)
            n += int(size, 16) // 2
            rest = rest[int(size, 16) + 2:]
        out[i] = dict(status=head.split(b" ")[1].decode(), headers=headers, ttfa=exts[0] if exts
                      else None, samples=n, chunks=len(exts), wall_s=time.perf_counter() - t)

    try:
        # the pool is built and warmed by the first request; one request first
        # so that the three concurrent ones meet a warm pool
        warm = {}
        stream(0, warm)
        pool = hs._STATE["rt_pool"]
        captured = {key: a.prefills.keys for key, a in pool.server._admissions.items()}
        reset_counts()
        out = {}
        threads = [threading.Thread(target=stream, args=(i, out)) for i in (1, 2, 3)]
        for x in threads:
            x.start()
        for x in threads:
            x.join(timeout=600)
        counts = read_counts()
        adm = {str(key): dict(a.prefills.counts)
               for key, a in sorted(pool.server._admissions.items())}
        log(f"  /stream pool admissions by the (k, attend) buckets its warmup kept (the "
            f"warmup ran the eager first uses and captured; other buckets admit eagerly into "
            f"transient states): {adm}; of the three requests' flash launches "
            f"{counts['graphs']['flash']} of {counts['flash']} in replayed graphs")
        if {key: a.prefills.keys for key, a in pool.server._admissions.items()} != captured:
            raise AssertionError("/stream: the pool captured an admission graph mid-serve")
    finally:
        srv.shutdown()
        srv.server_close()
        if hs._STATE["rt_pool"] is not None:
            hs._STATE["rt_pool"].close()
        hs._STATE["rt_pool"], hs._STATE["rt_backend"] = None, None
    for i in (1, 2, 3):
        r = out.get(i)
        if not (r and r["status"] == "200" and r["headers"].get("X-Pooled") == "1"
                and r["headers"].get("X-Sample-Rate") == str(codec.sampling_rate)
                and r["ttfa"] and r["ttfa"].startswith("ttfa=") and r["samples"] > 0):
            raise AssertionError(f"/stream request {i}: {r}")
        log(f"  /stream #{i} (pooled): {r['chunks']} chunks, {r['samples']} samples "
            f"({r['samples'] / codec.sampling_rate:.2f} s), first chunk's {r['ttfa']}, "
            f"request {r['wall_s']:.2f} s")
    if not (counts["graphs"]["decode"] and counts["graphs"]["w8a16"] and counts["flash"]):
        raise AssertionError(f"/stream: the pool's frames did not run the kernels: {counts}")
    return counts, [out[i] for i in (1, 2, 3)]


def phase_realtime() -> tuple:
    """Phase 10 (see the module docstring). Returns (the main paths' launch
    counts, the kernel numbers at the 1.7B shapes, the path's numbers)."""
    log("phase 10: the Realtime family at MOSS-TTS-Realtime 1.7B width")
    log("phase 10 kernels: flash, decode and W8A16 at the 1.7B shapes against plain")
    knum = rt_kernels()
    cfg = RealtimeConfig()
    t = time.perf_counter()
    engine = RealtimeEngine.random_init(seed=0, config=cfg, dtype=torch.bfloat16, device=DEV,
                                        max_length=RT_FRAMES + 16, cache_len=1024)
    torch.cuda.synchronize()
    bf16_bytes = param_bytes(engine.params)
    log(f"  init on card: RealtimeConfig() bf16 ({bf16_bytes / 1e9:.3f} GB of parameters) in "
        f"{time.perf_counter() - t:.2f} s")
    log("phase 10a: engine, bf16 weights")
    counts, rows = rt_engine_phase(engine, "bf16")
    engine.quantize()
    int8_bytes = param_bytes(engine.params)
    log(f"  quantize(): parameters {bf16_bytes / 1e9:.3f} -> {int8_bytes / 1e9:.3f} GB")
    log("phase 10a: engine, int8 weights")
    c, r = rt_engine_phase(engine, "int8")
    counts += c
    rows += r
    for c in counts:
        if not (c["flash"] and c["graphs"]["decode"]):
            raise AssertionError(f"engine: prefills without flash or frames without the decode "
                                 f"kernel in replayed graphs: {c}")
    if not all(c["graphs"]["w8a16"] for c in counts[2:]):
        raise AssertionError(f"int8 engine: no W8A16 launch in replayed graphs: {counts[2:]}")
    log("phase 10b: continuous batching, 8 slots, int8 weights, 24 conversations")
    sc, srows, server = rt_server_phase(engine.params, cfg)
    counts += sc
    admissions = rt_admissions(server, cfg)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    rt_small_server_vs_solo()
    log("phase 10c: streaming session and decoder on codec_1p6b, then /stream over HTTP")
    codec = MossAudioTokenizer.random_init(seed=0, config=codec_1p6b(), dtype=torch.float32,
                                           device=DEV)
    codec.warmup(stream_levels=cfg.rvq)  # as load_realtime_backend's codec
    eager = MossAudioTokenizer(codec.params, codec.config, graphs=False)
    proc = RealtimeProcessor(ByteFallbackTokenizer(), channels=cfg.rvq)
    stream = [rt_streaming_phase(engine, codec, proc, label, eager)
              for label in ("cold", "warm")]
    codes = np.random.default_rng(10).integers(0, 1024, (cfg.rvq, 1, 4))
    chunk = codec_graphs_vs_eager("10c codec_1p6b", codec, eager, [
        ("decode of one 4-frame stream chunk", ("decode", 1, 4, cfg.rvq, torch.float32),
         lambda c: c._decode_array(codes, 4))])
    log("phase 14b: the Realtime Gradio demo's handler on the int8 engine and codec_1p6b")
    with codec_chunks("14b", codec):
        gc_counts, gradio = gradio_realtime(engine, proc, codec)
    counts.append(gc_counts)
    with codec_chunks("10c /stream", codec):
        hc, hrows = rt_http_phase(engine, proc, codec)
    counts.append(hc)
    numbers = dict(engine=rows, param_bytes=dict(bf16=bf16_bytes, int8=int8_bytes),
                   server=srows, admissions=admissions, stream=stream, stream_chunk=chunk,
                   gradio=gradio, http=hrows)
    log("  phase 10 numbers: " + json.dumps(numbers))
    del engine, codec, eager
    gc.collect()
    torch.cuda.empty_cache()
    return counts, knum, numbers


# ----------------------------------------------------------------- phase 11
LOCAL_FRAMES = 64  # frames of the engine's timed load (bench.py's --steps default)
LOCAL_CHECK = 12  # frames of the graph-against-eager, seed and bitrate checks
LOCAL_SMALL = LocalConfig(  # a small float32 Local model whose heads the kernels take
    language_config=tiny_qwen3(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                               num_key_value_heads=2, head_dim=128),
    n_vq=8, additional_mlp_ffn_hidden_size=256, local_ffn_hidden_size=512,
    local_hidden_size=256, local_num_layers=2)


def local_greedy(cfg) -> dict:
    return dict(do_samples=[False] * cfg.channels)


def local_load(cfg, B: int, T: int = 128, seed: int = 0):
    """``bench.py:291-297``'s engine load: ``B`` random (T, C) grids with an
    ``audio_start`` row at 8, all rows valid."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (B, T, cfg.channels))
    ids[..., 1:] = rng.integers(0, 1024, (B, T, cfg.n_vq))
    ids[:, 8, 0] = cfg.audio_start_token_id
    return ids, np.ones((B, T), bool)


def local_frames(out) -> int:
    """Frames a ``LocalEngine.generate`` produced (its grids start at the
    last ``audio_start`` row, ``start_length + 1`` prompt rows)."""
    start, grid = out[0]
    return grid.shape[0] - start - 1


def local_kernels() -> dict:
    """The three kernels of the Local path at MossTTSLocal 1.7B's shapes,
    each against its plain version, with its device time, the plain
    version's, the library call's and the bound: flash for the engine's
    prefill (B = 64, the 127 rows before the last of bench.py's 128-row
    prompt, over a 256-slot cache) and the server's admission (B = 1, a
    64-row bucket with 33 rows of left pad, over 512 slots), GQA group 2;
    decode over the depth transformer's 33-slot cache (attend 1, 17 and 33
    at B = 1, 8 and 64; timed at 33) and the backbone's at B = 64; W8A16
    at the depth transformer's, the adapters' and the heads' shapes (one
    (2048, 1025) slice of the 32 stacked audio heads, f32 out; the
    (2048, 151936) text head), M = 1 and 64."""
    g = torch.Generator(device=DEV).manual_seed(11)
    bf = torch.bfloat16
    cfg = LocalConfig(language_config=qwen3_1p7b(), n_vq=32)
    lc = cfg.language_config
    L, H, KV, hd = lc.num_hidden_layers, lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim
    scale = hd ** -0.5
    out = {}
    fshapes = []
    for label, B, T, S, pad in (("engine prefill B=64 T=127 S=256", 64, 127, 256, 0),
                                ("server admission B=1 T=63 S=512", 1, 63, 512, 33)):
        q = torch.randn((B, T, H, hd), generator=g, device=DEV).to(bf)
        kc = torch.randn((L, B, KV, S, hd), generator=g, device=DEV).to(bf)
        vc = torch.randn((L, B, KV, S, hd), generator=g, device=DEV).to(bf)
        valid = torch.zeros((B, S), dtype=torch.bool, device=DEV)
        valid[:, pad:T + 1] = True
        fshapes.append(flash_shape(f"Local 1.7B {label}", q, None, None, valid,
                                   torch.zeros((), dtype=torch.int32, device=DEV), kv_major=True,
                                   rows=valid[:, :T], n_layers=L,
                                   layer=lambda i, kc=kc, vc=vc: (kc[i % L], vc[i % L])))
        del q, kc, vc
    out["flash"] = dict(max_abs_err=max(r["max_abs_err"] for r in fshapes), shapes=fshapes)

    dshapes, derr = [], 0.0
    Ld = cfg.local_num_layers
    for label, Lx, B, Sd, attends in (("depth", Ld, 1, 33, (1, 17, 33)),
                                      ("depth", Ld, 8, 33, (1, 17, 33)),
                                      ("depth", Ld, 64, 33, (1, 17, 33)),
                                      ("backbone", L, 64, 256, (256,))):
        kd = torch.randn((Lx, B, KV, Sd, hd), generator=g, device=DEV).to(bf)
        vd = torch.randn((Lx, B, KV, Sd, hd), generator=g, device=DEV).to(bf)
        qd = torch.randn((B, H, hd), generator=g, device=DEV).to(bf)
        for attend in attends:
            vald = (torch.arange(Sd, device=DEV) < attend)[None].expand(B, Sd).contiguous()
            if label == "backbone":
                vald = vald & (torch.rand((B, Sd), generator=g, device=DEV) < 0.9)
            for li in (0, Lx - 1):
                args = (qd, kd, vd, vald, li)
                derr = max(derr, check_close(
                    f"decode Local 1.7B {label} B={B} attend={attend} layer={li}",
                    decode_attn.decode_attention(*args, scale=scale, attend_len=attend),
                    decode_attn.decode_attention_ref(*args, scale=scale, attend_len=attend)))
        ms = time_ms(lambda i: decode_attn.decode_attention(qd, kd, vd, vald, i % Lx, scale=scale,
                                                             attend_len=attend))
        plain = time_ms(lambda i: decode_attn.decode_attention_ref(qd, kd, vd, vald, i % Lx,
                                                                   scale=scale, attend_len=attend))
        lib = library_ms(lambda i: F.scaled_dot_product_attention(
            qd[:, :, None], kd[i % Lx, :, :, :attend], vd[i % Lx, :, :, :attend],
            attn_mask=vald[:, None, None, :attend], scale=scale, enable_gqa=True))
        bd = decode_bound(qd, vald, attend, KV, hd * 2)
        shape = f"Local 1.7B {label} B={B} attend={attend} of {tuple(kd.shape)}"
        log(f"  decode {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {fmt_ms(lib)}, "
            f"bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})")
        dshapes.append(dict(shape=shape, ms=ms, plain_ms=plain, library_ms=lib, **bd))
        del kd, vd
    out["decode"] = dict(max_abs_err=derr, shapes=dshapes)

    wshapes, werr = [], 0.0
    w8_gemm.LAUNCHES_W8A16_BYTES = 0
    for name, K, N, count in (
            ("depth wq, mlp_out gate/up", 1536, 2048, Ld), ("depth wk/wv", 1536, 1024, Ld),
            ("depth wo, mlp_in down", 2048, 1536, Ld), ("depth w_gate/w_up", 1536, 8960, Ld),
            ("depth w_down", 8960, 1536, Ld), ("mlp_in gate/up, mlp_out down", 2048, 2048, 32),
            ("one audio head", 2048, 1025, 32), ("text head", 2048, 151936, 1)):
        qw = pitched(torch.empty((count, K, N), dtype=torch.int8, device=DEV).random_(
            -127, 128, generator=g))
        sc = torch.rand((count, N), generator=g, device=DEV) * 0.019 + 0.001
        head = name == "one audio head"
        out_dtype = torch.float32 if head else bf
        qt = qw.transpose(1, 2).contiguous()
        for M in (1, 64):
            x = torch.randn((M, K), generator=g, device=DEV).to(bf)
            for li in sorted({0, count - 1}):
                o = w8_gemm.w8a16_gemm(x, qw[li], sc[li], out_dtype)
                ref = w8_gemm.w8a16_gemm_ref(x, qw[li], sc[li], out_dtype)
                absref = w8_gemm.w8a16_gemm_ref(x.abs(), qw[li].abs(), sc[li], torch.float32)
                werr = max(werr, check_gemm(f"w8a16 Local 1.7B {name} M={M} layer={li}", o, ref,
                                            absref))
            ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, qw[i % count], sc[i % count], out_dtype))
            plain = time_ms(lambda i: w8_gemm.w8a16_gemm_ref(x, qw[i % count], sc[i % count],
                                                             out_dtype))
            lib = library_ms(lambda i: torch._weight_int8pack_mm(x, qt[i % count],
                                                                 sc[i % count].to(bf)))
            bd = gemm_bound(M, K, N, out_bytes=4 if head else 2)
            log(f"  w8a16 Local 1.7B {name} M={M} K={K} N={N}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, torch._weight_int8pack_mm {fmt_ms(lib)}, bound "
                f"{bd['bound_ms']:.5f} ms ({bd['bound_by']})")
            wshapes.append(dict(shape=f"Local 1.7B {name} ({K}, {N}) M={M}", ms=ms,
                                plain_ms=plain, library_ms=lib, **bd))
        del qw, sc, qt
    if w8_gemm.LAUNCHES_W8A16_BYTES:
        raise AssertionError(f"W8A16 took byte loads {w8_gemm.LAUNCHES_W8A16_BYTES} times at "
                             "the Local shapes")
    out["w8a16"] = dict(max_abs_err=werr, shapes=wshapes)
    torch.cuda.empty_cache()
    return out


def ckpt_family(label: str, cfg, src, table, load, same_output, serve=None) -> dict:
    """Write ``src`` (a random model on the card) under the reference's
    names into a sharded bf16 directory (1 GB shards and an index), load it
    onto the card through ``load``, and hold the loaded weights equal to
    the source's bit for bit and ``same_output(src, loaded)`` true; then
    ``serve(directory)``, whose result joins the row as ``served``."""
    with tempfile.TemporaryDirectory(dir=_build.build_root()) as tmp:
        t = time.perf_counter()
        info = write_hf_checkpoint(tmp, src, cfg, table(cfg), shard_bytes=1 << 30)
        write_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        loaded, lcfg = load(tmp, dtype=torch.bfloat16, device=DEV)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        if lcfg != cfg or not same_params(loaded, src):
            raise AssertionError(f"{label}: the loaded weights differ from their source")
        if not same_output(src, loaded):
            raise AssertionError(f"{label}: the loaded model's greedy frames differ from the "
                                 "source's")
        served = serve(tmp) if serve is not None else None
    r = dict(family=label, tensors=info["tensors"], shards=info["shards"], gb=info["bytes"] / 1e9,
             write_s=write_s, load_s=load_s, load_gb_per_s=info["bytes"] / 1e9 / load_s,
             served=served)
    log(f"  checkpoint {label}: {info['tensors']} tensors, {r['gb']:.3f} GB in {info['shards']} "
        f"shards; written in {write_s:.2f} s, loaded onto the card in {load_s:.2f} s "
        f"({r['load_gb_per_s']:.2f} GB/s); every tensor == its source bit for bit; greedy "
        "frames == the source model's")
    del loaded
    return r


TOK = tokenizer_fixture.load_expected()  # computed through transformers where it is installed


def tokenizer_texts(tok) -> None:
    """The committed texts' ids and decodes out of ``tok`` bit for bit."""
    if not isinstance(tok, Qwen2BPETokenizer):
        raise AssertionError(f"the directory's tokenizer is {type(tok).__name__}, not "
                             "Qwen2BPETokenizer")
    for e in TOK["texts"]:
        ids = tok.encode(e["text"])
        got = (ids, tok.decode(ids), tok.decode(ids, skip_special_tokens=True))
        if got != (e["ids"], e["decode"], e["decode_skip"]):
            raise AssertionError(f"tokenizer: {e['text']!r} gives {got}, expected {e}")


class TimedEncode:
    """``tok`` whose ``encode`` calls are timed (``seconds``, ``chars``)."""

    def __init__(self, tok):
        self.tok, self.seconds, self.chars = tok, 0.0, 0

    def encode(self, text, **kw):
        t = time.perf_counter()
        ids = self.tok.encode(text, **kw)
        self.seconds += time.perf_counter() - t
        self.chars += len(text)
        return ids


def tokenizer_times(path) -> dict:
    """Host times of the directory's tokenizer: load seconds (the first in
    this process builds the Unicode class tables), encode us per 1,000
    characters of the 2,000-character reply on an empty pre-token cache and
    then cached (median of 5), and the total encode time of a
    ``TextDeltaTokenizer`` fed that reply in word deltas (it re-encodes the
    whole text on every delta), whose released ids must be the committed
    ones."""
    reply = TOK["reply"]
    r = {}
    for key in ("load_s_first", "load_s"):
        t = time.perf_counter()
        tok = load_tokenizer(path)
        r[key] = time.perf_counter() - t
    tokenizer_texts(tok)
    text = reply["text"]
    tok = load_tokenizer(path)
    t = time.perf_counter()
    tok.encode(text)
    r["encode_us_per_1k_chars_cold"] = (time.perf_counter() - t) * 1e9 / len(text)
    runs = []
    for _ in range(5):
        t = time.perf_counter()
        tok.encode(text)
        runs.append((time.perf_counter() - t) * 1e9 / len(text))
    r["encode_us_per_1k_chars_cached"] = float(np.median(runs))
    timed = TimedEncode(load_tokenizer(path))
    deltas = TextDeltaTokenizer(timed)
    words = tokenizer_fixture.delta_words(text)
    released = [deltas.push_delta(w) for w in words] + [deltas.flush()]
    if released != reply["released"]:
        raise AssertionError("TextDeltaTokenizer over the reply's word deltas released other ids "
                             "than the committed ones")
    r.update(reply_chars=len(text), reply_deltas=len(words), reply_chars_encoded=timed.chars,
             bridge_encode_ms=timed.seconds * 1e3)
    log(f"  tokenizer (host times on the card's machine; {card_line()}): load "
        f"{r['load_s_first']:.3f} s first in the process, {r['load_s']:.3f} s again; encode "
        f"{r['encode_us_per_1k_chars_cold']:.1f} us per 1,000 characters cold, "
        f"{r['encode_us_per_1k_chars_cached']:.1f} cached; a {len(text)}-character reply in "
        f"{len(words)} word deltas through TextDeltaTokenizer: {timed.chars} characters "
        f"encoded in {r['bridge_encode_ms']:.1f} ms; released ids == the committed ones")
    return r


class RecordingEngine:
    """An engine whose ``generate`` keeps its last prompt and output."""

    def __init__(self, engine):
        self.engine, self.config, self.input_ids, self.out = engine, engine.config, None, None

    def generate(self, input_ids, *args, **kw):
        self.input_ids = np.asarray(input_ids)
        self.out = self.engine.generate(input_ids, *args, **kw)
        return self.out


NO_AUDIO = "No audio segments were generated."  # the pipelines' error, in JAX's too


def delay_tokenizer_request(path, src, cfg) -> dict:
    """11a on the Delay directory with the tokenizer fixture's files:
    ``load_delay_backend(path)`` on the card reads ``Qwen2BPETokenizer``
    (not the byte fallback) and weights equal to ``src``; the committed
    texts come out bit for bit (after the tokenizer's host times,
    ``tokenizer_times``); one mixed-script ``synthesize`` request
    (sampled, the demo's opening ``audio_start`` row) puts the committed
    prompt text ids into the engine, which generates frames, and returns a
    finite wave, or the pipeline's ``NO_AUDIO`` error when the random
    2-layer model closes the audio block before it outlasts the prompt's
    last rows (``DelayProcessor._parse_audio`` trims those)."""
    tokenizer_fixture.write_tokenizer_dir(path)
    times = tokenizer_times(path)  # first: its first load builds the Unicode class tables
    t = time.perf_counter()
    backend = load_delay_backend(path, device=DEV)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    try:
        tokenizer_texts(backend.processor.tokenizer)
        if not same_params(backend.engine.params, src):
            raise AssertionError("load_delay_backend: the weights differ from their source")
        rec = RecordingEngine(backend.engine)
        t = time.perf_counter()
        try:
            sr, wav, _ = synthesize(pipelines.DelayBackend(
                engine=rec, processor=backend.processor, demo=True), TOK["delay"]["text"],
                max_new_tokens=112, seed=0)
            outcome = f"{wav.size / sr:.2f} s of finite wave"
        except RuntimeError as e:
            if str(e) != NO_AUDIO:
                raise
            wav, outcome = np.zeros(1, np.float32), f"no wave ({NO_AUDIO!r})"
        wall = time.perf_counter() - t
    finally:
        del backend
        load_delay_backend.cache_clear()
    want = TOK["delay"]["prompt_text_ids"]
    got = rec.input_ids[0, :, 0].tolist()
    if got != want + [cfg.audio_start_token_id]:
        raise AssertionError(f"synthesize: prompt text ids {got}, expected {want} + audio_start")
    (start, grid), = rec.out
    frames = grid.shape[0] - start
    if not (frames > 0 and grid.shape[1] == cfg.channels and grid.min() >= 0
            and np.isfinite(wav).all()):
        raise AssertionError(f"synthesize: {frames} frames, grid {grid.shape}, wave {wav.shape}")
    log(f"  load_delay_backend(directory): {load_s:.2f} s, tokenizer Qwen2BPETokenizer; the "
        f"committed texts' ids and decodes bit for bit; synthesize({TOK['delay']['text']!r}): "
        f"{len(want)} prompt text ids == the committed ones, {frames} frames, {outcome}, "
        f"{wall:.2f} s")
    return dict(backend_load_s=load_s, synthesize_s=wall, frames=int(frames), wave=outcome,
                **times)


def realtime_tokenizer_turn(path, src) -> dict:
    """11a on the Realtime directory with the tokenizer fixture's files:
    ``load_realtime_backend(path)`` on the card reads ``Qwen2BPETokenizer``
    and weights equal to ``src``; a streaming turn (the committed user text
    and 8 silent frames) holds the committed prompt text ids, and the
    committed reply, sent in word deltas through ``TextDeltaTokenizer`` into
    ``RealtimeTextStreamBridge``, releases the committed ids and streams
    finite audio (the drain bounded at 64 frames)."""
    tokenizer_fixture.write_tokenizer_dir(path)
    exp = TOK["realtime"]
    t = time.perf_counter()
    engine, proc, codec = load_realtime_backend(path, device=DEV)
    load_s = time.perf_counter() - t
    try:
        tokenizer_texts(proc.tokenizer)
        if not same_params(engine.params, src):
            raise AssertionError("load_realtime_backend: the weights differ from their source")
        session = RealtimeStreamingSession(engine, proc, codec=codec, temperature=0.8)
        session.reset_turn(user_text=exp["user_text"], user_audio_tokens=np.zeros(
            (exp["user_audio_frames"], engine.config.rvq), np.int64))
        if session._turn_input_ids[:, 0].tolist() != exp["turn_text_ids"]:
            raise AssertionError("Realtime turn: the prompt's text ids differ from the committed")
        bridge = RealtimeTextStreamBridge(session, AudioStreamDecoder(
            codec, chunk_frames=12, overlap_frames=2, first_chunk_frames=2))
        deltas = TextDeltaTokenizer(proc.tokenizer)
        released, chunks = [], []
        t = time.perf_counter()
        with codec.streaming(batch_size=1):
            for w in tokenizer_fixture.delta_words(exp["reply"]) + [None]:
                released.append(deltas.flush() if w is None else deltas.push_delta(w))
                chunks += bridge.push_text_tokens(released[-1])
            chunks += bridge.finish(max_frames=64)
        wall = time.perf_counter() - t
        frames, sr = len(engine.generated_tokens), codec.sampling_rate
    finally:
        del engine, proc, codec
        load_realtime_backend.cache_clear()
    if released != exp["released"]:
        raise AssertionError(f"Realtime turn: released {released}, expected {exp['released']}")
    wave = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if not (frames > 0 and np.isfinite(wave).all()):
        raise AssertionError(f"Realtime turn: {frames} frames, wave {wave.shape}")
    log(f"  load_realtime_backend(directory): {load_s:.2f} s, tokenizer Qwen2BPETokenizer; "
        f"the committed texts bit for bit; a turn's prompt text ids and the {len(released)} "
        f"deltas' released ids == the committed ones; {frames} frames, {len(chunks)} chunks, "
        f"{wave.size / sr:.2f} s of finite wave in {wall:.2f} s")
    return dict(backend_load_s=load_s, turn_s=wall, frames=frames, chunks=len(chunks))



def phase_checkpoints() -> list:
    """11a (see the module docstring)."""
    rows = []
    gen = torch.Generator(device=DEV).manual_seed(21)
    bf = torch.bfloat16

    # Local 1.7B at full width, the backbone cut to 4 of 28 layers
    cfg = LocalConfig(language_config=qwen3_1p7b(num_hidden_layers=4), n_vq=32)
    src = init_local_params(cfg, generator=gen, dtype=bf, device=DEV)
    ids, mask = local_load(cfg, 2, T=32)

    def local_same(a, b):
        return same_grids(*(LocalEngine(p, cfg, graphs=False).generate(
            ids, mask, max_new_tokens=4, **local_greedy(cfg)) for p in (a, b)))

    rows.append(ckpt_family("Local 1.7B (4 of 28 layers)", cfg, src, local_table,
                            load_local_checkpoint, local_same))
    with tempfile.TemporaryDirectory(dir=_build.build_root()) as tmp:
        t = time.perf_counter()
        save_model(tmp, src, cfg, "moss_tts_local")
        back, bcfg = load_model(tmp, device=DEV)
        torch.cuda.synchronize()
        if bcfg != cfg or not same_params(back, src):
            raise AssertionError("save_model/load_model: the round trip changed the weights")
        log(f"  save_model/load_model round trip of that model: equal bit for bit, "
            f"{time.perf_counter() - t:.2f} s")
    del src, back

    # Delay 8B and Realtime 1.7B at full width with 2 layers
    cfg = DelayConfig(language_config=qwen3_8b(num_hidden_layers=2), n_vq=32)
    src = init_delay_params(cfg, generator=gen, dtype=bf, device=DEV)
    proc = DelayProcessor(ByteFallbackTokenizer(), config=cfg)
    batch = proc([[proc.build_user_message(text="A checkpoint, loaded.")]], mode="generation")

    def delay_same(a, b):
        return same_grids(*(DelayEngine(p, cfg, graphs=False).generate(
            batch["input_ids"], batch["attention_mask"], max_new_tokens=4, text_temperature=0.0,
            audio_temperature=0.0) for p in (a, b)))

    rows.append(ckpt_family("Delay 8B (2 of 36 layers)", cfg, src, delay_table,
                            load_delay_checkpoint, delay_same,
                            serve=lambda d: delay_tokenizer_request(d, src, cfg)))
    del src
    cfg = RealtimeConfig(language_config=qwen3_1p7b(num_hidden_layers=2))
    src = init_realtime_params(cfg, generator=gen, dtype=bf, device=DEV)
    grids, text = rt_load(cfg, 1)

    def rt_same_output(a, b):
        return rt_same(*(RealtimeEngine(p, cfg, device=DEV, max_length=16, cache_len=256,
                                        graphs=False).generate(grids, text, max_length=4,
                                                               **RT_GREEDY) for p in (a, b)))

    rows.append(ckpt_family("Realtime 1.7B (2 of 28 layers)", cfg, src, realtime_table,
                            load_realtime_checkpoint, rt_same_output,
                            serve=lambda d: realtime_tokenizer_turn(d, src)))
    del src

    codec = MossAudioTokenizer.random_init(seed=3, config=codec_1p6b(), dtype=torch.float32,
                                           device=DEV)
    with tempfile.TemporaryDirectory(dir=_build.build_root()) as tmp:
        t = time.perf_counter()
        codec.save_pretrained(tmp)
        saved = time.perf_counter() - t
        back = MossAudioTokenizer.from_pretrained(tmp, device=DEV)
        torch.cuda.synchronize()
        if back.config != codec.config or not same_params(back.params, codec.params):
            raise AssertionError("codec save_pretrained/from_pretrained changed the weights")
        log(f"  codec_1p6b save_pretrained/from_pretrained ({param_bytes(codec.params) / 1e9:.3f} "
            f"GB, f32): equal bit for bit; saved in {saved:.2f} s, loaded in "
            f"{time.perf_counter() - t - saved:.2f} s")
    del codec, back
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def local_time(engine, eager, ids, mask, label: str) -> dict:
    """The warm engine's load through ``generate`` (greedy, ``LOCAL_FRAMES``
    frames): wall per frame (the median of 3 calls, the prefill included,
    with their spread), the realtime multiple (frames / 12.5 over that
    wall, per stream and in all), the time to the first frame (a warm
    prefill and one frame, the frame read to the host; median of 5, wall
    and device) through the graphs and through ``eager`` (the same
    weights, graphs off: its frame is eager too), and the prefill alone
    both ways, the warm prefill checked to be one replay with no flash or
    W8A16 launch outside it; then 8 frames
    replayed back to back, timed by CUDA events with no profiler (the
    device clock), and 8 more under ``device_profile`` for the device
    kernels, their summed time (CUPTI's per-kernel tracing included) and
    the launches per frame."""
    cfg = engine.config
    B = ids.shape[0]
    greedy = local_greedy(cfg)
    engine.generate(ids, mask, max_new_tokens=LOCAL_FRAMES, **greedy)  # warm
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.generate(ids, mask, max_new_tokens=LOCAL_FRAMES, **greedy)
        walls.append(time.perf_counter() - t)
    wall = float(np.median(walls))
    n = local_frames(out)
    ttff, prefill = {}, {}
    ids_h, mask_h = torch.as_tensor(ids).pin_memory(), torch.as_tensor(mask).pin_memory()
    engine.generate(ids, mask, max_new_tokens=1, **greedy)  # warm (the eager engine is warm)
    for name, e in (("graph", engine), ("eager", eager)):
        ttff[name] = timed(lambda e=e: e.generate(ids, mask, max_new_tokens=1, **greedy), n=5)
        # the prefill alone (the eager engine's frame is eager too)
        prefill[name] = timed(lambda e=e: e._prefills.run(ids_h, mask_h, n_vq_infer=cfg.n_vq),
                              n=5)
    replays = engine._prefills.counts["replay"]
    reset_counts()
    engine.generate(ids, mask, max_new_tokens=1, **greedy)
    c = read_counts()
    if not (engine._prefills.counts["replay"] == replays + 1
            and c["flash"] == c["graphs"]["flash"] > 0 and c["w8a16"] == c["graphs"]["w8a16"]):
        raise AssertionError(f"{label} B={B}: a warm prefill launched outside its graph: {c}")
    kw = dict(attend_len=engine._steps.keys[0][0], n_vq_infer=cfg.n_vq,
              eos_token_id=cfg.audio_end_token_id)
    engine._steps.step(**kw)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(8):
        engine._steps.step(**kw)
    ev[1].record()
    ev[1].synchronize()
    replay_ms = ev[0].elapsed_time(ev[1]) / 8
    reset_counts()
    with profile_step.device_profile() as prof:
        for _ in range(8):
            engine._steps.step(**kw)
    per_frame = {k: v / 8 for k, v in read_counts()["graphs"].items() if v}
    evts = profile_step.device_events(prof)
    dev_ms = sum(e.self_device_time_total for e in evts) / 8 / 1e3
    kernels = sum(e.count for e in evts) / 8
    r = dict(weights=label, batch=B, frames=n, wall_s=wall, ms_per_frame=wall / n * 1e3,
             ms_per_frame_min=min(walls) / n * 1e3, ms_per_frame_max=max(walls) / n * 1e3,
             replay_ms_per_frame=replay_ms, device_ms_per_frame=dev_ms,
             kernels_per_frame=kernels, realtime_per_stream=n / 12.5 / wall,
             realtime_total=B * n / 12.5 / wall,
             first_frame_ms=ttff["graph"][0], first_frame_device_ms=ttff["graph"][1],
             first_frame_eager_ms=ttff["eager"][0],
             first_frame_eager_device_ms=ttff["eager"][1], prefill_ms=prefill["graph"][0],
             prefill_device_ms=prefill["graph"][1], prefill_eager_ms=prefill["eager"][0],
             prefill_eager_device_ms=prefill["eager"][1], launches_per_frame=per_frame)
    log(f"  {label} B={B}: {n} frames in {wall:.3f} s, {r['ms_per_frame']:.2f} ms/frame wall "
        f"(median of 3, {r['ms_per_frame_min']:.2f}-{r['ms_per_frame_max']:.2f}); replays "
        f"{replay_ms:.2f} ms/frame by CUDA events, {dev_ms:.2f} ms/frame of kernel time under "
        f"the profiler, {kernels:.0f} device kernels/frame; "
        f"{r['realtime_per_stream']:.2f}x realtime per stream, {r['realtime_total']:.2f}x total; "
        f"first frame (median of 5): graph {ttff['graph'][0]:.2f} ms wall / "
        f"{ttff['graph'][1]:.2f} ms device, eager {ttff['eager'][0]:.2f} ms wall / "
        f"{ttff['eager'][1]:.2f} ms device (a warm prefill: one replay, flash {c['flash']} and "
        f"W8A16 {c['w8a16']} launches all in it); the prefill alone (median of 5): graph "
        f"{prefill['graph'][0]:.2f} ms wall / {prefill['graph'][1]:.2f} ms device, eager "
        f"{prefill['eager'][0]:.2f} ms wall / {prefill['eager'][1]:.2f} ms device; kernel "
        f"launches per frame, all in the replayed graph: {per_frame}")
    if dev_ms <= 0 or replay_ms <= 0 or n <= 0:
        raise AssertionError(f"{label} B={B}: no device time, or no frame")
    return r


def cut_bitrate_ok(out: torch.Tensor, cfg, n: int) -> bool:
    """The frames ``out`` (B, frames, C) of a ``n_vq_for_inference=n`` run:
    channels 1..n hold codes, channels past n are 0 up to each row's first
    EOS frame and the pad code after it (a finished row emits EOS and pads,
    reference :429-432)."""
    out = out.cpu().numpy()
    eos = out[:, :, 0] == cfg.audio_end_token_id
    after = (np.cumsum(eos, axis=1) - eos) > 0  # frames after a row's first EOS frame
    tail = out[:, :, 1 + n:]
    return bool(np.where(after[..., None], tail == cfg.audio_pad_code, tail == 0).all()
                and (out[:, :, 1:1 + n] != 0).any())


def local_engine_phase(engine, label: str) -> tuple:
    """11b on ``engine`` (graph frames) and an eager engine over the same
    weights, at B = 1, 8 and 64: greedy grids equal bit for bit; seeds s1,
    s2, s1 give equal, different, equal grids; ``n_vq_for_inference=8``
    zero-fills channels 9-32; then the timings. Returns (launch counts of
    the graph engine's runs, timing rows)."""
    cfg = engine.config
    greedy = local_greedy(cfg)
    eager = LocalEngine(engine.params, cfg, dtype=engine.dtype, graphs=False)
    counts, rows = [], []
    for B in (1, 8, 64):
        ids, mask = local_load(cfg, B)
        reset_counts()
        g = engine.generate(ids, mask, max_new_tokens=LOCAL_CHECK, **greedy)
        seeded = [engine.generate(ids, mask, max_new_tokens=LOCAL_CHECK, seed=s)
                  for s in SEEDS]
        # the key's first prefill ran eagerly, its second captured: this one replays
        replayed = engine.generate(ids, mask, max_new_tokens=LOCAL_CHECK, **greedy)
        cut = engine.generate(ids, mask, max_new_tokens=LOCAL_CHECK, n_vq_for_inference=8,
                              **greedy)
        counts.append(read_counts())
        e = eager.generate(ids, mask, max_new_tokens=LOCAL_CHECK, **greedy)
        if not (same_grids(g, e) and same_grids(replayed, e)):
            raise AssertionError(f"{label} B={B}: graph frames or prefills differ from eager")
        if not (same_grids(seeded[0], seeded[2]) and not same_grids(seeded[0], seeded[1])):
            raise AssertionError(f"{label} B={B}: seeds s1, s2, s1 not equal, different, equal")
        if not cut_bitrate_ok(engine._steps.state.out[:, :local_frames(cut)], cfg, 8):
            raise AssertionError(f"{label} B={B}: n_vq_for_inference=8 did not zero-fill "
                                 "channels 9-32")
        log(f"  {label} B={B}: greedy graph frames == eager ({B} x {LOCAL_CHECK} frames; and "
            f"after a replayed prefill), seeds "
            f"s1 s2 s1 equal/different/equal, n_vq_for_inference=8 zero-fills channels 9-32")
        rows.append(local_time(engine, eager, ids, mask, label))
    log(f"  {label} engine prefills: {engine._prefills.counts} (graphs held: "
        f"{list(engine._prefills.keys)})")
    del eager
    return counts, rows


def local_server_load(cfg, n: int = 24, steps: int = LOCAL_FRAMES, seed: int = 0):
    """``bench.py:581-590``: ``n`` prompts of 24-63 rows with an
    ``audio_start`` row at 2, budgets of steps/2 .. steps-1 frames."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        T = int(rng.integers(24, 64))
        g = rng.integers(0, 1000, (T, cfg.channels))
        g[..., 1:] = rng.integers(0, 1024, (T, cfg.n_vq))
        g[2, 0] = cfg.audio_start_token_id
        prompts.append(g)
    return prompts, [int(x) for x in rng.integers(steps // 2, steps, n)]


def local_server_phase(params, cfg) -> tuple:
    """11c: ``LocalBatchServer(slots=8, cache_len=512, prompt_bucket=32)``,
    greedy (``bench.py:592-603``), warmed up, serves the 24 requests through
    ``run`` and through ``run_events``: useful frames/s (``min(steps,
    budget)``, ``bench.py:607``), ms per frame step, host waits per request.
    Returns (counts, rows, the server)."""
    prompts, budgets = local_server_load(cfg)
    server = LocalBatchServer(params, cfg, slots=8, cache_len=512,
                              out_capacity=LOCAL_FRAMES + 8, prompt_bucket=32, **local_greedy(cfg))
    t = time.perf_counter()
    server.warmup(prompt_lens=(32, 64), attend_upto=min(64 + LOCAL_FRAMES + 16, 512))
    torch.cuda.synchronize()
    log(f"  warmup (admission graphs at buckets {[k[0] for k in server._prefills.keys]}, frame "
        f"graphs {server._steps.keys}): {time.perf_counter() - t:.2f} s")
    counts, rows, ref = [], [], None
    for run in ("run", "run_events"):
        server._ids = itertools.count()  # the same request ids in both runs
        rids = {server.submit(g, max_new_tokens=n): n for g, n in zip(prompts, budgets)}
        steps0, launched = server.total_steps, loop_launches(server)
        reset_counts()
        with host_waits() as waits:
            torch.cuda.synchronize()
            t = time.perf_counter()
            done = getattr(server, run)()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts.append(read_counts())
        launched = loop_launches(server) - launched
        if sorted(c.request_id for c in done) != sorted(rids):
            raise AssertionError(f"server {run}: completions {len(done)} of {len(rids)}")
        if not all(c.tokens.shape[1] == cfg.channels and c.start_length >= 0 for c in done):
            raise AssertionError(f"server {run}: bad grids")
        useful = sum(min(c.steps, rids[c.request_id]) for c in done)
        steps = server.total_steps - steps0
        done = sorted(done, key=lambda c: c.request_id)
        firsts = None if ref is None else [
            first_divergence((a.start_length, a.tokens), (b.start_length, b.tokens))
            for a, b in zip(done, ref)]
        ref = done if ref is None else ref
        r = dict(run=run, requests=len(done), useful_frames=useful, wall_s=wall,
                 useful_frames_per_s=useful / wall, frame_steps=steps,
                 ms_per_step=wall / steps * 1e3, host_waits_per_request=waits[0] / len(done),
                 loop_launches_per_request=launched / len(done), first_differing=firsts)
        log(f"  server {run}: {len(done)} requests, {useful} useful frames in {wall:.3f} s "
            f"= {r['useful_frames_per_s']:.1f} useful frames/s, {steps} frame steps "
            f"({r['ms_per_step']:.2f} ms/step), {r['host_waits_per_request']:.1f} host waits "
            f"and {launched / len(done):.2f} loop-graph launches per request"
            + ("" if firsts is None else f"; first frame differing from run's: {firsts}"))
        rows.append(r)
        c = counts[-1]
        if not (c["graphs"]["decode"] and c["graphs"]["w8a16"] and c["flash"]):
            raise AssertionError(f"server {run}: the frames did not run the kernels in "
                                 f"replayed graphs, or no admission ran flash: {c}")
        if not (c["flash"] == c["graphs"]["flash"] and c["w8a16"] == c["graphs"]["w8a16"]
                and c["row_copy"] == c["graphs"]["row_copy"] > 0):
            raise AssertionError(f"server {run}: an admission launched outside its graph: {c}")
    log(f"  admissions {server._prefills.counts} (eager first uses in warmup, replays in the "
        f"runs); every flash, W8A16 and splice (row copy) launch of both runs inside replayed "
        f"graphs")
    return counts, rows, server


def local_admissions(server, cfg) -> list:
    """11c, on ``local_server_phase``'s server (graphs, warmed up at
    buckets 32 and 64) and an eager one of the same shape warmed up at
    bucket 64: a 60-row prompt (bucket 64) and a 100-row one (bucket 128,
    which the warmup did not name) admitted into slot 0, each from the same
    running and admission state (copied over) and request id in both: after
    each the batch-1 admission state and the running state equal; the
    bucket-64 admission one replay with no flash or W8A16 launch outside it,
    the bucket-128 one eager with nothing captured (a server never captures
    mid-serve); then each admission timed warm both ways (median of 5, wall
    and device, the splice included). Returns the timing rows."""
    prompts, _ = local_server_load(cfg, n=1, seed=6)
    eager = LocalBatchServer(server.params, cfg, slots=8, cache_len=512,
                             out_capacity=server.out_capacity, prompt_bucket=32, graphs=False,
                             **local_greedy(cfg))
    eager.warmup(prompt_lens=(64,), attend_upto=256)
    servers = dict(graph=server, eager=eager)
    captured = server._prefills.keys
    rows = []
    for n, Tb in ((60, 64), (100, 128)):
        grid = np.concatenate([prompts[0]] * 5)[:n]

        def admit(srv):  # as serving admits: from the queue into a free slot
            srv.submit(grid, max_new_tokens=32)
            srv._admit(0, srv._queue.pop(0))
            srv._active.clear()

        warm = Tb == 64
        mirror_state(eager.state, server.state)
        mirror_state(eager._small, server._small)
        for srv in servers.values():  # the same request ids, so the same seeds
            srv._ids = itertools.count(1000)
        before = dict(server._prefills.counts)
        reset_counts()
        admit(server)
        c = read_counts()
        admit(eager)
        runs = {name: server._prefills.counts[name] - before[name] for name in before}
        if not (same_state(server._small, eager._small) and same_state(server.state, eager.state)):
            raise AssertionError(f"Local admission at bucket {Tb}: graph state != eager state: "
                                 f"{state_diff(server._small, eager._small)} "
                                 f"{state_diff(server.state, eager.state)}")
        if warm and not (c["flash"] == c["graphs"]["flash"] > 0
                         and c["w8a16"] == c["graphs"]["w8a16"] and runs["replay"] == 1
                         and c["row_copy"] == c["graphs"]["row_copy"] == 1):
            raise AssertionError(f"Local admission: not one replay of its graph, the splice "
                                 f"inside: {c} {runs}")
        if not warm and not (c["flash"] > c["graphs"]["flash"] and c["row_copy"] == 1
                             and runs == dict(eager=1, capture=0, replay=0)):
            raise AssertionError(f"Local admission at bucket {Tb} (not warmed): not eager: "
                                 f"{c} {runs}")
        walls = {name: timed(lambda srv=srv: admit(srv), n=5) for name, srv in servers.items()}
        rows.append(dict(rows=n, bucket=Tb, warmed=warm, graph_ms=walls["graph"][0],
                         graph_device_ms=walls["graph"][1], eager_ms=walls["eager"][0],
                         eager_device_ms=walls["eager"][1]))
        log(f"  admission of a {n}-row prompt (bucket {Tb}, "
            f"{'a replay' if warm else 'eager'} on the graph server, splice included), warm, "
            f"median of 5: graph server {walls['graph'][0]:.2f} ms wall / "
            f"{walls['graph'][1]:.2f} ms device, eager {walls['eager'][0]:.2f} ms wall / "
            f"{walls['eager'][1]:.2f} ms device; state == eager's, flash {c['flash']} "
            f"({c['graphs']['flash']} in replays), W8A16 {c['w8a16']} "
            f"({c['graphs']['w8a16']} in replays) and splice {c['row_copy']} "
            f"({c['graphs']['row_copy']} in replays) launches")
    if server._prefills.keys != captured:
        raise AssertionError("a Local admission of a bucket not warmed captured a graph mid-serve")
    del servers, eager
    return rows


def local_small_server_vs_solo() -> None:
    """On the small float32 model: a 2-slot server's greedy grids (5
    requests, mid-flight admissions) equal the solo engine's fed the same
    bucket-padded grid, on the card and on the CPU, and the card's equal
    the CPU's."""
    cfg = LOCAL_SMALL
    greedy = local_greedy(cfg)
    gen = torch.Generator(device="cpu").manual_seed(4)
    cpu_params = init_local_params(cfg, generator=gen, dtype=torch.float32, device="cpu")
    prompts, _ = local_server_load(cfg, n=5, seed=2)
    budgets = [12, 20, 9, 15, 11]
    grids = {}
    for dev in ("cpu", DEV):
        params = copy.deepcopy(cpu_params).to(dev)
        server = LocalBatchServer(params, cfg, slots=2, cache_len=256, out_capacity=32,
                                  prompt_bucket=32, dtype=torch.float32, **greedy)
        rids = [server.submit(g, max_new_tokens=n) for g, n in zip(prompts, budgets)]
        done = {c.request_id: c for c in server.run()}
        engine = LocalEngine(params, cfg, dtype=torch.float32, cache_bucket=64, device=dev)
        for rid, g, n in zip(rids, prompts, budgets):
            T = g.shape[0]
            Tb = -(-T // 32) * 32
            ids = np.full((1, Tb, cfg.channels), cfg.audio_pad_code, np.int64)
            ids[..., 0] = cfg.pad_token_id
            ids[0, Tb - T:] = g
            mask = np.zeros((1, Tb), bool)
            mask[0, Tb - T:] = True
            start, solo = engine.generate(ids, mask, max_new_tokens=n, **greedy)[0]
            got = done[rid]
            # the server ends a request at its first EOS frame (kept), else
            # at its budget; the engine runs on to its next poll
            eos = np.nonzero(solo[start + 1:, 0] == server.eos_token_id)[0]
            if len(eos):
                solo = solo[: start + 2 + int(eos[0])]
            if got.start_length != start or not np.array_equal(got.tokens, solo):
                raise AssertionError(f"small f32 {dev}: server grid {rid} != solo engine")
        grids[dev] = [done[r].tokens for r in rids]
    if not all(np.array_equal(a, b) for a, b in zip(grids["cpu"], grids[DEV])):
        raise AssertionError("small f32: the card's server grids differ from the CPU's")
    log(f"  small f32 2-slot server, 5 greedy requests: == solo engine on the card and on the "
        f"CPU, card == CPU ({sum(len(x) for x in grids[DEV])} rows)")


def phase_local() -> tuple:
    """Phase 11 (see the module docstring). Returns (the main paths' launch
    counts, the kernel numbers at the Local shapes, the path's numbers)."""
    t11 = time.perf_counter()
    log("phase 11: checkpoints, and the Local family at MossTTSLocal 1.7B width")
    log("phase 11 kernels: flash, decode and W8A16 at the Local 1.7B shapes against plain")
    knum = local_kernels()
    log(f"phase 11a: checkpoint directories in the reference's layout, loaded onto the card "
        f"({time.perf_counter() - t11:.1f} s into phase 11)")
    ckpt = phase_checkpoints()
    cfg = LocalConfig(language_config=qwen3_1p7b(), n_vq=32)
    t = time.perf_counter()
    engine = LocalEngine.random_init(seed=0, config=cfg, dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    bf16_bytes = param_bytes(engine.params)
    log(f"  init on card: LocalConfig(qwen3_1p7b(), n_vq=32) bf16 ({bf16_bytes / 1e9:.3f} GB of "
        f"parameters) in {time.perf_counter() - t:.2f} s")
    log(f"phase 11b: engine, bf16 weights ({time.perf_counter() - t11:.1f} s into phase 11)")
    counts, rows = local_engine_phase(engine, "bf16")
    engine.quantize()
    int8_bytes = param_bytes(engine.params)
    log(f"  quantize(): parameters {bf16_bytes / 1e9:.3f} -> {int8_bytes / 1e9:.3f} GB")
    log("phase 11b: engine, int8 weights")
    c, r = local_engine_phase(engine, "int8")
    counts += c
    rows += r
    for c in counts:
        if not (c["flash"] and c["graphs"]["decode"]):
            raise AssertionError(f"Local engine: prefills without flash or frames without the "
                                 f"decode kernel in replayed graphs: {c}")
    if not all(c["graphs"]["w8a16"] for c in counts[3:]):
        raise AssertionError(f"int8 Local engine: no W8A16 launch in replayed graphs: {counts[3:]}")
    log(f"phase 11c: continuous batching, 8 slots, int8 weights, 24 requests "
        f"({time.perf_counter() - t11:.1f} s into phase 11)")
    sc, srows, server = local_server_phase(engine.params, cfg)
    counts += sc
    admission = local_admissions(server, cfg)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    local_small_server_vs_solo()
    numbers = dict(checkpoints=ckpt, engine=rows, param_bytes=dict(bf16=bf16_bytes, int8=int8_bytes),
                   server=srows, admission=admission)
    log(f"  phase 11 numbers ({time.perf_counter() - t11:.1f} s): " + json.dumps(numbers))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return counts, knum, numbers


TRAIN_T = 256  # the full-width trainers' sequence length (frames)
# batch at T = 256: Local's is the largest whose remat-off step fits the card
# after the earlier phases (B = 4 peaks at 78.0 GB alone and runs out of
# memory here, beside the 1.4 GB they leave allocated and the allocator's
# fragments); Realtime's and Delay's leave 14 and 33 GB free
TRAIN_B = dict(local=3, realtime=8, delay=8)
CODEC_B, CODEC_SECONDS = 4, 1.0
TRAIN_SMALL_CODEC = CodecConfig(  # the codec of tests/test_codec_training.py's trainer test
    hidden_size=48, intermediate_size=96, num_encoder_layers=1, num_decoder_layers=1,
    num_attention_heads=2, num_key_value_heads=2, head_dim=24, n_q=4, codebook_dim=24,
    causal_context=16)


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def params_gap(a, b) -> float:
    """||a - b|| / ||b|| over every parameter of two modules (b on any device)."""
    pb = dict(b.named_parameters())
    num = den = 0.0
    for n, x in a.named_parameters():
        y = pb[n].detach().to(x.device, torch.float64)
        num += float(((x.detach().double() - y) ** 2).sum())
        den += float((y ** 2).sum())
    return (num / den) ** 0.5


def same_start(card, cpu) -> None:
    """The card trainer's parameters (and discriminators) := the CPU trainer's."""
    load_tree_(card.params, cpu.params.state_dict())
    if hasattr(cpu, "d_params"):
        load_tree_(card.d_params, cpu.d_params.state_dict())


def card_vs_cpu(label: str, make, batches) -> dict:
    """12a: the same trainer on the card and on the CPU from the same
    parameters over the same batches: per step loss within rel 1e-4 and
    grad_norm within 1e-3, the final parameters within ||d|| / ||p|| 1e-4."""
    card, cpu = make(DEV), make("cpu")
    same_start(card, cpu)
    worst = dict(loss=0.0, grad_norm=0.0)
    for b in batches:
        rc, rp = card.train_step(b), cpu.train_step(b)
        for key, tol in (("loss", 1e-4), ("grad_norm", 1e-3)):
            if key not in rp:
                continue
            gap = rel_gap(rc[key], rp[key])
            worst[key] = max(worst[key], gap)
            if not gap <= tol:
                raise AssertionError(f"12a {label}: step {rp['step']} {key} card {rc[key]} "
                                     f"CPU {rp[key]} (rel {gap:.2e} > {tol:g})")
    gap = params_gap(card.params, cpu.params)
    if hasattr(cpu, "d_params"):
        gap = max(gap, params_gap(card.d_params, cpu.d_params))
    if not gap <= 1e-4:
        raise AssertionError(f"12a {label}: parameters after {len(batches)} steps differ, "
                             f"||d||/||p|| {gap:.2e}")
    log(f"  12a {label}: {len(batches)} steps, card == CPU: loss rel {worst['loss']:.2e}, "
        f"grad_norm rel {worst['grad_norm']:.2e}, parameters ||d||/||p|| {gap:.2e}")
    return dict(label=label, loss_rel=worst["loss"], grad_norm_rel=worst["grad_norm"],
                params_rel=gap)


def train_small() -> list:
    """12a (see the module docstring)."""
    rows = []
    for family in ("delay", "local", "realtime"):
        cfg = tiny_config(family)
        rng = np.random.default_rng(12)
        batches = [synthetic_tts_batch(family, cfg, rng, batch=2, seq=16) for _ in range(3)]
        rows.append(card_vs_cpu(family, lambda dev: TTSTrainer(
            family, cfg, peak_lr=3e-3, warmup_steps=1, total_steps=10, device=dev), batches))
    wav = synthetic_audio_batch(np.random.default_rng(12), 2, 0.25)
    for label, kw in (("codec", {}), ("codec adversarial", dict(adversarial=True,
                                                                   disc_channels=8))):
        rows.append(card_vs_cpu(label, lambda dev: CodecTrainer(
            TRAIN_SMALL_CODEC, num_quantizers=4, peak_lr=1e-3, warmup_steps=1, total_steps=10,
            device=dev, **kw), [wav] * 3))
    return rows


def no_kernel_launches(label: str) -> None:
    counts = read_counts()
    ran = {k: v for k, v in counts.items() if k != "graphs" and v}
    if ran:
        raise AssertionError(f"{label}: a training step launched hand-written kernels: {ran}")


def timed_steps(trainer, batch, n: int, label: str) -> dict:
    """``n`` steps on one batch, each timed by CUDA events (a step ends in
    the host reading its loss); the peak memory from the first step on."""
    gc.collect()
    torch.cuda.empty_cache()  # the run before may have cached blocks of other sizes
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    recs, ms = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        recs.append(trainer.train_step(batch))
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in recs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"12b {label}: a loss is not finite: {losses}")
    return dict(ms=ms, step_ms=float(np.median(ms[1:])) if n > 1 else ms[0],
                peak_gb=peak / 1e9, losses=losses,
                alloc_retries=torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries)


def train_full(label: str, trainer, batch, tokens: int, n: int, remat_too: bool,
               unit: str = "tokens") -> dict:
    """12b: ``n`` steps with remat off (and with ``remat_too`` ``n`` more
    with it on) on one repeated batch; the loss must fall; no kernel of
    ``ops/kernels`` may launch."""
    reset_counts()
    runs = {"off": timed_steps(trainer, batch, n, label)}
    if remat_too:
        trainer.remat = True
        runs["on"] = timed_steps(trainer, batch, n, label)
        trainer.remat = False
    no_kernel_launches(f"12b {label}")
    losses = [x for r in runs.values() for x in r["losses"]]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"12b {label}: the loss did not fall on a repeated batch: {losses}")
    row = dict(label=label, params=sum(p.numel() for p in trainer.params.parameters()),
               tokens=tokens, first_loss=losses[0], last_loss=losses[-1])
    for key, r in runs.items():
        row[f"remat_{key}"] = dict(step_ms=r["step_ms"], per_s=tokens / r["step_ms"] * 1e3,
                                   peak_gb=r["peak_gb"], ms=r["ms"],
                                   alloc_retries=r["alloc_retries"])
    log(f"  12b {label}: {row['params'] / 1e9:.3f} B parameters (f32), {tokens} {unit} a step; "
        + "; ".join(f"{'remat ' + k + ': ' if remat_too else ''}{v['step_ms']:.1f} ms a step, "
                    f"{v['per_s']:.0f} {unit}/s, "
                    f"peak {v['peak_gb']:.2f} GB, {v['alloc_retries']} allocator retries"
                    for k, v in ((k, row[f'remat_{k}']) for k in runs))
        + f"; loss {losses[0]:.4f} -> {losses[-1]:.4f}; no kernel of ops/kernels launched")
    return row


def tts_full(family: str, cfg, n: int = 4):
    """12b for one TTS family: (its trainer, the numbers)."""
    B = TRAIN_B[family]
    trainer = TTSTrainer(family, cfg, peak_lr=1e-4, warmup_steps=1, total_steps=2 * n,
                         device=DEV)
    batch = synthetic_tts_batch(family, cfg, np.random.default_rng(12), batch=B, seq=TRAIN_T)
    return trainer, train_full(f"{family} B={B} T={TRAIN_T}", trainer, batch, B * TRAIN_T, n,
                               remat_too=True)


def serve_trained(trainer, cfg) -> None:
    """12c: the Local trainer saved in the serving format, read back onto the
    card bit for bit, and its greedy frames equal the trainer's own."""
    trainer.params.requires_grad_(False)
    ids, mask = local_load(cfg, 1, T=32)
    with tempfile.TemporaryDirectory(dir=_build.build_root()) as tmp:
        t = time.perf_counter()
        trainer.save(tmp)
        saved = time.perf_counter() - t
        back, bcfg = load_model(tmp, device=DEV)
        torch.cuda.synchronize()
        loaded = time.perf_counter() - t - saved
    if bcfg != cfg or not same_params(back, trainer.params):
        raise AssertionError("12c: the saved trainer loaded back differs from its parameters")
    grids = [LocalEngine(p, cfg, dtype=torch.float32, graphs=False).generate(
        ids, mask, max_new_tokens=6, **local_greedy(cfg)) for p in (trainer.params, back)]
    if not same_grids(*grids):
        raise AssertionError("12c: the loaded model's greedy frames differ from the trainer's")
    log(f"  12c: Local 1.7B trainer saved ({param_bytes(back) / 1e9:.3f} GB f32) in "
        f"{saved:.2f} s, load_model onto the card in {loaded:.2f} s: equal bit for bit; "
        f"greedy LocalEngine frames from the loaded model == from the trainer's")


def release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_training() -> dict:
    """Phase 12 (see the module docstring)."""
    t12 = time.perf_counter()
    log("phase 12: training (no kernel of ops/kernels on the path, as no Pallas kernel is on "
        "JAX's)")
    log(f"  {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the card at the start")
    log("phase 12a: small f32 trainers, card against CPU")
    small = train_small()
    log(f"phase 12b: full width, f32, AdamW, T={TRAIN_T} ({time.perf_counter() - t12:.1f} s)")
    rows = []
    cfg = LocalConfig(language_config=qwen3_1p7b(), n_vq=32)
    local, row = tts_full("local", cfg)
    rows.append(row)
    log(f"phase 12c: train, save, serve ({time.perf_counter() - t12:.1f} s)")
    del local.opt
    serve_trained(local, cfg)
    del local
    release()
    for family, cfg in (("realtime", RealtimeConfig()),
                        ("delay", dataclasses.replace(
                            delay_8b(), language_config=qwen3_8b(num_hidden_layers=4)))):
        trainer, row = tts_full(family, cfg)
        rows.append(row)
        del trainer
        release()
    ccfg = codec_1p6b()
    wav = synthetic_audio_batch(np.random.default_rng(12), CODEC_B, CODEC_SECONDS)
    frames = CODEC_B * (wav.shape[1] // ccfg.hop)
    for label, kw, n in (("codec_1p6b AdamW", {}, 4),
                         ("codec_1p6b Adafactor", dict(optimizer="adafactor"), 1),
                         ("codec_1p6b adversarial", dict(adversarial=True), 1)):
        trainer = CodecTrainer(ccfg, peak_lr=1e-4, warmup_steps=1, total_steps=8, device=DEV,
                               **kw)
        if n > 1:
            rows.append(train_full(f"{label} B={CODEC_B} {CODEC_SECONDS:g} s", trainer, wav,
                                   frames, n, remat_too=False, unit="frames"))
        else:
            reset_counts()
            r = timed_steps(trainer, wav, n, label)
            no_kernel_launches(f"12b {label}")
            log(f"  12b {label}: one step, {r['step_ms']:.1f} ms, peak {r['peak_gb']:.2f} GB, "
                f"loss {r['losses'][0]:.4f}")
            rows.append(dict(label=label, step_ms=r["step_ms"], peak_gb=r["peak_gb"],
                             loss=r["losses"][0]))
        del trainer
        release()
    numbers = dict(small=small, full=rows, seconds=time.perf_counter() - t12)
    log(f"  phase 12 numbers ({numbers['seconds']:.1f} s): " + json.dumps(numbers))
    return numbers


# ---------------------------------------------------------------------------
# Phase 13: tensor and pipeline parallelism over torch.distributed, the int8
# codec, text_lazy

P13_NEW = 24  # new frames of 13b's greedy requests
P13_TRAIN = dict(B=2, T=64)  # 13c's batch


def shared_copy(module):
    """A module tree of its own over the same parameter tensors: ``shard_params``
    marks the modules it shards, and the unsharded engine keeps its own."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {k: shared_copy(v) for k, v in module._modules.items()}
    if hasattr(new, "_views"):
        new._views = {}
    return new


def tp_shapes(n: int) -> list:
    """The 8B model's int8 products on one rank of TP ``n``: name, K, N,
    stacked count, output dtype (column-parallel weights split N, the
    row-parallel ``wo``/``w_down`` split K, the heads their vocab columns
    and codebooks)."""
    return [("wq", 4096, 4096 // n, 0, torch.bfloat16), ("wk", 4096, 1024 // n, 0, torch.bfloat16),
            ("wo", 4096 // n, 4096, 0, torch.bfloat16),
            ("w_gate", 4096, 12288 // n, 0, torch.bfloat16),
            ("w_down", 12288 // n, 4096, 0, torch.bfloat16),
            ("text_head", 4096, 151936 // n, 0, torch.bfloat16),
            ("audio_heads", 4096, 1025, 32 // n, torch.float32)]


def phase_parallel_kernels() -> dict:
    """13a: flash, decode and W8A16 at one rank's shapes of TP 2 and 4 at 8B
    width (H = 32 / n, KV = 8 / n heads; the weights' blocks), against their
    plain versions; then W8A16's float32-activation mode (``w8f32_gemm``,
    the ring kernel's F32X3 mode) at ``codec_1p6b()``'s shapes against
    plain and bit-equal over two calls, with its time, its device kernels a
    call (read off a captured graph), the plain version's time, a yardstick
    (the float32 ``torch.matmul`` over the weights dequantized outside the
    timing), the library call ``torch._weight_int8pack_mm`` with float32
    activations and scales (``library_ms``; where it refuses them, null, and
    the refusal recorded) and two bounds: the work as the kernel does it
    (three bf16 products, or the bytes) and as one f32 product, at M = 200
    and 100 (the encoder pads every chunk to 100 frames: two waves and one,
    as phase 13d's 4 s wave runs), 50, 12 and 1. The kernels line takes
    ``w_gate`` at M = 100."""
    g = torch.Generator(device=DEV).manual_seed(13)
    bf = torch.bfloat16
    scale = HD8 ** -0.5
    for n in (2, 4):
        H, KV = H8 // n, KV8 // n
        kc = torch.randn((4, B8, KV, S8, HD8), generator=g, device=DEV).to(bf)
        vc = torch.randn((4, B8, KV, S8, HD8), generator=g, device=DEV).to(bf)
        T = 160
        q = torch.randn((B8, T, H, HD8), generator=g, device=DEV).to(bf)
        valid = torch.zeros((B8, S8), dtype=torch.bool, device=DEV)
        for b, p in enumerate((0, 17, 40, 95)):
            valid[b, p:T] = True
        flash_shape(f"TP{n} H={H} KV={KV} B={B8} T={T} kv-major S={S8}", q, None, None, valid, 0,
                    kv_major=True, rows=valid[:, :T], n_layers=4,
                    layer=lambda i: (kc[i % 4], vc[i % 4]))
        for B in (1, 4, 16):
            qd = torch.randn((B, H, HD8), generator=g, device=DEV).to(bf)
            kd = torch.randn((2, B, KV, SS, HD8), generator=g, device=DEV).to(bf)
            vd = torch.randn((2, B, KV, SS, HD8), generator=g, device=DEV).to(bf)
            vld = torch.rand((B, SS), generator=g, device=DEV) < 0.7
            vld[:, 0] = True
            for a in (256, 300, 1024):
                plan = decode_attn.decode_plan(B, KV, a, HD8, 2)
                out = decode_attn.decode_attention(qd, kd, vd, vld, 1, scale=scale, attend_len=a)
                ref = decode_attn.decode_attention_ref(qd, kd, vd, vld, 1, scale=scale,
                                                       attend_len=a)
                check_close(f"decode TP{n} H={H} KV={KV} B={B} attend={a} plan={plan}", out, ref)
            ms = time_ms(lambda i: decode_attn.decode_attention(qd, kd, vd, vld, i % 2,
                                                                scale=scale, attend_len=256))
            log(f"  decode TP{n} B={B} attend=256: kernel {ms:.4f} ms")
        for name, K, N, count, out_dtype in tp_shapes(n):
            shape = ((count,) if count else ()) + (K, N)
            qw = torch.empty(shape, dtype=torch.int8, device=DEV).random_(-127, 128, generator=g)
            sc = torch.rand(shape[:-2] + (N,), generator=g, device=DEV) * 0.019 + 0.001
            qw = pitched(qw)
            for M in (1, 16):
                x = torch.randn((M, K), generator=g, device=DEV).to(bf)
                out = w8_gemm.w8a16_gemm(x, qw, sc, out_dtype)
                ref = w8_gemm.w8a16_gemm_ref(x, qw, sc, out_dtype)
                absref = w8_gemm.w8a16_gemm_ref(x.abs(), qw.abs(), sc, torch.float32)
                check_gemm(f"w8a16 TP{n} {name} {tuple(shape)} M={M}", out, ref, absref)
            ms = time_ms(lambda i: w8_gemm.w8a16_gemm(x, qw, sc, out_dtype))
            log(f"  w8a16 TP{n} {name} M=16: kernel {ms:.4f} ms")
        del kc, vc, q
        torch.cuda.empty_cache()

    rows, main = [], None
    for name, K, N in codec_f32_shapes():
        qw = torch.empty((K, N), dtype=torch.int8, device=DEV).random_(-127, 128, generator=g)
        sc = torch.rand((N,), generator=g, device=DEV) * 0.019 + 0.001
        wf = qw.float() * sc  # the yardstick's weights, dequantized once
        qt = qw.t().contiguous()  # torch._weight_int8pack_mm's (N, K) layout
        err = 0.0
        for M in (200, 100, 50, 12, 1):
            x = torch.randn((M, K), generator=g, device=DEV)
            out = w8_gemm.w8f32_gemm(x, qw, sc)
            ref = w8_gemm.w8a16_gemm_ref(x, qw, sc, torch.float32)
            absref = w8_gemm.w8a16_gemm_ref(x.abs(), qw.abs(), sc, torch.float32)
            err = max(err, check_gemm(f"w8f32 codec {name} ({K}, {N}) M={M}", out, ref, absref))
            if not torch.equal(w8_gemm.w8f32_gemm(x, qw, sc), out):
                raise AssertionError(f"w8f32 codec {name} M={M}: two calls gave different bits")
            kernels, _ = graph_kernels(lambda: w8_gemm.w8f32_gemm(x, qw, sc))
            ms = time_ms(lambda i: w8_gemm.w8f32_gemm(x, qw, sc))
            plain_ms = time_ms(lambda i: w8_gemm.w8a16_gemm_ref(x, qw, sc, torch.float32))
            yard_ms = time_ms(lambda i: torch.matmul(x, wf))
            # PyTorch's one call for (x @ q) * scale, with float32 x and scales
            try:
                lib = torch._weight_int8pack_mm(x, qt, sc)
                lib_ms, refusal = time_ms(lambda i: torch._weight_int8pack_mm(x, qt, sc)), None
                lib_err = float((lib.float() - ref).abs().max())
            except (RuntimeError, NotImplementedError) as e:
                lib_ms, lib_err, refusal = None, None, f"{type(e).__name__}: {e}"[:300]
            # the work as the kernel does it: three bf16 products (x's
            # terms) on the tensor cores; beside it, one f32 product on the
            # CUDA cores
            nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
            bd = bound(nbytes, 3 * 2.0 * M * K * N, torch.bfloat16)
            f32_bd = bound(nbytes, 2.0 * M * K * N, torch.float32)
            row = dict(shape=f"{name} ({K}, {N}) M={M}", ms=ms, plain_ms=plain_ms,
                       yardstick_ms=yard_ms, library_ms=lib_ms, library_refusal=refusal,
                       library_max_abs_diff=lib_err, max_abs_err=err, kernels_per_call=kernels,
                       f32_bound_ms=f32_bd["bound_ms"], **bd)
            rows.append(row)
            lib_note = (f"torch._weight_int8pack_mm {lib_ms:.4f} ms (max abs difference from "
                        f"plain {lib_err:.3e})" if refusal is None else
                        f"torch._weight_int8pack_mm refuses float32: {refusal}")
            log(f"  w8f32 codec {name} ({K}, {N}) M={M}: kernel {ms:.4f} ms ({kernels} device "
                f"kernels a call, bit-equal over two calls), plain {plain_ms:.4f} ms, f32 matmul "
                f"over dequantized weights {yard_ms:.4f} ms, {lib_note}, bound {bd['bound_ms']:.5f} "
                f"ms ({bd['bound_by']}; three bf16 products at 989 TFLOP/s), f32 bound "
                f"{f32_bd['bound_ms']:.5f} ms ({f32_bd['bound_by']}; one f32 product at 67 "
                f"TFLOP/s)")
            if name == "w_gate" and M == 100:
                main = row
        del qw, sc, wf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                        "f32_bound_ms", "kernels_per_call")},
                yardstick_ms=main["yardstick_ms"], library_refusal=main["library_refusal"],
                shapes=rows)


def p13_prompts(cfg, B: int, seed: int = 13):
    """``B`` left-padded prompt grids that end in the audio generation slot."""
    rng = np.random.default_rng(seed)
    T = 40
    ids = rng.integers(0, 1024, (B, T, cfg.channels)).astype(np.int64)
    ids[..., 0] = rng.integers(0, 20000, (B, T))
    mask = np.ones((B, T), bool)
    for b in range(B):
        mask[b, :3 * b] = False
        ids[b, 3 * b + 1, 0] = cfg.im_start_token_id
    ids[:, -1, 0] = cfg.audio_assistant_gen_slot_token_id
    return ids, mask


def p13_server(params, cfg, mesh, grids) -> tuple:
    server = DelayBatchServer(params, cfg, slots=16, cache_len=512, out_capacity=64,
                              prompt_bucket=64, sampling=make_sampling(text_temperature=0.0,
                                                                       audio_temperature=0.0),
                              mesh=mesh)
    rids = [server.submit(g, max_new_tokens=P13_NEW) for g in grids]
    done = {c.request_id: c for c in server.run()}
    return [(done[r].start_length, done[r].tokens) for r in rids], server


def p13_engines(rank: int, world: int, mesh) -> dict:
    """13b on one rank: the 8B model, unsharded and with ``mesh=``, graphs on,
    bf16 then int8: ``generate`` (both loops) and a 16-slot server."""
    from mosstts_tpu_torch.parallel.mesh import mesh_axis

    cfg = delay_8b()
    gen = torch.Generator(device=DEV).manual_seed(13)
    params = init_delay_params(cfg, generator=gen, dtype=torch.bfloat16, device=DEV)
    solo = DelayEngine(params, cfg, dtype=torch.bfloat16, device=DEV)
    tp = DelayEngine(shared_copy(params), cfg, dtype=torch.bfloat16, device=DEV, mesh=mesh)
    ids, mask = p13_prompts(cfg, 4)
    grids = [ids[b][mask[b]] for b in range(4)] * 4  # 16 requests, 16 slots
    out, greedy = {}, dict(max_new_tokens=P13_NEW, text_temperature=0.0, audio_temperature=0.0)
    for label in ("bf16", "int8"):
        if label == "int8":
            solo.quantize()
            tp.quantize()
        for od in (False, True):
            reset_counts()
            t = time.perf_counter()
            got = tp.generate(ids, mask, on_device=od, **greedy)
            wall = time.perf_counter() - t
            counts, coll = read_counts(), read_collectives()
            want = solo.generate(ids, mask, on_device=od, **greedy)
            same = same_grids(got, want)
            # at n > 1 the bf16 sums of the shards round otherwise than one
            # card's (the CPU tests hold TP against JAX in float32)
            first = all(np.array_equal(a[1][a[0]], b[1][b[0]]) for a, b in zip(got, want))
            if world == 1 and not same:
                raise AssertionError(f"13b {label} on_device={od}: the TP1 engine's greedy "
                                     f"grids differ from the unsharded engine's")
            if not coll["in_graphs"]:
                raise AssertionError(f"13b {label}: no collective ran inside the replayed "
                                     f"graphs: {coll}")
            out[f"engine_{label}_{od}"] = dict(same=same, wall_s=wall, launches=counts,
                                               collectives=coll)
            if rank == 0:
                log(f"  13b engine {label} B=4 on_device={od} TP{world}: greedy grids "
                    f"{'equal bit for bit to' if same else 'differ from'} the unsharded engine's "
                    f"(first frames {'equal' if first else 'differ'}); {wall:.2f} s; launches "
                    f"{counts}; collectives {coll}")
        reset_counts()
        got, server = p13_server(tp.params, cfg, mesh, grids)
        counts, coll = read_counts(), read_collectives()
        want, _ = p13_server(solo.params, cfg, None, grids)
        same = same_grids(got, want)
        if world == 1 and not same:
            raise AssertionError(f"13b {label}: the TP1 server's grids differ from the unsharded "
                                 f"server's")
        if not coll["in_graphs"] or not counts["graphs"]["decode"]:
            raise AssertionError(f"13b {label} server: no collective or decode kernel inside "
                                 f"the replayed graphs: {counts} {coll}")
        out[f"server_{label}"] = dict(same=same, steps=server.total_steps, launches=counts,
                                      collectives=coll)
        if rank == 0:
            log(f"  13b server {label} 16 slots, 16 greedy requests TP{world}: grids "
                f"{'equal bit for bit to' if same else 'against'} the unsharded server's; "
                f"{server.total_steps} steps; launches {counts} (inside replayed graphs: "
                f"{counts['graphs']}); collectives {coll}")
        del server
    if world > 1:  # (one card makes no data axis; the CPU tests hold the refusal)
        try:
            DelayBatchServer(shared_copy(solo.params), cfg, slots=2,
                             mesh=make_mesh(data=world, model=1, device="cuda"))
            raise AssertionError("13b: a server mesh with data > 1 was accepted")
        except ValueError:
            pass
    assert mesh_axis(mesh, "model").size == world
    del solo, tp, params
    release()
    return out


def p13_trainers(rank: int, world: int, mesh) -> dict:
    """13c on one rank: one Delay step at 8B width cut to 4 layers with
    ``mesh=`` and with ``pipeline=`` (S = world), and one step of Local and
    Realtime at 1.7B width cut to 2 backbone layers with ``mesh=``, each
    against the unsharded trainer's loss (on rank 0). Realtime's mesh is
    data-parallel (``data=world``, twice the rows a rank): its spec table
    admits no model axis of 2 or more."""
    rt = RealtimeConfig()
    dp = make_mesh(data=world, model=1, device="cuda")
    runs = (
        ("delay", dataclasses.replace(delay_8b(), language_config=qwen3_8b(num_hidden_layers=4)),
         P13_TRAIN["B"], (("mesh", dict(mesh=mesh)),
                          ("pipeline", dict(pipeline=(make_pp_mesh(world, device="cuda"), 2))))),
        ("local", LocalConfig(language_config=qwen3_1p7b(num_hidden_layers=2), n_vq=32),
         P13_TRAIN["B"], (("mesh", dict(mesh=mesh)),)),
        ("realtime", dataclasses.replace(rt, language_config=dataclasses.replace(
            rt.language_config, num_hidden_layers=2)), P13_TRAIN["B"] * world,
         (("mesh", dict(mesh=dp)),)),
    )
    kw = dict(peak_lr=1e-4, warmup_steps=1, total_steps=4, device=DEV)
    out = {}
    for family, cfg, rows, options in runs:
        batch = synthetic_tts_batch(family, cfg, np.random.default_rng(13), batch=rows,
                                    seq=P13_TRAIN["T"])
        ref = None
        if rank == 0:
            plain = TTSTrainer(family, cfg, **kw)
            ref = plain.train_step(batch)
            del plain
            release()
        for option, extra in options:
            label = f"{family} {option}"
            reset_counts()
            tr = TTSTrainer(family, cfg, **kw, **extra)
            torch.cuda.synchronize()
            t = time.perf_counter()
            rec = tr.train_step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            no_kernel_launches(f"13c {label}")
            out[label] = dict(rec=rec, wall_s=wall)
            if rank == 0:
                gap = rel_gap(rec["loss"], ref["loss"])
                if not gap <= 1e-5:
                    raise AssertionError(f"13c {label}: loss {rec['loss']} against the "
                                         f"unsharded {ref['loss']} (rel {gap:.2e})")
                log(f"  13c {label} TP/PP {world}: loss {rec['loss']:.6f} against unsharded "
                    f"{ref['loss']:.6f} (rel {gap:.2e}), |g| {rec['grad_norm']:.5f} against "
                    f"{ref['grad_norm']:.5f}; {wall:.2f} s a step")
            del tr
            release()
    return out


def parallel_ranks(rank: int, world: int) -> dict:
    """13b and 13c, every rank the same calls (SPMD)."""
    mesh = make_mesh(data=1, model=world, device="cuda")
    return dict(engines=p13_engines(rank, world, mesh), trainers=p13_trainers(rank, world, mesh))


def _init_group(rank: int, world: int, address: str) -> None:
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=address, rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank),
                            timeout=datetime.timedelta(seconds=300))


def _spawned_rank(rank: int, world: int, address: str) -> None:
    """A rank of 13b/13c after the first, in a process of its own."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _init_group(rank, world, address)
    parallel_ranks(rank, world)
    dist.destroy_process_group()


def phase_int8_codec(wav: np.ndarray) -> dict:
    """13d: ``codec_1p6b()`` with int8 weights (``quantize_tree_``): the
    encoder's products through W8A16's float32-activation mode, the
    decoder's through W8A16 (bf16 activations, as JAX's int8 codec), each
    chunk one replay of the graphs the codec's ``warmup`` captured (batch 1,
    100 frames). Phase 8a's 4 s wave encoded and decoded on the card: equal
    bit for bit to the same chunks run eagerly (``graphs=False``), with
    their times, the two kernels counted inside the graphs; against the
    float32 codec on the card (JAX's test's bound: mean relative deviation
    < 0.5); with 2 of 22 encoder and decoder layers, the card's int8 codes
    against the CPU's int8 codes (near ties only) and the card's wave
    against the CPU's."""
    from mosstts_tpu_torch.codec.model import MossAudioTokenizer
    from mosstts_tpu_torch.ops.quant import quantize_tree_

    cfg = codec_1p6b()
    f32 = MossAudioTokenizer.random_init(seed=13, config=cfg, device=DEV)
    q8 = MossAudioTokenizer(quantize_tree_(copy.deepcopy(f32.params)), cfg)
    q8.warmup(decode_levels=cfg.n_q)
    eager = MossAudioTokenizer(q8.params, cfg, graphs=False)
    reset_counts()
    t = time.perf_counter()
    with codec_chunks("13d int8 encode + decode", q8):
        enc = q8.encode(wav)
        wave = np.asarray(q8.decode(enc.audio_codes)["audio"], np.float32)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    g = counts["graphs"]
    if not (counts["w8f32"] and counts["w8a16"] and g["w8f32"] == counts["w8f32"]
            and g["w8a16"] == counts["w8a16"]):
        raise AssertionError(f"13d: the int8 codec did not run both GEMMs inside its graphs: "
                             f"{counts}")
    key = ("int8",)
    graphs = codec_graphs_vs_eager("13d int8 codec_1p6b", q8, eager, [
        ("encode of the 4 s wave", ("encode", 1, 100, cfg.n_q) + key,
         lambda c: c.encode(wav).audio_codes),
        ("decode of its 50 frames", ("decode", 1, 100, cfg.n_q) + key,
         lambda c: c.decode(enc.audio_codes)["audio"])])
    ref = np.asarray(f32.decode(enc.audio_codes, chunk_duration=None)["audio"], np.float32)
    if not np.isfinite(wave).all():
        raise AssertionError("13d: non-finite int8 wave")
    dev = float(np.abs(wave - ref).mean() / (np.abs(ref).mean() + 1e-6))
    if not dev < 0.5:
        raise AssertionError(f"13d: int8 wave deviates {dev:.3f} (mean relative) from f32's")
    # card against CPU, 2 of 22 layers each side
    cut = dataclasses.replace(cfg, num_encoder_layers=2, num_decoder_layers=2)
    card_cut = MossAudioTokenizer(quantize_tree_(cpu_codec_copy(f32.params, cut).to(DEV)), cut)
    cpu_cut = MossAudioTokenizer(quantize_tree_(cpu_codec_copy(f32.params, cut)), cut)
    with rvq_inputs() as lat_cpu:
        cpu_codes = cpu_cut.encode(wav).audio_codes
    card_codes = card_cut.encode(wav).audio_codes
    T = cpu_codes.shape[-1]
    books = f32.params.rvq.codebooks.detach().cpu()
    flips = code_mismatches("13d int8 encode, 2 of 22 layers, card vs CPU", card_codes,
                            cpu_codes, lat_cpu[0][:, :T], books)
    cw = np.asarray(card_cut.decode(cpu_codes, chunk_duration=None)["audio"], np.float32)
    pw = np.asarray(cpu_cut.decode(cpu_codes, chunk_duration=None)["audio"], np.float32)
    wave_gap = float(np.abs(cw - pw).max() / (np.abs(pw).max() + 1e-6))
    if not wave_gap < 2.0 ** -6:  # the decoder runs bf16: two bf16 ulps of the peak
        raise AssertionError(f"13d: the card's int8 wave (2 layers) lies {wave_gap:.2e} of its "
                             f"peak from the CPU's")
    log(f"  13d int8 codec_1p6b: encode + decode of {wav.size / cfg.sampling_rate:.1f} s on the "
        f"card {wall:.2f} s, one replay a chunk (w8f32 {counts['w8f32']} launches, w8a16 "
        f"{counts['w8a16']}, all inside the codec's graphs); mean relative deviation from the f32 "
        f"codec {dev:.4f} (< 0.5); 2-layer card vs CPU: {flips} frames differ at near ties, wave "
        f"{wave_gap:.2e} of the peak apart (the SIMT f32 kernel's run, PERF.md §6: 0.13 s, 156 "
        f"w8f32 launches, 0 frames differ, 7.18e-03)")
    out = dict(wall_s=wall, deviation=dev, card_vs_cpu_frames=flips, wave_gap=wave_gap,
               w8f32_launches=counts["w8f32"], w8a16_launches=counts["w8a16"],
               w8f32_in_graphs=g["w8f32"], w8a16_in_graphs=g["w8a16"], graphs=graphs)
    del f32, q8, eager, card_cut
    release()
    return out


def cpu_codec_copy(params, cfg):
    """The first layers of ``params`` (both halves) for config ``cfg``, as a
    float32 CodecParams on the CPU."""
    from mosstts_tpu_torch.codec.model import CodecParams

    card = dict(params.named_parameters())
    cpu = CodecParams(cfg)
    with torch.no_grad():
        for name, dst in cpu.named_parameters():
            src = card[name]
            dst.copy_(src[: dst.shape[0]] if src.shape != dst.shape else src)
    return cpu


def phase_text_lazy() -> dict:
    """13e: ``delay_decode_step(text_lazy=True)`` on a small float32 model on
    the card: 15 eager greedy steps of 3 rows (one in free text) equal the
    full path's bit for bit; then the lazy step captured into one CUDA
    graph (the condition kernel and an IF node per branch) and replayed 6
    times from a state with a row in free text and 6 from one with every
    row in an audio block: the frames equal the eager lazy steps', and the
    device counters say how many times each branch ran. Returns the
    condition kernel's launches and the branch counts."""
    from mosstts_tpu_torch.engine.step_graph import (STEP_FIELDS, GraphSteps, copy_state_,
                                                     zero_state)
    from mosstts_tpu_torch.models.delay import delay_decode_step, delay_prefill
    from mosstts_tpu_torch.ops.kernels import graph_loop as gl
    from mosstts_tpu_torch.ops.sampling import row_keys

    cfg = DelayConfig(language_config=tiny_qwen3(
        hidden_size=256, intermediate_size=512, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128), n_vq=4)
    params = init_delay_params(cfg, generator=torch.Generator(device=DEV).manual_seed(13),
                               dtype=torch.float32, device=DEV)
    greedy = make_sampling(text_temperature=0.0, audio_temperature=0.0, device=DEV)

    def prefilled(free_text: bool, B: int = 3):
        ids, mask = p13_prompts(cfg, B)
        for b in range(B):  # every row in an open audio block, after its im_start
            ids[b, 3 * b + 3, 0] = cfg.audio_start_token_id
        if free_text:
            ids[2, -1, 0] = 100  # row 2 in free text: the full branch
        return delay_prefill(params, cfg, torch.as_tensor(ids, device=DEV),
                             torch.as_tensor(mask, device=DEV), max_new_tokens=16,
                             cache_len=128, rng=row_keys(1, B).to(DEV), sampling=greedy,
                             dtype=torch.float32)

    def steps(st, n, lazy):
        for _ in range(n):
            st = delay_decode_step(params, cfg, st, greedy, attend_len=128, text_lazy=lazy)
        return st

    reset_counts()
    with torch.no_grad():
        outs = {lazy: steps(prefilled(True), 15, lazy).out.cpu().numpy() for lazy in (False, True)}
        if not np.array_equal(outs[False], outs[True]):
            raise AssertionError("13e: text_lazy's greedy frames differ from the full path's")
        state = zero_state(cfg, 3, 128, 16, dtype=torch.float32, kv_quant=False, device=DEV)

        def lazy_step():
            new = delay_decode_step(params, cfg, state, greedy, attend_len=128, text_lazy=True)
            for name in STEP_FIELDS:
                getattr(state, name).copy_(getattr(new, name))

        graphs = GraphSteps(params, "text_head", DEV)
        copy_state_(state, prefilled(True))
        graphs.warm(lazy_step)
        graph, captured = graphs.capture(lazy_step)
        counts = gl.lazy_counts(DEV)
        ran = {}
        for free_text in (True, False):
            copy_state_(state, prefilled(free_text))
            before = counts[:2].cpu()
            for _ in range(6):
                graph.replay()
                kernel_launches.add_replay(captured)
            ran[free_text] = (counts[:2].cpu() - before).tolist()
            want = steps(prefilled(free_text), 6, True)
            if not (torch.equal(want.out, state.out) and torch.equal(want.cur_ids, state.cur_ids)):
                raise AssertionError(f"13e: the lazy graph's frames differ from the eager lazy "
                                     f"steps' (free text: {free_text})")
    if not (ran[True][0] >= 1 and ran[False][1] >= 1):
        raise AssertionError(f"13e: a branch never ran in the lazy graph: {ran}")
    launched = read_counts()["lazy_cond"]
    log(f"  13e text_lazy: 16 greedy frames of 3 rows (one in free text) equal the full path's "
        f"bit for bit on the card; the lazy step as one CUDA graph (condition kernel + an IF "
        f"node per branch), 6 replays from each state equal the eager lazy steps: branch runs "
        f"[full, 2 columns] {ran[True]} with a row in free text, {ran[False]} with every row in "
        f"audio; condition kernel launches {launched}")
    return dict(frames=int(outs[True].shape[1]), branch_runs=ran, lazy_cond_launches=launched)


def phase_parallel() -> dict:
    """Phase 13 (see the module docstring)."""
    import socket

    import torch.distributed as dist

    t13 = time.perf_counter()
    log("phase 13: parallelism over torch.distributed, the int8 codec, text_lazy")
    log("phase 13a: flash, decode and W8A16 at TP 2 and 4 shard shapes (8B width); W8A16's "
        "float32-activation mode at codec_1p6b's shapes")
    numbers = dict(w8f32=phase_parallel_kernels())
    world = min(torch.cuda.device_count(), 4)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    log(f"phase 13b: DelayEngine and a 16-slot DelayBatchServer with mesh=make_mesh(1, {world}) "
        f"over NCCL, graphs on, bf16 then int8 ({time.perf_counter() - t13:.1f} s)")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spawned_rank, args=(r, world, address)) for r in range(1, world)]
    for p in procs:
        p.start()
    _init_group(0, world, address)
    try:
        numbers["ranks"] = parallel_ranks(0, world)
    finally:
        for p in procs:
            p.join(600)
        dist.destroy_process_group()
    bad = [(i + 1, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"13b/13c: ranks failed (rank, exit code): {bad}")
    log(f"phase 13d: int8 codec_1p6b ({time.perf_counter() - t13:.1f} s)")
    numbers["codec"] = phase_int8_codec(sweep_wav(4.0, seed=8))
    numbers["w8f32_launches"] = numbers["codec"]["w8f32_launches"]
    log(f"phase 13e: text_lazy on a small model ({time.perf_counter() - t13:.1f} s)")
    numbers["text_lazy"] = phase_text_lazy()
    numbers["lazy_cond_launches"] = numbers["text_lazy"]["lazy_cond_launches"]
    numbers["seconds"] = time.perf_counter() - t13
    log(f"  phase 13 numbers ({numbers['seconds']:.1f} s): "
        + json.dumps({k: v for k, v in numbers.items() if k != "w8f32"}, default=str))
    return numbers


# ----------------------------------------------------------------- phase 14
GRADIO_NEW = 40  # max_new_tokens of the Delay demos' calls (sfx: its duration's budget)
GRADIO_RT_FRAMES = 96  # the Realtime demo's turn, in frames (random weights need not stop)


def timed_call(fn, *args, **kw):
    """``fn(*args, **kw)`` and its wall seconds, the card synchronized
    before (a call that returns host arrays has waited for its own work)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kw)
    wall = time.perf_counter() - t
    torch.cuda.synchronize()
    return out, wall


def check_ui_wave(label: str, out, sr: int) -> np.ndarray:
    """A handler's ``((sr, wav), status)``: the rate, a finite non-empty
    float32 wave, a status string."""
    (got_sr, wav), status = out
    if not (got_sr == sr and isinstance(wav, np.ndarray) and wav.dtype == np.float32
            and wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()
            and isinstance(status, str) and status):
        raise AssertionError(f"{label}: bad handler output sr={got_sr} "
                             f"wave={getattr(wav, 'shape', None)} status={status!r}")
    return wav


@contextlib.contextmanager
def pipeline_walls(module, names):
    """Within: each ``module.<name>`` (a pipeline function a handler calls)
    records its wall seconds in the returned dict's list under ``name``."""
    walls = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                walls[name].append(time.perf_counter() - t)
        return call

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    try:
        yield walls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def phase_gradio_delay(backend, wav_path: str) -> tuple:
    """14a: the four Delay demos' click handlers (``serve/gradio_apps.py``'s
    factories; no gradio needed) on phase 4's backend, int8 weights by then,
    each called with values shaped like the UI's, once to capture its
    graphs, then in the order handler, pipeline, pipeline, handler (the
    same call made straight to its pipeline function, same seed): every
    output a finite float32 wave at 24 kHz, the five waves of a case within
    1e-4; each timed call's wall, and the handler's own seconds outside its
    pipeline call. Returns (launch counts, rows)."""
    ga = gradio_apps
    sr = backend.sample_rate
    tts, ttsd = ga.tts_handler(backend), ga.ttsd_handler(backend)
    voice, sfx = ga.voice_handler(backend), ga.sfx_handler(backend)
    n = float(GRADIO_NEW)
    direct = "Hello from the Gradio handler on a GPU."
    clone = "The cloned voice reads this line through the demo's handler."
    dialogue = "[S1]Hello there, how are you today? [S2]Fine, thanks, and you?"
    prompts = ("[S1]This is the first voice.", "[S2]And this is the second one.")
    hot = dict(temperature=1.7, top_p=0.8, top_k=25, repetition_penalty=1.0)
    cases = [  # label, handler, UI values, pipeline name, its arguments
        ("tts Direct, duration on", tts,
         (direct, "Direct", None, True, 60.0, 1.7, 0.8, 25.0, 1.0, n),
         "synthesize", (backend, direct),
         dict(mode="Direct", reference_audio=None, duration_tokens=60,
              max_new_tokens=GRADIO_NEW, **hot)),
        ("tts Clone", tts,
         (clone, "Clone", wav_path, False, 100.0, 1.7, 0.8, 25.0, 1.0, n),
         "synthesize", (backend, clone),
         dict(mode="Clone", reference_audio=wav_path, duration_tokens=None,
              max_new_tokens=GRADIO_NEW, **hot)),
        ("ttsd two cloned speakers", ttsd,
         (dialogue, 2.0, True, False, 1.1, 0.9, 50.0, 1.1, n,
          wav_path, wav_path, None, None, None, *prompts, "", "", ""),
         "synthesize_dialogue", (backend, dialogue),
         dict(speakers={1: (wav_path, prompts[0]), 2: (wav_path, prompts[1])}, speaker_count=2,
              do_text_normalize=True, sample_rate_normalize=False, max_new_tokens=GRADIO_NEW,
              temperature=1.1, top_p=0.9, top_k=50, repetition_penalty=1.1)),
        ("voice", voice,
         ("A voice designed from its description.", "a warm, low voice", 1.5, 0.6, 50.0,
          1.1, n),
         "generate_voice", (backend, "A voice designed from its description.",
                            "a warm, low voice"),
         dict(max_new_tokens=GRADIO_NEW, temperature=1.5, top_p=0.6, top_k=50,
              repetition_penalty=1.1)),
        ("sfx 2 s", sfx, ("rain on a tin roof", 2.0, 1.5, 0.6, 50.0, 1.2),
         "generate_sound_effect", (backend, "rain on a tin roof", 2.0),
         dict(temperature=1.5, top_p=0.6, top_k=50, repetition_penalty=1.2)),
    ]
    rows = []
    names = sorted({c[3] for c in cases})
    reset_counts()
    with pipeline_walls(ga, names) as inner:
        for label, handler, values, name, args, kw in cases:
            waves = [check_ui_wave(f"14a {label} (first call)", handler(*values), sr)]
            walls, own = [], []
            for turn in "ABBA":
                if turn == "A":
                    out, wall = timed_call(handler, *values)
                    own.append(wall - inner[name][-1])
                else:
                    got, wall = timed_call(getattr(pipelines, name), *args, **kw)
                    out = (got[0], got[1]), got[2]
                waves.append(check_ui_wave(f"14a {label} ({turn})", out, sr))
                walls.append(wall)
            diff = max(float(np.abs(w - waves[0]).max()) if w.shape == waves[0].shape
                       else float("inf") for w in waves)
            if diff > 1e-4:
                raise AssertionError(f"14a {label}: handler and pipeline waves differ "
                                     f"(max |d| {diff}, shapes {[w.shape for w in waves]})")
            row = dict(case=label, wave_s=waves[0].size / sr, walls_abba_s=walls,
                       handler_own_ms=[1e3 * x for x in own], max_abs_diff=diff)
            rows.append(row)
            log(f"  14a {label}: {row['wave_s']:.2f} s of wave; wall handler / pipeline / "
                f"pipeline / handler {' / '.join(f'{w:.4f}' for w in walls)} s; the handler's own "
                f"time outside {name} {' / '.join(f'{x:.4f}' for x in row['handler_own_ms'])} ms; "
                f"the five waves {'equal' if diff == 0 else f'within {diff:.2e}'}")
    counts = read_counts()
    g = counts["graphs"]
    if not (counts["flash"] and counts["decode"] and counts["w8a16"] and g["flash"]
            and g["decode"] and g["w8a16"]):
        raise AssertionError(f"14a: the demos' calls did not run flash, decode and W8A16 "
                             f"(decode and W8A16 inside replayed graphs): {counts}")
    log(f"  14a launches (5 x 5 calls): flash {counts['flash']} ({g['flash']} in prefill graphs), "
        f"decode {counts['decode']} ({g['decode']} in graphs), W8A16 {counts['w8a16']} "
        f"({g['w8a16']} in graphs)")
    return counts, rows


class BoundedTurn:
    """``engine``, whose drain (``finish``) ends once the turn holds
    ``frames`` frames, as an EOS would: the demo drains until EOS, which
    random weights need not emit."""

    def __init__(self, engine, frames: int):
        self._engine, self._frames = engine, frames

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def finish(self, max_steps=None, **kw):
        left = self._frames - len(self._engine.generated_tokens)
        if left <= 0:
            return []
        return self._engine.finish(max_steps=min(max_steps or left, left), **kw)


def gradio_realtime(engine, proc, codec) -> tuple:
    """14b: the Realtime demo's handler (``gradio_apps.realtime_handler``)
    on phase 10's int8 engine and the ``codec_1p6b()`` codec, with the
    demo's defaults (chunk 12, no prebuffer, no backpressure), the turn
    ended at ``GRADIO_RT_FRAMES`` frames (``BoundedTurn``): more than one
    chunk, each a finite wave, and a last status ``done | <metrics json>``
    with its TTFA. Returns (launch counts, numbers)."""
    run = gradio_apps.realtime_handler(BoundedTurn(engine, GRADIO_RT_FRAMES), proc, codec,
                                       AudioTokenCache(max_entries=32))
    values = ("The Gradio demo streams this reply as the words arrive, one chunk at a time.",
              None, 0.8, 0.6, 30.0, 1.1, 12.0, 0.0, 0.0)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    first, outs = None, []
    for out in run(*values):
        first = first or time.perf_counter() - t
        outs.append(out)
    wall = time.perf_counter() - t
    counts = read_counts()
    *chunks, (last, status) = outs
    if len(chunks) < 2 or last is not None:
        raise AssertionError(f"14b: {len(chunks)} chunks, last yield {last!r}")
    for i, out in enumerate(chunks):
        check_ui_wave(f"14b chunk {i}", out, codec.sampling_rate)
    if not status.startswith("done | "):
        raise AssertionError(f"14b: last status {status!r}")
    report = json.loads(status[len("done | "):])
    if report.get("ttfa_s") is None:
        raise AssertionError(f"14b: no TTFA in {report}")
    g = counts["graphs"]
    if not (counts["flash"] and g["decode"] and g["w8a16"]):
        raise AssertionError(f"14b: the demo's frames did not run the kernels: {counts}")
    samples = sum(out[0][1].size for out in chunks)
    r = dict(chunks=len(chunks), frames=len(engine.generated_tokens), first_chunk_ms=first * 1e3,
             wall_s=wall, wave_s=samples / codec.sampling_rate, report=report)
    log(f"  14b realtime demo: {r['frames']} frames -> {r['chunks']} chunks, {r['wave_s']:.2f} s "
        f"of wave, first chunk after {r['first_chunk_ms']:.1f} ms, {wall:.2f} s in all; "
        f"status {status[:120]}")
    log(f"  14b launches: flash {counts['flash']}, decode {counts['decode']} ({g['decode']} in "
        f"graphs), W8A16 {counts['w8a16']} ({g['w8a16']} in graphs)")
    return counts, r


def kernel_label(name: str) -> str:
    """A ptxas entry's name, ``ring_kernel``'s instantiations spelled out:
    ring_kernel<mode, MT, BN, WM, WN, WK, STAGES, NP, MINB, vec>."""
    if "ring_kernel" not in name:
        return name[:160]
    ints, vec = re.findall(r"Li(\d+)E", name), re.findall(r"Lb(\d)E", name)
    mode = ("W8A16", "W8A8", "INT4", "F32X3")[int(ints[0])]
    return f"ring_kernel<{mode}, {', '.join(ints[1:])}, vec={''.join(vec)}>"


def main() -> None:
    log("phase 1: device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script runs on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products, as the JAX package
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"  {kind}; nvidia-smi: {card_line()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; TF32 off")

    log("phase 2: build")
    t0 = time.perf_counter()
    lib = _build.build()
    flash._entry()
    for entry in ("mosstts_decode_attention", "mosstts_decode_attention_q8",
                  "mosstts_paged_decode_attention", "mosstts_paged_decode_attention_q8"):
        decode_attn._entry(entry)
    decode_attn._entry("mosstts_decode_attention_q8t", 1)
    w8_gemm._entry("mosstts_w8a16_gemm")
    w8_gemm._entry("mosstts_int4_gemm")
    w8_gemm._entry("mosstts_w8a8_gemm", 2)
    w8_gemm._entry("mosstts_w8f32_gemm", 2)
    log(f"  {lib.relative_to(Path(__file__).resolve().parent)} in "
        f"{time.perf_counter() - t0:.2f} s")
    # ptxas -v of the redesigned kernels' instantiations (static shared
    # memory only: flash, decode and W8A16 set their rings' dynamic size at
    # launch)
    for r in _build.ptxas_report():
        if any(k in r["name"] for k in ("flash_tc_kernel", "decode_kernel", "ring_kernel",
                                         "quant_rows_kernel", "split3_kernel")):
            log(f"  ptxas: {kernel_label(r['name'])}: {r.get('registers')} registers, "
                f"{r.get('smem')} B "
                f"static smem, {r.get('stack')} B stack, spill stores {r.get('spill_stores')} B, "
                f"loads {r.get('spill_loads')} B")

    log("phase 3: kernels vs plain (bf16, main-path shapes) and a small f32 reference")
    numbers = phase_kernels()
    numbers.update(phase_kernels_server())
    # decode's line keeps its B=4 times (PR 1's shape) and the worse error of
    # all shapes; the server's B=16 attend-256 numbers go in as decode_b16
    b16 = numbers.pop("decode_b16")
    numbers["decode"]["max_abs_err"] = max(numbers["decode"]["max_abs_err"], b16["max_abs_err"])
    numbers["decode"]["shapes"] += b16.pop("shapes")
    numbers["decode"]["decode_b16"] = {k: b16[k] for k in ("ms", "plain_ms", "library_ms",
                                                            "bound_ms", "bound_by")}
    # decode_attention_q8t's line: the bf16-scale times, the worse error of both scale types
    numbers["decode_q8t"] = numbers.pop("decode_q8t_bf16")
    numbers["decode_q8t"]["max_abs_err"] = max(numbers["decode_q8t"]["max_abs_err"],
                                               numbers.pop("decode_q8t_f32")["max_abs_err"])
    numbers.update(phase_kernels_gemm())
    log("phase 3c: the device loops' kernels: JAX's threefry and the loop control, vs plain")
    numbers.update(phase_kernels_sampling())
    phase_small_reference()
    phase_small_int8()
    log("phase 3b: small f32 continuous-batching server, card vs CPU and paged vs linear")
    phase_small_server()

    log("phase 4: solo path at MOSS-TTS 8B width")
    solo_counts, backend, od_counts = phase_main_path()
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 5: continuous batching at MOSS-TTS 8B width")
    server_counts = phase_server(backend.engine.params)
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 7a: CUDA-graph decode steps against eager steps, bf16 weights, 8B width")
    reset_counts()
    solo_graphs_vs_eager(backend.engine, backend.processor, "bf16")
    prefill_graphs_vs_eager(backend.engine, backend.processor, "bf16")
    times = step_times(backend.engine, "bf16")
    log(f"  launches inside replayed graphs: {read_counts()['graphs']}")

    log("phase 6: int8 weights at MOSS-TTS 8B width")
    int8_counts, int8_server_counts = phase_int8(backend)

    log("phase 7b: CUDA-graph decode steps against eager steps, int8 weights, 8B width")
    reset_counts()
    solo_graphs_vs_eager(backend.engine, backend.processor, "int8")
    server_graphs_vs_eager(backend.engine.params, "int8 weights,")
    times += step_times(backend.engine, "int8")
    log(f"  launches inside replayed graphs: {read_counts()['graphs']}")
    log("  step times: " + json.dumps(times))
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 8: voice cloning and the serving front end at MOSS-TTS 8B width (int8 weights)")
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = str(Path(tmp) / "reference.wav")
        write_wav(wav_path, sweep_wav(4.0, seed=8), 24000)
        log("phase 8a: codec encode at codec_1p6b width")
        encode_numbers = phase_codec_encode(backend.processor.audio_tokenizer,
                                            read_wav(wav_path)[0][0])
        log("phase 8b: HTTP front end, 16-slot pool, 7 concurrent requests")
        front_counts, pool, clones = phase_front_end(backend, wav_path)
    log("phase 8c: the Clone prompts, greedy, pool against the solo engine at 8B width")
    try:
        pool_vs_solo(pool, backend.engine, clones, "8B int8", exact=False)
    finally:
        pool.close()
        del pool
        gc.collect()
        torch.cuda.empty_cache()
    log("phase 8d: the same prompts, pool against the solo engine, small f32 model")
    phase_small_front_end(clones)
    log("  phase 8 numbers: " + json.dumps(encode_numbers))

    log("phase 9: prefill graphs, run_events and run_drain at MOSS-TTS 8B width (int8 weights)")
    log("phase 9a: prefill graphs against eager prefills")
    prefill_graphs_vs_eager(backend.engine, backend.processor, "int8")
    admission_graphs_vs_eager(backend.engine.params)
    log("phase 9b: run_events and run_drain against run, 16 slots, phase 5's 24 requests")
    loop_counts = loops_vs_run(backend.engine.params)
    log("phase 9c: the same loops on the small f32 model, card against card and CPU")
    phase_small_loops()
    log("phase 14a: the four Delay Gradio demos' handlers at MOSS-TTS 8B width (int8 weights)")
    with tempfile.TemporaryDirectory() as tmp:
        wav_path = str(Path(tmp) / "reference.wav")
        write_wav(wav_path, sweep_wav(4.0, seed=8), 24000)
        with codec_chunks("14a, the Delay demos", backend.processor.audio_tokenizer,
                          eager_ok=True):  # TTSD's two speakers encode at batch 2, eagerly
            gradio_counts, gradio_rows = phase_gradio_delay(backend, wav_path)
    log("  phase 14a numbers: " + json.dumps(gradio_rows))
    del backend
    gc.collect()
    torch.cuda.empty_cache()

    rt_counts, rt_knum, _ = phase_realtime()
    local_counts, local_knum, _ = phase_local()
    phase_training()
    p13 = phase_parallel()
    for knum in (rt_knum, local_knum):
        for kernel in ("flash", "decode", "w8a16"):
            numbers[kernel]["max_abs_err"] = max(numbers[kernel]["max_abs_err"],
                                                 knum[kernel]["max_abs_err"])
            numbers[kernel]["shapes"] += knum[kernel]["shapes"]

    runs = [solo_counts, od_counts, int8_counts, *server_counts.values(), *int8_server_counts.values(),
            front_counts, *loop_counts, gradio_counts, *rt_counts, *local_counts]
    launches = {name: sum(c[name] for c in runs) for name in COUNTERS}
    if not all(launches[name] for name in COUNTERS if name not in OFF_PATH + PHASE13):
        raise AssertionError(f"a kernel was never launched on the main paths: {launches}")
    in_graphs = {name: sum(c["graphs"][name] for c in runs) for name in COUNTERS}
    if not all(in_graphs[name] for name in IN_GRAPHS):
        raise AssertionError(f"the main paths' prefills and decode steps did not run their "
                             f"kernels inside replayed CUDA graphs: {in_graphs}")
    log(f"main paths (phases 4-6, 8, 9b, 10, 11, 14): launches {launches}; of them inside "
        f"replayed CUDA graphs {in_graphs}")
    launches.update(decode_q8t=numbers.pop("q8t_launches"), w8a8=numbers["w8a8"].pop("launches"),
                    int4=numbers["int4"].pop("launches"), w8f32=p13["w8f32_launches"],
                    lazy_cond=p13["lazy_cond_launches"])
    if not all(launches[name] for name in OFF_PATH):
        raise AssertionError(f"an off-path kernel was never launched on its path: {launches}")
    kernels = [
        dict(name="flash_attention", route="cuda", source="mosstts_tpu_torch/csrc/flash_attn.cu",
             replaces="mosstts_tpu/ops/pallas/flash.py:83", launches=launches["flash"],
             **numbers["flash"]),
        dict(name="decode_attention", route="cuda",
             source="mosstts_tpu_torch/csrc/decode_attn.cu",
             replaces="mosstts_tpu/ops/pallas/decode_attn.py:189", launches=launches["decode"],
             **numbers["decode"]),
        dict(name="decode_attention_q8", route="cuda",
             source="mosstts_tpu_torch/csrc/decode_attn.cu",
             replaces="mosstts_tpu/ops/pallas/decode_attn.py:250",
             launches=launches["decode_q8"], **numbers["decode_q8"]),
        dict(name="paged_decode_attention", route="cuda",
             source="mosstts_tpu_torch/csrc/paged_attn.cu",
             replaces="mosstts_tpu/ops/pallas/paged_attn.py:180", launches=launches["paged"],
             **numbers["paged"]),
        dict(name="paged_decode_attention_q8", route="cuda",
             source="mosstts_tpu_torch/csrc/paged_attn.cu",
             replaces="mosstts_tpu/ops/pallas/paged_attn.py:243",
             launches=launches["paged_q8"], **numbers["paged_q8"]),
        dict(name="decode_attention_q8t", route="cuda",
             source="mosstts_tpu_torch/csrc/decode_attn.cu",
             replaces="mosstts_tpu/ops/pallas/decode_attn.py:414",
             launches=launches["decode_q8t"], **numbers["decode_q8t"]),
        # in_codec_graphs: 13d's launches inside the int8 codec's chunk graphs
        dict(name="w8a16_gemm", route="cuda", source="mosstts_tpu_torch/csrc/w8_gemm.cu",
             replaces="tools/tune_mm8.py:165", launches=launches["w8a16"],
             in_codec_graphs=p13["codec"]["w8a16_in_graphs"], **numbers["w8a16"]),
        dict(name="w8a8_gemm", route="cuda", source="mosstts_tpu_torch/csrc/w8_gemm.cu",
             replaces="tools/tune_mm8.py:85", launches=launches["w8a8"], **numbers["w8a8"]),
        dict(name="int4_gemm", route="cuda", source="mosstts_tpu_torch/csrc/w8_gemm.cu",
             replaces="tools/probe_int4.py:102", launches=launches["int4"], **numbers["int4"]),
        # W8A16's float32-activation mode (the int8 codec's encoder, 13d)
        dict(name="w8a16_gemm_f32_activations", route="cuda",
             source="mosstts_tpu_torch/csrc/w8_gemm.cu", replaces="tools/tune_mm8.py:165",
             launches=launches["w8f32"], in_codec_graphs=p13["codec"]["w8f32_in_graphs"],
             **{k: v for k, v in p13["w8f32"].items() if k != "yardstick_ms"}),
    ]
    # the kernels the device loops and splices add; none replaces a Pallas
    # kernel: each names the JAX code it stands for (the key split and draw
    # inside JAX's step, the while_loop's condition, the drain program's
    # admission and collect, the admissions' splices (the row copy, measured
    # as the Realtime scatter with dropped rows; its 8B cache-lane copy under
    # lane_8b), the Realtime event loop's fed column, text_lazy's lax.cond)
    for name, key, source, jax_at in (
            ("threefry_split", "threefry_split", "threefry.cu", "mosstts_tpu/ops/sampling.py:40"),
            ("categorical_gumbel_max", "categorical", "threefry.cu",
             "mosstts_tpu/ops/sampling.py:49"),
            ("loop_condition", "loop_cond", "graph_loop.cu", "mosstts_tpu/models/delay.py:688"),
            ("drain_admission", "drain_admit", "graph_loop.cu",
             "mosstts_tpu/engine/batch_server.py:641"),
            ("drain_collect", "drain_collect", "graph_loop.cu",
             "mosstts_tpu/engine/batch_server.py:680"),
            ("row_copy", "row_copy", "graph_loop.cu",
             "mosstts_tpu/engine/realtime_batch_server.py:67"),
            ("fed_column", "feed", "graph_loop.cu",
             "mosstts_tpu/engine/realtime_batch_server.py:224"),
            ("text_lazy_condition", "lazy_cond", "graph_loop.cu",
             "mosstts_tpu/models/delay.py:450")):
        kernels.append(dict(name=name, route="cuda", source=f"mosstts_tpu_torch/csrc/{source}",
                            replaces=jax_at, launches=launches[key], **numbers[key]))
    phase_wall()
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
