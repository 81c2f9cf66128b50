"""Host-facing generation engine for the Delay model family (MOSS-TTS 8B,
MOSS-TTSD, MOSS-VoiceGenerator, MOSS-SoundEffect).

Ports ``mosstts_tpu/engine/delay_engine.py``: ``attend_bucket``,
``DelayEngine`` with ``random_init``, ``quantize``, ``generate`` and
``hidden_out_layers``. The engine keeps one static decode state, with its
decode steps (``engine/step_graph.DecodeSteps``) and prefills
(``step_graph.Prefills``), for its last ``(batch, cache_len, kv_quant)``
only: a call at another key frees it, graphs included, before it makes its
own, so the engine holds at most one KV cache. Each call prefills into that
state in place. On the card the prefill is the replay of a CUDA graph of
``delay_prefill`` per ``(T, top_k_text, top_k_audio, hidden_out_layers)``,
captured at the key's second use (the first runs eagerly; the JAX engine's
``_get_prefill``), so it pays only where a caller repeats a prompt length;
the graphs of the ``PREFILL_GRAPHS`` most recent keys are kept. Every
decode step is the replay of a CUDA graph of the step, one per attend
bucket (its ``_get_step``). ``on_device=False`` polls the stop flags every
``poll_every`` steps; ``on_device=True`` runs JAX's segment loop over
``delay_generate_on_device``: on the card each segment is one launch of a
graph that loops on the card until its condition fails
(``step_graph.DeviceLoop``; JAX: one ``lax.while_loop`` program per
segment), then one read of the flags. ``graphs=False`` runs the same
prefills and steps eagerly on the card, to compare; the CPU always runs
them eagerly. The rows draw from JAX's keys: ``split(PRNGKey(seed), B)``,
as JAX's prefill splits its key, so a seeded call draws JAX's bits.

``mesh=`` (``parallel.mesh.make_mesh``; every rank makes the same calls)
shards the params in place on ``"model"`` (``delay_param_specs``: each
rank's steps hold its heads and run their collectives inside the graphs)
and the batch on ``"data"``: ``generate`` needs ``B % data == 0``, each
data rank decodes its block of rows (their keys those rows of the whole
batch's), the stop flags are gathered over ``"data"`` at the end of every
step (inside its graph) so all ranks run the same steps, and every rank
returns every row. ``quantize()`` under a mesh gives each output channel of a
row-parallel weight the scale of the whole input dimension
(``ops.quant.quantize_tree_``), so int8 weights are those of one device.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import DelayConfig
from ..models.delay import (DelayParams, delay_generate_on_device, init_delay_params,
                            make_sampling, rank_delay_config)
from ..ops.quant import quantize_tree_
from ..ops.sampling import prng_key, split
from ..ops.collectives import gather
from .step_graph import DecodeSteps, Prefills, host_tensor, zero_state

# prefill graphs kept per decode state. The key holds the prompt's exact
# length, which callers need not repeat, so the set of keys has no bound of
# its own (a server's prompt buckets do); a graph holds its launches' nodes
# and its prompt buffers, so the engine keeps the most recent keys only
PREFILL_GRAPHS = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def attend_bucket(needed: int, base: int, cap: int) -> int:
    """Ports ``mosstts_tpu.engine.delay_engine.attend_bucket``: smallest
    base * 2^k >= needed, capped."""
    b = base
    while b < needed:
        b *= 2
    return min(b, cap)


class DelayEngine:
    """Ports ``mosstts_tpu.engine.delay_engine.DelayEngine`` (solo engine,
    linear KV cache in ``dtype``, or int8 with per-slot scales when
    ``kv_quant``). ``params`` is a ``DelayParams`` module on ``device``,
    float or, after ``quantize()``, with int8 matmul weights.
    ``hidden_out_layers`` (1 + n_vq indices into the backbone's hidden
    states) sources each head from its own layer. ``graphs`` (on the card):
    replay each prefill and decode step as a CUDA graph; False runs them
    eagerly, to compare. ``mesh``: tensor and data parallelism (see the
    module docstring)."""

    def __init__(self, params: DelayParams, config: DelayConfig, *, dtype=torch.bfloat16,
                 cache_bucket: int = 256, top_k_text: int = 50, top_k_audio: int = 25,
                 hidden_out_layers: Optional[tuple] = None, kv_quant: bool = False,
                 device=None, graphs: bool = True, mesh=None):
        self.mesh = mesh
        self._data = None  # the "data" axis of a mesh
        if mesh is not None:
            from ..parallel.mesh import delay_param_specs, mesh_axis, shard_params

            shard_params(params, mesh, delay_param_specs())
            self._data = mesh_axis(mesh, "data")
        self.params = params
        self.config = config
        self.dtype = dtype
        self.cache_bucket = cache_bucket
        self.top_k_text = top_k_text
        self.top_k_audio = top_k_audio
        self.hidden_out_layers = tuple(hidden_out_layers) if hidden_out_layers else None
        self.kv_quant = kv_quant
        self.device = torch.device(device) if device is not None else params.text_head.device
        self.graphs = graphs
        # (B, cache_len, kv_quant) -> the static decode state's steps and its
        # prefills, and their graphs, for the last key only
        self._steps: Dict[tuple, DecodeSteps] = {}
        self._prefills: Dict[tuple, Prefills] = {}
        # one call at a time: the calls share the static decode state (the
        # JAX engine's calls share nothing; concurrent HTTP handlers call one
        # engine)
        self._lock = threading.Lock()

    @classmethod
    def random_init(cls, seed: int = 0, config: Optional[DelayConfig] = None,
                    dtype=torch.bfloat16, device="cuda", **kw) -> "DelayEngine":
        """Random weights drawn directly on ``device`` from ``seed``."""
        config = config or DelayConfig()
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_delay_params(config, generator=gen, dtype=dtype, device=device)
        return cls(params, config, dtype=dtype, device=device, **kw)

    def quantize(self, mode: str = "int8", kv_cache: bool = False) -> "DelayEngine":
        """Ports ``mosstts_tpu.engine.delay_engine.DelayEngine.quantize``:
        weight-only int8 serving. Every matmul weight of ``params`` becomes a
        ``QuantWeight`` in place (``ops.quant.quantize_tree_``; the float
        tensors are freed, so the model never holds both); embeddings and
        norms keep their dtype. ``kv_cache=True`` also switches later
        prefills to the int8 KV cache. Every prefill and decode graph and
        static buffer is dropped, as JAX drops its compiled programs: the
        graphs read the float weights' addresses. Returns ``self``."""
        if mode != "int8":
            raise ValueError(f"unknown quantization mode: {mode}")
        with self._lock:
            self._steps.clear()
            self._prefills.clear()
            quantize_tree_(self.params)
            if kv_cache:
                self.kv_quant = True
        return self

    def _decode_steps(self, B: int, cache_len: int) -> Tuple[DecodeSteps, Prefills]:
        """The static decode state of batch ``B`` at ``cache_len`` (its
        ``out`` holds ``cache_len`` steps, more than any ``max_new_tokens``
        at that cache length), its decode steps and prefills, made at first
        use after the previous key's are freed."""
        key = (B, cache_len, self.kv_quant)
        steps = self._steps.get(key)
        if steps is None:
            self._steps.clear()  # the old cache, buffers and graphs go first
            self._prefills.clear()
            dev = self.device
            state = zero_state(rank_delay_config(self.config, self.params), B, cache_len,
                               cache_len, dtype=self.dtype, kv_quant=self.kv_quant, device=dev)
            steps = self._steps[key] = DecodeSteps(
                self.params, self.config, state, make_sampling(device=dev), graphs=self.graphs)
            if self._data is not None:  # every data rank's stop flags, after each step
                data, flags = self._data, torch.zeros((B * self._data.size,), dtype=torch.bool,
                                                      device=dev)

                def sync(st=state):
                    flags.copy_(gather(st.is_stopping.to(torch.uint8), 0, data))

                steps.flags, steps.sync = flags, sync
            self._prefills[key] = Prefills(steps, state, steps.sampling,
                                           max_graphs=PREFILL_GRAPHS)
        return steps, self._prefills[key]

    @torch.no_grad()
    def generate(
        self,
        input_ids: np.ndarray,  # (B, T, 1+n_vq) left-padded
        attention_mask: Optional[np.ndarray] = None,  # (B, T) bool
        *,
        max_new_tokens: int = 1000,
        text_temperature: float = 1.5,
        text_top_p: float = 1.0,
        text_top_k: int = 50,
        audio_temperature: float = 1.7,
        audio_top_p: float = 0.8,
        audio_top_k: int = 25,
        audio_repetition_penalty: float = 1.0,
        audio_rp_cross_batch: bool = False,
        seed: int = 0,
        on_device: bool = False,
        poll_every: int = 8,
    ) -> List[Tuple[int, np.ndarray]]:
        """Batched synthesis; returns per-sample (start_length, token grid)
        as the JAX engine does, so ``processor.decode`` consumes it. Calls
        from several threads run one after another."""
        with self._lock:
            cfg, dev = self.config, self.device
            input_ids = np.asarray(input_ids, np.int64)
            B, T, C = input_ids.shape
            if C != cfg.channels:
                raise ValueError(f"input_ids must have {cfg.channels} channels, got {C}")
            if attention_mask is None:
                attention_mask = np.ones((B, T), bool)
            first = 0  # this rank's first row
            if self._data is not None:
                n = self._data.size
                if B % n:
                    raise ValueError(f"batch {B} not divisible by mesh data axis {n}")
                first = self._data.index * (B // n)
                rows = slice(first, first + B // n)
                ids_rank, mask_rank = input_ids[rows], np.asarray(attention_mask)[rows]
            else:
                ids_rank, mask_rank = input_ids, attention_mask

            self.top_k_text = text_top_k
            self.top_k_audio = audio_top_k
            sampling = make_sampling(
                text_temperature=text_temperature, text_top_p=text_top_p,
                audio_temperature=audio_temperature, audio_top_p=audio_top_p,
                audio_repetition_penalty=audio_repetition_penalty,
                audio_rp_cross_batch=audio_rp_cross_batch, device=dev,
            )
            cache_len = _round_up(T + max_new_tokens + 1, self.cache_bucket)

            runner, prefills = self._decode_steps(ids_rank.shape[0], cache_len)
            state, samp = runner.state, runner.sampling
            for static, value in zip(samp, sampling):
                static.copy_(value)
            # JAX's prefill splits PRNGKey(seed) into the batch's rows
            keys = split(prng_key(seed)[None], B)[0][first:first + ids_rank.shape[0]]
            state.rng.copy_(host_tensor(keys.numpy(), dev), non_blocking=True)
            kw = dict(top_k_text=self.top_k_text, top_k_audio=self.top_k_audio,
                      hidden_out_layers=self.hidden_out_layers)
            prefills.run(host_tensor(ids_rank, dev), host_tensor(mask_rank, dev), **kw)
            if runner.sync is not None:
                runner.sync()
            kw["uniform_slots"] = True
            steps = 1
            if on_device:
                # JAX's segments (delay_engine.py:221-233): each attends one bucket
                while steps < max_new_tokens:
                    attend = attend_bucket(T + steps + 2, self.cache_bucket, cache_len)
                    seg_end = min(attend - T - 1, max_new_tokens)
                    _, did, flags = delay_generate_on_device(runner, max_new_tokens=seg_end,
                                                             attend_len=attend, **kw)
                    steps += did  # every row steps alike: step.max() advances by did
                    if bool(flags.all()):
                        break
            else:
                while steps < max_new_tokens:
                    attend = attend_bucket(T + steps + 1, self.cache_bucket, cache_len)
                    runner.step(attend_len=attend, **kw)
                    steps += 1
                    if steps % poll_every == 0 and bool(runner.flags.all()):
                        break

            out = gather(state.out[:, :steps].contiguous(), 0, self._data)  # every row
            out = out.cpu().numpy().astype(np.int64)  # (B, steps, C)
            full = np.concatenate([input_ids, out], axis=1)
            # slice from the last <|im_start|> + 3 (reference generate :518-524)
            results: List[Tuple[int, np.ndarray]] = []
            for b in range(B):
                matches = np.nonzero(input_ids[b, :, 0] == cfg.im_start_token_id)[0]
                start_idx = int(matches[-1]) + 3 if len(matches) else 0
                results.append((T - start_idx, full[b, start_idx:]))
            return results
