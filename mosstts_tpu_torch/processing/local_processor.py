"""Processor for the MossTTSLocal (time-synchronous depth-transformer)
family: the port's own copy of ``mosstts_tpu/processing/local_processor.py``,
over the port's ``DelayProcessor``.

Deltas vs the Delay processor mirror the reference's 5-hunk divergence
(diff of moss_tts_local/processing_moss_tts.py vs moss_tts_delay/):
  * no delay pattern — prompt audio codes align 1:1 with text slots;
  * placeholder expands to gen_slot * T only (no delay-slot tail);
  * generation mode appends a trailing <audio_start> row so decoding starts
    inside an audio block;
  * continuation/truncation is unsupported;
  * decode does not de-delay.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .delay_processor import AUDIO_PLACEHOLDER, DelayProcessor


class LocalProcessor(DelayProcessor):
    def _expand_placeholders(self, content, lengths, n_vq, gen_slot, delay_slot):
        if content.count(AUDIO_PLACEHOLDER) != len(lengths):
            raise ValueError("Audio placeholders do not match the audio codes list.")
        it = iter(lengths)

        def block(length: int) -> str:
            if length == 0:
                return f"{self.audio_start_token}{self.audio_end_token}"
            return f"{self.audio_start_token}" + gen_slot * length + f"{self.audio_end_token}"

        import re

        return re.sub(re.escape(AUDIO_PLACEHOLDER), lambda m: block(next(it)), content)

    def _unified_codes(self, role, content, codes_list, truncation):
        c = self.config
        if role == "user":
            gen_slot = delay_slot = self.audio_user_slot_token
        else:
            gen_slot = self.audio_gen_slot_token
            delay_slot = self.audio_delay_slot_token
        if len(codes_list) > 1:
            raise ValueError("Local variant supports at most one audio per message.")

        n_vq = codes_list[0].shape[1] if codes_list else c.n_vq
        content = self._expand_placeholders(
            content, [len(x) for x in codes_list], n_vq, gen_slot, delay_slot
        )
        text_codes = np.asarray(self.tokenizer.encode(content), dtype=np.int64)
        starts = np.where(text_codes == c.audio_start_token_id)[0]
        ends = np.where(text_codes == c.audio_end_token_id)[0]
        if len(starts) != len(codes_list) or len(ends) != len(codes_list):
            raise ValueError("Audio placeholders do not match the audio codes list.")

        if not codes_list:
            audio = np.full((len(text_codes), n_vq), c.audio_pad_code, dtype=np.int64)
        else:
            pieces = []
            prefix = 0
            for s_idx, e_idx, codes in zip(starts, ends, codes_list):
                pad = np.full((s_idx - prefix + 1, n_vq), c.audio_pad_code, np.int64)
                pieces.extend([pad, codes.astype(np.int64)])  # time-synchronous
                prefix = e_idx
            pieces.append(
                np.full((len(text_codes) - ends[-1], n_vq), c.audio_pad_code, np.int64)
            )
            audio = np.concatenate(pieces, axis=0)

        if len(text_codes) != len(audio):
            text_codes = text_codes[: len(audio)]
        return np.concatenate([text_codes[:, None], audio], axis=1)

    def __call__(self, conversations, mode: str = "generation", n_vq=None,
                 apply_chat_template: bool = True):
        if mode == "continuation":
            raise RuntimeError("Truncation generation is not supported at present")
        out = DelayProcessor.__call__(self, conversations, mode, n_vq, apply_chat_template)
        # generation mode: append one <audio_start> row per sample so the
        # model begins emitting codebook blocks immediately
        if mode == "generation":
            c = self.config
            ids, mask = out["input_ids"], out["attention_mask"]
            B, T, C = ids.shape
            row = np.full((B, 1, C), c.audio_pad_code, dtype=ids.dtype)
            row[..., 0] = c.audio_start_token_id
            ids = np.concatenate([ids, row], axis=1)
            mask = np.concatenate([mask, np.ones((B, 1), bool)], axis=1)
            out = {"input_ids": ids, "attention_mask": mask}
        return out

    def _parse_audio(self, start_length: int, audio_codes: np.ndarray) -> List[np.ndarray]:
        c = self.config
        non_pad = ~(audio_codes == c.audio_pad_code).all(axis=1)
        if not non_pad.any():
            return []
        idx = np.nonzero(non_pad)[0]
        breaks = np.where(idx[1:] != idx[:-1] + 1)[0] + 1
        segments = np.split(idx, breaks) if len(breaks) else [idx]
        codes_list = [audio_codes[s] for s in segments]
        wavs = self.decode_audio_codes(codes_list)
        if start_length > 0 and codes_list and wavs:
            first_len = codes_list[0].shape[0]
            if first_len > 0:
                ratio = max(0.0, min(float(start_length) / float(first_len), 1.0))
                if ratio >= 1.0:
                    wavs = wavs[1:]
                elif ratio > 0.0:
                    trim = int(wavs[0].shape[-1] * ratio)
                    wavs[0] = wavs[0][..., trim:]
        return wavs
