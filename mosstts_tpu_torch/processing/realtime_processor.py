"""Prompt-grid builder for MossTTSRealtime: (T, 1+rvq) numpy grids with text
leading audio by ``delay_tokens_len`` positions.

Ports ``mosstts_tpu/processing/realtime_processor.py`` (numpy only; the port keeps
its own copy). Contract parity: reference
moss_tts_realtime/mossttsrealtime/processing_mossttsrealtime.py:25-175.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .tokenizer import TokenizerLike

DEFAULT_TTS_SYSTEM_PROMPT = (
    "<|im_start|>system\n"
    "You are a highly expressive text-to-speech (TTS) engine developed by Mosi Intelligence. \n"
    "You possess natural language understanding, emotional modeling, and multi-style speech generation "
    "capabilities, allowing you to generate the corresponding speech based on the text given in the assistant."
    "<|im_end|>\n"
)


class RealtimeProcessor:
    def __init__(
        self,
        tokenizer: TokenizerLike,
        audio_pad_token: str = "<|audio_pad|>",
        text_pad_token: str = "<|text_pad|>",
        tts_system_prompt: Optional[str] = None,
        channels: int = 16,
        audio_channel_pad: int = 1024,
        audio_bos_token: int = 1025,
        audio_eos_token: int = 1026,
        delay_tokens_len: int = 12,
    ):
        self.tokenizer = tokenizer
        self.audio_pad_token = audio_pad_token
        self.text_pad_token = text_pad_token
        self.channels = channels
        self.audio_channel_pad = audio_channel_pad
        self.audio_bos_token = audio_bos_token
        self.audio_eos_token = audio_eos_token
        self.delay_tokens_len = delay_tokens_len
        self.audio_pad_token_id = tokenizer.convert_tokens_to_ids(audio_pad_token)
        self.text_pad_token_id = tokenizer.convert_tokens_to_ids(text_pad_token)
        self.tts_system_prompt = tts_system_prompt or DEFAULT_TTS_SYSTEM_PROMPT

    def make_voice_clone_prompt(self, prompt_audio_tokens_len: int) -> str:
        return (
            "<|im_start|>context\n"
            "The assistant section should be synthesized using the following voice timbre:"
            f"{self.audio_pad_token * prompt_audio_tokens_len}"
        )

    def _normalize_audio_tokens(self, audio_tokens) -> np.ndarray:
        tokens = np.array(audio_tokens)
        if tokens.ndim != 2:
            raise ValueError(f"Expected 2D audio tokens, got shape {tokens.shape}")
        ch = self.channels
        if tokens.shape[0] == ch:
            tokens = tokens.T
        elif tokens.shape[1] == ch:
            pass
        elif tokens.shape[0] > ch and tokens.shape[1] != ch:
            tokens = tokens[:ch, :].T
        elif tokens.shape[1] > ch and tokens.shape[0] != ch:
            tokens = tokens[:, :ch]
        if tokens.shape[1] != ch:
            raise ValueError(f"Expected {ch} channels, got shape {tokens.shape}")
        return tokens

    def make_ensemble(self, prompt_audio_tokens: Optional[np.ndarray] = None) -> np.ndarray:
        """System prompt grid; with a voice prompt, its RVQ tokens ride the
        audio channels under the <|audio_pad|> run (reference :106-128)."""
        if prompt_audio_tokens is not None:
            prompt_audio_tokens = self._normalize_audio_tokens(prompt_audio_tokens)
            text = self.tts_system_prompt + self.make_voice_clone_prompt(
                prompt_audio_tokens.shape[0]
            )
        else:
            text = self.tts_system_prompt
        ids = self.tokenizer.encode(text)
        grid = np.full((len(ids), self.channels + 1), self.audio_channel_pad, np.int64)
        grid[:, 0] = ids
        if prompt_audio_tokens is not None:
            idx = np.where(np.asarray(ids) == self.audio_pad_token_id)[0]
            if idx.size == 0:
                raise ValueError("No <|audio_pad|> tokens found in the system prompt.")
            grid[idx[0] : idx[-1] + 1, 1:] = prompt_audio_tokens
        return grid

    def make_user_prompt(self, text: str, audio_tokens: np.ndarray) -> np.ndarray:
        """User turn grid: text channel leads the user audio by
        ``delay_tokens_len`` rows; audio_bos precedes the audio run on
        channel 1 and audio_eos follows it (reference :130-175)."""
        prefill_temp = "<|im_end|>\n<|im_start|>user\n"
        text_tokens = self.tokenizer.encode(text)
        text_start = len(self.tokenizer.encode(prefill_temp))
        token = self._normalize_audio_tokens(audio_tokens)
        text_len, audio_len = len(text_tokens), token.shape[0]
        ch = self.channels

        if text_len >= self.delay_tokens_len:
            padded_text_len = audio_len + self.delay_tokens_len - text_len + 1
            full_text = prefill_temp + text + self.text_pad_token * padded_text_len
            ids = self.tokenizer.encode(full_text)
            grid = np.full((len(ids), ch + 1), self.audio_channel_pad, np.int64)
            grid[:, 0] = ids
            a0 = text_start + self.delay_tokens_len
            grid[a0 : a0 + audio_len, 1:] = token
            grid[a0 - 1, 1] = self.audio_bos_token
            grid[a0 + audio_len, 1] = self.audio_eos_token
        else:
            padded_text_len = audio_len + 1
            full_text = prefill_temp + text + self.text_pad_token * padded_text_len
            ids = self.tokenizer.encode(full_text)
            grid = np.full((len(ids), ch + 1), self.audio_channel_pad, np.int64)
            grid[:, 0] = ids
            grid[-(audio_len + 1) : -1, 1:] = token
            grid[-(audio_len + 2), 1] = self.audio_bos_token
            grid[-1, 1] = self.audio_eos_token

        bor = self.tokenizer.encode("<|im_end|>\n<|im_start|>assistant\n")
        bor_grid = np.full((len(bor), ch + 1), self.audio_channel_pad, np.int64)
        bor_grid[:, 0] = bor
        return np.concatenate([grid, bor_grid], axis=0)
