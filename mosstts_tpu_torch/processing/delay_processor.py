"""Conversation -> (B, T, 1+n_vq) token-grid processor for the Delay/Local
model families, plus the inverse ``decode``.

Feature parity with the reference ``MossTTSDelayProcessor``
(moss_tts_delay/processing_moss_tts.py:47-930): the <user_inst> template with
its 8 control fields, audio placeholder expansion into
``<audio_start> gen_slot*T delay_slot*(n_vq-1) <audio_end>`` blocks, delay
pattern embedding of prompt codes, consecutive-placeholder merging, left-pad
batching, continuation truncation, decode-side segmentation and waveform
prefix trimming. All arrays are numpy (host side); the codec is any object
implementing the contract of ``codec.model.MossAudioTokenizer``.

The port's own copy of ``mosstts_tpu/processing/delay_processor.py`` (which
imports no JAX): the port imports nothing of the JAX package.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.config import DelayConfig
from ..ops.delay import apply_delay_pattern, apply_de_delay_pattern
from ..utils import audio as audio_io
from .tokenizer import TokenizerLike, qwen_chat_wrap

AUDIO_PLACEHOLDER = "<|audio|>"

USER_INST_TEMPLATE = """<user_inst>
- Reference(s):
{reference}
- Instruction:
{instruction}
- Tokens:
{tokens}
- Quality:
{quality}
- Sound Event:
{sound_event}
- Ambient Sound:
{ambient_sound}
- Language:
{language}
- Text:
{text}
</user_inst>"""

USER_MESSAGE_FIELDS = (
    "text",
    "reference",
    "instruction",
    "tokens",
    "quality",
    "sound_event",
    "ambient_sound",
    "language",
)


@dataclass
class UserMessage:
    """Renders the <user_inst> prompt (reference processing_moss_tts.py:54-120)."""

    text: Optional[str] = None
    reference: Optional[List[Optional[Union[str, np.ndarray]]]] = None
    instruction: Optional[str] = None
    tokens: Optional[int] = None
    quality: Optional[str] = None
    sound_event: Optional[str] = None
    ambient_sound: Optional[str] = None
    language: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        audio_codes_list: List[Any] = []
        if self.reference is None:
            reference = "None"
        elif isinstance(self.reference, list):
            parts = []
            for i, ref in enumerate(self.reference):
                if ref is not None:
                    parts.append(f"[S{i+1}]:\n{AUDIO_PLACEHOLDER}")
            reference = "\n".join(parts)
            audio_codes_list = [r for r in self.reference if r is not None]
        else:
            raise TypeError("`reference` should be a list when not None.")

        content = (
            USER_INST_TEMPLATE.replace("{reference}", str(reference))
            .replace("{instruction}", str(self.instruction))
            .replace("{tokens}", str(self.tokens))
            .replace("{quality}", str(self.quality))
            .replace("{sound_event}", str(self.sound_event))
            .replace("{ambient_sound}", str(self.ambient_sound))
            .replace("{language}", str(self.language))
            .replace("{text}", str(self.text))
        )
        return {"role": "user", "content": content, "audio_codes_list": audio_codes_list}


@dataclass
class AssistantMessage:
    audio_codes_list: List[Any] = field(default_factory=list)
    content: str = AUDIO_PLACEHOLDER

    def to_dict(self) -> Dict[str, Any]:
        return {
            "role": "assistant",
            "content": self.content,
            "audio_codes_list": self.audio_codes_list,
        }


class DelayProcessor:
    def __init__(
        self,
        tokenizer: TokenizerLike,
        audio_tokenizer: Any = None,
        config: Optional[DelayConfig] = None,
    ):
        self.tokenizer = tokenizer
        self.audio_tokenizer = audio_tokenizer
        self.config = config or DelayConfig()
        c = self.config
        self.audio_start_token = tokenizer.convert_ids_to_tokens(c.audio_start_token_id)
        self.audio_end_token = tokenizer.convert_ids_to_tokens(c.audio_end_token_id)
        self.audio_user_slot_token = tokenizer.convert_ids_to_tokens(c.audio_user_slot_token_id)
        self.audio_gen_slot_token = tokenizer.convert_ids_to_tokens(
            c.audio_assistant_gen_slot_token_id
        )
        self.audio_delay_slot_token = tokenizer.convert_ids_to_tokens(
            c.audio_assistant_delay_slot_token_id
        )

    # -------------------------- message helpers ---------------------------
    @staticmethod
    def build_user_message(
        text=None, reference=None, instruction=None, tokens=None, quality=None,
        sound_event=None, ambient_sound=None, language=None,
    ) -> Dict:
        if reference is not None and not isinstance(reference, list):
            reference = [reference]
        return UserMessage(
            text=text, reference=reference, instruction=instruction, tokens=tokens,
            quality=quality, sound_event=sound_event, ambient_sound=ambient_sound,
            language=language,
        ).to_dict()

    @staticmethod
    def build_assistant_message(audio_codes_list, content: str = AUDIO_PLACEHOLDER) -> Dict:
        return AssistantMessage(audio_codes_list=audio_codes_list, content=content).to_dict()

    def _normalize_message(self, message) -> Dict:
        if isinstance(message, (UserMessage, AssistantMessage)):
            return message.to_dict()
        if not isinstance(message, dict):
            raise TypeError("Each message must be a UserMessage/AssistantMessage or dict.")
        if "role" not in message:
            raise ValueError("Message dict must include a 'role' field.")
        if "content" in message and "audio_codes_list" in message:
            return message
        role = message["role"]
        if role == "user":
            return self.build_user_message(
                **{k: message.get(k) for k in USER_MESSAGE_FIELDS}
            )
        if role == "assistant":
            return self.build_assistant_message(
                audio_codes_list=message.get("audio_codes_list", []),
                content=message.get("content", AUDIO_PLACEHOLDER),
            )
        raise ValueError(f"Unsupported role: {role}")

    # ------------------------------ __call__ ------------------------------
    def __call__(self, conversations, mode: str = "generation", n_vq: Optional[int] = None,
                 apply_chat_template: bool = True):
        if mode not in {"generation", "continuation"}:
            raise ValueError(f"Unknown mode: {mode}")
        if isinstance(conversations, (dict, UserMessage, AssistantMessage)):
            conversations = [conversations]

        truncation = mode == "continuation"
        grids: List[np.ndarray] = []
        for conversation in conversations:
            if isinstance(conversation, (dict, UserMessage, AssistantMessage)):
                conversation = [conversation]
            conversation = [self._normalize_message(m) for m in conversation]

            # generation ends on a user turn; continuation on an assistant turn
            if (mode == "generation") ^ (len(conversation) % 2 != 0):
                raise ValueError("Conversation length does not match mode.")
            if (mode == "generation") ^ (conversation[-1]["role"] == "user"):
                raise ValueError("Conversation's last role does not match mode.")

            parts = []
            for mi, message in enumerate(conversation):
                if apply_chat_template:
                    add_gen = mode == "generation" and mi == len(conversation) - 1
                    content = qwen_chat_wrap(message["role"], message["content"], add_gen)
                else:
                    content = message["content"]
                codes_list = self._encode_audio_items(
                    message.get("audio_codes_list", []), n_vq
                )
                parts.append(
                    self._unified_codes(message["role"], content, codes_list, truncation)
                )
            grids.append(np.concatenate(parts, axis=0))
        return self._pad(grids)

    def _encode_audio_items(self, items: Sequence, n_vq: Optional[int]) -> List[np.ndarray]:
        out: List[Optional[np.ndarray]] = [None] * len(items)
        paths, positions = [], []
        for i, item in enumerate(items):
            if isinstance(item, np.ndarray):
                if n_vq is not None and item.shape[1] != n_vq:
                    raise RuntimeError(
                        "audio_codes' n_vq does not match the `n_vq` parameter; "
                        "pass n_vq=None for pre-tokenized codes."
                    )
                out[i] = item
            elif isinstance(item, (str,)) or hasattr(item, "__fspath__"):
                paths.append(str(item))
                positions.append(i)
            else:
                raise TypeError("Audio item must be an (T, n_vq) ndarray or a path.")
        if paths:
            encoded = self.encode_audios_from_path(paths, n_vq)
            for pos, codes in zip(positions, encoded):
                out[pos] = codes
        return [c for c in out]  # type: ignore

    # ------------------------- placeholder handling ------------------------
    @staticmethod
    def _merge_consecutive_placeholders(
        content: str, codes_list: List[np.ndarray]
    ) -> Tuple[str, List[np.ndarray]]:
        """Adjacent (whitespace-separated) placeholders merge into one block
        with concatenated codes (reference :473-513)."""
        matches = list(re.finditer(re.escape(AUDIO_PLACEHOLDER), content))
        if len(matches) <= 1:
            return content, codes_list
        if len(matches) != len(codes_list):
            raise ValueError("Audio placeholders do not match the audio codes list.")
        new_codes, parts = [], []
        last = 0
        i = 0
        while i < len(matches):
            j = i
            while (
                j + 1 < len(matches)
                and content[matches[j].end() : matches[j + 1].start()].strip() == ""
            ):
                j += 1
            parts.append(content[last : matches[i].start()])
            parts.append(AUDIO_PLACEHOLDER)
            last = matches[j].end()
            new_codes.append(
                codes_list[i] if j == i else np.concatenate(codes_list[i : j + 1], axis=0)
            )
            i = j + 1
        parts.append(content[last:])
        return "".join(parts), new_codes

    def _expand_placeholders(
        self, content: str, lengths: List[int], n_vq: int,
        gen_slot: str, delay_slot: str,
    ) -> str:
        if content.count(AUDIO_PLACEHOLDER) != len(lengths):
            raise ValueError("Audio placeholders do not match the audio codes list.")
        it = iter(lengths)

        def block(length: int) -> str:
            if length == 0:
                return f"{self.audio_start_token}{self.audio_end_token}"
            return (
                f"{self.audio_start_token}"
                + gen_slot * length
                + delay_slot * (n_vq - 1)
                + f"{self.audio_end_token}"
            )

        return re.sub(re.escape(AUDIO_PLACEHOLDER), lambda m: block(next(it)), content)

    def _unified_codes(
        self, role: str, content: str, codes_list: List[np.ndarray], truncation: bool
    ) -> np.ndarray:
        c = self.config
        if role == "user":
            gen_slot = delay_slot = self.audio_user_slot_token
            truncation = False
        else:
            gen_slot = self.audio_gen_slot_token
            delay_slot = self.audio_delay_slot_token

        n_vq = codes_list[0].shape[1] if codes_list else c.n_vq
        if len(codes_list) > 1 and AUDIO_PLACEHOLDER in content:
            content, codes_list = self._merge_consecutive_placeholders(content, codes_list)
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
                delayed = apply_delay_pattern(codes.astype(np.int64), c.audio_pad_code)
                pad = np.full((s_idx - prefix + 1, n_vq), c.audio_pad_code, np.int64)
                pieces.extend([pad, delayed])
                prefix = e_idx
            if truncation:
                # continuation prefix: drop the delay-flush tail of the last
                # audio block (reference :619-622)
                pieces[-1] = pieces[-1][: -(n_vq - 1), :]
            else:
                pieces.append(
                    np.full((len(text_codes) - ends[-1], n_vq), c.audio_pad_code, np.int64)
                )
            audio = np.concatenate(pieces, axis=0)

        if len(text_codes) != len(audio):
            text_codes = text_codes[: len(audio)]
        return np.concatenate([text_codes[:, None], audio], axis=1)

    def _pad(self, grids: List[np.ndarray]) -> Dict[str, np.ndarray]:
        """Left-pad to a common length: audio channels with pad_code, text
        channel with pad_token (reference _pad :410-431)."""
        c = self.config
        max_len = max(g.shape[0] for g in grids)
        B = len(grids)
        C = grids[0].shape[1]
        ids = np.full((B, max_len, C), c.audio_pad_code, dtype=np.int64)
        ids[..., 0] = c.pad_token_id
        mask = np.zeros((B, max_len), dtype=bool)
        for i, g in enumerate(grids):
            ids[i, max_len - g.shape[0] :] = g
            mask[i, max_len - g.shape[0] :] = True
        return {"input_ids": ids, "attention_mask": mask}

    # ------------------------------- decode -------------------------------
    def _parse_text(self, start_length: int, text_codes: np.ndarray) -> str:
        text = self.tokenizer.decode(list(text_codes))
        prefix = self.tokenizer.decode(list(text_codes[:start_length]))
        text = text[len(prefix):]
        pattern = re.compile(
            rf"(?:{re.escape(self.audio_start_token)})?"
            rf"(?:{re.escape(self.audio_gen_slot_token)})*"
            rf"(?:{re.escape(self.audio_delay_slot_token)})*"
            rf"{re.escape(self.audio_end_token)}"
        )

        def repl(m: re.Match) -> str:
            return AUDIO_PLACEHOLDER if self.audio_gen_slot_token in m.group(0) else ""

        return pattern.sub(repl, text)

    def _parse_audio(self, start_length: int, audio_codes: np.ndarray) -> List[np.ndarray]:
        c = self.config
        if audio_codes.shape[0] < audio_codes.shape[1]:
            return []  # shorter than one delay diagonal: nothing decodable
        audio_codes = apply_de_delay_pattern(audio_codes)
        non_pad = ~(audio_codes == c.audio_pad_code).all(axis=1)
        if not non_pad.any():
            return []
        idx = np.nonzero(non_pad)[0]
        breaks = np.where(idx[1:] != idx[:-1] + 1)[0] + 1
        segments = np.split(idx, breaks) if len(breaks) else [idx]
        codes_list = [audio_codes[s] for s in segments]
        wavs = self.decode_audio_codes(codes_list)
        # waveform-level continuation-prefix trim (reference :693-708)
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

    def decode(self, output: List[Tuple[int, np.ndarray]]) -> List[Optional[AssistantMessage]]:
        messages = []
        for start_length, generation_ids in output:
            generation_ids = np.asarray(generation_ids)
            content = self._parse_text(int(start_length), generation_ids[:, 0])
            wavs = self._parse_audio(int(start_length), generation_ids[:, 1:])
            messages.append(
                None if content == "" else AssistantMessage(content=content, audio_codes_list=wavs)
            )
        return messages

    # ----------------------------- codec glue ------------------------------
    loudness_normalize = staticmethod(audio_io.loudness_normalize)
    # reference API compatibility (staticmethods on the processor,
    # processing_moss_tts.py:516-537)
    apply_delay_pattern = staticmethod(apply_delay_pattern)
    apply_de_delay_pattern = staticmethod(apply_de_delay_pattern)

    def encode_audios_from_wav(
        self, wav_list, sampling_rate: int, n_vq: Optional[int] = None
    ) -> List[np.ndarray]:
        if self.audio_tokenizer is None:
            raise RuntimeError("audio_tokenizer is not set on processor.")
        if isinstance(wav_list, np.ndarray):
            wav_list = [wav_list]
        prepped = []
        for wav in wav_list:
            wav = np.asarray(wav, np.float32)
            if wav.ndim == 2:
                wav = audio_io.to_mono(wav)
            if sampling_rate != self.config.sampling_rate:
                wav = audio_io.resample(wav, sampling_rate, self.config.sampling_rate)
            prepped.append(audio_io.loudness_normalize(wav))
        enc = self.audio_tokenizer.batch_encode(prepped, num_quantizers=n_vq)
        codes = np.asarray(enc.audio_codes)  # (NQ, B, T)
        lengths = np.asarray(enc.audio_codes_lengths)
        return [
            codes[:, i, : int(lengths[i])].T.astype(np.int64) for i in range(codes.shape[1])
        ]

    def encode_audios_from_path(self, paths, n_vq: Optional[int] = None) -> List[np.ndarray]:
        if isinstance(paths, str):
            paths = [paths]
        target = self.config.sampling_rate
        wavs = []
        for p in paths:
            wav, sr = audio_io.read_wav(p)
            wav = audio_io.to_mono(wav)
            if sr != target:
                wav = audio_io.resample(wav, sr, target)
            wavs.append(wav)
        return self.encode_audios_from_wav(wavs, target, n_vq)

    def decode_audio_codes(self, audio_tokens_list) -> List[np.ndarray]:
        if self.audio_tokenizer is None:
            raise RuntimeError("audio_tokenizer is not set on processor.")
        if isinstance(audio_tokens_list, np.ndarray):
            audio_tokens_list = [audio_tokens_list]
        if not audio_tokens_list:
            return []
        nq = audio_tokens_list[0].shape[1]
        max_t = max(x.shape[0] for x in audio_tokens_list)
        codes = np.zeros((nq, len(audio_tokens_list), max_t), dtype=np.int64)
        mask = np.zeros((len(audio_tokens_list), max_t), dtype=bool)
        for i, x in enumerate(audio_tokens_list):
            codes[:, i, : x.shape[0]] = x.T
            mask[i, : x.shape[0]] = True
        dec = self.audio_tokenizer.decode(codes, padding_mask=mask, chunk_duration=8)
        audio = np.asarray(dec.audio)  # (B, 1, L)
        lengths = np.asarray(dec.audio_lengths)
        return [audio[i, 0, : int(lengths[i])].astype(np.float32) for i in range(audio.shape[0])]
