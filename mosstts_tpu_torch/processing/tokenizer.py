"""Text-tokenizer protocol + built-in fallback.

The framework loads the checkpoint's own tokenizer (``load_tokenizer``);
everything downstream only relies on the small protocol below, so tests and
offline environments use ``ByteFallbackTokenizer`` — a deterministic
byte-level tokenizer that maps the MOSS/Qwen special-token *strings* to
their real ids (reference ids: moss_tts_delay/configuration_moss_tts.py:62-77).

The port's own copy of ``mosstts_tpu/processing/tokenizer.py``, except for
``load_tokenizer``: where the JAX package asks ``transformers`` for the
checkpoint's tokenizer, the port reads the directory's ``tokenizer.json``
itself (``bpe.Qwen2BPETokenizer``): it depends on no ``transformers`` and
tokenizes the same wherever it runs.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Protocol, runtime_checkable


@runtime_checkable
class TokenizerLike(Protocol):
    def encode(self, text: str, **kw) -> List[int]: ...
    def decode(self, ids, **kw) -> str: ...
    def convert_tokens_to_ids(self, token: str) -> int: ...
    def convert_ids_to_tokens(self, token_id: int) -> str: ...


# Special-token string <-> id table used by every model in the family.
SPECIAL_TOKENS: Dict[str, int] = {
    "<|endoftext|>": 151643,
    "<|im_start|>": 151644,
    "<|im_end|>": 151645,
    "<|audio_start|>": 151652,
    "<|audio_end|>": 151653,
    "<|audio_pad|>": 151654,  # user slot / realtime reference_audio_pad
    "<|text_pad|>": 151655,  # realtime text pad
    "<|audio_gen_slot|>": 151656,
    "<|audio_delay_slot|>": 151662,
}
ID_TO_SPECIAL = {v: k for k, v in SPECIAL_TOKENS.items()}


def qwen_chat_wrap(role: str, content: str, add_generation_prompt: bool = False) -> str:
    """Qwen chat template: <|im_start|>{role}\\n{content}<|im_end|>\\n."""
    s = f"<|im_start|>{role}\n{content}<|im_end|>\n"
    if add_generation_prompt:
        s += "<|im_start|>assistant\n"
    return s


class ByteFallbackTokenizer:
    """Deterministic offline tokenizer: greedy special-token match, plain
    bytes otherwise (byte b -> id BYTE_BASE + b). Round-trips any UTF-8
    text and keeps every special id at its real slot."""

    BYTE_BASE = 1000

    # single-token words, mirroring the real Qwen vocab's role tokens so the
    # reference's "<|im_start|> + 3 rows" slicing convention holds
    # (moss_tts_delay/modeling_moss_tts.py:518)
    WORD_TOKENS = {"assistant": 501, "user": 502, "system": 503, "\n": 504}

    def __init__(self):
        self.specials = {**SPECIAL_TOKENS, **self.WORD_TOKENS}
        self.id_to_special = {v: k for k, v in self.specials.items()}
        self.pad_token_id = SPECIAL_TOKENS["<|endoftext|>"]
        self.unk_token_id = -1
        # longest-first for greedy matching
        self._sorted = sorted(self.specials, key=len, reverse=True)

    @property
    def vocab_size(self) -> int:
        return 151936

    def encode(self, text: str, add_special_tokens: bool = False, **kw) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(text):
            for tok in self._sorted:
                if text.startswith(tok, i):
                    ids.append(self.specials[tok])
                    i += len(tok)
                    break
            else:
                ch = text[i].encode("utf-8")
                ids.extend(self.BYTE_BASE + b for b in ch)
                i += 1
        return ids

    def __call__(self, text: str, **kw):
        return {"input_ids": self.encode(text)}

    def decode(self, ids, **kw) -> str:
        out: List[str] = []
        buf = bytearray()

        def flush():
            nonlocal buf
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()

        for t in ids:
            t = int(t)
            if t in self.id_to_special:
                flush()
                out.append(self.id_to_special[t])
            elif self.BYTE_BASE <= t < self.BYTE_BASE + 256:
                buf.append(t - self.BYTE_BASE)
            else:
                flush()
                out.append(f"<unk:{t}>")
        flush()
        return "".join(out)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.specials.get(token, self.unk_token_id)

    def convert_ids_to_tokens(self, token_id: int) -> str:
        return self.id_to_special.get(int(token_id), f"<unk:{token_id}>")

    def apply_chat_template(self, messages, add_generation_prompt=False, tokenize=False, **kw):
        s = "".join(qwen_chat_wrap(m["role"], m["content"]) for m in messages)
        if add_generation_prompt:
            s += "<|im_start|>assistant\n"
        return self.encode(s) if tokenize else s


_OLD_FORMAT = ("vocab.json", "merges.txt", "tokenizer_config.json")


def load_tokenizer(path: str | None = None):
    """The tokenizer of the checkpoint directory ``path``: its
    ``tokenizer.json`` through ``Qwen2BPETokenizer``, which raises on a
    file it cannot read; the byte fallback with no path or a directory with
    no tokenizer files. A directory with only ``vocab.json``/``merges.txt``
    (or ``tokenizer_config.json``), or a path that is no directory, raises
    ``FileNotFoundError``."""
    if path is None:
        return ByteFallbackTokenizer()
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    if (path / "tokenizer.json").is_file():
        from .bpe import Qwen2BPETokenizer

        return Qwen2BPETokenizer.from_dir(path)
    found = [n for n in _OLD_FORMAT if (path / n).is_file()]
    if found:
        raise FileNotFoundError(f"{path} holds {', '.join(found)} but no tokenizer.json, the one "
                                "tokenizer format the port reads")
    return ByteFallbackTokenizer()
