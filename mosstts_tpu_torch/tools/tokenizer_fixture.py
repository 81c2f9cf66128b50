"""A checkpoint's tokenizer directory in Qwen3's layout, from a small
committed byte-level BPE core, in plain Python.

``tokenizer_fixture_core.json`` (beside this file) holds a byte-level BPE
vocabulary and merges of a few thousand entries, trained once with the
``tokenizers`` package over seeded mixed text (English, Chinese, digits,
punctuation, runs of white space and newlines, emoji;
``tests/torch_tokenizer_data.py`` builds it). ``write_tokenizer_dir`` writes
from it what a MOSS-TTS checkpoint carries:

- ``tokenizer.json``: Qwen2's components (NFC, the Split pattern below and
  ByteLevel, BPE, the ByteLevel decoder and post-processor); the core
  vocabulary padded with unreachable filler tokens (no merge makes them) to
  Qwen3's 151,643 entries; the 26 added tokens at 151643-151668, under the
  family's names at the ids of ``processing.tokenizer.SPECIAL_TOKENS`` and
  Qwen3's elsewhere, special or not as Qwen3 marks them;
- ``tokenizer_config.json`` as Qwen3's (``Qwen2Tokenizer``, no BOS or unk
  token, no clean-up of spaces).

``tokenizer_fixture_expected.json`` holds the ids and decodes of a fixed
set of texts through ``transformers``' tokenizer of such a directory, and
the prompts' text ids of one Delay request and one Realtime turn streamed
in word deltas; ``chip_smoke.py`` checks the port against them on the
card's machine, without ``transformers``.

Usage: ``python3 -m mosstts_tpu_torch.tools.tokenizer_fixture DIR``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..processing.tokenizer import SPECIAL_TOKENS

CORE = Path(__file__).with_name("tokenizer_fixture_core.json")
EXPECTED = Path(__file__).with_name("tokenizer_fixture_expected.json")
VOCAB = 151643  # Qwen3's BPE vocabulary; the added tokens follow it

# Qwen2's and Qwen3's pre-tokenizer pattern
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# Qwen3's added tokens at 151643-151668 (content, special)
_QWEN3_ADDED = (
    ("<|endoftext|>", True), ("<|im_start|>", True), ("<|im_end|>", True),
    ("<|object_ref_start|>", True), ("<|object_ref_end|>", True), ("<|box_start|>", True),
    ("<|box_end|>", True), ("<|quad_start|>", True), ("<|quad_end|>", True),
    ("<|vision_start|>", True), ("<|vision_end|>", True), ("<|vision_pad|>", True),
    ("<|image_pad|>", True), ("<|video_pad|>", True), ("<tool_call>", False),
    ("</tool_call>", False), ("<|fim_prefix|>", False), ("<|fim_middle|>", False),
    ("<|fim_suffix|>", False), ("<|fim_pad|>", False), ("<|repo_name|>", False),
    ("<|file_sep|>", False), ("<tool_response>", False), ("</tool_response>", False),
    ("<think>", False), ("</think>", False),
)


def added_tokens() -> list:
    """The 26 added tokens as ``tokenizer.json`` lists them: the family's
    special tokens at their ids (special), Qwen3's at the others."""
    names = {i: t for t, i in SPECIAL_TOKENS.items()}
    out = []
    for k, (content, special) in enumerate(_QWEN3_ADDED):
        i = VOCAB + k
        out.append(dict(id=i, content=names.get(i, content), single_word=False, lstrip=False,
                        rstrip=False, normalized=False, special=special or i in names))
    return out


def load_core(path=CORE) -> dict:
    """``{"vocab": [token, ...] (id order), "merges": [[a, b], ...]}``."""
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def tokenizer_json(core: dict) -> dict:
    """``tokenizer.json`` of Qwen3's layout over ``core``."""
    vocab = {t: i for i, t in enumerate(core["vocab"])}
    n = len(vocab)
    if n > VOCAB:
        raise ValueError(f"the core holds {n} tokens, more than {VOCAB}")
    vocab.update({f"<fill{i}>": i for i in range(n, VOCAB)})
    if len(vocab) != VOCAB:
        raise ValueError("a filler token collides with a core token")
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                  "use_regex": False}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added_tokens(),
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated",
             "invert": False},
            byte_level]},
        "post_processor": byte_level,
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "", "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False, "vocab": vocab,
                  "merges": [f"{a} {b}" for a, b in core["merges"]]},
    }


def tokenizer_config() -> dict:
    """``tokenizer_config.json`` as Qwen3's, under the family's names."""
    added = added_tokens()
    return {
        "add_bos_token": False, "add_prefix_space": False,
        "added_tokens_decoder": {str(t["id"]): {k: v for k, v in t.items() if k != "id"}
                                 for t in added},
        "additional_special_tokens": [t["content"] for t in added[1:14]],
        "bos_token": None, "clean_up_tokenization_spaces": False, "eos_token": "<|im_end|>",
        "errors": "replace", "model_max_length": 131072, "pad_token": "<|endoftext|>",
        "split_special_tokens": False, "tokenizer_class": "Qwen2Tokenizer", "unk_token": None,
    }


def write_tokenizer_dir(path, core: dict | None = None) -> Path:
    """Write ``tokenizer.json`` and ``tokenizer_config.json`` into ``path``
    (made if missing) from ``core`` (the committed core by default)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    spec = tokenizer_json(core if core is not None else load_core())
    with open(path / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(path / "tokenizer_config.json", "w", encoding="utf-8") as f:
        json.dump(tokenizer_config(), f, ensure_ascii=False, indent=1)
    return path


def load_expected(path=EXPECTED) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def delta_words(text: str) -> list:
    """``text`` as a language model's word deltas: each word with the space
    that follows it."""
    words = text.split(" ")
    return [w + " " for w in words[:-1]] + [words[-1]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir", help="directory to write tokenizer.json and tokenizer_config.json into")
    write_tokenizer_dir(ap.parse_args(argv).dir)


if __name__ == "__main__":
    main()
