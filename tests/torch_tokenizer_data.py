"""Seeded mixed text, and the build of the tokenizer fixture's committed data.

``mixed_texts(seed, n)`` draws texts of English, Chinese, digits,
punctuation, runs of white space and newlines, emoji, contractions and
the family's added tokens, from a numpy seed; the tokenizer tests draw
theirs from it.

``python tests/torch_tokenizer_data.py`` (from the repo root, where
``tokenizers``, ``transformers`` and JAX are installed) rebuilds
``mosstts_tpu_torch/tools/tokenizer_fixture_core.json`` (a byte-level BPE
trained with ``tokenizers`` on ``mixed_texts(0, 20000)``, ~3,000 tokens)
and ``tokenizer_fixture_expected.json``: the ids and decodes of
``SMOKE_TEXTS``, a Delay prompt's and a Realtime turn's text ids, and the
ids a ``TextDeltaTokenizer`` releases for ``RT_REPLY`` and for ``REPLY``
(2,000 characters) sent in word deltas,
all through the JAX package's ``load_tokenizer`` (``transformers``) over a
directory ``write_tokenizer_dir`` wrote.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

WORDS = ("the of and to in is you that it he was for on are as with his they at be this "
         "have from or one had by word but not what all were we when your can said there use "
         "an each which she do how their if will up other about out many then them these so "
         "some her would make like him into time has look two more write go see number no way "
         "could people my than first water been call who oil its now find long down day did "
         "get come made may part voice speech audio model stream token text sound music "
         "realtime server request reply hello world") .split()
CHINESE = ("的一是不了人我在有他这中大来上国个到说们为子和你地出道也时年得就那要下以生会自着"
           "去之过家学对可里后小么心多天而能好都然没日于起还发成事只作当想看文无开手十用主行"
           "方又如前所本见经头面公同三已老从动两长知民样现分将外但身些与高意进把法此实回二理"
           "美点月明其种声全工己话儿者向情部正名定女问力机给等几很业最间新什打便位因重被走电"
           "四第门相次东政海口使教西再平真听世气信北少关并内加化由却代军产入先山五太水万市眼"
           "体别处总才场师书比住员九笑性通目华报立马命张活难神数件安表原车白应路期叫死常提感"
           "金何更反合放做系计或司利受光王果亲界语音合成实时流式模型")
PUNCT = list(",.!?;:'\"()[]{}-—…，。！？、；：“”‘’（）《》/@#$%&*+=<>|~`^_")
SPACES = [" ", "  ", "   ", "\t", "\n", "\n\n", " \n", "\r\n", "　", " "]
EMOJI = ["😀", "😂", "🥲", "👍", "👍🏽", "👨‍👩‍👧", "❤️", "🎉", "🚀", "🌏",
         "🤖", "🎵", "🔊", "✨", "🙏🏻"]
CONTRACTIONS = ["it's", "don't", "I'm", "we'll", "they've", "you're", "he'd", "IT'S", "We'RE",
                "'s", "'ll"]
ADDED = ["<|im_start|>", "<|im_end|>", "<|audio_start|>", "<|audio_end|>", "<|text_pad|>",
         "<think>", "</think>", "<tool_call>", "<|endoftext|>"]


def _piece(rng: np.random.Generator) -> str:
    kind = rng.choice(9, p=[0.34, 0.2, 0.08, 0.1, 0.1, 0.05, 0.06, 0.04, 0.03])
    if kind == 0:
        w = WORDS[rng.integers(len(WORDS))]
        return w.capitalize() if rng.random() < 0.15 else w
    if kind == 1:
        return "".join(CHINESE[i] for i in rng.integers(0, len(CHINESE), rng.integers(1, 6)))
    if kind == 2:
        return str(rng.integers(0, 10 ** rng.integers(1, 7)))
    if kind == 3:
        return PUNCT[rng.integers(len(PUNCT))]
    if kind == 4:
        return SPACES[rng.integers(len(SPACES))]
    if kind == 5:
        return EMOJI[rng.integers(len(EMOJI))]
    if kind == 6:
        return CONTRACTIONS[rng.integers(len(CONTRACTIONS))]
    if kind == 7:
        return ADDED[rng.integers(len(ADDED))]
    return ["é", "é", "ſ", "Å", "ﬁ", "Ｆｕｌｌ", "١٢٣", "ǅ", "Ⅻ"][rng.integers(9)]


def mixed_texts(seed: int, n: int, max_pieces: int = 24) -> list:
    """``n`` texts of 1..``max_pieces`` pieces each, words mostly joined
    by a space."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, max_pieces + 1))):
            parts.append(_piece(rng))
            if rng.random() < 0.6:
                parts.append(" ")
        out.append("".join(parts))
    return out


SMOKE_TEXTS = [
    "Hello, world! This is MOSS-TTS speaking.",
    "你好，世界！这是一个语音合成的例子。",
    "Mixed 中英文 text: it's 2026年10月18日, 3.14159 and 42%.",
    "  leading spaces, trailing spaces  \n\nand\ttabs\r\nand newlines\n",
    "Emoji: 😀👍🏽👨‍👩‍👧 ❤️ 🚀 done.",
    "<|im_start|>user\nRead this aloud.<|im_end|>\n<|im_start|>assistant\n",
    "<think>plan</think> <tool_call>{\"name\": \"speak\"}</tool_call>",
    "Combining: é vs é, long s: 'ſ, fullwidth: Ｆｕｌｌ， ligature: ﬁ.",
    "I'M SURE THEY'LL SAY WE'VE DONE IT'S WORK'D",
    "<|audio_start|><|audio_gen_slot|><|audio_delay_slot|><|audio_end|><|text_pad|>",
]
DELAY_TEXT = "MOSS-TTS 语音合成: it's 12:30, 天气很好 😀 — let's go!"
RT_USER = "Tell me about the weather 今天."
RT_REPLY = ("Sure! 今天天气很好, it's 23°C and sunny ☀️ — a great day for a walk in the "
            "park. 🌳")
REPLY = " ".join(mixed_texts(7, 40, max_pieces=30)).replace("\n", " ")
for _a in ADDED:  # a reply is plain text
    REPLY = REPLY.replace(_a, "")
REPLY = REPLY[:2000]


def build_core(n_texts: int = 20000, vocab_size: int = 3000) -> dict:
    """A byte-level BPE trained with ``tokenizers`` on ``mixed_texts(0, n)``
    through Qwen2's normalizer and pre-tokenizer."""
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

    from mosstts_tpu_torch.tools.tokenizer_fixture import QWEN2_PATTERN

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, min_frequency=2, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(mixed_texts(0, n_texts), trainer=trainer)
    spec = json.loads(tok.to_str())["model"]
    vocab = sorted(spec["vocab"], key=spec["vocab"].get)
    assert [spec["vocab"][t] for t in vocab] == list(range(len(vocab)))
    merges = [m.split(" ", 1) if isinstance(m, str) else list(m) for m in spec["merges"]]
    return {"vocab": vocab, "merges": merges}


def build_expected(tok_dir) -> dict:
    """The expected ids through the JAX package over ``tok_dir``."""
    from mosstts_tpu.core.config import DelayConfig, RealtimeConfig, qwen3_1p7b, qwen3_8b
    from mosstts_tpu.engine.streaming import TextDeltaTokenizer
    from mosstts_tpu.processing.delay_processor import DelayProcessor
    from mosstts_tpu.processing.realtime_processor import RealtimeProcessor
    from mosstts_tpu.processing.tokenizer import load_tokenizer
    from mosstts_tpu_torch.tools.tokenizer_fixture import delta_words

    tok = load_tokenizer(str(tok_dir))
    assert type(tok).__name__ == "Qwen2TokenizerFast", type(tok)
    texts = []
    for t in SMOKE_TEXTS:
        ids = tok.encode(t, add_special_tokens=False)
        texts.append(dict(text=t, ids=ids, decode=tok.decode(ids),
                          decode_skip=tok.decode(ids, skip_special_tokens=True)))
    proc = DelayProcessor(tok, config=DelayConfig(language_config=qwen3_8b(num_hidden_layers=2),
                                                  n_vq=32))
    batch = proc([[proc.build_user_message(text=DELAY_TEXT)]], mode="generation")
    rcfg = RealtimeConfig(language_config=qwen3_1p7b(num_hidden_layers=2))
    rproc = RealtimeProcessor(tok, channels=rcfg.rvq)
    audio = np.zeros((8, rcfg.rvq), np.int64)
    turn = np.concatenate([rproc.make_ensemble(None), rproc.make_user_prompt(RT_USER, audio)])

    def released(text):
        deltas = TextDeltaTokenizer(tok)
        return [deltas.push_delta(d) for d in delta_words(text)] + [deltas.flush()]

    return dict(
        texts=texts,
        delay=dict(text=DELAY_TEXT, prompt_text_ids=batch["input_ids"][0, :, 0].tolist()),
        realtime=dict(user_text=RT_USER, user_audio_frames=8, turn_text_ids=turn[:, 0].tolist(),
                      reply=RT_REPLY, released=released(RT_REPLY)),
        reply=dict(text=REPLY, released=released(REPLY)),
    )


def main() -> None:
    sys.path.insert(0, str(ROOT))
    from mosstts_tpu_torch.tools import tokenizer_fixture as fx

    core = build_core()
    with open(fx.CORE, "w", encoding="utf-8") as f:
        json.dump(core, f, ensure_ascii=False, separators=(",", ":"))
    with tempfile.TemporaryDirectory() as d:
        fx.write_tokenizer_dir(d)
        expected = build_expected(d)
    with open(fx.EXPECTED, "w", encoding="utf-8") as f:
        json.dump(expected, f, ensure_ascii=False, indent=1)
    print(f"core: {len(core['vocab'])} tokens, {len(core['merges'])} merges; "
          f"{len(expected['texts'])} texts, reply of {len(REPLY)} characters")


if __name__ == "__main__":
    main()
