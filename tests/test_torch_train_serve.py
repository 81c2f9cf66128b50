"""Training into serving, resumption and the data loader of the port, on
the CPU.

A ``TTSTrainer`` saved in the serving format loads back through the port's
``utils/save.load_model`` bit for bit, and a greedy ``DelayEngine``
generates the same grids from the loaded parameters as from the trainer's,
and as the JAX package's ``load_model`` and engine from the same directory.
``save_state`` after 2 steps, ``restore_state`` into a fresh trainer (another
seed) and 2 more steps equal 4 uninterrupted steps bit for bit (losses,
parameters and moments), and a checkpoint of another family raises. The
port's ``BucketedLoader`` yields the same batches as JAX's from one manifest,
over a corpus written with the port's ``utils/audio.write_wav`` and codecs
with the same weights.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosstts_tpu.codec.model import MossAudioTokenizer as JCodec
from mosstts_tpu.core import config as jconfig
from mosstts_tpu.engine.delay_engine import DelayEngine as JEngine
from mosstts_tpu.processing.delay_processor import DelayProcessor as JProcessor
from mosstts_tpu.processing.tokenizer import ByteFallbackTokenizer as JTokenizer
from mosstts_tpu.train import data as jdata
from mosstts_tpu.utils.save import load_model as jload_model
from mosstts_tpu_torch.codec.model import CodecParams, MossAudioTokenizer
from mosstts_tpu_torch.core import config as tconfig
from mosstts_tpu_torch.engine.delay_engine import DelayEngine
from mosstts_tpu_torch.processing.delay_processor import DelayProcessor
from mosstts_tpu_torch.processing.tokenizer import ByteFallbackTokenizer
from mosstts_tpu_torch.tools.hf_checkpoint import same_params
from mosstts_tpu_torch.train import checkpoint as tck
from mosstts_tpu_torch.train import data as tdata
from mosstts_tpu_torch.train.trainer import TTSTrainer, tiny_config
from mosstts_tpu_torch.utils.audio import write_wav
from mosstts_tpu_torch.utils.convert import load_tree_
from mosstts_tpu_torch.utils.save import load_model

from test_torch_train import one_thread  # noqa: F401
from test_torch_train_loop import OPT, batches, same_state


def greedy(engine, ids, mask):
    return engine.generate(ids, mask, max_new_tokens=8, text_temperature=0.0,
                           audio_temperature=0.0)


def test_train_save_load_serve(tmp_path):
    cfg = tiny_config("delay")
    tr = TTSTrainer("delay", cfg, total_steps=3, device="cpu")
    for b in batches("delay", n=2, seed=3):
        tr.train_step(b)
    tr.save(tmp_path / "ckpt")
    assert json.loads((tmp_path / "ckpt" / "train_history.json").read_text()) == tr.history
    params, lcfg = load_model(tmp_path / "ckpt", device="cpu")
    tr.params.requires_grad_(False)
    assert lcfg == cfg and same_params(params, tr.params)

    rng = np.random.default_rng(3)
    ids = rng.integers(0, 200, (1, 10, cfg.channels))
    ids[0, 2, 0] = cfg.im_start_token_id
    ids[0, 4, 0] = cfg.audio_start_token_id
    ids[0, -1, 0] = cfg.audio_assistant_gen_slot_token_id
    mask = np.ones((1, 10), bool)
    kw = dict(dtype=torch.float32, cache_bucket=32, device="cpu")
    got = greedy(DelayEngine(params, lcfg, **kw), ids, mask)
    own = greedy(DelayEngine(tr.params, cfg, **kw), ids, mask)
    jparams, jcfg = jload_model(tmp_path / "ckpt", dtype=jnp.float32)
    ref = greedy(JEngine(jparams, jcfg, dtype=jnp.float32, cache_bucket=32), ids, mask)
    assert len(got) == len(own) == len(ref) == 1
    for a, b, c in zip(got, own, ref):
        assert a[0] == b[0] == c[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[1], np.asarray(c[1]))


def test_resume_is_bit_equal(tmp_path):
    bs = batches("delay", n=4, seed=5)
    cfg = tiny_config("delay")
    straight = TTSTrainer("delay", cfg, device="cpu", **OPT)
    losses = [straight.train_step(b)["loss"] for b in bs]

    first = TTSTrainer("delay", cfg, device="cpu", **OPT)
    for b in bs[:2]:
        first.train_step(b)
    first.save_state(tmp_path / "ckpt").wait_until_finished()
    resumed = TTSTrainer("delay", cfg, seed=123, device="cpu", **OPT)
    resumed.restore_state(tmp_path / "ckpt")
    assert resumed.step_idx == 2 and len(resumed.history) == 2
    assert resumed.history == first.history
    assert [resumed.train_step(b)["loss"] for b in bs[2:]] == losses[2:]
    assert same_state(resumed, straight)
    meta = json.loads((tmp_path / "ckpt" / tck.META_FILE).read_text())
    assert meta["family"] == "delay" and meta["step"] == 2

    wrong = TTSTrainer("local", tiny_config("local"), device="cpu", **OPT)
    with pytest.raises(ValueError, match="family"):
        wrong.restore_state(tmp_path / "ckpt")


def _tone(seconds: float, f0: float, sr: int = 24000) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def test_bucketed_loader_matches_jax(tmp_path):
    """``tests/test_train_data.py``'s corpus (three clips), written with the
    port's ``write_wav``; four batches cross an epoch boundary."""
    rows = []
    for i, sec in enumerate((0.4, 0.6, 0.9)):
        write_wav(tmp_path / f"clip_{i}.wav", _tone(sec, 200.0 + 40 * i), 24000)
        rows.append({"text": f"sample utterance number {i}", "audio": f"clip_{i}.wav"})
    manifest = tmp_path / "train.jsonl"
    manifest.write_text("\n".join(json.dumps(r) for r in rows))
    ckw = dict(hidden_size=64, intermediate_size=128, num_encoder_layers=1,
               num_decoder_layers=1, num_attention_heads=2, num_key_value_heads=2, head_dim=32,
               n_q=4, codebook_dim=64)
    jcodec = JCodec.random_init(seed=0, config=jconfig.CodecConfig(**ckw))
    tcfg = tconfig.CodecConfig(**ckw)
    tcodec = MossAudioTokenizer(load_tree_(CodecParams(tcfg), jax.device_get(jcodec.params)),
                                tcfg)
    jproc = JProcessor(JTokenizer(), jcodec,
                       jconfig.DelayConfig(language_config=jconfig.tiny_qwen3(), n_vq=4))
    tproc = DelayProcessor(ByteFallbackTokenizer(), tcodec, tiny_config("delay"))

    assert tdata.load_manifest(manifest) == jdata.load_manifest(manifest)
    kw = dict(batch_size=2, bucket=16, prefetch=2, seed=1)
    loaders = [mod.BucketedLoader(mod.TTSDataset(mod.load_manifest(manifest), proc,
                                                 proc.audio_tokenizer, n_vq=4), **kw)
               for mod, proc in ((tdata, tproc), (jdata, jproc))]
    its = [iter(loader) for loader in loaders]
    for _ in range(4):
        got, want = (next(it) for it in its)
        assert set(got) == set(want) == {"input_ids", "attention_mask", "labels"}
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for it in its:
        it.close()
