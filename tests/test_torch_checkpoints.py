"""The port's checkpoint loading against the JAX package's on the CPU.

Reference-layout state dicts are built with numpy (as JAX
``tests/test_checkpoints.py:35-52`` does) for the three families on tiny
configs, under the names ``utils/checkpoints.py``'s tables give, and
written as float32 shards with ``model.safetensors.index.json`` (the port's
writer) and as one bfloat16 file (``safetensors.torch``'s writer). The
port's ``load_*_checkpoint`` of the float32 directory equals JAX's
``*_params_from_state_dict`` of the dict, tensor for tensor (JAX is fed the
dict: its directory reader cannot read bf16 shards); the bf16 directory
equals the float32 one cast to bf16; greedy Local grids from a loaded
model equal JAX's. ``save_model``/``load_model`` round trips go both ways
between the packages, and so does the codec's ``save_pretrained``/
``from_pretrained``; ``quantize()`` after a load equals a quantize of the
same weights; the port's safetensors reader and writer agree with the
``safetensors`` package's; a missing path raises ``FileNotFoundError``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

from mosstts_tpu.codec.model import MossAudioTokenizer as JCodec
from mosstts_tpu.core import config as jconfig
from mosstts_tpu.engine.local_engine import LocalEngine as JLocalEngine
from mosstts_tpu.utils import checkpoints as jck
from mosstts_tpu.utils import save as jsave
from mosstts_tpu_torch.codec.model import MossAudioTokenizer
from mosstts_tpu_torch.core import config as tconfig
from mosstts_tpu_torch.engine.local_engine import LocalEngine
from mosstts_tpu_torch.models.delay import DelayParams
from mosstts_tpu_torch.models.local import LocalParams
from mosstts_tpu_torch.models.realtime import RealtimeParams
from mosstts_tpu_torch.ops.quant import quantize_tree_
from mosstts_tpu_torch.tools.hf_checkpoint import same_params
from mosstts_tpu_torch.utils import checkpoints as tck
from mosstts_tpu_torch.utils.convert import flatten_tree, load_tree_
from mosstts_tpu_torch.utils.hf_loader import (SafetensorsFile, load_safetensors_dir,
                                               save_safetensors)
from mosstts_tpu_torch.utils.save import load_model, save_model


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(mod, **over):
    return mod.tiny_qwen3(vocab_size=300, hidden_size=32, num_attention_heads=2,
                          num_key_value_heads=2, head_dim=16, intermediate_size=64, **over)


def _configs(mod):
    """The three families' tiny configs in ``mod`` (either package's config
    module), as JAX ``tests/test_checkpoints.py`` sizes them."""
    return {
        "delay": mod.DelayConfig(language_config=_tiny(mod), n_vq=4),
        "local": mod.LocalConfig(language_config=_tiny(mod), n_vq=4,
                                 additional_mlp_ffn_hidden_size=24, local_ffn_hidden_size=40,
                                 local_hidden_size=16, local_num_layers=2),
        "realtime": mod.RealtimeConfig(
            language_config=_tiny(mod),
            local_config=mod.RealtimeLocalConfig(
                hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=2, num_key_value_heads=2, head_dim=16, rvq=4),
            rvq=4),
    }


FAMILIES = {
    "delay": (DelayParams, tck.delay_table, tck.load_delay_checkpoint,
              jck.delay_params_from_state_dict),
    "local": (LocalParams, tck.local_table, tck.load_local_checkpoint,
              jck.local_params_from_state_dict),
    "realtime": (RealtimeParams, tck.realtime_table, tck.load_realtime_checkpoint,
                 jck.realtime_params_from_state_dict),
}
TCFGS, JCFGS = _configs(tconfig), _configs(jconfig)


def reference_sd(family: str, seed: int = 0) -> dict:
    """A reference-layout state dict of float32 numpy arrays: every name the
    family's table reads, in the reference's (out, in) layout."""
    cls, table, _, _ = FAMILIES[family]
    cfg = TCFGS[family]
    shapes = {n: tuple(p.shape) for n, p in cls(cfg, device="meta").named_parameters()}
    rng = np.random.default_rng(seed)
    sd = {}
    for e in table(cfg):
        shape = shapes[e.dst] if e.n is None else shapes[e.dst][1:]
        if e.transpose:
            shape = shape[:-2] + (shape[-1], shape[-2])
        for j in range(1 if e.n is None else e.n):
            name = e.src if e.n is None else e.src.format(i=e.start + j)
            sd[name] = rng.standard_normal(shape, np.float32)
    return sd


def write_dirs(tmp_path, family: str, sd: dict):
    """The dict as float32 shards (3, with an index, the port's writer) and
    as one bfloat16 file (``safetensors.torch``'s writer), each with the
    family's ``config.json``."""
    f32, bf16 = tmp_path / f"{family}-f32", tmp_path / f"{family}-bf16"
    for d in (f32, bf16):
        d.mkdir()
        with open(d / "config.json", "w") as f:
            json.dump(dataclasses.asdict(TCFGS[family]), f)
    names = sorted(sd)
    weight_map = {}
    for k in range(3):
        fname = f"model-{k + 1:05d}-of-00003.safetensors"
        part = names[k::3]
        save_safetensors({n: torch.from_numpy(sd[n]) for n in part}, f32 / fname)
        weight_map.update({n: fname for n in part})
    with open(f32 / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": weight_map}, f)
    st_save_file({n: torch.from_numpy(a).to(torch.bfloat16) for n, a in sd.items()},
                 str(bf16 / "model.safetensors"))
    return f32, bf16


def _equal_tree(port, tree):
    flat = {k: np.asarray(v, np.float32) for k, v in flatten_tree(jax.device_get(tree)).items()}
    named = dict(port.named_parameters())
    assert set(flat) == set(named)
    for name, p in named.items():
        np.testing.assert_array_equal(p.float().numpy(), flat[name], err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loaders_match_jax_and_read_bf16(tmp_path, family):
    sd = reference_sd(family)
    f32, bf16 = write_dirs(tmp_path, family, sd)
    _, _, load, jconvert = FAMILIES[family]
    params, cfg = load(f32, dtype=torch.float32, device="cpu")
    assert cfg == TCFGS[family]
    _equal_tree(params, jconvert(sd, JCFGS[family], dtype=jnp.float32))
    half, _ = load(bf16, device="cpu")
    assert same_params(half, params.to(torch.bfloat16))


def test_qwen3_params_and_stack_rows_match_jax():
    """The ported helpers on their own: a backbone under a prefix, with and
    without its embedding, and stacks of transposed rows in f32 and bf16."""
    from mosstts_tpu.utils import hf_loader as jhf
    from mosstts_tpu_torch.utils import hf_loader as thf

    sd = reference_sd("delay", seed=3)
    for with_embed in (True, False):
        want = jhf.qwen3_params_from_state_dict(sd, JCFGS["delay"].language_config,
                                                prefix="language_model.", with_embed=with_embed)
        got = thf.qwen3_params_from_state_dict(sd, TCFGS["delay"].language_config,
                                               prefix="language_model.", with_embed=with_embed,
                                               dtype=torch.float32, device="cpu")
        _equal_tree(got, want)
    want = jhf.stack_rows(sd, "emb_ext.{i}.weight", 4, transpose=True)
    got = thf.stack_rows(sd, "emb_ext.{i}.weight", 4, transpose=True, dtype=torch.float32,
                         device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    half = thf.stack_rows(sd, "emb_ext.{i}.weight", 4, transpose=True, dtype=torch.bfloat16,
                          device="cpu")
    assert torch.equal(half, got.to(torch.bfloat16))


def test_loaded_local_generates_like_jax(tmp_path):
    """Greedy Local grids from the loaded float32 directory equal JAX's on
    the dict it was written from; ``quantize()`` after a load equals a
    quantize of the bridged weights."""
    sd = reference_sd("local", seed=1)
    f32, _ = write_dirs(tmp_path, "local", sd)
    params, cfg = tck.load_local_checkpoint(f32, dtype=torch.float32, device="cpu")
    jp = jck.local_params_from_state_dict(sd, JCFGS["local"], dtype=jnp.float32)
    ids = np.random.default_rng(0).integers(0, 300, (2, 7, cfg.channels))
    greedy = dict(max_new_tokens=5, do_samples=[False] * cfg.channels)
    want = JLocalEngine(jp, JCFGS["local"], dtype=jnp.float32, cache_bucket=16).generate(
        ids, **greedy)
    got = LocalEngine(params, cfg, dtype=torch.float32, cache_bucket=16,
                      device="cpu").generate(ids, **greedy)
    for (s1, g1), (s2, g2) in zip(want, got):
        assert s1 == s2
        np.testing.assert_array_equal(g2, g1)
    bridged = quantize_tree_(load_tree_(LocalParams(cfg), jax.device_get(jp)))
    assert same_params(quantize_tree_(params), bridged)


@pytest.mark.parametrize("family,dtype", [("delay", jnp.float32), ("local", jnp.bfloat16),
                                          ("realtime", jnp.bfloat16)])
def test_save_load_both_ways_with_jax(tmp_path, family, dtype):
    """``save_model`` of either package loads in the other: bf16 as uint16
    bits under ``<name>::bf16``, ``model_type`` picking the family."""
    jp = FAMILIES[family][3](reference_sd(family, seed=2), JCFGS[family], dtype=dtype)
    model_type = f"moss_tts_{family}"
    jsave.save_model(tmp_path / "jax", jp, JCFGS[family], model_type)
    params, cfg = load_model(tmp_path / "jax", device="cpu")
    assert cfg == TCFGS[family] and isinstance(params, FAMILIES[family][0])
    want = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    assert all(p.dtype == want for p in params.parameters())
    _equal_tree(params, jp)
    save_model(tmp_path / "port", params, cfg, model_type)
    back, jcfg = jsave.load_model(tmp_path / "port")
    assert jcfg == JCFGS[family]
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    again, _ = load_model(tmp_path / "port", device="cpu")
    assert same_params(again, params)


def test_codec_round_trip_both_ways(tmp_path):
    cfg = dict(n_q=4, codebook_size=64, codebook_dim=8, hidden_size=32, intermediate_size=64,
               num_encoder_layers=1, num_decoder_layers=1, num_attention_heads=2,
               num_key_value_heads=2, head_dim=16, causal_context=8)
    codec = MossAudioTokenizer.random_init(seed=0, config=tconfig.CodecConfig(**cfg),
                                           device="cpu")
    codec.save_pretrained(tmp_path / "port")
    back = MossAudioTokenizer.from_pretrained(tmp_path / "port", device="cpu")
    assert back.config == codec.config and same_params(back.params, codec.params)
    jc = JCodec.from_pretrained(tmp_path / "port")
    _equal_tree(codec.params, jc.params)
    JCodec.random_init(seed=1, config=jconfig.CodecConfig(**cfg)).save_pretrained(tmp_path / "jax")
    loaded = MossAudioTokenizer.from_pretrained(tmp_path / "jax", device="cpu")
    _equal_tree(loaded.params, JCodec.from_pretrained(tmp_path / "jax").params)


def test_reader_and_writer_agree_with_safetensors(tmp_path):
    """The port's reader reads ``safetensors.torch``'s files in every dtype
    the checkpoints use, and ``safetensors.torch`` reads the port's."""
    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "f16": torch.randn(7, generator=g).to(torch.float16),
        "f32": torch.randn(2, 3, 4, generator=g),
        "i8": torch.randint(-128, 128, (9,), dtype=torch.int8, generator=g),
        "i64": torch.arange(5),
        "u16": torch.arange(6, dtype=torch.int32).to(torch.uint16),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }
    st_save_file(tensors, str(tmp_path / "theirs.safetensors"), metadata={"format": "pt"})
    ours = SafetensorsFile(tmp_path / "theirs.safetensors")
    assert set(ours) == set(tensors) and ours.metadata == {"format": "pt"}
    save_safetensors(tensors, tmp_path / "ours.safetensors", metadata={"format": "pt"})
    theirs = st_load_file(str(tmp_path / "ours.safetensors"))
    for name, t in tensors.items():
        for got in (ours[name], theirs[name]):
            assert got.dtype == t.dtype and got.shape == t.shape
            bits = torch.int16 if t.dtype == torch.uint16 else t.dtype  # no uint16 compare
            assert torch.equal(got.view(bits), t.view(bits)), name
    assert dict(load_safetensors_dir(tmp_path)).keys() == tensors.keys()


def test_missing_paths_raise(tmp_path):
    for fn in (tck.load_delay_checkpoint, tck.load_local_checkpoint,
               tck.load_realtime_checkpoint, load_model, MossAudioTokenizer.from_pretrained):
        with pytest.raises(FileNotFoundError):
            fn(tmp_path / "no-such-dir", device="cpu")
    with pytest.raises(FileNotFoundError):
        load_safetensors_dir(tmp_path)  # a directory with no shard
