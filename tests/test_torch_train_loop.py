"""The port's ``TTSTrainer`` against the JAX package's on the CPU, and its
resumable train state.

Per family (``tests/test_tts_trainer.py``'s tiny configs, float32, the JAX
trainer's initial weights through ``utils.convert``, JAX at full matmul
precision): four steps on four numpy batches give each step's loss and
gradient norm within rtol 1e-4, and parameters within ||d|| / ||p|| 1e-5
(not element by element: where a gradient is near 0, Adam's update nears
+-lr and its sign can differ between the packages).
``use_async`` writes the same files as a plain save, and either restores
the state bit for bit (``tests/test_torch_train_serve.py`` holds a resume
against an uninterrupted run).
"""
import json

import jax
import numpy as np
import pytest
import torch

from mosstts_tpu.train.trainer import TTSTrainer as JTrainer
from mosstts_tpu_torch.train import checkpoint as tck
from mosstts_tpu_torch.train.trainer import TTSTrainer, synthetic_tts_batch, tiny_config
from mosstts_tpu_torch.utils.convert import flatten_tree, load_tree_

from test_torch_train import FAMILIES, jax_config, jax_numerics, one_thread  # noqa: F401

OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=10)


def batches(family, n=4, seed=21):
    rng = np.random.default_rng(seed)
    return [synthetic_tts_batch(family, tiny_config(family), rng, batch=2, seq=16)
            for _ in range(n)]


def rel_gap(params, tree) -> float:
    flat = flatten_tree(jax.device_get(tree))
    num = den = 0.0
    for name, p in params.named_parameters():
        ref = np.asarray(flat[name], np.float64)
        num += float(((p.detach().double().numpy() - ref) ** 2).sum())
        den += float((ref ** 2).sum())
    return (num / den) ** 0.5


@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_matches_jax(family):
    jt = JTrainer(family, jax_config(family), **OPT)
    tt = TTSTrainer(family, tiny_config(family), device="cpu", **OPT)
    load_tree_(tt.params, jax.device_get(jt.params))
    assert all(p.requires_grad for p in tt.params.parameters())
    for b in batches(family):
        j, t = jt.train_step(b), tt.train_step(b)
        assert t["step"] == j["step"]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
    assert rel_gap(tt.params, jt.params) <= 1e-5
    assert [h["step"] for h in tt.history] == [0, 1, 2, 3]


def same_state(a: TTSTrainer, b: TTSTrainer) -> bool:
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    params = all(torch.equal(x, y) for x, y in zip(a.params.parameters(), b.params.parameters()))
    moments = all(torch.equal(sa[k][n], sb[k][n]) for k in ("mu", "nu") for n in sa[k])
    return params and moments and sa["count"] == sb["count"] and a.step_idx == b.step_idx


def test_async_save_writes_the_same_files(tmp_path):
    tr = TTSTrainer("realtime", tiny_config("realtime"), device="cpu", **OPT)
    tr.train_step(batches("realtime", n=1)[0])
    tr.save_state(tmp_path / "sync").wait_until_finished()
    handle = tr.save_state(tmp_path / "async", use_async=True)
    handle.wait_until_finished()
    names = sorted(p.name for p in (tmp_path / "sync").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "async").iterdir()) == [
        tck.STATE_FILE, tck.META_FILE]
    assert ((tmp_path / "sync" / tck.META_FILE).read_text()
            == (tmp_path / "async" / tck.META_FILE).read_text())
    a, b = (torch.load(tmp_path / d / tck.STATE_FILE, weights_only=True) for d in ("sync", "async"))
    assert a["step"] == b["step"] == 1
    for key in ("params",):
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key])
    for key in ("mu", "nu"):
        assert all(torch.equal(a["opt_state"][key][n], b["opt_state"][key][n])
                   for n in a["opt_state"][key])
    back = TTSTrainer("realtime", tiny_config("realtime"), seed=9, device="cpu", **OPT)
    back.restore_state(tmp_path / "async")
    assert same_state(back, tr)


def test_parallel_options_raise():
    """``mesh=`` and ``pipeline=`` are ported (``tests/test_torch_parallel_*.py``
    run them); what JAX refuses the port refuses: ``pipeline=`` outside the
    Delay family, and both options at once."""
    with pytest.raises(ValueError, match="delay"):
        TTSTrainer("local", tiny_config("local"), device="cpu", pipeline=object())
    with pytest.raises(ValueError, match="not both"):
        TTSTrainer("delay", tiny_config("delay"), device="cpu", mesh=object(), pipeline=object())
