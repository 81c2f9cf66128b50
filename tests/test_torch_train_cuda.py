"""Training on the card where it differs from the CPU: bf16 heads. They skip
without a card.

``torch.bmm(..., out_dtype=torch.float32)``, the product the bf16 audio
heads take on the card when serving, has no derivative; where autograd
records the product, ``models/delay._audio_head_logits`` takes the float32
product instead, so a bf16 Delay model's loss has gradients on the card,
and its loss and audio heads' gradient agree with the same bf16 model's on
the CPU (which always takes the float32 product) to bf16 rounding.

This file imports no JAX, so it runs on the machine with the card:

    python3 -m pytest --noconftest tests/test_torch_train_cuda.py -q
"""
import copy

import numpy as np
import pytest
import torch

from mosstts_tpu_torch.models.delay import _audio_head_logits, delay_loss, init_delay_params
from mosstts_tpu_torch.train.optim import value_and_grad
from mosstts_tpu_torch.train.trainer import synthetic_tts_batch, tiny_config

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


def test_bmm_out_dtype_has_no_derivative_and_training_does_not_take_it():
    _need_card()
    x = torch.randn(6, 64, dtype=torch.bfloat16, device="cuda")
    heads = torch.randn(4, 64, 32, dtype=torch.bfloat16, device="cuda")
    a = x.requires_grad_(True)
    out = torch.bmm(a.expand(4, 6, 64), heads, out_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="derivative"):
        out.sum().backward()
    logits = _audio_head_logits(a.reshape(1, 6, 64), heads)
    (g,) = torch.autograd.grad(logits.sum(), a)
    want = torch.matmul(a.detach().float(), heads.float()).permute(1, 0, 2).reshape(1, 6, 4, 32)
    # the float32 product; cuBLAS may sum in another order with and without
    # autograd recording
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_bf16_delay_loss_has_card_gradients():
    _need_card()
    cfg = tiny_config("delay")
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = init_delay_params(cfg, generator=gen, dtype=torch.bfloat16, device="cuda")
    cpu = copy.deepcopy(card).to("cpu")
    b = synthetic_tts_batch("delay", cfg, np.random.default_rng(0), batch=2, seq=16)

    def run(params, dev):
        t = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        return value_and_grad(params, lambda p: delay_loss(
            p, cfg, t["input_ids"], t["attention_mask"], t["labels"]))

    loss, _, grads = run(card, "cuda")
    ref_loss, _, ref = run(cpu, "cpu")
    assert all(torch.isfinite(g.float()).all() for g in grads.values())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-2)
    got, want = grads["audio_heads"].float().cpu(), ref["audio_heads"].float()
    assert float((got - want).norm() / want.norm()) < 5e-2
