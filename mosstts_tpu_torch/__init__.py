"""mosstts-tpu-torch: the PyTorch / CUDA port of ``mosstts_tpu``.

Each module ``mosstts_tpu_torch/<path>.py`` ports ``mosstts_tpu/<path>.py``
and names the JAX function it ports. The package imports ``torch`` and
nothing of ``jax`` or ``mosstts_tpu``: it keeps its own copies of the JAX
package's JAX-free modules (configs, processor, tokenizer, delay pattern,
audio I/O). The TPU kernels' counterparts are hand-written CUDA kernels in
``csrc/``, built on the first CUDA launch by ``ops/kernels/_build.py``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
