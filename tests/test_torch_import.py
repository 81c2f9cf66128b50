"""Every module of ``mosstts_tpu_torch`` imports with ``jax``, ``triton``,
the JAX package ``mosstts_tpu`` and the text-tokenizer packages
(``transformers``, ``tokenizers``, ``regex``, ``jinja2``) blocked, and
importing touches neither CUDA nor the kernel build: the port must run on a
machine with no JAX and needs none of those packages, keeps its own copies of
what it needs from the JAX package, and the CPU tests must import it with
no CUDA toolkit; with them blocked it still reads a checkpoint's
``tokenizer.json``. (``tests/test_import_hermetic.py`` covers
``mosstts_tpu``.) The port's entry points default to the card.
"""
import ast
import subprocess
import sys
from pathlib import Path

BLOCKED = ("jax", "jaxlib", "triton", "mosstts_tpu", "optax", "orbax", "transformers",
           "tokenizers", "regex", "jinja2")

BLOCK = r"""
import sys
sys.modules["jax"] = None      # any import of jax (direct or indirect) raises
sys.modules["triton"] = None
sys.modules["mosstts_tpu"] = None  # nor of the JAX package, even its JAX-free modules
sys.modules["optax"] = None    # nor JAX's optimizer and checkpoint libraries
sys.modules["orbax"] = None
sys.modules["gradio"] = None   # the Gradio demos import it only when a UI is built
for name in ("transformers", "tokenizers", "regex", "jinja2"):  # the port needs none of them
    sys.modules[name] = None
"""

CODE = BLOCK + r"""
import importlib, pkgutil
import torch
import mosstts_tpu_torch
bad = []
names = [m.name for m in pkgutil.walk_packages(mosstts_tpu_torch.__path__, "mosstts_tpu_torch.")]
for name in names:
    try:
        importlib.import_module(name)
    except Exception as e:
        bad.append(f"{name}: {type(e).__name__}: {e}")
from mosstts_tpu_torch.ops.kernels import _build
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print("MODULES", len(names))
print("NAMES", ",".join(names))
print("BAD", bad)
print("LEAKED", leaked)
print("CUDA_INIT", torch.cuda.is_initialized())
print("DIST_INIT", torch.distributed.is_initialized())
print("LIB", _build._lib)
sys.exit(1 if bad or leaked or torch.cuda.is_initialized() or torch.distributed.is_initialized()
         or _build._lib is not None else 0)
"""


SMOKE = BLOCK + r"""
import torch
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print("LEAKED", leaked)
sys.exit(1 if leaked or torch.cuda.is_initialized() else 0)
"""

TOKENIZER = BLOCK + r"""
import tempfile
from mosstts_tpu_torch.processing.bpe import Qwen2BPETokenizer
from mosstts_tpu_torch.processing.tokenizer import load_tokenizer
from mosstts_tpu_torch.tools.tokenizer_fixture import load_expected, write_tokenizer_dir
with tempfile.TemporaryDirectory() as d:
    tok = load_tokenizer(str(write_tokenizer_dir(d)))
assert type(tok) is Qwen2BPETokenizer, type(tok)
for e in load_expected()["texts"]:
    assert tok.encode(e["text"]) == e["ids"], e["text"]
    assert tok.decode(e["ids"]) == e["decode"], e["text"]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print("LEAKED", leaked)
sys.exit(1 if leaked else 0)
"""

REPO = Path(__file__).resolve().parent.parent


def _run(code: str) -> subprocess.CompletedProcess:
    code = f"BLOCKED = {BLOCKED!r}\n" + code
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_without_jax_triton_or_cuda():
    proc = _run(CODE)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split("MODULES ")[1].split()[0])
    assert n_modules >= 20  # the walk really found the package
    names = set(proc.stdout.split("NAMES ")[1].split()[0].split(","))
    # the int8-weight slice: quantization, the GEMM wrappers, the two tools
    assert {"mosstts_tpu_torch.ops.quant", "mosstts_tpu_torch.ops.kernels.w8_gemm",
            "mosstts_tpu_torch.tools.tune_mm8", "mosstts_tpu_torch.tools.probe_int4",
            "mosstts_tpu_torch.tools.bf16_path"} <= names
    # the serving front end: pool, backend, HTTP server, CLI, Gradio demos and
    # their helpers
    assert {f"mosstts_tpu_torch.{m}" for m in (
        "serve.pool", "serve.backend", "serve.http_server", "serve.cli", "serve.web_player",
        "serve.gradio_apps", "serve.text_norm", "engine.metrics", "utils.native")} <= names
    # the Realtime family: model, processor, engine, server, streaming layer
    assert {f"mosstts_tpu_torch.{m}" for m in (
        "models.realtime", "processing.realtime_processor", "engine.realtime_engine",
        "engine.realtime_batch_server", "engine.streaming")} <= names
    # checkpoints, and the Local family: model, processor, engine, server;
    # the servers' shared polling core
    assert {f"mosstts_tpu_torch.{m}" for m in (
        "utils.hf_loader", "utils.checkpoints", "utils.save", "tools.hf_checkpoint",
        "models.local", "processing.local_processor", "engine.local_engine",
        "engine.local_batch_server", "engine.polling")} <= names
    # training: the TTS trainer, its optimizers, train state and data; the
    # codec's losses, discriminators, trainer and synthetic speech
    assert {f"mosstts_tpu_torch.{m}" for m in (
        "train", "train.trainer", "train.optim", "train.checkpoint", "train.data",
        "codec.losses", "codec.discriminator", "codec.train", "codec.speech_synth")} <= names
    # parallelism: the mesh, the collectives, the pipeline and ring attention
    # (importing them makes no process group)
    assert {f"mosstts_tpu_torch.{m}" for m in (
        "parallel.mesh", "ops.collectives", "parallel.pipeline", "parallel.ring_attn")} <= names


def test_chip_smoke_imports_without_jax():
    """The card machine has no JAX: the smoke script's imports must not
    reach it or the JAX package, and importing the script runs nothing."""
    proc = _run(SMOKE)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_tokenizer_json_loads_without_the_tokenizer_packages():
    """The port depends on none of ``transformers``, ``tokenizers``,
    ``regex`` or ``jinja2``: with them blocked, its ``load_tokenizer`` reads
    the fixture's ``tokenizer.json`` and gives the committed ids and
    decodes."""
    proc = _run(TOKENIZER)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_only_torch_and_the_port():
    """The smoke script names no module of the JAX package, not even its
    JAX-free ones: it reaches configs, processor and tokenizer through the
    port (``mosstts_tpu_torch.core.config``, ``serve.pipelines.demo_backend``)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "mosstts_tpu_torch" in roots and "torch" in roots
    assert not roots & set(BLOCKED), roots


def test_profile_tool_refuses_to_run_without_a_gpu(monkeypatch):
    import pytest
    import torch

    from mosstts_tpu_torch.tools import profile_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="profiles a GPU"):
        profile_step.main(["--batch", "1"])


def test_gemm_tools_refuse_to_run_without_a_gpu(monkeypatch):
    """The ported ``tools/tune_mm8.py`` and ``tools/probe_int4.py`` time the
    card; without one they raise before making any input."""
    import pytest
    import torch

    from mosstts_tpu_torch.tools import probe_int4, tune_mm8

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (tune_mm8, probe_int4):
        with pytest.raises(RuntimeError, match="times a GPU"):
            tool.main([])


def test_bf16_path_tool_refuses_to_run_without_a_gpu(monkeypatch):
    """``tools/bf16_path.py`` times a checkout's bf16 path on the card;
    without one it raises before building anything."""
    import pytest
    import torch

    from mosstts_tpu_torch.tools import bf16_path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="times a GPU"):
        bf16_path.main(["--root", str(REPO)])


def test_kernel_times_tool_refuses_to_run_without_a_gpu(monkeypatch):
    """``tools/kernel_times.py`` times a checkout's kernels on the card;
    without one it raises before importing that checkout."""
    import pytest
    import torch

    from mosstts_tpu_torch.tools import kernel_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="times a GPU"):
        kernel_times.main(["--root", str(REPO)])


def test_entry_points_default_to_the_card():
    """Nothing runs on the CPU unless the caller asks: the port's entry points
    default to ``device="cuda"``, and ``DelayBatchServer`` has no device of
    its own (it runs where its params live)."""
    import inspect

    from mosstts_tpu_torch.codec.model import MossAudioTokenizer
    from mosstts_tpu_torch.codec.train import CodecTrainer
    from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
    from mosstts_tpu_torch.engine.delay_engine import DelayEngine
    from mosstts_tpu_torch.serve.pipelines import demo_backend
    from mosstts_tpu_torch.train.trainer import TTSTrainer

    for fn in (DelayEngine.random_init, demo_backend, MossAudioTokenizer.random_init,
               TTSTrainer, CodecTrainer):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    assert "device" not in inspect.signature(DelayBatchServer).parameters


def test_train_memory_tool_refuses_to_run_without_a_gpu(monkeypatch):
    """``tools/train_memory.py`` measures the card; without one it raises
    before it makes a trainer."""
    import pytest
    import torch

    from mosstts_tpu_torch.tools import train_memory

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="measures a GPU"):
        train_memory.main(["--family", "local"])


def test_ops_and_nn_import_nothing_above_them():
    """The layers below the models (``ops/``, ``nn/``) import nothing of
    ``parallel/``: the collectives the sharded forwards call live in
    ``ops/collectives.py``."""
    pkg = REPO / "mosstts_tpu_torch"
    for path in sorted((pkg / "ops").rglob("*.py")) + sorted((pkg / "nn").rglob("*.py")):
        for n in ast.walk(ast.parse(path.read_text())):
            if isinstance(n, ast.ImportFrom) and n.module:
                assert "parallel" not in n.module.split("."), (path, n.module)
