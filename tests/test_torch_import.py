"""Every module of ``mosstts_tpu_torch`` imports with ``jax``, ``triton``
and the JAX package ``mosstts_tpu`` blocked, and importing touches neither
CUDA nor the kernel build: the port must run on a machine with no JAX, keeps
its own copies of what it needs from the JAX package, and the CPU tests must
import it with no CUDA toolkit. (``tests/test_import_hermetic.py`` covers
``mosstts_tpu``.) The port's entry points default to the card.
"""
import ast
import subprocess
import sys
from pathlib import Path

CODE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any import of jax (direct or indirect) raises
sys.modules["triton"] = None
sys.modules["mosstts_tpu"] = None  # nor of the JAX package, even its JAX-free modules
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
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "triton", "mosstts_tpu")
                and sys.modules[m] is not None)
print("MODULES", len(names))
print("NAMES", ",".join(names))
print("BAD", bad)
print("LEAKED", leaked)
print("CUDA_INIT", torch.cuda.is_initialized())
print("LIB", _build._lib)
sys.exit(1 if bad or leaked or torch.cuda.is_initialized() or _build._lib is not None else 0)
"""


SMOKE = r"""
import sys
sys.modules["jax"] = None
sys.modules["triton"] = None
sys.modules["mosstts_tpu"] = None
import torch
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "triton", "mosstts_tpu")
                and sys.modules[m] is not None)
print("LEAKED", leaked)
sys.exit(1 if leaked or torch.cuda.is_initialized() else 0)
"""

REPO = Path(__file__).resolve().parent.parent


def _run(code: str) -> subprocess.CompletedProcess:
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


def test_chip_smoke_imports_without_jax():
    """The card machine has no JAX: the smoke script's imports must not
    reach it or the JAX package, and importing the script runs nothing."""
    proc = _run(SMOKE)
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
    assert not roots & {"mosstts_tpu", "jax", "jaxlib", "triton"}, roots


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


def test_entry_points_default_to_the_card():
    """Nothing runs on the CPU unless the caller asks: the port's entry points
    default to ``device="cuda"``, and ``DelayBatchServer`` has no device of
    its own (it runs where its params live)."""
    import inspect

    from mosstts_tpu_torch.codec.model import MossAudioTokenizer
    from mosstts_tpu_torch.engine.batch_server import DelayBatchServer
    from mosstts_tpu_torch.engine.delay_engine import DelayEngine
    from mosstts_tpu_torch.serve.pipelines import demo_backend

    for fn in (DelayEngine.random_init, demo_backend, MossAudioTokenizer.random_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    assert "device" not in inspect.signature(DelayBatchServer).parameters
