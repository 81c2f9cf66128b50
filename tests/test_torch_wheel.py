"""The port's kernel sources in an installed package, and where its kernels
are built.

A wheel built from the tree carries every ``mosstts_tpu_torch/csrc`` source;
installed outside a checkout, the package builds its kernels into a per-user
cache directory (or ``$MOSSTTS_TORCH_BUILD_DIR``); a build with no ``.cu``
source raises before it calls ``nvcc``. The wheel is built with the
installed setuptools, offline (``--no-build-isolation --no-index``), from a
copy of the tree in a temporary directory, so the tree gets no build files.
"""
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from mosstts_tpu_torch.ops.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
CSRC = sorted(p.name for p in (ROOT / "mosstts_tpu_torch" / "csrc").iterdir()
              if p.suffix in (".cu", ".cuh"))


def _run(cmd, **kw):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, **kw)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, src / name)
    for pkg in ("mosstts_tpu", "mosstts_tpu_torch"):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=shutil.ignore_patterns("__pycache__"))
    _run([sys.executable, "-m", "pip", "wheel", "--no-build-isolation", "--no-deps",
          "--no-index", "-q", str(src), "-w", str(tmp / "dist")])
    (whl,) = (tmp / "dist").glob("*.whl")
    return whl


def test_wheel_carries_every_kernel_source(wheel):
    assert CSRC and any(n.endswith(".cu") for n in CSRC)
    names = zipfile.ZipFile(wheel).namelist()
    got = sorted(n.rsplit("/", 1)[1] for n in names if n.startswith("mosstts_tpu_torch/csrc/"))
    assert got == CSRC


def test_wheel_carries_the_training_modules(wheel):
    names = set(zipfile.ZipFile(wheel).namelist())
    want = {f"mosstts_tpu_torch/{m}.py" for m in (
        "train/__init__", "train/trainer", "train/optim", "train/checkpoint", "train/data",
        "codec/losses", "codec/discriminator", "codec/train", "codec/speech_synth")}
    assert want <= names, sorted(want - names)


def test_installed_package_builds_into_a_user_cache(wheel, tmp_path):
    site = tmp_path / "site"
    _run([sys.executable, "-m", "pip", "install", "--no-deps", "--no-index", "-q",
          "--target", str(site), str(wheel)])
    probe = ("from mosstts_tpu_torch.ops.kernels import _build\n"
             "print(_build.build_root())\n"
             "print(len([f for f in _build._sources() if f.suffix == '.cu']))\n")
    env = {k: v for k, v in os.environ.items() if k != _build.BUILD_ENV}
    env.update(PYTHONPATH=str(site), XDG_CACHE_HOME=str(tmp_path / "cache"))
    out = _run([sys.executable, "-c", probe], cwd=tmp_path, env=env).split()
    assert out == [str(tmp_path / "cache" / "mosstts_tpu_torch"),
                   str(sum(n.endswith(".cu") for n in CSRC))]
    env[_build.BUILD_ENV] = str(tmp_path / "kernels")
    out = _run([sys.executable, "-c", probe], cwd=tmp_path, env=env).split()
    assert out[0] == str(tmp_path / "kernels")


def test_checkout_builds_under_its_build_dir(monkeypatch):
    monkeypatch.delenv(_build.BUILD_ENV, raising=False)
    assert _build.build_root() == ROOT / "build"
    assert _build.library_path().parent.parent == ROOT / "build"


def test_build_raises_without_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / "build"))
    (tmp_path / "only.cuh").write_text("// a header alone builds nothing\n")
    with pytest.raises(RuntimeError, match="no CUDA sources"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_wheel_carries_the_tokenizer_fixture(wheel):
    """``tools/tokenizer_fixture.py`` writes a tokenizer directory from the
    committed core beside it, and the smoke reads the expected ids there."""
    names = set(zipfile.ZipFile(wheel).namelist())
    assert {f"mosstts_tpu_torch/tools/tokenizer_fixture_{n}.json"
            for n in ("core", "expected")} <= names
