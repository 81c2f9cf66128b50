"""Build and load the hand-written CUDA kernels of ``mosstts_tpu_torch``.

Every ``*.cu`` file under ``mosstts_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process for Hopper (``sm_90a``), all started together, and the
objects are linked into one shared library with a plain C interface, loaded
with ``ctypes``. Nothing here runs at import: ``ctypes`` is imported
and ``nvcc`` is called on the first CUDA launch, so the package imports on a
machine with no CUDA toolkit.

The library lands in ``<build root>/kernels-<hash>/``, the hash covering the
sources and the flags, so a second process reuses it and a changed source
rebuilds. The build root (``build_root``) is ``$MOSSTTS_TORCH_BUILD_DIR``
when set, else ``build/`` at the root of the checkout the package lies in,
else (an installed package, whose wheel carries ``csrc/``) a per-user cache
directory, ``$XDG_CACHE_HOME/mosstts_tpu_torch`` or
``~/.cache/mosstts_tpu_torch``. ``ptxas`` reports each kernel's registers, shared
memory and spills (``-Xptxas -v``) into ``ptxas.log`` beside it;
``ptxas_report`` reads them back.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_ENV = "MOSSTTS_TORCH_BUILD_DIR"
LIB_NAME = "libmosstts_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
PTXAS_LOG = "ptxas.log"

_lib = None


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME or /usr/local/cuda): "
        "the CUDA kernels cannot be built")


def build_root() -> Path:
    """Where the kernel libraries are built (the module docstring says how
    it is chosen)."""
    if os.environ.get(BUILD_ENV):
        return Path(os.environ[BUILD_ENV])
    if (_PKG_DIR.parent / "pyproject.toml").is_file():  # a checkout
        return _PKG_DIR.parent / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "mosstts_tpu_torch"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_root() / f"kernels-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the kernels unless a library built from the same sources and
    flags exists; return its path. Raises if ``SRC_DIR`` holds no ``.cu``
    source (an installation without the package's ``csrc/`` data)."""
    cu = [f for f in _sources() if f.suffix == ".cu"]
    if not cu:
        raise RuntimeError(f"no CUDA sources (*.cu) under {SRC_DIR}: the package was installed "
                           "without its csrc/ files, so its kernels cannot be built")
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs, procs = [], []
    for src in cu:
        obj = path.with_name(f"{src.stem}.{pid}.o")  # nvcc reads the type off the suffix
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objs.append(str(obj))
    failed, logs = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        logs.append(f"== {Path(cmd[-1]).name}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    path.with_name(PTXAS_LOG).write_text("".join(logs))
    tmp = path.with_name(f"tmp.{pid}.{LIB_NAME}")
    cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def ptxas_report() -> list[dict]:
    """Per kernel of the built library: its mangled ``name``, ``registers``,
    static ``smem`` bytes (dynamic shared memory is set at launch),
    ``stack``, ``spill_stores`` and ``spill_loads`` bytes, as ``ptxas -v``
    printed them at the build."""
    log = library_path().with_name(PTXAS_LOG)
    rows, cur = [], None
    for line in log.read_text().splitlines() if log.exists() else ():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(name=m.group(1))
            rows.append(cur)
        elif cur is not None and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return rows


def kernel(name: str, argtypes: list):
    """The C entry point ``name`` of the kernel library, with its ctypes
    argument types set (``c_void_p`` for pointers and the stream)."""
    global _lib
    import ctypes

    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    fn = getattr(_lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
