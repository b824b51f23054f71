"""Build-at-first-use for the CUDA sources under ``csrc/``.

``load(name, sources)`` compiles the named ``.cu`` files with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and returns
it as a ``ctypes.CDLL``.  The library file is keyed by a hash of the
sources and the flags, so a changed source rebuilds and an unchanged one
is reused.  Nothing here runs at import time: a machine without ``nvcc``
can import every module of the package; it only cannot launch a kernel.

The build directory is ``build/repro_torch/`` at the repository root.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
build_seconds: dict = {}      # name -> seconds nvcc took (0.0 when reused)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled at first use and need the CUDA toolkit")


def load(name: str, sources) -> ctypes.CDLL:
    """Compile (if needed) and load ``lib<name>-<hash>.so``."""
    if name in _LIBS:
        return _LIBS[name]
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.read_bytes())
    out = build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"
    build_seconds[name] = 0.0
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
