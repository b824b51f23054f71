"""Build-at-first-use for the CUDA sources under ``csrc/``.

``load_all({name: sources, ...})`` compiles each library's ``.cu`` files
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, one ``nvcc`` per library, all started together, and returns
them as ``ctypes.CDLL`` objects by name.  A library file is keyed by a
hash of its sources, the headers (``*.cuh``) of ``csrc/`` and the flags,
so a changed source or header rebuilds and an unchanged one is reused.  ``build_logs`` keeps what ``nvcc`` printed for
each library built in this process (``-Xptxas -v``: every kernel's
registers, shared memory and spills).  Nothing here runs at import time: a machine
without ``nvcc`` can import every module of the package; it only cannot
launch a kernel.

A build that fails, and a launch that the card refuses, raise
``KernelError``; callers that fall back on other errors re-raise it.

The build directory is ``build/repro_torch/`` at the repository root.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel library of the package, one source each: the first launch
# of any kernel builds them all (``load_all(SOURCES)``), one nvcc each,
# started together
SOURCES = {"cutjoin": ("cutjoin.cu",), "trijoin": ("trijoin.cu",),
           "matreduce": ("matreduce.cu",), "bitset": ("bitset.cu",),
           "flashattn": ("flashattn.cu",),
           "flashattn_bwd": ("flashattn_bwd.cu",)}

_LIBS: dict = {}
build_seconds: dict = {}      # name -> seconds nvcc took (0.0 when reused)
build_logs: dict = {}         # name -> nvcc's output (built in this process)


class KernelError(RuntimeError):
    """A CUDA kernel of this package could not be built or launched."""


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
    raise KernelError("nvcc not found: the CUDA kernels of repro_torch are "
                      "compiled at first use and need the CUDA toolkit")


def _library(name: str, sources) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in (*sorted(p.name for p in CSRC.glob("*.cuh")), *sources):
        h.update((CSRC / s).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def sass_opcodes(name: str, pattern: str) -> dict | None:
    """The SASS instructions whose opcode matches ``pattern`` in each
    kernel of library ``name`` (built, from ``SOURCES``), counted by
    opcode: ``{mangled kernel: {opcode: count}}``, read with ``cuobjdump
    -sass``.  None where the toolkit has no ``cuobjdump``."""
    found = shutil.which("cuobjdump")
    if found is None:
        try:
            found = str(Path(_nvcc()).with_name("cuobjdump"))
        except KernelError:
            return None
        if not Path(found).exists():
            return None
    dump = subprocess.run([found, "-sass", str(_library(name, SOURCES[name]))],
                          capture_output=True, text=True, check=True).stdout
    out: dict = {}
    current = None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = out.setdefault(m[1], {})
            continue
        for op in re.findall(r"\b(" + pattern + r")\b", line):
            if current is not None:
                current[op] = current.get(op, 0) + 1
    return out


def load_all(specs: dict) -> dict:
    """Compile (where needed) and load every ``name -> sources`` library of
    ``specs``; the ``nvcc`` runs of the missing ones all start together."""
    todo = {}
    for name, sources in specs.items():
        if name in _LIBS:
            continue
        out = _library(name, sources)
        build_seconds[name] = 0.0
        if not out.exists():
            todo[name] = (out, [str(CSRC / s) for s in sources])
    if todo:
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for name, (out, paths) in todo.items():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *paths]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), cmd, tmp, out)
        failed = []
        for name, (proc, cmd, tmp, out) in procs.items():
            log = proc.communicate()[0]
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise KernelError("\n".join(failed))
    for name, sources in specs.items():
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_library(name, sources)))
    return {name: _LIBS[name] for name in specs}
