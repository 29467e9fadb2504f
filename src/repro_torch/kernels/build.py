"""Builds and loads the port's CUDA kernels.

Each source under ``csrc/`` is compiled on its own by ``nvcc`` into a
shared library with a plain C interface, in ``build/repro_torch/`` at the
root of the checkout, and loaded with ``ctypes``.  A library's name
carries a hash of its source and of the flags, so an edited source is
rebuilt.  Nothing is compiled when a module is imported: a wrapper calls
``load`` at its first launch, and ``build`` compiles several sources at
once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# No --use_fast_math: sqrtf and division stay IEEE-correct, so a kernel's
# result can match its plain version bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

THREADS = 256        # kThreads in every source
MAX_BLOCKS = 4096    # grid cap; the grid is a function of the size only


def grid_blocks(n: int) -> int:
    """Blocks of a grid-stride launch over n items: fixed by n alone, so a
    two-pass reduction sums in the same order on every run."""
    return max(1, min(-(-n // THREADS), MAX_BLOCKS))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(*sources: Path) -> Dict[str, str]:
    """Compile every source not built yet, all ``nvcc`` processes started
    together.  Returns each compiled source's resource report
    (``-Xptxas -v``) by file name; a source already built is left out."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        running[source] = (cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports, failed = {}, []
    for source, (cmd, tmp, out, proc) in running.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"building {source.name} failed "
                          f"({' '.join(cmd)}):\n{err}")
            continue
        os.replace(tmp, out)    # atomic: a concurrent loader sees all or none
        reports[source.name] = err
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(source: Path, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build ``source`` if needed and bind its C entry points:
    ``signatures`` maps each function name to its ctypes argument types.
    Every entry point returns ``cudaGetLastError()`` as an int."""
    build(source)
    lib = ctypes.CDLL(str(library_path(source)))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
