"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
for ``sm_90a``, into ``build/repro_torch_kernels/lib<name>-<digest>.so`` at
the root of the checkout, where ``<digest>`` hashes the source and the
flags: an edited source builds anew, an unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for every one of them.  Nothing here runs at import time; the
wrappers call :func:`load_function` at their first launch on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "load_function"]

CSRC = Path(__file__).resolve().parent / "csrc"
# <checkout>/build/repro_torch_kernels (this file is
# <checkout>/src/repro_torch/kernels/build.py); listed in .gitignore
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("momentum", "gossip_mix", "sign_compress", "qsgd_quant",
           "topk_select", "row_gather")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Bound C functions by (source, symbol).  A shared object is process-wide
# once dlopen'ed, so this cache is too; the lock makes first use from two
# threads build and load once.
_FUNCS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): cannot build the port's kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: compiler output}``
    for the sources built (``-Xptxas -v`` reports registers and spills);
    raises with the compiler's output if any build fails."""
    todo = [(n, _library(n)) for n in names if not _library(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, lib in todo:
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)      # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_function(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<name>.cu``, building the
    library first if needed, with ``argtypes`` declared and an ``int``
    (a ``cudaError_t``) result."""
    with _LOCK:
        fn = _FUNCS.get((name, symbol))
        if fn is None:
            build((name,))
            fn = getattr(ctypes.CDLL(str(_library(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[(name, symbol)] = fn
    return fn
