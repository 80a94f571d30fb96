"""Build the CUDA kernels and bind them with ctypes.

Each source in `csrc/` becomes its own shared library with a plain C
interface: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``. All missing libraries build at once, one nvcc process
per source, into ``build/kernels/`` at the repository root (listed in
`.gitignore`). A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and never confused with an old one.
Nothing is built at import time: the first wrapper call on a CUDA tensor
(or an explicit `build_all()`) triggers it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("field.cu", "curve.cu", "msm.cu", "msm_chunked.cu", "hash.cu")
HEADERS = ("mont.cuh", "fold.cuh", "msm_table.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict = {}
_FNS: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def lib_path(src: str) -> Path:
    h = hashlib.sha256()
    for name in (src,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_log(src: str) -> str:
    """nvcc's output (with `-Xptxas -v` register and spill counts)."""
    log = lib_path(src).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(sources=SOURCES) -> list:
    """Compile every library that is missing, all nvcc processes at once.
    Returns the sources that were built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    jobs = []
    for src in sources:
        out = lib_path(src)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=log, stderr=subprocess.STDOUT,
        )
        jobs.append((src, proc, tmp, out, log))
    failed = []
    for src, proc, tmp, out, log in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{src} (nvcc exit {rc}):\n{build_log(src)}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return [j[0] for j in jobs]


def function(src: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function `name` of `src`'s library (built on first use)."""
    with _LOCK:
        fn = _FNS.get((src, name))
        if fn is None:
            lib = _LIBS.get(src)
            if lib is None:
                if not lib_path(src).exists():
                    build_all()
                lib = ctypes.CDLL(str(lib_path(src)))
                _LIBS[src] = lib
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[(src, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero `cudaGetLastError()` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
