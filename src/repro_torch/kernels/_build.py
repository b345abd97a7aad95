"""Build the CUDA kernels into one shared library and load it with ctypes.

Every ``csrc/*.cu`` file exposes a plain C interface (no PyTorch headers),
so ``nvcc`` compiles each in seconds.  At first use the sources are
compiled in parallel, one ``nvcc`` per file, and linked into
``build/repro_torch/libkernels.so`` at the root of the checkout.  The
library is rebuilt when the hash of the sources or the flags changes; a
file lock keeps concurrent processes from building over each other.  The
compiler's output, register and shared-memory use included
(``-Xptxas -v``), is kept in ``build/repro_torch/build.log``.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` fails only when a kernel is launched.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc") if home else None,
                  shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile and link the kernels if the sources changed; returns the
    path of the shared library.  Raises with the compiler's output when a
    source does not compile."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest(sources)
    so = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and stamp.exists() and stamp.read_text() == digest:
            return so
        nvcc = _nvcc()
        objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        log, failed = [], []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if not failed:
            tmp = BUILD_DIR / "libkernels.so.tmp"
            link = subprocess.run(
                [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode:
                failed.append("link")
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                               + "\n".join(log))
        os.replace(tmp, so)
        stamp.write_text(digest)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        loaded.dmath_error_string.argtypes = [ctypes.c_int]
        loaded.dmath_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def function(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry of the library with its argument types declared (every
    pointer and the stream as ``c_void_p``: ctypes would otherwise pass a
    Python int as a 32-bit C int and cut the pointer).  Every entry
    returns the launch's ``cudaGetLastError()``."""
    fn = getattr(lib(), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib().dmath_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} ({msg})")
