"""Build and load the CUDA kernels in ``ops/csrc``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first
use with ``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``m4depth_tpu_torch/_build/``, then loaded with ``ctypes``. Pointers go in
as ``c_void_p`` and the stream as PyTorch's current stream, and every C
entry point returns ``cudaGetLastError()``.

A library's file name carries a hash of its source and flags, so an edited
source is never run from a stale binary. An exclusive file lock serialises
concurrent builds (several processes importing at once). Nothing here
falls back: a missing compiler, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("sncv.cu", "dscv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME); the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every listed source whose library is missing, one ``nvcc``
    per source, all started together. The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept in ``_build/<stem>.log``.

    Raises ``RuntimeError`` naming each source that failed to build.
    """
    libs = {s: library_path(s) for s in sources}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s, p in libs.items() if not p.exists()]
        if not todo:
            return libs
        compiler = nvcc()
        procs = {}
        for s in todo:
            tmp = libs[s].with_suffix(".so.tmp")
            procs[s] = (subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp)
        failures = []
        for s, (proc, tmp) in procs.items():
            try:
                out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                failures.append(f"{s}: nvcc timed out\n{out}")
                continue
            (BUILD_DIR / f"{Path(s).stem}.log").write_text(out)
            if proc.returncode != 0:
                failures.append(f"{s}: nvcc exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, libs[s])
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failures))
    return libs


def check_kernel_inputs(name: str, tensors, dtypes, device) -> None:
    """Raise unless every tensor lies on ``device`` (a CUDA device), has one
    of ``dtypes`` and is contiguous: what a kernel's pointers may carry."""
    for t in tensors:
        if device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: inputs must all lie on one CUDA "
                             f"device or all on the CPU, got {t.device} "
                             f"and {device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


class CudaKernel:
    """One C entry point of a ``csrc`` source, built and loaded at first
    launch.

    ``launches`` grows by one for each successful launch through
    :meth:`launch`, and nowhere else.
    """

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._errstr = None

    def _load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            errstr = getattr(lib, f"{Path(self.source).stem}_error_string")
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; raise if it reports a CUDA error."""
        err = self._load()(*args)
        if err != 0:
            msg = self._errstr(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
