"""Build and load the CUDA kernels in ``ops/csrc`` (and, through
``compile_libraries``, the host library of ``native/``).

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

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Counter, Dict, Iterable, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("sncv.cu", "dscv.cu", "mark.cu", "glue.cu", "glue_backward.cu",
           "glue_v1.cu", "conv_epilogue.cu")
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


def library_path(source: str, src_dir: Path = CSRC_DIR,
                 flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Where the library built from ``src_dir/<source>`` with ``flags``
    lives."""
    src = src_dir / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every listed ``csrc`` source whose library is missing, one
    ``nvcc`` per source, all started together. The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``_build/<stem>.log``.

    Raises ``RuntimeError`` naming each source that failed to build.
    """
    return compile_libraries(sources, CSRC_DIR, nvcc, NVCC_FLAGS,
                             "CUDA kernel")


def compile_libraries(sources: Iterable[str], src_dir: Path,
                      compiler: Callable[[], str], flags: Sequence[str],
                      what: str) -> Dict[str, Path]:
    """Compile each of ``sources`` (in ``src_dir``) whose library is
    missing into ``BUILD_DIR`` with ``compiler()`` and ``flags``, under the
    build lock, all started together; keep each compiler's output in
    ``<stem>.log``. Raises ``RuntimeError`` ("<what> build failed"), with
    each failing source's compiler output."""
    libs = {s: library_path(s, src_dir, flags) for s in sources}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s, p in libs.items() if not p.exists()]
        if not todo:
            return libs
        cc = compiler()
        name = Path(cc).name
        procs = {}
        for s in todo:
            tmp = libs[s].with_suffix(".so.tmp")
            procs[s] = (subprocess.Popen(
                [cc, *flags, "-o", str(tmp), str(src_dir / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp)
        failures = []
        for s, (proc, tmp) in procs.items():
            try:
                out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                failures.append(f"{s}: {name} timed out\n{out}")
                continue
            (BUILD_DIR / f"{Path(s).stem}.log").write_text(out)
            if proc.returncode != 0:
                failures.append(f"{s}: {name} exited {proc.returncode}\n"
                                f"{out}")
            else:
                os.replace(tmp, libs[s])
        if failures:
            raise RuntimeError(f"{what} build failed:\n"
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


# the Counters of the CUDA-graph captures in progress, innermost last; a
# capture's backward launches from autograd's device thread, so every
# thread records into them
_recording: list = []


@contextlib.contextmanager
def recording_launches():
    """Count the launches captured into a CUDA graph in the block (onto a
    capturing stream, from any thread) into the ``Counter`` it yields
    (kernel -> launches), and not into the kernels' ``launches``: a
    captured kernel runs only when the graph is replayed
    (``add_launches``)."""
    counts: Counter = collections.Counter()
    _recording.append(counts)
    try:
        yield counts
    finally:
        # by identity: two open recordings may hold equal counts
        del _recording[next(i for i, c in enumerate(_recording)
                            if c is counts)]


def add_launches(counts: Counter) -> None:
    """Add a recorded capture's counts to its kernels' ``launches``: one
    replay of the graph."""
    for kernel, n in counts.items():
        kernel.launches += n


class CudaKernel:
    """One C entry point of a ``csrc`` source, built and loaded at first
    launch.

    ``launches`` counts the kernel's runs on the device: one for each
    successful launch through :meth:`launch` outside a CUDA graph's
    capture, and for each replay of a graph the launches its capture
    recorded (``recording_launches``, ``add_launches``); a capture itself
    adds none.
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

    def launch(self, *args, device) -> None:
        """Call the entry point with ``device`` (the inputs' CUDA device) as
        the current one: the C side launches on the current device, so a
        launch on tensors of another device would run on the wrong one.
        Raise if it reports a CUDA error."""
        import torch

        with torch.cuda.device(device):
            err = self._load()(*args)
            captured = torch.cuda.is_current_stream_capturing()
        if err != 0:
            msg = self._errstr(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        if not captured:
            self.launches += 1
        elif _recording:
            _recording[-1][self] += 1
