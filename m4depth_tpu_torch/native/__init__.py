"""The native host backproject: a multithreaded C++ bilinear warp and its
VJP (``backproject.cc``), loaded with ``ctypes``. Counterpart of
``m4depth_tpu/native``, with its API.

The library is compiled at first use with the host C++ compiler (``g++``)
into ``m4depth_tpu_torch/_build/`` by ``ops._build.compile_libraries`` (a
hash of source and flags in the file name, a file lock around the build).
Unlike the JAX loader, a failed build raises with the compiler's output:
there is no other path to fall back to. ``available()`` says only whether
a host compiler is there.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import Tuple

import numpy as np

from m4depth_tpu_torch.ops import _build

SRC_DIR = Path(__file__).resolve().parent
SOURCE = "backproject.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def cxx() -> str:
    """Path of the host C++ compiler (``g++`` on PATH)."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the native backproject "
                           "cannot be built")
    return found


def available() -> bool:
    """Whether a host C++ compiler is there to build the library."""
    return shutil.which("g++") is not None


class _Library:
    """The built library, loaded at first use."""

    def __init__(self):
        self._lib = None

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            path = _build.compile_libraries(
                [SOURCE], SRC_DIR, cxx, CXX_FLAGS, "native backproject")[
                    SOURCE]
            lib = ctypes.CDLL(str(path))
            fp = ctypes.POINTER(ctypes.c_float)
            lib.backproject_forward.argtypes = [fp] * 3 + [ctypes.c_int] * 5
            lib.backproject_forward.restype = None
            lib.backproject_backward.argtypes = ([fp] * 5
                                                 + [ctypes.c_int] * 5)
            lib.backproject_backward.restype = None
            self._lib = lib
        return self._lib


LIBRARY = _Library()


def _as_f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


def _ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _checked(image, flow, grad=None):
    image, flow = _as_f32(image), _as_f32(flow)
    if image.ndim != 4 or flow.shape != image.shape[:3] + (2,):
        raise ValueError(f"backproject: image {image.shape} must be "
                         f"[b, h, w, c] and flow {flow.shape} [b, h, w, 2]")
    if grad is not None:
        grad = _as_f32(grad)
        if grad.shape != image.shape:
            raise ValueError(f"backproject: grad {grad.shape} must be "
                             f"{image.shape}")
    return image, flow, grad


def backproject_forward(image: np.ndarray, flow: np.ndarray,
                        threads: int = 0) -> np.ndarray:
    """Bilinear warp of ``image`` [b, h, w, c] by ``flow`` [b, h, w, 2]
    (dx, dy), float32, on ``threads`` host threads (0: one a core)."""
    image, flow, _ = _checked(image, flow)
    b, h, w, c = image.shape
    out = np.empty_like(image)
    LIBRARY.get().backproject_forward(_ptr(image), _ptr(flow), _ptr(out),
                                      b, h, w, c,
                                      threads or (os.cpu_count() or 1))
    return out


def backproject_backward(image: np.ndarray, flow: np.ndarray,
                         grad: np.ndarray, threads: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Gradients (d_image, d_flow) of sum(warp(image, flow) * grad)."""
    image, flow, grad = _checked(image, flow, grad)
    b, h, w, c = image.shape
    dimg = np.empty_like(image)
    dflow = np.empty_like(flow)
    LIBRARY.get().backproject_backward(
        _ptr(image), _ptr(flow), _ptr(grad), _ptr(dimg), _ptr(dflow),
        b, h, w, c, threads or (os.cpu_count() or 1))
    return dimg, dflow
