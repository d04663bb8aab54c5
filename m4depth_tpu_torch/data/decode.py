"""Host-side image decoding, writing and resizing. Counterpart of
``m4depth_tpu/data/decode.py``.

JPEG color, uint16 PNG (raw or bitcast to float16) and raw float32 depth
blobs. Bilinear resizing (half-pixel, no antialias) for color and Mid-Air
depth, nearest (half-pixel floor) for sparse or exact depth.

The image library (cv2, else PIL) is imported at the first call that needs
one, never when this module is imported: a host with neither trains and
evaluates from a record store (``--record_store``), which holds decoded
frames and needs numpy alone.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

@functools.cache
def _image_lib():
    """("cv2", cv2) or ("pil", PIL.Image); raises ``ImportError`` naming the
    record-store route when neither imports."""
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "decoding or writing images needs cv2 or PIL, and neither "
                "imports here. Convert the dataset into a record store on a "
                "host that has one (--mode=convert --record_store=<dir>), "
                "then train and evaluate from it with --record_store=<dir>: "
                "that path needs numpy alone") from e
        return "pil", Image
    cv2.setNumThreads(0)  # decoding is parallel at the worker level
    return "cv2", cv2


def _cv2_or_none():
    try:
        name, mod = _image_lib()
    except ImportError:
        return None
    return mod if name == "cv2" else None


def load_jpeg(path: str) -> np.ndarray:
    """[h, w, 3] float32 in [0, 1]."""
    name, lib = _image_lib()
    if name == "cv2":
        img = lib.imread(path, lib.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        img = lib.cvtColor(img, lib.COLOR_BGR2RGB)
    else:
        img = np.asarray(lib.open(path).convert("RGB"))
    return img.astype(np.float32) / 255.0


def load_png16(path: str) -> np.ndarray:
    """[h, w, 1] uint16."""
    name, lib = _image_lib()
    if name == "cv2":
        img = lib.imread(path, lib.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
    else:
        img = np.asarray(lib.open(path))
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.uint16)[..., None]


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a uint8 [h, w, 3] RGB or [h, w(, 1)] grey image, or a uint16
    [h, w] image, as PNG or JPEG (by the file's extension)."""
    name, lib = _image_lib()
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if name == "cv2":
        if img.ndim == 3:
            img = img[..., ::-1]  # cv2 writes BGR
        if not lib.imwrite(path, np.ascontiguousarray(img)):
            raise OSError(f"could not write {path}")
    else:  # PIL takes a uint16 [h, w] array as a 16-bit image
        lib.fromarray(np.ascontiguousarray(img)).save(path)


def load_midair_depth(path: str) -> np.ndarray:
    """Mid-Air depth: 512 / float16-bitcast of the uint16 PNG."""
    raw = load_png16(path)
    disp = raw.view(np.float16).astype(np.float32)
    with np.errstate(divide="ignore"):
        return (512.0 / disp).astype(np.float32)


def load_kitti_depth(path: str) -> np.ndarray:
    """KITTI annotated depth: uint16 PNG / 256 m."""
    return load_png16(path).astype(np.float32) / 256.0


def load_raw_float32_depth(path: str, h: int, w: int) -> np.ndarray:
    """TartanAir depth: trailing h*w float32 of the file."""
    blob = np.fromfile(path, dtype=np.float32)
    return blob[-(h * w):].reshape(h, w, 1).copy()


def resize_bilinear_np(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """TF2-convention bilinear resize (half-pixel centers, no antialias):
    cv2's where it imports, else the same grid in numpy."""
    h, w = size
    if img.shape[0] == h and img.shape[1] == w:
        return img
    cv2 = _cv2_or_none()
    if cv2 is not None:
        squeeze = img.ndim == 3 and img.shape[2] == 1
        out = cv2.resize(img[..., 0] if squeeze else img, (w, h),
                         interpolation=cv2.INTER_LINEAR)
        return out[..., None] if squeeze else out
    return _resize_np(img, size, nearest=False)


def resize_nearest_np(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """TF2-convention nearest resize: src = floor((dst+0.5)*scale).

    (cv2.INTER_NEAREST uses a different grid, so this is done by indexing.)
    """
    return _resize_np(img, size, nearest=True)


def _axis_idx(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    pos = np.clip(pos, 0, src - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), src - 1)
    hi = np.minimum(lo + 1, src - 1)
    return lo, hi, (pos - lo).astype(np.float32)


def _resize_np(img: np.ndarray, size: Sequence[int],
               nearest: bool) -> np.ndarray:
    h, w = size
    sh, sw = img.shape[:2]
    if nearest:
        yi = np.clip(np.floor((np.arange(h) + 0.5) * (sh / h)), 0,
                     sh - 1).astype(int)
        xi = np.clip(np.floor((np.arange(w) + 0.5) * (sw / w)), 0,
                     sw - 1).astype(int)
        return img[yi][:, xi]
    ylo, yhi, fy = _axis_idx(sh, h)
    xlo, xhi, fx = _axis_idx(sw, w)
    top = img[ylo]
    bot = img[yhi]
    rows = top + (bot - top) * fy[:, None, None]
    left = rows[:, xlo]
    right = rows[:, xhi]
    return (left + (right - left) * fx[None, :, None]).astype(img.dtype)
