"""Dataset adapters: Mid-Air, KITTI-raw, TartanAir. Counterpart of
``m4depth_tpu/data/datasets.py``, the same adapters.

Parity reference: dataloaders/{midair,kitti,tartanair}.py. Each adapter
decodes one CSV-manifest row into a frame dict and knows its intrinsics,
output geometry and augmentation policy. Manifest schema (TSV):
  id  camera_l  disp|depth  qw qx qy qz  tx ty tz   (+ fx fy cx cy for KITTI)
(scripts/midair-split-generator.py:55).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from m4depth_tpu_torch.data import augment as aug
from m4depth_tpu_torch.data import decode


class DatasetAdapter:
    """Base adapter. Subclasses configure geometry and decoding."""

    name: str = ""
    depth_type: str = "map"
    default_out_size: Tuple[int, int] = (384, 384)

    def __init__(self):
        self.out_size = self.default_out_size
        self.crop = False
        self.intermediate_size = self.default_out_size

    def set_output_size(self, out_size: Optional[Sequence[int]] = None,
                        crop: bool = False) -> None:
        self.out_size = tuple(out_size) if out_size else self.default_out_size
        self.crop = crop
        self.intermediate_size = self.out_size

    # -- per-row decoding ---------------------------------------------------
    def decode_row(self, row: Dict, db_path: str, usecase: str) -> Dict:
        raise NotImplementedError

    # -- sequence-level augmentation ---------------------------------------
    def augment_sequence(self, seq: Dict[str, np.ndarray],
                         rng: np.random.RandomState, usecase: str) -> Dict:
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _motion(row: Dict) -> Tuple[np.ndarray, np.ndarray, bool]:
        rot = np.array([row["qw"], row["qx"], row["qy"], row["qz"]], np.float32)
        trans = np.array([row["tx"], row["ty"], row["tz"]], np.float32)
        return rot, trans, int(row["id"]) == 0


class MidAirAdapter(DatasetAdapter):
    """Mid-Air: 1024x1024 JPEG color + float16-bitcast disparity PNGs.

    Parity: dataloaders/midair.py — f = c = half the (intermediate) size;
    depth = 512/disparity resized bilinear; flips + square transpose + color
    inversion augmentation; finetune mode crops a square intermediate down to
    the requested (KITTI) size.
    """

    name = "midair"
    depth_type = "map"
    default_out_size = (384, 384)

    def set_output_size(self, out_size=None, crop: bool = False) -> None:
        super().set_output_size(out_size, crop)
        oh, ow = self.out_size
        if crop:
            long_edge = max(oh, ow)
            self.intermediate_size = (long_edge, long_edge)
        else:
            self.intermediate_size = self.out_size

    def intrinsics(self) -> Tuple[np.ndarray, np.ndarray]:
        ih, iw = self.intermediate_size
        f = np.array([0.5 * iw, 0.5 * ih], np.float32)
        c = np.array([0.5 * iw, 0.5 * ih], np.float32)
        return f, c

    def decode_row(self, row, db_path, usecase):
        rgb = decode.load_jpeg(os.path.join(db_path, row["camera_l"]))
        rgb = decode.resize_bilinear_np(rgb, self.intermediate_size)
        f, c = self.intrinsics()
        rot, trans, new_traj = self._motion(row)
        out = {"RGB_im": rgb.astype(np.float32), "rot": rot, "trans": trans,
               "new_traj": new_traj, "camera_f": f, "camera_c": c}
        if "disp" in row and isinstance(row["disp"], str):
            depth = decode.load_midair_depth(os.path.join(db_path, row["disp"]))
            out["depth"] = decode.resize_bilinear_np(
                depth, self.intermediate_size).astype(np.float32)
        return out

    def augment_sequence(self, seq, rng, usecase):
        if usecase != "finetune":
            seq = aug.flip_augment(seq, rng)
            seq = aug.transpose_augment(seq, rng)
        if self.crop:
            seq = aug.crop_augment(seq, rng, self.out_size)
        seq["RGB_im"] = aug.color_augment(
            seq["RGB_im"], rng, finetune=(usecase == "finetune"),
            invert_color=True)
        return seq


class KittiRawAdapter(DatasetAdapter):
    """KITTI raw: per-row normalized intrinsics, sparse velodyne depth.

    Parity: dataloaders/kitti.py — 256x768 default, depth from uint16
    PNG/256 nearest-resized, Garg/Eigen eval crop mask, color-only
    augmentation without inversion.
    """

    name = "kitti-raw"
    depth_type = "velodyne"
    default_out_size = (256, 768)

    def eval_crop_mask(self) -> np.ndarray:
        oh, ow = self.out_size
        crop = np.array([0.40810811 * oh, 0.99189189 * oh,
                         0.03594771 * ow, 0.96405229 * ow]).astype(np.int32)
        mask = np.zeros((oh, ow, 1), np.float32)
        mask[crop[0]:crop[1], crop[2]:crop[3], :] = 1.0
        return mask

    def decode_row(self, row, db_path, usecase):
        oh, ow = self.out_size
        rgb = decode.load_jpeg(os.path.join(db_path, row["camera_l"]))
        rgb = decode.resize_bilinear_np(rgb, self.out_size)
        f = np.array([row["fx"] * ow, row["fy"] * oh], np.float32)
        c = np.array([row["cx"] * ow, row["cy"] * oh], np.float32)
        rot, trans, new_traj = self._motion(row)
        out = {"RGB_im": rgb.astype(np.float32), "rot": rot, "trans": trans,
               "new_traj": new_traj, "camera_f": f, "camera_c": c}
        if "depth" in row and isinstance(row["depth"], str):
            depth = decode.load_kitti_depth(os.path.join(db_path, row["depth"]))
            depth = decode.resize_nearest_np(depth, self.out_size)
            if usecase == "eval":
                depth = depth * self.eval_crop_mask()
            out["depth"] = depth.astype(np.float32)
        return out

    def augment_sequence(self, seq, rng, usecase):
        seq["RGB_im"] = aug.color_augment(
            seq["RGB_im"], rng, finetune=(usecase == "finetune"),
            invert_color=False)
        return seq


class TartanAirAdapter(DatasetAdapter):
    """TartanAir: 480x640 inputs, raw float32 depth blobs.

    Parity: dataloaders/tartanair.py — 384x512 default, fx = w/2,
    fy = 2h/3, depth nearest-resized and masked where the color image is
    black (no information).
    """

    name = "tartanair"
    depth_type = "map"
    default_out_size = (384, 512)
    in_size = (480, 640)

    def intrinsics(self) -> Tuple[np.ndarray, np.ndarray]:
        oh, ow = self.out_size
        f = np.array([0.5 * ow, (2.0 / 3.0) * oh], np.float32)
        c = np.array([0.5 * ow, 0.5 * oh], np.float32)
        return f, c

    def decode_row(self, row, db_path, usecase):
        rgb = decode.load_jpeg(os.path.join(db_path, row["camera_l"]))
        rgb = decode.resize_bilinear_np(rgb, self.out_size)
        f, c = self.intrinsics()
        rot, trans, new_traj = self._motion(row)
        out = {"RGB_im": rgb.astype(np.float32), "rot": rot, "trans": trans,
               "new_traj": new_traj, "camera_f": f, "camera_c": c}
        if "depth" in row and isinstance(row["depth"], str):
            depth = decode.load_raw_float32_depth(
                os.path.join(db_path, row["depth"]), *self.in_size)
            depth = decode.resize_nearest_np(depth, self.out_size)
            mask = (np.linalg.norm(rgb, axis=-1, keepdims=True) > 0.0)
            out["depth"] = (depth * mask).astype(np.float32)
        return out

    def augment_sequence(self, seq, rng, usecase):
        seq = aug.flip_augment(seq, rng)
        seq["RGB_im"] = aug.color_augment(
            seq["RGB_im"], rng, finetune=(usecase == "finetune"),
            invert_color=True)
        return seq


_ADAPTERS = {
    "midair": MidAirAdapter,
    "kitti-raw": KittiRawAdapter,
    "tartanair": TartanAirAdapter,
}


def get_adapter(name: str) -> DatasetAdapter:
    """Registry lookup (parity: dataloaders/__init__.py:6-17)."""
    try:
        return _ADAPTERS[name]()
    except KeyError:
        raise NotImplementedError(
            f"Unknown dataset '{name}'. Available: {sorted(_ADAPTERS)}")
