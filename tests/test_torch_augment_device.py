"""The port's augmentation on the device (``m4depth_tpu_torch/data/
augment_device.py``) against the JAX package's (``m4depth_tpu/data/
augment_device.py``), on the CPU: the same inputs and parameters through
both, rtol 1e-5. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m4depth_tpu.data import augment_device as jdev
from m4depth_tpu_torch.data import augment_device as tdev

RTOL = dict(rtol=1e-5, atol=1e-6)


def _seq(T=3, h=12, w=12, seed=0):
    r = np.random.RandomState(seed)
    return {
        "rgb": r.rand(T, h, w, 3).astype(np.float32),
        "depth": (1 + 10 * r.rand(T, h, w, 1)).astype(np.float32),
        "rot": np.tile(np.array([0.9, 0.1, -0.2, 0.05], np.float32), (T, 1)),
        "trans": np.tile(np.array([0.1, -0.05, 0.4], np.float32), (T, 1)),
        "camera_f": np.array([7.0, 6.0], np.float32),
        "camera_c": np.array([6.0, 5.5], np.float32),
    }


def _j(seq):
    return {k: jnp.asarray(v) for k, v in seq.items()}


def _t(seq):
    return {k: torch.from_numpy(np.array(v)) for k, v in seq.items()}


def _close(got, ref, what):
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=f"{what}: {k}", **RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_hsv_conversions_match_jax(seed):
    rgb = _seq(seed=seed)["rgb"]
    hsv = tdev.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(
        hsv.numpy(), np.asarray(jdev.rgb_to_hsv(jnp.asarray(rgb))), **RTOL)
    back = tdev.hsv_to_rgb(hsv)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jdev.hsv_to_rgb(jnp.asarray(hsv.numpy()))),
        **RTOL)
    np.testing.assert_allclose(back.numpy(), rgb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("invert", [0.0, 1.0])
@pytest.mark.parametrize("params", [
    dict(brightness=0.12, contrast=1.1, saturation=0.85, hue=0.17),
    dict(brightness=-0.15, contrast=0.8, saturation=1.2, hue=-0.33),
])
def test_apply_color_matches_jax(params, invert):
    rgb = _seq(seed=2)["rgb"]
    p = dict(params, invert=invert)
    ref = jdev.apply_color(jnp.asarray(rgb),
                           {k: jnp.float32(v) for k, v in p.items()})
    got = tdev.apply_color(torch.from_numpy(rgb), p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **RTOL)


@pytest.mark.parametrize("ops", [("v",), ("h",), ("t",), ("v", "h"),
                                 ("v", "h", "t")])
def test_flips_and_transpose_match_jax(ops):
    """Frames, depth, quaternion, translation and intrinsics fixups."""
    seq = _seq(h=12, w=12, seed=3)
    fns = {"v": "_flip_v", "h": "_flip_h", "t": "_transpose"}
    ref, got = _j(seq), _t(seq)
    for op in ops:
        ref = getattr(jdev, fns[op])(ref)
        got = getattr(tdev, fns[op])(got)
    _close(got, ref, "+".join(ops))


@pytest.mark.parametrize("out_size", [(16, 12), (10, 16)])
def test_crop_matches_jax(out_size):
    """The same offset: JAX draws it from its key, the port is given it."""
    seq = _seq(h=16, w=16, seed=4)
    key = jax.random.PRNGKey(7)
    ref = jdev._crop(_j(seq), key, out_size)
    oh, ow = out_size
    excess = 16 - ow if oh >= ow else 16 - oh
    off = int(jax.random.randint(key, (), 0, max(excess, 1)))
    got = tdev._crop(_t(seq), off, out_size)
    assert got["rgb"].shape == (3, oh, ow, 3)
    _close(got, ref, f"crop {out_size}")


def _batch(b=3, T=3, hw=12, seed=5):
    seqs = [_seq(T, hw, hw, seed + i) for i in range(b)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in seqs]))
             for k in seqs[0]}
    batch["new_traj"] = torch.zeros(b, T, dtype=torch.bool)
    return batch


@pytest.mark.parametrize("dataset,usecase,crop_to", [
    ("midair", "train", None), ("kitti-raw", "train", None),
    ("midair", "finetune", (12, 8))])
def test_batch_augment_is_a_function_of_seed_and_step(dataset, usecase,
                                                      crop_to):
    fn = tdev.make_batch_augment(dataset=dataset, usecase=usecase,
                                 crop_to=crop_to)
    batch = _batch()
    a, b, c = fn(batch, 42, 7), fn(batch, 42, 7), fn(batch, 42, 8)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["rgb"], c["rgb"])
    # each sequence draws its own parameters (same input, other output)
    same = {k: v[:1].expand_as(v).clone() for k, v in batch.items()}
    d = fn(same, 42, 7)["rgb"]
    assert not torch.equal(d[0], d[1])
    if crop_to is not None:
        assert a["rgb"].shape[2:4] == crop_to
    if dataset == "kitti-raw":  # color only: geometry untouched
        for k in ("depth", "rot", "trans", "camera_c", "camera_f"):
            assert torch.equal(a[k], batch[k]), k


def test_batch_augment_applies_the_drawn_transforms():
    """One sequence through ``augment_sequence`` equals the JAX transforms
    applied with the draws the port's generator made."""
    from m4depth_tpu_torch import mix_seed

    seq = _seq(h=12, w=12, seed=6)
    g = torch.Generator().manual_seed(mix_seed(1, 2, 0))
    got = tdev.augment_sequence(_t(seq), g, usecase="train", geometric=True,
                                invert_color=True)
    g = torch.Generator().manual_seed(mix_seed(1, 2, 0))
    flips = [tdev._uniform(g) < 0.5 for _ in range(3)]
    p = tdev.sample_color_params(g, False, True)
    ref = _j(seq)
    for fire, fn in zip(flips, (jdev._flip_v, jdev._flip_h,
                                jdev._transpose)):
        if fire:
            ref = fn(ref)
    ref["rgb"] = jdev.apply_color(ref["rgb"], {k: jnp.float32(v)
                                               for k, v in p.items()})
    _close(got, ref, "augment_sequence")
