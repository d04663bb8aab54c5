"""The PyTorch port's geometry against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both. Tolerance
rtol=1e-5, atol=1e-6: both sides compute the same float32 formulas, so
only rounding in a different operation order separates them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m4depth_tpu import geometry as jg
from m4depth_tpu.geometry.parallax import epipolar_terms as jax_epipolar_terms
from m4depth_tpu_torch import geometry as tg

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **TOL)


def _motion(rng, b, rot_dim):
    if rot_dim == 4:
        rot = np.concatenate([np.ones((b, 1)), rng.normal(0, 0.02, (b, 3))], 1)
        rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    else:
        rot = rng.normal(0, 0.02, (b, 3))
    trans = rng.normal(0, 0.3, (b, 3))
    f = rng.uniform(20, 40, (b, 2))
    c = rng.uniform(10, 20, (b, 2))
    return [x.astype(np.float32) for x in (rot, trans, f, c)]


def _both(rng, b, rot_dim):
    rot, trans, f, c = _motion(rng, b, rot_dim)
    jax_args = (jnp.asarray(rot), jnp.asarray(trans),
                jg.Camera(jnp.asarray(f), jnp.asarray(c)))
    torch_args = (torch.from_numpy(rot), torch.from_numpy(trans),
                  tg.Camera(torch.from_numpy(f), torch.from_numpy(c)))
    return jax_args, torch_args


@pytest.mark.parametrize("rot_dim", [3, 4])
def test_rot_mat(rot_dim):
    rng = np.random.RandomState(rot_dim)
    rot = rng.normal(0, 0.3, (5, rot_dim)).astype(np.float32)
    _close(tg.rot_mat(torch.from_numpy(rot)), jg.rot_mat(jnp.asarray(rot)))


def test_rot_mat_rejects_other_widths():
    with pytest.raises(ValueError):
        tg.rot_mat(torch.zeros(2, 5))


@pytest.mark.parametrize("rot_dim", [3, 4])
def test_epipolar_terms(rot_dim):
    rng = np.random.RandomState(10 + rot_dim)
    (jrot, jtr, jcam), (trot, ttr, tcam) = _both(rng, 2, rot_dim)
    ref = jax_epipolar_terms(7, 9, jrot, jtr, jcam)
    out = tg.epipolar_terms(7, 9, trot, ttr, tcam)
    for field in ref._fields:
        _close(getattr(out, field), getattr(ref, field))


def test_depth_parallax_round_trip():
    rng = np.random.RandomState(20)
    (jrot, jtr, jcam), (trot, ttr, tcam) = _both(rng, 2, 4)
    depth = rng.uniform(1.0, 50.0, (2, 6, 8, 1)).astype(np.float32)
    para_ref = jg.depth_to_parallax(jnp.asarray(depth), jrot, jtr, jcam)
    para = tg.depth_to_parallax(torch.from_numpy(depth), trot, ttr, tcam)
    _close(para, para_ref)
    _close(tg.parallax_to_depth(para, trot, ttr, tcam),
           jg.parallax_to_depth(para_ref, jrot, jtr, jcam))


def test_prev_depth_to_parallax_is_detached():
    rng = np.random.RandomState(21)
    (jrot, jtr, jcam), (trot, ttr, tcam) = _both(rng, 2, 3)
    depth = rng.uniform(1.0, 50.0, (2, 6, 8, 1)).astype(np.float32)
    td = torch.from_numpy(depth).requires_grad_(True)
    out = tg.prev_depth_to_parallax(td, trot, ttr, tcam)
    assert not out.requires_grad
    _close(out, jg.prev_depth_to_parallax(jnp.asarray(depth), jrot, jtr, jcam))


@pytest.mark.parametrize("search_range", [1, 4])
def test_parallax_sweep_flows(search_range):
    rng = np.random.RandomState(22 + search_range)
    (jrot, jtr, jcam), (trot, ttr, tcam) = _both(rng, 2, 4)
    # centres above 1e-6 (the clip) plus some far out of the image
    centre = rng.uniform(0.5, 4.5, (2, 5, 7, 1)).astype(np.float32)
    centre[:, 0, 0] = 300.0
    ref = jg.parallax_sweep_flows(jnp.asarray(centre), jrot, jtr, jcam,
                                  search_range)
    out = tg.parallax_sweep_flows(torch.from_numpy(centre), trot, ttr, tcam,
                                  search_range)
    assert out.shape == (2, 2 * search_range + 1, 5, 7, 2)
    _close(out, ref)


@pytest.mark.parametrize("size", [(8, 12), (5, 7), (24, 10)])
@pytest.mark.parametrize("fn", ["resize_bilinear_v1", "resize_bilinear",
                                "resize_nearest"])
def test_resize(fn, size):
    """2x, non-2x down and mixed up/down ratios from a 4x6 map."""
    rng = np.random.RandomState(30)
    x = rng.normal(size=(2, 4, 6, 3)).astype(np.float32)
    _close(getattr(tg, fn)(torch.from_numpy(x), size),
           getattr(jg, fn)(jnp.asarray(x), size))


def test_bilinear_v1_is_not_half_pixel():
    """The TFv1 grid samples source pixel dst*scale: output 1 of a 2x
    upsample is the midpoint of source pixels 0 and 1."""
    x = torch.tensor([0.0, 2.0]).reshape(1, 1, 2, 1)
    out = tg.resize_bilinear_v1(x, (1, 4)).reshape(-1)
    assert out.tolist() == [0.0, 1.0, 2.0, 2.0]
