"""The port's native host backproject (``m4depth_tpu_torch.native``) against
the JAX warp and ``jax.grad``: the three cases of ``test_native.py``, at
its tolerances, and a failed build, which raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from m4depth_tpu.ops.warp import dense_image_warp
from m4depth_tpu_torch import native
from m4depth_tpu_torch.ops import _build


def test_forward_matches_jax_warp():
    rng = np.random.RandomState(0)
    img = rng.randn(3, 9, 11, 4).astype(np.float32)
    flow = (rng.randn(3, 9, 11, 2) * 4).astype(np.float32)
    out = native.backproject_forward(img, flow)
    expected = np.asarray(dense_image_warp(jnp.asarray(img),
                                           jnp.asarray(flow)))
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)


def test_backward_matches_jax_grad():
    rng = np.random.RandomState(1)
    img = rng.randn(2, 7, 8, 3).astype(np.float32)
    flow = (rng.randn(2, 7, 8, 2) * 2).astype(np.float32)
    grad = rng.randn(2, 7, 8, 3).astype(np.float32)

    def f(i, fl):
        return (dense_image_warp(i, fl) * jnp.asarray(grad)).sum()

    gi, gf = jax.grad(f, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(flow))
    dimg, dflow = native.backproject_backward(img, flow, grad)
    np.testing.assert_allclose(dimg, np.asarray(gi), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dflow, np.asarray(gf), rtol=1e-4, atol=1e-4)


def test_multithreaded_matches_single():
    rng = np.random.RandomState(2)
    img = rng.randn(8, 16, 16, 4).astype(np.float32)
    flow = (rng.randn(8, 16, 16, 2) * 3).astype(np.float32)
    a = native.backproject_forward(img, flow, threads=1)
    b = native.backproject_forward(img, flow, threads=8)
    np.testing.assert_array_equal(a, b)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises with its output and leaves no
    library: no fallback."""
    failing = tmp_path / "g++"
    failing.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "cxx", lambda: str(failing))
    monkeypatch.setattr(native, "LIBRARY", native._Library())
    img = np.zeros((1, 4, 4, 1), np.float32)
    with pytest.raises(RuntimeError,
                       match="backproject.cc: g\\+\\+ exited 1(.|\n)*refused"):
        native.backproject_forward(img, np.zeros((1, 4, 4, 2), np.float32))
    assert not list((tmp_path / "build").glob("*.so"))
