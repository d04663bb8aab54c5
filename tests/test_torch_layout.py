"""The layout the PyTorch port hands its cost-volume kernels, on the CPU.

The kernels take only contiguous NHWC tensors and raise on a strided view
(``tests/test_torch_cuda.py`` holds them to that). The features reach them
from ``Conv3x3``, whose NHWC result is a view of the conv's NCHW output: it
is contiguous only when the conv backend returns channels-last, as cuDNN
does for the channels-last views the port feeds it. These tests feed the
convs NCHW layouts (a strided input, or a conv that returns NCHW, as the
card's native conv does with cuDNN off) and check that every tensor bound
for a kernel is contiguous and that the results do not change.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, decoder, init_state
from m4depth_tpu_torch.models.encoder import Conv3x3, Encoder

# d3 at narrow widths; the channels divide into each level's cuts (1, 2, 2)
WIDTHS = dict(num_levels=3, encoder_channels=(8, 12, 16),
              refiner_prep_channels=(16, 16, 8),
              refiner_est_channels=(8, 8, 5),
              compute_dtype="float32", cv_dtype="float32")


def _nhwc_view_of_nchw(rng, shape):
    """An NHWC tensor whose memory is NCHW-contiguous: a strided view."""
    b, h, w, c = shape
    x = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32))
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(8, 8), (7, 5)], ids=["even", "odd"])
def test_conv3x3_returns_contiguous_nhwc(stride, hw):
    conv = Conv3x3(4, 6, stride=stride)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = _nhwc_view_of_nchw(np.random.RandomState(0), (2,) + hw + (4,))
    assert not x.is_contiguous()
    y = conv(x)
    assert y.is_contiguous()
    torch.testing.assert_close(y, conv(x.contiguous()), rtol=0, atol=0)


def test_encoder_returns_contiguous_nhwc():
    """Odd sizes: a stride-2 conv on an odd size pads symmetrically inside
    the conv (no ``F.pad`` copy), so its NCHW output reached the next op."""
    enc = Encoder(ModelConfig(**WIDTHS))
    g = torch.Generator().manual_seed(0)
    for m in enc.modules():
        if isinstance(m, Conv3x3):
            m.reset_parameters(g)
    x = _nhwc_view_of_nchw(np.random.RandomState(1), (2, 15, 13, 3))
    outs = enc(x)
    refs = enc(x.contiguous())
    for out, ref in zip(outs, refs):
        assert out.is_contiguous()
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_cost_volume_inputs_contiguous_when_conv_returns_nchw(monkeypatch):
    """Three streaming frames with every conv returning NCHW memory (what
    the card's native conv gives with cuDNN off): each tensor the decoder
    hands the two cost volumes is contiguous, and the depth equals the
    depth with the default conv."""
    cfg = ModelConfig(**WIDTHS)
    b, hw = 2, 32
    rng = np.random.RandomState(2)
    frames = [torch.from_numpy(rng.rand(b, hw, hw, 3).astype(np.float32))
              for _ in range(3)]
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.001]] * b)
    trans = torch.tensor([[0.3, 0.1, 0.02]] * b)
    f = torch.full((b, 2), hw / 2.0)
    model = M4Depth(cfg, device="cpu", seed=3)

    def run():
        state = init_state(cfg, b, hw, hw, device="cpu")
        depths = []
        for t, rgb in enumerate(frames):
            state, depth = model.step(state, rgb, rot, trans,
                                      Camera(f, f.clone()),
                                      torch.tensor([t == 0, t == 0]))
            depths.append(depth)
        return depths

    ref = run()
    seen = []

    def spy(fn):
        def call(*args, **kwargs):
            for a in args:
                if isinstance(a, torch.Tensor) and a.dim() == 4:
                    seen.append(a.is_contiguous())
            return fn(*args, **kwargs)
        return call

    conv2d = F.conv2d
    monkeypatch.setattr(F, "conv2d",
                        lambda *a, **k: conv2d(*a, **k).contiguous())
    for name in ("parallax_sweeping_cv_fused", "spatial_cost_volume_fused"):
        monkeypatch.setattr(decoder, name, spy(getattr(decoder, name)))
    got = run()
    # 3 frames x 3 levels x (4 DSCV + 2 SNCV feature-sized tensors)
    assert len(seen) == 3 * 3 * 6 and all(seen)
    for d, r in zip(got, ref):
        torch.testing.assert_close(d, r, rtol=0, atol=0)
