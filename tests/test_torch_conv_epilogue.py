"""The convs' epilogue: ``Conv3x3`` with its activation,
``ops/conv_epilogue.py`` and the kernels of ``ops/csrc/conv_epilogue.cu``.

On the CPU: every conv layer runs the plain chain, so ``Conv3x3(..., slope)``
equals the former composition (the conv with its bias, then the caller's
leaky ReLU) bit for bit; both model families keep their parameters, and a
checkpoint of the former models gives the depth it gave
(``data/conv_epilogue_parent.pt``, written by the former models); the
autograd Function runs with a CPU stand-in for the forward kernel against
autograd of the plain chain. On the card (``cuda``-marked, skipped
elsewhere; the file imports no JAX): each kernel against the plain chain on
the card, the launches of a frame and a step counted from their captures,
and a training step's peak memory against the plain chain's.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from m4depth_tpu_torch.config import ModelConfig, TrainConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.models import M4Depth, M4DepthV1, init_state
from m4depth_tpu_torch.models.encoder import Conv3x3, _same_pad
from m4depth_tpu_torch.ops import (
    KERNELS,
    conv_epilogue,
    glue_launches,
    kernel_launches,
)
from m4depth_tpu_torch.testing import (
    BWD_TOL,
    EPILOGUE_BIAS_RTOL,
    assert_bf16_depth_close,
    assert_grad_close,
    plain_epilogue,
    train_batch,
)
from m4depth_tpu_torch.train import make_optimizer

FIXTURE = Path(__file__).resolve().parent / "data" / "conv_epilogue_parent.pt"

# the narrow d3 models the fixture holds (seed 5, 16x16, b=2, 3 frames)
D6_NARROW = dict(num_levels=3, encoder_channels=(8, 12, 16),
                 refiner_prep_channels=(16, 16, 8),
                 refiner_est_channels=(8, 8, 5))
V1_NARROW = dict(num_levels=3, encoder_channels=(8, 12, 16))
FAMILIES = {"m4depth": (M4Depth, D6_NARROW), "v1": (M4DepthV1, V1_NARROW)}
EPILOGUE = ("conv_epilogue_forward", "conv_epilogue_backward")


def _former_conv(conv: Conv3x3, x: torch.Tensor, slope):
    """The former ``Conv3x3.forward`` (the conv with its bias cast to the
    input's dtype, as contiguous NHWC), then the caller's leaky ReLU."""
    _, h, w, _ = x.shape
    pt, pb = _same_pad(h, conv.stride)
    pl, pr = _same_pad(w, conv.stride)
    if (pt, pl) != (pb, pr):
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pt = pl = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                 conv.bias.to(x.dtype), stride=conv.stride,
                 padding=(pt, pl)).permute(0, 2, 3, 1).contiguous()
    return y if slope is None else F.leaky_relu(y, slope)


def _conv(cin, cout, stride, slope, seed=0):
    conv = Conv3x3(cin, cout, stride=stride, slope=slope)
    g = torch.Generator().manual_seed(seed)
    conv.reset_parameters(g)
    with torch.no_grad():
        conv.bias.normal_(0.0, 0.5, generator=g)
    return conv


# -- the CPU: the plain chain ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "bias_only"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(2, 9, 7, 3, 16), (1, 8, 8, 12, 5),
                                   (3, 6, 10, 5, 1)],
                         ids=["rgb-16", "12-5", "5-1"])
def test_conv3x3_equals_the_former_chain(dtype, slope, stride, shape):
    """The layer and its gradients, bit for bit, against the former
    composition on the CPU."""
    b, h, w, cin, cout = shape
    dt = getattr(torch, dtype)
    conv = _conv(cin, cout, stride, slope)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32)).to(dt)
    x.requires_grad_(True)
    got = conv(x)
    want = _former_conv(conv, x, slope)
    assert got.is_contiguous() and got.dtype == dt
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32)).to(dt)
    params = [x, conv.weight, conv.bias]
    for a, c in zip(torch.autograd.grad(got, params, g),
                    torch.autograd.grad(want, params, g)):
        assert torch.equal(a, c)


def test_models_activate_as_before():
    """Each conv layer carries the activation that followed it: d6's last
    refiner conv and level 0's stride-1 conv (the normalization follows
    it) none, every other conv of both families the model's slope."""
    cfg = ModelConfig(**D6_NARROW)
    slopes = {n: m.slope for n, m in M4Depth(cfg, device="cpu").named_modules()
              if isinstance(m, Conv3x3)}
    none = {n for n, s in slopes.items() if s is None}
    assert none == {"encoder.conv_s1.0"} | {
        f"levels.{i}.refiner.est.2" for i in range(3)}
    assert set(slopes.values()) == {None, cfg.leaky_slope}
    v1 = {m.slope for m in M4DepthV1(ModelConfig(**V1_NARROW),
                                     device="cpu").modules()
          if isinstance(m, Conv3x3)}
    assert v1 == {cfg.leaky_slope}


def _structure(sd) -> str:
    return hashlib.sha256("".join(
        f"{k}:{tuple(v.shape)};" for k, v in sorted(sd.items())).encode()
    ).hexdigest()


def _digest(sd) -> str:
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu()
        h.update(f"{k}:{tuple(v.shape)}:{v.dtype};".encode())
        h.update(v.float().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def former():
    return torch.load(FIXTURE, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_dict_keys_and_shapes_unchanged(former, family):
    """The default models' parameter names and shapes, and the narrow
    seeded models' values, are the former models'."""
    fam, widths = FAMILIES[family]
    assert _structure(fam(ModelConfig(), device="cpu").state_dict()) == \
        former[f"{family}-default"]
    for dt in ("float32", "bfloat16"):
        cfg = ModelConfig(compute_dtype=dt, cv_dtype=dt, **widths)
        assert _digest(fam(cfg, device="cpu", seed=5).state_dict()) == \
            former[f"{family}-{dt}"]["digest"]


def _stream(model, cfg, b=2, hw=16, T=3, seed=7):
    """Depth [T, b, hw, hw, 1] of ``T`` streamed frames (every element
    starts at frame 0, element 1 again at frame 2)."""
    rng = np.random.RandomState(seed)
    rgb = torch.from_numpy(rng.rand(T, b, hw, hw, 3).astype(np.float32))
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.001]] * b)
    trans = torch.tensor([[0.3, 0.1, 0.02]] * b)
    f = torch.full((b, 2), hw / 2.0)
    state = init_state(cfg, b, hw, hw, device="cpu")
    depths = []
    with torch.no_grad():
        for t in range(T):
            state, d = model.step(state, rgb[t], rot, trans,
                                  Camera(f, f.clone()),
                                  torch.tensor([t == 0, t in (0, 2)]))
            depths.append(d)
    return torch.stack(depths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_former_checkpoint_gives_the_same_depth(former, tmp_path, family,
                                                dtype):
    """A checkpoint of the former model (seed 5's weights, saved and loaded
    into a model of other weights) streams the depth the former model
    gave on the same frames."""
    fam, widths = FAMILIES[family]
    cfg = ModelConfig(compute_dtype=dtype, cv_dtype=dtype, **widths)
    path = tmp_path / "model.pt"
    torch.save(fam(cfg, device="cpu", seed=5).state_dict(), path)
    model = fam(cfg, device="cpu", seed=0)
    model.load_state_dict(torch.load(path, weights_only=True))
    got = _stream(model, cfg)
    want = former[f"{family}-{dtype}"]["depth"]
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        for t in range(got.shape[0]):
            assert_bf16_depth_close(got[t], want[t], f"frame {t}")


def test_cpu_model_launches_no_epilogue_kernel():
    """On CPU tensors no conv goes near the kernels."""
    cfg = ModelConfig(**D6_NARROW)
    before = kernel_launches("conv_epilogue")
    _stream(M4Depth(cfg, device="cpu", seed=1), cfg, T=2)
    assert kernel_launches("conv_epilogue") == before == {
        k: KERNELS[k].launches for k in EPILOGUE}


def test_kernel_launches_by_prefix():
    """``glue_launches`` is ``kernel_launches("glue")``; a count since an
    earlier one is its difference over the calls."""
    assert glue_launches() == kernel_launches("glue")
    assert set(kernel_launches("conv_epilogue")) == set(EPILOGUE)
    since = kernel_launches("conv_epilogue")
    KERNELS["conv_epilogue_forward"].launches += 6
    try:
        assert kernel_launches("conv_epilogue", since, 3) == {
            "conv_epilogue_forward": 2.0, "conv_epilogue_backward": 0.0}
    finally:
        KERNELS["conv_epilogue_forward"].launches -= 6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "bias_only"])
def test_plain_backward_matches_autograd(dtype, slope):
    """``conv_epilogue_backward``: dx bit for bit as autograd's, the bias
    gradient (float32) within the dtype's rounding of autograd's."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(4)
    out = torch.from_numpy(rng.randn(2, 5, 6, 7).astype(np.float32)).to(dt)
    out.requires_grad_(True)
    bias = torch.from_numpy(rng.randn(7).astype(np.float32))
    bias.requires_grad_(True)
    y = conv_epilogue.conv_epilogue(out, bias, slope)
    g = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).to(dt)
    d_out, d_bias = torch.autograd.grad(y, (out, bias), g)
    dx, db = conv_epilogue.conv_epilogue_backward(g, y.detach(), slope)
    assert torch.equal(dx, d_out) and db.dtype == torch.float32
    tol = 2.0 ** -8 if dt == torch.bfloat16 else 1e-6
    torch.testing.assert_close(db, d_bias, rtol=tol, atol=tol)


def _cpu_kernels(monkeypatch):
    """The forward kernel's CPU stand-in: the plain epilogue written in
    place; the backward wrapper takes its plain version on the CPU."""
    def launch_forward(y, bias, slope):
        y.copy_(conv_epilogue.conv_epilogue(y, bias, slope))

    monkeypatch.setattr(conv_epilogue, "_launch_forward", launch_forward)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "bias_only"])
def test_function_matches_autograd_of_the_plain_chain(monkeypatch, dtype,
                                                      slope):
    """``conv_epilogue_fused`` under grad, with the CPU stand-in: the
    conv's output rewritten in place, its gradients for the input and the
    weight bit for bit those of the plain epilogue, the bias's within the
    dtype's rounding; the activated output is the only tensor it saves."""
    _cpu_kernels(monkeypatch)
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 6, 5, 4).astype(np.float32)).to(dt)
    x.requires_grad_(True)
    conv = _conv(4, 6, 1, slope, seed=2)
    w = conv.weight.to(dt)
    params = [x, conv.weight, conv.bias]

    def conv_out():
        return F.conv2d(x.permute(0, 3, 1, 2), w, None, padding=1)

    out = conv_out()
    got = conv_epilogue.conv_epilogue_fused(out, conv.bias, slope)
    assert got.data_ptr() == out.data_ptr() and got.is_contiguous()
    want = conv_epilogue.conv_epilogue(
        conv_out().permute(0, 2, 3, 1), conv.bias, slope)
    assert torch.equal(got, want)
    g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32)).to(dt)
    a = torch.autograd.grad(got, params, g, retain_graph=True)
    c = torch.autograd.grad(want, params, g)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    assert a[2].dtype == torch.float32
    tol = 2.0 ** -8 if dt == torch.bfloat16 else 1e-6
    torch.testing.assert_close(a[2], c[2], rtol=tol, atol=tol)


def _saved_bytes(fn) -> int:
    """Bytes of the distinct tensors autograd saves while ``fn`` runs."""
    seen = {}

    def pack(t):
        seen[(t.untyped_storage().data_ptr(), t.dtype)] = \
            t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def test_function_saves_less_than_the_plain_chain(monkeypatch):
    """Three convs in a row and a square under grad, with the CPU
    stand-in: the Function path keeps each activation once (the next op's
    input); the plain chain also keeps each pre-activation for the leaky
    ReLU's backward."""
    _cpu_kernels(monkeypatch)
    convs = [_conv(c, 8, 1, 0.1, seed=i) for i, c in enumerate((3, 8, 8))]
    x = torch.rand(2, 12, 12, 3, requires_grad=True)

    def run(layer):
        y = x
        for conv in convs:
            y = layer(y, conv.weight, conv.bias, 1, (1, 1), conv.slope)
        return (y * y).sum()

    def fused(x_, weight, bias, stride, padding, slope):
        out = F.conv2d(x_.permute(0, 3, 1, 2), weight, None, stride=stride,
                       padding=padding)
        return conv_epilogue.conv_epilogue_fused(out, bias, slope)

    plain = _saved_bytes(lambda: run(conv_epilogue.conv3x3_plain))
    kernels = _saved_bytes(lambda: run(fused))
    act = 2 * 12 * 12 * 8 * 4
    assert plain - kernels == 3 * act


def test_plain_epilogue_swaps_the_layer():
    """``testing.plain_epilogue`` makes every ``Conv3x3`` run the plain
    chain, and restores the layer."""
    from m4depth_tpu_torch.models import encoder

    layer = encoder.conv3x3
    with plain_epilogue():
        assert encoder.conv3x3 is conv_epilogue.conv3x3_plain
    assert encoder.conv3x3 is layer


# -- the card --------------------------------------------------------------

# Every conv output of the d6 and V1 models at 384x384 as (h, w, C), and
# the odd channel counts the kernels' channel arithmetic must take
CARD_SHAPES = ((384, 384, 16), (192, 192, 16), (192, 192, 32), (96, 96, 64),
               (48, 48, 96), (24, 24, 128), (12, 12, 192), (6, 6, 192),
               (192, 192, 128), (96, 96, 96), (24, 24, 5), (6, 6, 5),
               (192, 192, 1), (6, 6, 1), (7, 5, 3), (13, 11, 7),
               (5, 9, 33))
CARD_IDS = [f"{h}x{w}-C{C}" for h, w, C in CARD_SHAPES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(dev, b, h, w, C, dt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    out = torch.randn(b, C, h, w, generator=g, device=dev).to(dt).contiguous(
        memory_format=torch.channels_last)
    bias = 0.5 * torch.randn(C, generator=g, device=dev)
    grad = torch.randn(b, C, h, w, generator=g, device=dev).to(dt).contiguous(
        memory_format=torch.channels_last)
    return out, bias, grad


def _plain_chain(out, bias, slope):
    """The former epilogue on the card: the bias cast and added in place to
    the conv's output, then the activation (pre-activation, output)."""
    x = out.clone(memory_format=torch.channels_last)
    x.add_(bias.to(x.dtype).reshape(1, -1, 1, 1))
    return x, (x if slope is None else F.leaky_relu(x, slope))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "bias_only"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
def test_forward_kernel_matches_the_plain_chain(cuda, shape, b, slope, dtype):
    """In place, and bit for bit the plain chain's."""
    h, w, C = shape
    if b == 8 and h * w * C > 192 * 192 * 128:
        pytest.skip("b=8 runs V1's shapes; the 384x384 level is d6's alone")
    out, bias, _ = _card_case(cuda, b, h, w, C, getattr(torch, dtype), 1)
    _, want = _plain_chain(out, bias, slope)
    before = KERNELS["conv_epilogue_forward"].launches
    got = conv_epilogue.conv_epilogue_fused(out, bias, slope)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, want.permute(0, 2, 3, 1))
    assert KERNELS["conv_epilogue_forward"].launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "bias_only"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
def test_backward_kernel_matches_aten(cuda, shape, b, slope, dtype):
    """dx bit for bit ATen's leaky_relu_backward; the bias gradient within
    EPILOGUE_BIAS_RTOL of an fp64 sum, within the dtype's rounding of the
    plain path's (the sum in the dtype), the same on a second run."""
    h, w, C = shape
    dt = getattr(torch, dtype)
    out, bias, grad = _card_case(cuda, b, h, w, C, dt, 2)
    x, y = _plain_chain(out, bias, slope)
    ref = grad if slope is None else torch.ops.aten.leaky_relu_backward(
        grad, x, slope, False)
    yv = None if slope is None else y.permute(0, 2, 3, 1)
    dx, db = conv_epilogue.conv_epilogue_backward_fused(
        grad.permute(0, 2, 3, 1), yv, slope)
    torch.cuda.synchronize()
    assert torch.equal(dx, ref.permute(0, 2, 3, 1))
    assert db.dtype == torch.float32 and db.shape == (C,)
    exact = ref.double().sum((0, 2, 3))
    scale = ref.double().abs().sum((0, 2, 3))
    assert bool(((db.double() - exact).abs()
                 <= EPILOGUE_BIAS_RTOL * scale).all())
    plain = ref.sum((0, 2, 3)).float()
    rnd = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
           torch.float16: 2.0 ** -11}[dt]
    assert bool(((db - plain).abs() <= rnd * plain.abs()
                 + 2 * EPILOGUE_BIAS_RTOL * scale.float()).all())
    again = conv_epilogue.conv_epilogue_backward_fused(
        grad.permute(0, 2, 3, 1), yv, slope)[1]
    assert torch.equal(again, db)


@pytest.mark.cuda
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "bias_only"])
def test_function_gradcheck(cuda, slope):
    """The Function's gradients against finite differences, float32, on a
    small shape whose values keep a step's width away from the kink."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand(2, 3, 4, 5, generator=g, device=cuda) + 0.2
    x = x * (torch.rand(x.shape, generator=g, device=cuda) > 0.5).float() \
        .mul(2).sub(1)
    bias = torch.zeros(3, device=cuda)

    def fn(out, b):
        return conv_epilogue.ConvEpilogueFunction.apply(
            out.clone(memory_format=torch.channels_last), b, slope)

    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    bias.requires_grad_(True)
    assert torch.autograd.gradcheck(fn, (x, bias), eps=1e-2, atol=1e-3,
                                    rtol=1e-3, nondet_tol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slope", [0.1, None], ids=["leaky", "bias_only"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_on_the_card_matches_the_plain_chain(cuda, stride, slope,
                                                     dtype):
    """The whole layer (cuDNN without the bias, then the kernel) against the
    plain chain on the card, bit for bit; its gradients under grad to
    BWD_TOL, the input's and the weight's (cuDNN's strided data gradient
    and its weight gradient sum in an order that may change from one call
    to the next: the same cotangent gave other bits), the bias's to the
    float32 sum."""
    dt = getattr(torch, dtype)
    conv = _conv(16, 32, stride, slope).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(3, 48, 40, 16, generator=g, device=cuda).to(dt)
    x.requires_grad_(True)
    got = conv(x)
    with plain_epilogue():
        want = conv(x)
    assert torch.equal(got, want)
    cot = torch.randn(got.shape, generator=g, device=cuda).to(dt)
    params = [x, conv.weight, conv.bias]
    a = torch.autograd.grad(got, params, cot)
    c = torch.autograd.grad(want, params, cot)
    assert_grad_close(a[0], c[0], BWD_TOL[dt], "the input's gradient")
    assert_grad_close(a[1], c[1], BWD_TOL[dt], "the weight's gradient")
    tol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(a[2], c[2], rtol=tol, atol=tol)


def _frames(b, hw, T, dev, seed):
    rng = np.random.RandomState(seed)
    rgb = torch.from_numpy(rng.rand(T, b, hw, hw, 3).astype(np.float32))
    rot = torch.tensor([[1.0, 0.001, -0.002, 0.001]] * b)
    trans = torch.tensor([[0.3, 0.1, 0.02]] * b)
    f = torch.full((b, 2), hw / 2.0)
    return rgb.to(dev), rot.to(dev), trans.to(dev), Camera(f.to(dev),
                                                           f.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("family,b", [("m4depth", 1), ("v1", 8)])
def test_compiled_frame_launches_the_epilogue_once_a_conv(cuda, family, b):
    """A compiled bf16 serving frame (six levels, 128x128) launches the
    forward kernel 54 times (12 encoder and 42 refiner convs), the backward
    none, in every call (the eager first call, the capture's replay,
    replays), and each replay equals the eager step."""
    from m4depth_tpu_torch.parallel import compile_step

    fam = M4Depth if family == "m4depth" else M4DepthV1
    cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype="bfloat16")
    model = fam(cfg, device=cuda, seed=5)
    step = compile_step(model)
    state = init_state(cfg, b, 128, 128, device=cuda)
    eager = init_state(cfg, b, 128, 128, device=cuda)
    rgb, rot, trans, cam = _frames(b, 128, 4, cuda, 9)
    for t in range(4):
        reset = torch.full((b,), t == 0, device=cuda)
        before = kernel_launches("conv_epilogue")
        state, depth = step(state, rgb[t], rot, trans, cam, reset)
        torch.cuda.synchronize()
        assert kernel_launches("conv_epilogue", before) == {
            "conv_epilogue_forward": 54.0, "conv_epilogue_backward": 0.0}, t
        with torch.no_grad():
            eager, want = model.step(eager, rgb[t], rot, trans, cam, reset)
        assert torch.equal(depth, want), t


@pytest.mark.cuda
def test_compiled_train_step_launches_174_of_each(cuda):
    """A compiled d6 train step (b=3, T=4, 128x128, bf16): 48 encoder calls
    and 126 refiner calls (frame 0 runs no refiner), each launching the
    forward kernel and, in the backward, the backward kernel: 174 of each
    in every call, replays included."""
    from m4depth_tpu_torch.train import compile_train_step

    cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype="bfloat16")
    model = M4Depth(cfg, device=cuda, seed=6)
    step = compile_train_step(model, make_optimizer(
        model, TrainConfig(learning_rate=1e-4)))
    batch = train_batch(3, 4, 128, 7, [1.0, 0.001, -0.002, 0.001],
                        [0.3, 0.1, 0.02], cuda)
    for i in range(4):
        before = kernel_launches("conv_epilogue")
        step(batch)
        torch.cuda.synchronize()
        assert kernel_launches("conv_epilogue", before) == {
            "conv_epilogue_forward": 174.0,
            "conv_epilogue_backward": 174.0}, i


@pytest.mark.cuda
def test_train_step_peak_memory_below_the_plain_chain(cuda):
    """One eager d6 train step (b=2, T=3, 128x128, bf16): its peak memory
    lies below the same step's with the plain chain (``plain_epilogue``),
    which also keeps every pre-activation; the losses agree."""
    from m4depth_tpu_torch.train import make_train_step

    cfg = ModelConfig(compute_dtype="bfloat16", cv_dtype="bfloat16")
    batch = train_batch(2, 3, 128, 8, [1.0, 0.001, -0.002, 0.001],
                        [0.3, 0.1, 0.02], cuda)
    peaks, losses = {}, {}
    for key in ("plain", "kernels", "plain again"):
        model = M4Depth(cfg, device=cuda, seed=7)
        step = make_train_step(model, make_optimizer(
            model, TrainConfig(learning_rate=1e-4)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if key == "kernels":
            losses[key] = float(step(batch)["loss"])
        else:
            with plain_epilogue():
                losses[key] = float(step(batch)["loss"])
        torch.cuda.synchronize()
        peaks[key] = torch.cuda.max_memory_allocated() - base
        del model, step
        torch.cuda.empty_cache()
    assert peaks["kernels"] < min(peaks["plain"], peaks["plain again"]), \
        peaks
    assert abs(losses["kernels"] - losses["plain"]) <= 1e-2 * abs(
        losses["plain"]), losses
