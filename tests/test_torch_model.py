"""The PyTorch port's model against the JAX package's, on the CPU.

Both run the same weights (the JAX tree converted by
``m4depth_tpu_torch.interop``) on inputs made with numpy from a seed, in
float32. The JAX side runs its reference DSCV (``dscv_impl="gather"``) and
XLA SNCV; the port runs its plain versions, which its kernel wrappers take
on CPU tensors.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m4depth_tpu.config import ModelConfig as JaxConfig
from m4depth_tpu.geometry import Camera as JCamera
from m4depth_tpu.models import M4Depth as JaxM4Depth
from m4depth_tpu.models import init_state as jax_init_state
from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.geometry import Camera
from m4depth_tpu_torch.interop import load_jax_params, state_dict_from_jax
from m4depth_tpu_torch.models import M4Depth, init_state

REPO = pathlib.Path(__file__).resolve().parent.parent

# d4 at narrow widths; each level's channels divide into its cuts (1,2,2,4)
WIDTHS = dict(num_levels=4, encoder_channels=(8, 12, 16, 16),
              refiner_prep_channels=(16, 16, 8),
              refiner_est_channels=(8, 8, 5),
              compute_dtype="float32", cv_dtype="float32")
B, T, H, W = 2, 4, 64, 64


@pytest.fixture(scope="module")
def pair():
    """A JAX model with its parameters, the port with the same weights,
    and one 4-frame stream."""
    rng = np.random.RandomState(0)
    rgb = rng.rand(B, T, H, W, 3).astype(np.float32)
    rot = np.tile(np.array([1.0, 0.001, -0.002, 0.001], np.float32),
                  (B, T, 1))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    # mostly lateral motion keeps depth = rho/(para*alpha) positive and the
    # recurrence well conditioned; with a large forward component, random
    # weights give depths near t_z, whose parallax 1/(depth - t_z) blows
    # float32 rounding up over frames
    trans = np.tile(np.array([0.3, 0.1, 0.02], np.float32), (B, T, 1))
    f = np.full((B, 2), W / 2, np.float32)
    c = np.full((B, 2), W / 2, np.float32)
    jcfg = JaxConfig(dscv_impl="gather", sncv_impl="xla", **WIDTHS)
    jmodel = JaxM4Depth(jcfg)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), rgb[:, :2], rot[:, :2], trans[:, :2],
        JCamera(jnp.asarray(f), jnp.asarray(c)))
    model = M4Depth(ModelConfig(**WIDTHS), device="cpu", seed=1)
    load_jax_params(model, jax.device_get(params)["params"])
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, model=model,
                rgb=rgb, rot=rot, trans=trans, f=f, c=c)


def test_converter_covers_every_parameter(pair):
    tree = jax.device_get(pair["params"])["params"]
    sd = state_dict_from_jax(tree, pair["model"])
    assert set(sd) == set(pair["model"].state_dict())
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(tree))
    assert sum(v.numel() for v in sd.values()) == n_jax


def test_converter_rejects_unused_and_missing_keys(pair):
    tree = jax.device_get(pair["params"])["params"]
    extra = dict(tree, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="left unused"):
        state_dict_from_jax(extra, pair["model"])
    missing = dict(tree)
    missing["encoder"] = {k: v for k, v in tree["encoder"].items()
                          if k != "conv_s2_3"}
    with pytest.raises(KeyError, match="conv_s2_3"):
        state_dict_from_jax(missing, pair["model"])


def test_encoder_matches_jax(pair):
    """float32 convs in two libraries: sum order only."""
    rgb = pair["rgb"][:, 0]
    ref = pair["jmodel"].apply(pair["params"], jnp.asarray(rgb),
                               method=lambda m, x: m.encoder(x))
    out = pair["model"].encoder(torch.from_numpy(rgb))
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-5)


def test_streaming_step_matches_jax(pair):
    """Four frames of ``step``; element 0 restarts its trajectory at frame
    2. Depth agrees at every frame to float32 rounding (rtol=1e-4)."""
    p = pair
    step = jax.jit(lambda params, s, rgb, rot, trans, f, c, nt: p["jmodel"]
                   .apply(params, s, rgb, rot, trans, JCamera(f, c), nt,
                          method=JaxM4Depth.step))
    jstate = jax_init_state(p["jcfg"], B, H, W)
    tstate = init_state(p["model"].cfg, B, H, W, device="cpu")
    cam = Camera(torch.from_numpy(p["f"]), torch.from_numpy(p["c"]))
    for t in range(T):
        new_traj = np.array([t in (0, 2), t == 0])
        jstate, jdepth = step(p["params"], jstate, p["rgb"][:, t],
                              p["rot"][:, t], p["trans"][:, t], p["f"],
                              p["c"], jnp.asarray(new_traj))
        tstate, tdepth = p["model"].step(
            tstate, torch.from_numpy(p["rgb"][:, t]),
            torch.from_numpy(p["rot"][:, t]),
            torch.from_numpy(p["trans"][:, t]), cam,
            torch.from_numpy(new_traj))
        assert tdepth.shape == (B, H, W, 1)
        np.testing.assert_allclose(tdepth.numpy(), np.asarray(jdepth),
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=f"frame {t}")


def test_package_imports_no_jax():
    """Nothing under m4depth_tpu_torch/ (nor chip_smoke.py) imports jax,
    flax, optax, orbax, pandas or the JAX package; the image libraries
    (cv2, PIL), which the card host lacks, are imported only inside the
    functions that decode or write images, never by a module's import."""
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas",
              "m4depth_tpu")
    late = ("cv2", "PIL")
    files = sorted((REPO / "m4depth_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        in_function = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                in_function.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in banned, (path, name)
                assert top not in late or id(node) in in_function, (
                    path, name)


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**WIDTHS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M4Depth(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(cfg, 1, 32, 32)
    assert next(M4Depth(cfg, device="cpu").parameters()).device.type == "cpu"


def test_seed_fixes_the_weights():
    cfg = ModelConfig(**WIDTHS)
    a = M4Depth(cfg, device="cpu", seed=3).state_dict()
    b = M4Depth(cfg, device="cpu", seed=3).state_dict()
    c = M4Depth(cfg, device="cpu", seed=4).state_dict()
    w = "levels.0.refiner.prep.0.weight"
    assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
