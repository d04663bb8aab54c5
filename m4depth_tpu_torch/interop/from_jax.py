"""Convert the JAX package's parameter tree into this package's weights.

Takes the tree under ``"params"`` that ``m4depth_tpu``'s ``M4Depth.init``
or ``M4DepthV1.init`` returns, as a nested dict of numpy arrays
(``jax.device_get`` makes one); imports no JAX. Names map as follows:

  encoder/conv_s{1,2}_{i}/{kernel,bias}  -> encoder.conv_s{1,2}.{i}.{weight,bias}
  encoder/dinl/{scale,bias} [1,1,1,C]    -> encoder.dinl.{scale,bias} [C]
  level_{i+1}/refiner/{prep,est}_{j}/... -> levels.{i}.refiner.{prep,est}.{j}...
  level_{i+1}/conv_{j}/... (V1)          -> levels.{i}.convs.{j}...

Conv kernels are HWIO there and OIHW here (``transpose(3, 2, 0, 1)``).
``save_jax_checkpoint`` writes such a tree as a checkpoint of this
package's CLI.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, TypeVar

import numpy as np
import torch

from m4depth_tpu_torch.config import ModelConfig
from m4depth_tpu_torch.models.m4depth import M4Depth

Model = TypeVar("Model", bound=torch.nn.Module)  # M4Depth or M4DepthV1


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name))
        else:
            flat[name] = np.asarray(value)
    return flat


def _jax_name(port_name: str) -> str:
    """The JAX parameter path of a port parameter name."""
    parts = port_name.split(".")
    leaf = {"weight": "kernel"}.get(parts[-1], parts[-1])
    if parts[0] == "encoder":
        if parts[1] == "dinl":
            return f"encoder/dinl/{leaf}"
        return f"encoder/{parts[1]}_{parts[2]}/{leaf}"
    if parts[0] == "levels" and parts[2] == "refiner":
        return f"level_{int(parts[1]) + 1}/refiner/{parts[3]}_{parts[4]}/{leaf}"
    if parts[0] == "levels" and parts[2] == "convs":
        return f"level_{int(parts[1]) + 1}/conv_{parts[3]}/{leaf}"
    raise KeyError(f"no JAX counterpart for {port_name}")


def _convert(port_name: str, value: np.ndarray) -> np.ndarray:
    if port_name.endswith(".weight"):
        return value.transpose(3, 2, 0, 1)         # HWIO -> OIHW
    return value.reshape(-1)


def state_dict_from_jax(params: Mapping, model: torch.nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` filled from the JAX tree ``params``,
    on the model's device.

    Raises ``KeyError`` if a JAX parameter is left unused or a parameter of
    the model is left unset, and ``ValueError`` on a shape mismatch.
    """
    flat = _flatten(params)
    own = model.state_dict()
    out, used = {}, set()
    for name, ref in own.items():
        jax_name = _jax_name(name)
        if jax_name not in flat:
            raise KeyError(f"port parameter {name} has no JAX value "
                           f"({jax_name} missing)")
        value = _convert(name, flat[jax_name])
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{jax_name}: shape {value.shape} does not fit "
                             f"{name} {tuple(ref.shape)}")
        out[name] = torch.tensor(value, dtype=torch.float32,
                                 device=ref.device)
        used.add(jax_name)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"JAX parameters left unused: {unused}")
    return out


def load_jax_params(model: Model, params: Mapping) -> Model:
    """Load the JAX tree ``params`` into ``model`` (in place) and return it."""
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model


def save_jax_checkpoint(params: Mapping, step: int, cfg: ModelConfig,
                        ckpt_dir: str, epoch: int = 0) -> str:
    """Write a JAX ``TrainState``'s weights as this package's checkpoint.

    ``params`` is the state's ``params`` as a numpy tree (with or without
    its top ``"params"`` key), ``step`` its step count. The checkpoint goes
    to ``ckpt_dir/train/<epoch>.pt``, where ``--mode=eval`` and
    ``--mode=predict`` load it; its Adam state is fresh (no moments), with
    the schedule's count at ``step``. Returns the file's path.
    """
    from m4depth_tpu_torch.train import create_train_state
    from m4depth_tpu_torch.train.checkpoints import TrainCheckpointManager

    tree = params.get("params", params)
    state = create_train_state(load_jax_params(
        M4Depth(cfg, device="cpu"), tree))
    state.optimizer.count = int(step)
    mgr = TrainCheckpointManager(os.path.join(ckpt_dir, "train"))
    mgr.save(epoch, state)
    return mgr.path(epoch)
