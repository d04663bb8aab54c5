"""Convert the JAX package's parameter tree into this package's weights.

Takes the tree under ``"params"`` that ``m4depth_tpu``'s ``M4Depth.init``
returns, as a nested dict of numpy arrays (``jax.device_get`` makes one);
imports no JAX. Names map as follows:

  encoder/conv_s{1,2}_{i}/{kernel,bias}  -> encoder.conv_s{1,2}.{i}.{weight,bias}
  encoder/dinl/{scale,bias} [1,1,1,C]    -> encoder.dinl.{scale,bias} [C]
  level_{i+1}/refiner/{prep,est}_{j}/... -> levels.{i}.refiner.{prep,est}.{j}...

Conv kernels are HWIO there and OIHW here (``transpose(3, 2, 0, 1)``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from m4depth_tpu_torch.models.m4depth import M4Depth


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
    if parts[0] == "levels":
        return f"level_{int(parts[1]) + 1}/refiner/{parts[3]}_{parts[4]}/{leaf}"
    raise KeyError(f"no JAX counterpart for {port_name}")


def _convert(port_name: str, value: np.ndarray) -> np.ndarray:
    if port_name.endswith(".weight"):
        return value.transpose(3, 2, 0, 1)         # HWIO -> OIHW
    return value.reshape(-1)


def state_dict_from_jax(params: Mapping, model: M4Depth
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


def load_jax_params(model: M4Depth, params: Mapping) -> M4Depth:
    """Load the JAX tree ``params`` into ``model`` (in place) and return it."""
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model
