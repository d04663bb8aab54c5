"""Weight interchange with the JAX package (numpy trees, no JAX import)."""

from m4depth_tpu_torch.interop.from_jax import (
    load_jax_params,
    state_dict_from_jax,
)

__all__ = ["load_jax_params", "state_dict_from_jax"]
