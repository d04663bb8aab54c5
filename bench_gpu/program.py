"""The system under test, ``m4depth_tpu_torch``, built from a configuration
file and given the benchmark's weights. The only module of the benchmark
that imports the port (the traffic drivers call the entry points it
returns)."""

from __future__ import annotations

from typing import Dict

import torch


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file (V1's refiner
    widths are the port's own constant, which loading the weights checks)."""
    from m4depth_tpu_torch.config import ModelConfig

    kw = dict(num_levels=cfg["num_levels"],
              encoder_channels=tuple(cfg["encoder_channels"]),
              search_range=cfg["search_range"],
              leaky_slope=cfg["leaky_slope"],
              compute_dtype=cfg["compute_dtype"], cv_dtype=cfg["cv_dtype"])
    if cfg["family"] == "m4depth":
        kw.update(refiner_prep_channels=tuple(cfg["refiner_prep_channels"]),
                  refiner_est_channels=tuple(cfg["refiner_est_channels"]),
                  sncv_search_range=cfg["sncv_search_range"])
    return ModelConfig(**kw)


def build_model(cfg: dict, params: Dict[str, torch.Tensor],
                device: torch.device):
    """The port's model of ``cfg``'s family on ``device``, holding
    ``params`` (every parameter, by name)."""
    from m4depth_tpu_torch.models import M4Depth, M4DepthV1

    mcfg = model_config(cfg)
    if cfg["family"] == "m4depth":
        model = M4Depth(mcfg, device=device)
    elif cfg["family"] == "m4depth-v1":
        model = M4DepthV1(mcfg, device=device, rot_dim=cfg["rot_dim"])
    else:
        raise ValueError(f"unknown model family {cfg['family']!r}")
    model.load_state_dict(params, strict=True)
    return model


def init_state(model, batch: int, h: int, w: int, device: torch.device):
    from m4depth_tpu_torch.models import init_state as port_init_state

    return port_init_state(model.cfg, batch, h, w, device=device)


def compile_stream(model, device: torch.device):
    """``sharded_stream`` over this one device: ``compile_step`` at the
    stream count's batch."""
    from m4depth_tpu_torch.parallel import sharded_stream

    return sharded_stream(model, [device])


def compile_train(model, learning_rate: float):
    """``compile_train_step`` with Adam at ``learning_rate`` (no clip, a
    constant rate): (step, optimizer)."""
    from m4depth_tpu_torch.config import TrainConfig
    from m4depth_tpu_torch.train import compile_train_step, make_optimizer

    opt = make_optimizer(model, TrainConfig(learning_rate=learning_rate))
    return compile_train_step(model, opt), opt


def graphs(step) -> int:
    """The CUDA graphs a compiled training step has captured."""
    return step.compiled.graphs


def camera(f: torch.Tensor, c: torch.Tensor):
    from m4depth_tpu_torch.geometry import Camera

    return Camera(f=f, c=c)
