"""Plain float32 training steps of M4Depth: the window's forward, the loss
(``m4depth.m4depth_loss``), autograd's gradients and Adam (betas 0.9 and
0.999, eps 1e-8, no clip: the reference's recipe), written out.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_gpu.reference.m4depth import m4depth_loss, window
from bench_gpu.reference.ops import Numerics

BETAS = (0.9, 0.999)
EPS = 1e-8


def train_steps(params: Dict[str, torch.Tensor], cfg: dict,
                batches: List[dict], lr: float, num: Numerics) -> dict:
    """Adam steps from ``params`` (float32, not modified), one a batch.
    Returns each step's loss, the first step's gradients and the
    parameters after the last step."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in
         params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    for t, batch in enumerate(batches, start=1):
        preds = window(p, cfg, batch["rgb"], batch["rot"], batch["trans"],
                       batch["camera_f"], batch["camera_c"], num)
        loss = m4depth_loss(batch["depth"], preds)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(loss.item())
        with torch.no_grad():
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in zip(p, grads)}
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mhat = m[k] / (1 - BETAS[0] ** t)
                vhat = v2[k] / (1 - BETAS[1] ** t)
                w.sub_(lr * mhat / (vhat.sqrt() + EPS))
        del preds, loss, grads
    return dict(losses=losses, grads=first_grads,
                params={k: w.detach() for k, w in p.items()})
