"""Optimizer: two-group Adam with per-step exponential LR decay
(counterpart of tensorf_tpu/train/optim.py, which builds it with optax).

Spatial grids (planes, lines) train at ``lr_init`` and the network (basis,
shading MLP) at ``lr_basis``; betas (0.9, 0.99), eps 1e-8 outside the sqrt,
with bias correction.  Step t (counting from 0) uses lr0 * factor**t —
the schedule of the JAX version's ``-lr0 * lr_factor**count``.
"""

from __future__ import annotations

import torch

from ..models.tensorf import spatial_label_tree


class TwoGroupAdam:
    """torch.optim.Adam over the two groups plus the exponential LR decay."""

    def __init__(self, field: torch.nn.Module, lr_init: float, lr_basis: float,
                 lr_factor: float):
        labels = spatial_label_tree(field)
        groups = {"spatial": [], "network": []}
        for name, p in field.named_parameters():
            groups[labels[name]].append(p)
        self.adam = torch.optim.Adam(
            [
                {"params": groups["spatial"], "lr": lr_init},
                {"params": groups["network"], "lr": lr_basis},
            ],
            betas=(0.9, 0.99),
            eps=1e-8,
        )
        self.schedule = torch.optim.lr_scheduler.ExponentialLR(self.adam, gamma=lr_factor)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.adam.step()
        self.schedule.step()


def make_optimizer(
    field: torch.nn.Module,
    lr_init: float = 0.02,
    lr_basis: float = 1e-3,
    lr_factor: float = 1.0,
) -> TwoGroupAdam:
    return TwoGroupAdam(field, lr_init, lr_basis, lr_factor)
