"""TrainState: what a step needs besides the batch (``mae_clip_tpu/train/state.py``).

The JAX state is one pytree (params, optimizer state, step, rng). Here the
model and the optimizer carry the parameters and the moments; the state
holds them with the step count and the ``torch.Generator`` that draws the
MAE masks, on the model's device. EMA parameters are not ported.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               seed: int = 0) -> "TrainState":
        if model.cfg.ema_decay > 0:
            raise NotImplementedError("ema_decay > 0: EMA parameters are "
                                      "not ported")
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        return cls(step=0, model=model, optimizer=optimizer,
                   generator=generator)
