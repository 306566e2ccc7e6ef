"""TrainState: what a step needs besides the batch (``mae_clip_tpu/train/state.py``).

The JAX state is one pytree (params, optimizer state, step, rng). Here the
model and the optimizer carry the parameters and the moments; the state
holds them with the step count, the seed, and the ``torch.Generator`` that
draws the training steps' MAE masks and crops, on the model's device. An
eval step draws from a generator of its own, seeded from the seed and the
step (``eval_generator``), as the JAX eval step folds the step into the
state's key: two evals at one state agree, and an eval leaves the training
stream alone. EMA parameters are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from mae_clip_torch.config import Config


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    seed: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               seed: int = 0, cfg: Optional[Config] = None) -> "TrainState":
        """``cfg`` defaults to ``model.cfg`` (a ``CLIPModel``'s); a
        standalone ``MAEViT`` has none and is passed its config here."""
        cfg = model.cfg if cfg is None else cfg
        if cfg.ema_decay > 0:
            raise NotImplementedError("ema_decay > 0: EMA parameters are "
                                      "not ported")
        if cfg.remat:
            raise NotImplementedError("remat=True: recomputing the tower "
                                      "blocks in the backward is not ported")
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        return cls(step=0, model=model, optimizer=optimizer,
                   generator=generator, seed=seed)

    def eval_generator(self) -> torch.Generator:
        """A fresh generator on the model's device, seeded from ``seed`` and
        ``step`` alone."""
        mixed = np.random.SeedSequence([self.seed, self.step]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.generator.device).manual_seed(
            int(mixed) >> 1)
