"""TrainState: what a step needs besides the batch (``mae_clip_tpu/train/state.py``).

The JAX state is one pytree (params, optimizer state, step, rng). Here the
model and the optimizer carry the parameters and the moments; the state
holds them with the step count, the seed, and the ``torch.Generator`` that
draws the training steps' MAE masks and crops, on the model's device. An
eval step draws from a generator of its own, seeded from the seed and the
step (``eval_generator``), as the JAX eval step folds the step into the
state's key: two evals at one state agree, and an eval leaves the training
stream alone.

With ``cfg.ema_decay > 0`` the state also keeps ``ema``: an fp32 copy of
each trainable parameter by name, on the model's device, equal to the
parameters at creation (as JAX's ``ema_params``). ``update_ema`` moves it
towards the live parameters after each update; frozen parameters are
neither copied nor averaged (an eval on the EMA weights reads them live).
Buffers (a ResNet's BatchNorm running statistics) are not averaged either:
an eval on the EMA weights reads the live ones, as JAX's.

``state_dict`` / ``load_state_dict`` hold everything a resumed run needs
to continue bit for bit: the step and seed, the model's ``state_dict``
(parameters and BatchNorm buffers), the optimizer's (moments, counts, the
plateau scale), ``generator``'s state, the EMA, and torch's own RNG states
(the CPU's and, on the card, the card's), which dropout draws from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

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
    ema: Optional[Dict[str, torch.Tensor]] = None
    _ema_live: List[torch.Tensor] = dataclasses.field(default_factory=list,
                                                      repr=False)

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               seed: int = 0, cfg: Optional[Config] = None) -> "TrainState":
        """``cfg`` defaults to ``model.cfg`` (a ``CLIPModel``'s); a
        standalone ``MAEViT`` has none and is passed its config here."""
        cfg = model.cfg if cfg is None else cfg
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        state = cls(step=0, model=model, optimizer=optimizer,
                    generator=generator, seed=seed)
        if cfg.ema_decay > 0:
            trainable = [(n, p) for n, p in model.named_parameters()
                         if p.requires_grad]
            # The port keeps fp32 parameters, so the copy is fp32.
            state.ema = {n: p.detach().clone() for n, p in trainable}
            state._ema_live = [p for _, p in trainable]
        return state

    @torch.no_grad()
    def update_ema(self, decay: float) -> None:
        """``e <- decay * e + (1 - decay) * p`` for every EMA tensor, from
        the live parameters, in one multi-tensor lerp."""
        torch._foreach_lerp_(list(self.ema.values()), self._ema_live,
                             1.0 - decay)

    def eval_params(self, cfg: Config) -> Optional[Dict[str, torch.Tensor]]:
        """The weights an eval runs on in place of the live ones: the EMA
        with ``cfg.ema_decay > 0 and cfg.ema_eval``, else None (the live
        parameters)."""
        if cfg.ema_decay > 0 and cfg.ema_eval and self.ema is not None:
            return self.ema
        return None

    def eval_generator(self) -> torch.Generator:
        """A fresh generator on the model's device, seeded from ``seed`` and
        ``step`` alone."""
        mixed = np.random.SeedSequence([self.seed, self.step]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.generator.device).manual_seed(
            int(mixed) >> 1)

    def state_dict(self) -> Dict[str, Any]:
        device = self.generator.device
        return {"step": self.step, "seed": self.seed,
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(),
                "ema": self.ema,
                "cpu_rng": torch.get_rng_state(),
                "cuda_rng": (torch.cuda.get_rng_state(device)
                             if device.type == "cuda" else None)}

    @torch.no_grad()
    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """Restore ``state_dict()``'s contents in place (the model's and
        the optimizer's tensors stay the objects the steps hold)."""
        self.model.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.step, self.seed = int(d["step"]), int(d["seed"])
        self.generator.set_state(d["generator"])
        if (self.ema is None) != (d["ema"] is None):
            raise ValueError("the checkpoint and the state disagree on EMA")
        for name, e in (self.ema or {}).items():
            e.copy_(d["ema"][name])
        torch.set_rng_state(d["cpu_rng"])
        if d["cuda_rng"] is not None and self.generator.device.type == "cuda":
            torch.cuda.set_rng_state(d["cuda_rng"], self.generator.device)
