"""AdamW with the JAX package's parameter groups (``mae_clip_tpu/train/optim.py``).

Each parameter gets a label from its name, as ``param_groups`` labels the
flax tree: ``text_encoder.*`` -> "text" (or "frozen"), ``image_encoder.*``
-> "image" (or "frozen"), ``logit_*`` -> "logit", the rest (the projection
heads) -> "head". Frozen parameters have ``requires_grad`` off and belong to
no group. Weight decay applies to every trainable leaf but the "logit" ones,
LayerNorms, biases and the cls/mask tokens included: that is what the JAX
package's optax ``adamw`` does here.

Only what the flagship step runs is ported: AdamW (torch's, betas (0.9,
0.999), eps 1e-8 as optax's here), a constant learning rate, no clipping.
The LR scale of the JAX package's plateau scheduler starts at 1 and the
recipe-``py`` scheduler never steps, so it is left out.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mae_clip_torch.config import Config


def _group_of(cfg: Config, name: str) -> str:
    if name.startswith("text_encoder"):
        return "frozen" if not cfg.text_trainable else "text"
    if name.startswith("image_encoder"):
        return "frozen" if not cfg.trainable else "image"
    if name.startswith("logit_"):
        return "logit"
    return "head"


def param_groups(cfg: Config, model: nn.Module) -> Dict[str, str]:
    """Parameter name -> "head" | "image" | "text" | "logit" | "frozen"."""
    return {name: _group_of(cfg, name)
            for name, _ in model.named_parameters()}


def _check_ported(cfg: Config) -> None:
    if cfg.optimizer != "adamw":
        raise NotImplementedError(f"optimizer {cfg.optimizer!r}: only adamw "
                                  "is ported (lamb and lion are not)")
    if cfg.lr_schedule != "constant":
        raise NotImplementedError(f"lr_schedule {cfg.lr_schedule!r}: only "
                                  "the constant schedule is ported")
    if cfg.grad_clip_norm > 0:
        raise NotImplementedError("grad_clip_norm > 0: gradient clipping is "
                                  "not ported")


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.AdamW:
    """AdamW over ``model``'s trainable parameters with ``cfg.recipe``'s
    per-group learning rate and weight decay."""
    _check_ported(cfg)
    if cfg.recipe == "py":
        hyper = {"head": (cfg.lr, cfg.weight_decay),
                 "image": (cfg.lr, cfg.weight_decay),
                 "text": (cfg.lr, cfg.weight_decay),
                 "logit": (cfg.lr, 0.0)}
    elif cfg.recipe == "notebook":
        hyper = {"head": (cfg.head_lr, cfg.weight_decay),
                 "image": (cfg.image_encoder_lr, 0.0),
                 "text": (cfg.text_encoder_lr, 0.0),
                 "logit": (cfg.head_lr, 0.0)}
    else:
        raise ValueError(f"unknown recipe {cfg.recipe!r}")
    members = {label: [] for label in hyper}
    for name, param in model.named_parameters():
        label = _group_of(cfg, name)
        if label != "frozen":
            members[label].append(param)
    groups = [dict(params=members[label], lr=lr, weight_decay=wd,
                   name=label)
              for label, (lr, wd) in hyper.items() if members[label]]
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
