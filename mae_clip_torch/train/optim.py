"""Optimizers over the JAX package's parameter groups
(``mae_clip_tpu/train/optim.py``).

Each parameter gets a label from its name, as ``param_groups`` labels the
flax tree: ``text_encoder.*`` -> "text" (or "frozen"), ``image_encoder.*``
-> "image" (or "frozen"), ``logit_*`` -> "logit", the rest (the projection
heads) -> "head". Frozen parameters have ``requires_grad`` off and belong to
no group. Weight decay applies to every trainable leaf but the "logit" ones,
LayerNorms, biases and the cls/mask tokens included: that is what the JAX
package's optax transforms do here.

``cfg.optimizer`` picks the update of every group:

* ``adamw``: torch's AdamW, betas (0.9, 0.999), eps 1e-8, as optax's here;
* ``lamb``: ``Lamb``, optax's ``lamb(b1=0.9, b2=0.999, eps=1e-6)``;
* ``lion``: ``Lion``, optax's ``lion(b1=0.9, b2=0.99)``.

Torch has neither of the last two; both are written here on
``torch._foreach_*`` ops, as torch's own AdamW is, so a step launches a
few kernels for all the tensors of a group, not a few for each tensor.

Two step pre-hooks run inside ``optimizer.step()`` (and its profiler span),
before the update:

* with ``cfg.grad_clip_norm > 0``, ``clip_grad_norm_`` scales the
  trainable gradients by ``min(1, max / (norm + 1e-6))``, ``norm`` their
  global L2 norm (frozen parameters have no gradient to count), on the
  card: nothing waits for it;
* every group's lr is set to ``lr_at(cfg, peak, count) * lr_scale``,
  ``count`` the updates done before this one, as optax evaluates a
  schedule (0 on the first update, so a warmup's first update has lr 0).
  Host arithmetic.

``lr_scale`` is the plateau scheduler's scale (``ReduceLROnPlateau``,
``set_lr_scale``; 1 at the start). JAX multiplies the whole update by it
after AdamW, LAMB or Lion (``scale_by_dynamic``, last in the chain); for
all three that is the lr times the scale, since each scales its whole
step, the decay included, by the lr. It is stored in every parameter
group, so the optimizer's ``state_dict`` (and a checkpoint) carries it,
and it is folded into the lr in the schedule hook, which sets the lr
before every update.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

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


def _check_schedule(cfg: Config) -> None:
    if cfg.lr_schedule == "constant":
        return
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if not cfg.decay_steps:
        raise ValueError("lr_schedule='cosine' needs decay_steps > 0 (total "
                         "train steps)")
    if cfg.decay_steps <= cfg.warmup_steps:
        raise ValueError(f"lr_schedule='cosine' needs decay_steps "
                         f"({cfg.decay_steps}) > warmup_steps "
                         f"({cfg.warmup_steps})")


def lr_at(cfg: Config, peak: float, count: int) -> float:
    """``cfg.lr_schedule``'s lr after ``count`` updates: ``peak``, or
    optax's ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, 0)`` at ``count``: linear from 0 over the warmup, then a
    half cosine to 0 at ``decay_steps``, and 0 after it."""
    _check_schedule(cfg)
    if cfg.lr_schedule == "constant":
        return peak
    warmup = cfg.warmup_steps
    if count < warmup:
        return peak * count / warmup
    span = cfg.decay_steps - warmup
    done = min(count - warmup, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * done / span))


def get_lr_scale(optimizer: torch.optim.Optimizer) -> float:
    """The plateau scale the optimizer's updates run at."""
    return float(optimizer.param_groups[0]["lr_scale"])


def set_lr_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    """Set the plateau scale of every group (the next update's lr is its
    schedule's times ``scale``)."""
    for group in optimizer.param_groups:
        group["lr_scale"] = float(scale)


def current_lr(cfg: Config, optimizer: Optional[torch.optim.Optimizer] = None,
               step: Optional[int] = None) -> float:
    """The first parameter group's lr at ``step`` (0 when not given) times
    ``optimizer``'s plateau scale (1 without an optimizer), as the JAX
    package's ``current_lr``."""
    peak = cfg.lr if cfg.recipe == "py" else cfg.head_lr
    scale = 1.0 if optimizer is None else get_lr_scale(optimizer)
    return lr_at(cfg, peak, 0 if step is None else step) * scale


class ReduceLROnPlateau:
    """torch's ``ReduceLROnPlateau(mode='min')`` on an lr *scale*, as the
    JAX package's: ``step(metric)`` returns the scale to install with
    ``set_lr_scale``. The reference builds it with ``patience=2``,
    ``factor=0.5`` (``Config.patience``, ``Config.factor``)."""

    def __init__(self, patience: int = 2, factor: float = 0.5,
                 threshold: float = 1e-4, min_scale: float = 0.0):
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_scale = min_scale
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.scale = 1.0

    def is_better(self, metric: float) -> bool:
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        if self.is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.num_bad_epochs = 0
        return self.scale

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "scale": self.scale}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
        self.scale = d["scale"]


@torch.no_grad()
def clip_grad_norm_(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """Scale the gradients of ``params`` in place by ``min(1, max_norm /
    (norm + 1e-6))``, ``norm`` their global L2 norm (torch's
    ``clip_grad_norm_`` formula; optax ``clip_by_trainable_global_norm``).
    Nothing waits for the card."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.clamp(max_norm / (norm + 1e-6),
                                               max=1.0))


def _with_grads(group: dict):
    params = [p for p in group["params"] if p.grad is not None]
    return params, [p.grad for p in params]


def _moments(state: dict, params: List[torch.Tensor],
             *names: str) -> List[List[torch.Tensor]]:
    """Each name's buffer of every param, zeros at the first step."""
    for p in params:
        if not state[p]:
            state[p].update({n: torch.zeros_like(p) for n in names})
    return [[state[p][n] for p in params] for n in names]


class Lamb(torch.optim.Optimizer):
    """LAMB (arXiv:1904.00962) as optax's ``lamb``: Adam's bias-corrected
    direction ``u = m_hat / (sqrt(v_hat) + eps)``, plus ``weight_decay *
    p``, scaled per tensor by the trust ratio ``||p|| / ||u||`` (1 where
    either norm is 0), then by ``-lr``. The decay sits inside the ratio:
    this is not torch's decoupled decay."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            group["step"] = t = group.get("step", 0) + 1
            m, v = _moments(self.state, params, "exp_avg", "exp_avg_sq")
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            u = torch._foreach_div(m, 1.0 - b1 ** t)
            den = torch._foreach_div(v, 1.0 - b2 ** t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(u, den)
            if group["weight_decay"]:
                torch._foreach_add_(u, params, alpha=group["weight_decay"])
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(u))
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            # The ratios stay 0-d tensors on the card: no host read.
            torch._foreach_addcmul_(params, u, list(ratio.unbind()),
                                    value=-group["lr"])


class Lion(torch.optim.Optimizer):
    """Lion (arXiv:2302.06675) as optax's ``lion``: ``u = sign((1 - b1) g +
    b1 m)``, then ``m <- b2 m + (1 - b2) g``, then ``u + weight_decay * p``
    scaled by ``-lr``."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            b1, b2 = group["betas"]
            (m,) = _moments(self.state, params, "exp_avg")
            u = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(u, m, alpha=b1)
            torch._foreach_sign_(u)
            torch._foreach_mul_(m, b2)
            torch._foreach_add_(m, grads, alpha=1.0 - b2)
            if group["weight_decay"]:
                torch._foreach_add_(u, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, u, alpha=-group["lr"])


def _build(cfg: Config, groups: List[dict]) -> torch.optim.Optimizer:
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "lamb":
        return Lamb(groups, betas=(0.9, 0.999), eps=1e-6)
    if cfg.optimizer == "lion":
        return Lion(groups, betas=(0.9, 0.99))
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.Optimizer:
    """``cfg.optimizer`` over ``model``'s trainable parameters with
    ``cfg.recipe``'s per-group peak lr and weight decay, the schedule and
    the clip as step pre-hooks (module docstring). Each group keeps its
    ``peak_lr``, the ``count`` of updates done and the plateau
    ``lr_scale``."""
    _check_schedule(cfg)
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
    groups = [dict(params=members[label], lr=lr_at(cfg, lr, 0), peak_lr=lr,
                   count=0, lr_scale=1.0, weight_decay=wd, name=label)
              for label, (lr, wd) in hyper.items() if members[label]]
    optimizer = _build(cfg, groups)
    if cfg.grad_clip_norm > 0:
        trainable = [p for g in groups for p in g["params"]]
        optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: clip_grad_norm_(trainable,
                                                      cfg.grad_clip_norm))

    def schedule(opt, args, kwargs):
        for group in opt.param_groups:
            group["lr"] = (lr_at(cfg, group["peak_lr"], group["count"])
                           * group["lr_scale"])
            group["count"] += 1

    optimizer.register_step_pre_hook(schedule)
    return optimizer
