"""Contrastive and reconstruction losses, the local (one-device) forms
(``mae_clip_tpu/ops/losses.py``).

``clip_soft_ce_loss`` keeps the reference's quirks (reference CLIP.py:34-52),
as the JAX package does:

* soft targets ``softmax((img @ img.T + txt @ txt.T) / 2 * T)`` that receive
  gradients (never detached);
* embeddings not L2-normalised in the loss;
* logits divided by T, targets multiplied by T;
* padded rows excluded through ``valid``: invalid columns get ``-1e30``
  before the softmaxes and their terms are zeroed; the mean runs over valid
  rows.

``clip_hard_ce_loss`` is the CLIP paper's objective (arXiv:2103.00020):
L2-normalised embeddings, identity targets, the same padding rules.
``siglip_loss`` is the pairwise sigmoid loss (arXiv:2303.15343 eq. 1) with
the model's learnable ``logit_scale`` and ``logit_bias``, divided by the
count of valid rows. ``temperature_of`` maps a learnable log-scale onto the
temperature the softmax losses divide by, clamped at 1/100.

All of it reduces in fp32. The global (all-gathered or chunked) forms are
not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from mae_clip_torch.ops.retrieval import l2_normalize

# Large-but-finite: finfo.min overflows to -inf once the row max is
# subtracted inside the softmax, and 0 * -inf = nan poisons the soft-CE sum.
_NEG_INF = -1e30


def _mask_cols(logits: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    return torch.where(col_valid[None, :], logits,
                       torch.full_like(logits, _NEG_INF))


def _masked_log_softmax(logits: torch.Tensor,
                        col_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """log_softmax over the last dim with invalid columns excluded."""
    if col_valid is not None:
        logits = _mask_cols(logits, col_valid)
    return torch.log_softmax(logits, dim=-1)


def _masked_softmax(logits: torch.Tensor,
                    col_valid: Optional[torch.Tensor]) -> torch.Tensor:
    if col_valid is None:
        return torch.softmax(logits, dim=-1)
    probs = torch.softmax(_mask_cols(logits, col_valid), dim=-1)
    return torch.where(col_valid[None, :], probs, torch.zeros_like(probs))


def _soft_ce_rows(logits: torch.Tensor, targets: torch.Tensor,
                  col_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Row-wise soft cross-entropy with invalid columns contributing zero."""
    terms = -targets * _masked_log_softmax(logits, col_valid)
    if col_valid is not None:
        terms = torch.where(col_valid[None, :], terms, torch.zeros_like(terms))
    return terms.sum(dim=-1)


def clip_soft_ce_loss(image_embeddings: torch.Tensor,
                      text_embeddings: torch.Tensor,
                      temperature=1.0,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-target symmetric InfoNCE, the reference's math. ``temperature``
    is a float or a 0-d tensor; ``valid`` is an optional (B,) bool mask;
    False rows are padding."""
    img = image_embeddings.float()
    txt = text_embeddings.float()
    logits = (txt @ img.T) / temperature
    targets = _masked_softmax((img @ img.T + txt @ txt.T) / 2 * temperature,
                              valid)
    texts_loss = _soft_ce_rows(logits, targets, valid)
    images_loss = _soft_ce_rows(logits.T, targets.T, valid)
    return _mean_valid((images_loss + texts_loss) / 2.0, valid)


def _mean_valid(per_row: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``per_row`` over the valid rows (all rows without
    ``valid``)."""
    if valid is None:
        return per_row.mean()
    per_row = torch.where(valid, per_row, torch.zeros_like(per_row))
    return per_row.sum() / valid.sum().clamp(min=1)


def temperature_of(logit_scale: torch.Tensor) -> torch.Tensor:
    """``1 / min(exp(s), 100)``: the temperature of a CLIP-style log-space
    scale (arXiv:2103.00020 section 2.5)."""
    return 1.0 / torch.clamp(torch.exp(logit_scale), max=100.0)


def clip_hard_ce_loss(image_embeddings: torch.Tensor,
                      text_embeddings: torch.Tensor,
                      temperature=1.0,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric hard-label InfoNCE on L2-normalised embeddings; logits
    ``txt @ img.T / temperature`` (a float or a 0-d tensor). Padded rows
    are neither rows nor softmax columns; the mean runs over valid rows."""
    img = l2_normalize(image_embeddings.float())
    txt = l2_normalize(text_embeddings.float())
    logits = (txt @ img.T) / temperature
    logp_txt = _masked_log_softmax(logits, valid)
    logp_img = _masked_log_softmax(logits.T, valid)
    per_row = -(torch.diagonal(logp_txt) + torch.diagonal(logp_img)) / 2.0
    return _mean_valid(per_row, valid)


def siglip_loss(image_embeddings: torch.Tensor,
                text_embeddings: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise sigmoid loss: ``softplus(-m_ij * z_ij)`` summed over the
    valid pairs, ``z = exp(logit_scale) * img @ txt.T + logit_bias`` on
    L2-normalised embeddings, ``m`` +1 on the diagonal and -1 elsewhere;
    divided by the count of valid rows (the paper's 1/|B|), not of pairs."""
    img = l2_normalize(image_embeddings.float())
    txt = l2_normalize(text_embeddings.float())
    b = img.shape[0]
    logits = torch.exp(logit_scale) * (img @ txt.T) + logit_bias
    labels = 2.0 * torch.eye(b, device=img.device) - 1.0
    pair_loss = F.softplus(-labels * logits)
    if valid is None:
        return pair_loss.sum() / b
    v = valid.float()
    pair_loss = pair_loss * v[:, None] * v[None, :]
    return pair_loss.sum() / v.sum().clamp(min=1.0)


_LOSS_PARAM_NAMES = ("logit_scale", "logit_bias")


def loss_extras(model, params: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The model's learnable loss parameters (SigLIP's ``logit_scale`` and
    ``logit_bias``, or the learnable temperature's ``logit_scale``) by
    name, for the function of ``contrastive_loss_fn``; taken from
    ``params`` (the EMA weights) where it names them."""
    params = params or {}
    return {name: params.get(name, getattr(model, name))
            for name in _LOSS_PARAM_NAMES if hasattr(model, name)}


def contrastive_loss_fn(cfg) -> Callable:
    """The local contrastive loss ``cfg`` selects, as ``fn(img, txt, valid,
    extras)``; ``extras`` is ``loss_extras(model)``, which the softmax
    losses at a fixed temperature ignore."""
    if cfg.contrastive_loss == "siglip":
        return lambda img, txt, valid, extras: siglip_loss(
            img, txt, extras["logit_scale"], extras["logit_bias"], valid)
    local_fn = (clip_hard_ce_loss if cfg.contrastive_loss == "clip"
                else clip_soft_ce_loss)

    def fn(img, txt, valid, extras):
        temperature = (temperature_of(extras["logit_scale"])
                       if cfg.learnable_temperature else cfg.temperature)
        return local_fn(img, txt, temperature, valid)

    return fn


def mae_reconstruction_loss(pred_patches: torch.Tensor,
                            target_patches: torch.Tensor,
                            mask: torch.Tensor,
                            norm_pix: bool = True) -> torch.Tensor:
    """Pixel MSE over the masked patches (mask 1 = reconstruct). With
    ``norm_pix`` each target patch is normalised by its mean and biased
    variance (+ 1e-6) first."""
    target = target_patches.float()
    pred = pred_patches.float()
    if norm_pix:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = (pred - target).square().mean(dim=-1)
    mask = mask.float()
    return (per_patch * mask).sum() / mask.sum().clamp(min=1.0)


def cross_entropy_soft(preds: torch.Tensor, targets: torch.Tensor,
                       reduction: str = "none") -> torch.Tensor:
    """Row-wise soft cross-entropy (reference CLIP.py:46-52)."""
    loss = (-targets * torch.log_softmax(preds, dim=-1)).sum(dim=1)
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    raise ValueError(f"unknown reduction {reduction!r}")
