"""Contrastive and reconstruction losses, main-path part
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

All of it reduces in fp32. SigLIP, the hard-label loss, the learnable
temperature and the global (all-gathered or chunked) forms are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# Large-but-finite: finfo.min overflows to -inf once the row max is
# subtracted inside the softmax, and 0 * -inf = nan poisons the soft-CE sum.
_NEG_INF = -1e30


def _mask_cols(logits: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    return torch.where(col_valid[None, :], logits,
                       torch.full_like(logits, _NEG_INF))


def _masked_softmax(logits: torch.Tensor,
                    col_valid: Optional[torch.Tensor]) -> torch.Tensor:
    if col_valid is None:
        return torch.softmax(logits, dim=-1)
    probs = torch.softmax(_mask_cols(logits, col_valid), dim=-1)
    return torch.where(col_valid[None, :], probs, torch.zeros_like(probs))


def _soft_ce_rows(logits: torch.Tensor, targets: torch.Tensor,
                  col_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Row-wise soft cross-entropy with invalid columns contributing zero."""
    if col_valid is not None:
        logits = _mask_cols(logits, col_valid)
    terms = -targets * torch.log_softmax(logits, dim=-1)
    if col_valid is not None:
        terms = torch.where(col_valid[None, :], terms, torch.zeros_like(terms))
    return terms.sum(dim=-1)


def clip_soft_ce_loss(image_embeddings: torch.Tensor,
                      text_embeddings: torch.Tensor,
                      temperature: float = 1.0,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-target symmetric InfoNCE, the reference's math. ``valid`` is an
    optional (B,) bool mask; False rows are padding."""
    img = image_embeddings.float()
    txt = text_embeddings.float()
    logits = (txt @ img.T) / temperature
    targets = _masked_softmax((img @ img.T + txt @ txt.T) / 2 * temperature,
                              valid)
    texts_loss = _soft_ce_rows(logits, targets, valid)
    images_loss = _soft_ce_rows(logits.T, targets.T, valid)
    per_row = (images_loss + texts_loss) / 2.0
    if valid is None:
        return per_row.mean()
    per_row = torch.where(valid, per_row, torch.zeros_like(per_row))
    return per_row.sum() / valid.sum().clamp(min=1)


def contrastive_loss_fn(cfg) -> Callable:
    """The local contrastive loss ``cfg`` selects, as ``fn(img, txt,
    valid)``. Only the soft-target InfoNCE at a fixed temperature is ported;
    SigLIP, the hard-label loss and the learnable temperature raise."""
    if cfg.contrastive_loss != "softmax":
        raise NotImplementedError(f"contrastive_loss "
                                  f"{cfg.contrastive_loss!r} is not ported")
    if cfg.learnable_temperature:
        raise NotImplementedError("the learnable temperature is not ported")
    return lambda img, txt, valid: clip_soft_ce_loss(img, txt,
                                                     cfg.temperature, valid)


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
