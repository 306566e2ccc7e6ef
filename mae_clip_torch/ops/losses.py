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

``clip_soft_ce_loss_chunked`` and ``clip_hard_ce_loss_chunked`` are the
one-device forms of the JAX package's chunked global losses
(``global_clip_soft_ce_loss_chunked``, ``global_clip_hard_ce_loss(
chunk_size > 0)``) with the all-gathers and sums over devices taken as
identities: the columns stream in ``chunk_size`` blocks with an online
log-sum-exp (arXiv:2410.17243), so no (B, B) matrix is ever held, forward
or backward. Each block's body runs under ``torch.utils.checkpoint``
(``layers.run_block``), as JAX wraps its scan bodies in
``jax.checkpoint``: the backward recomputes a block's (B, chunk) scores
instead of keeping every block's.

All of it reduces in fp32. The cross-device forms are not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from mae_clip_torch.models.layers import run_block
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


def _chunks(n: int, chunk_size: int):
    """``(start, stop)`` of each block of ``chunk_size`` columns; the last
    one is shorter where ``chunk_size`` does not divide ``n`` (it holds
    only real columns, so it needs no padding to mask)."""
    return [(s, min(s + chunk_size, n)) for s in range(0, n, chunk_size)]


def _online_lse(m: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
                col_valid: torch.Tensor):
    """One block of columns into a running row log-sum-exp ``m + log(s)``;
    invalid columns get ``_NEG_INF`` first."""
    x = _mask_cols(x, col_valid)
    m_new = torch.maximum(m, x.amax(dim=1))
    s_new = (s * torch.exp(m - m_new)
             + torch.exp(x - m_new[:, None]).sum(dim=1))
    return m_new, s_new


def _soft_scores(img, txt, ci, ct, t):
    """A block's (B, chunk) scores: the soft targets' similarity, the
    logits (texts over images) and their transpose's rows (images over
    texts)."""
    sim = (img @ ci.T + txt @ ct.T) / 2 * t
    return sim, (txt @ ci.T) / t, (img @ ct.T) / t


def clip_soft_ce_loss_chunked(image_embeddings: torch.Tensor,
                              text_embeddings: torch.Tensor,
                              temperature=1.0,
                              valid: Optional[torch.Tensor] = None,
                              chunk_size: int = 1024) -> torch.Tensor:
    """``clip_soft_ce_loss`` in two passes over blocks of ``chunk_size``
    columns: the row log-sum-exp of the similarity, the logits and their
    transpose; then the expectation terms, ``texts_loss[i] = z_log[i] -
    sum_j p_sim[i, j] logits[i, j]`` and ``images_loss[i] = sum_j t_ji
    (z_logT[i] - logitsT[i, j])`` with ``t_ji = exp(sim[j, i] - z_sim[j])``
    (the similarity is symmetric, so its column block is a row block).
    Padded columns are masked before the exponentials (JAX masks after,
    which gives NaN gradients when a padded row's own similarity overflows
    the exp)."""
    img = image_embeddings.float()
    txt = text_embeddings.float()
    b = img.shape[0]
    if valid is None:
        valid = torch.ones(b, dtype=torch.bool, device=img.device)
    t = temperature
    blocks = _chunks(b, chunk_size)

    def lse_block(m_sim, s_sim, m_log, s_log, m_lt, s_lt, ci, ct, cv):
        sim, logits, logits_t = _soft_scores(img, txt, ci, ct, t)
        return (*_online_lse(m_sim, s_sim, sim, cv),
                *_online_lse(m_log, s_log, logits, cv),
                *_online_lse(m_lt, s_lt, logits_t, cv))

    m0 = torch.full((b,), -torch.inf, device=img.device)
    s0 = torch.zeros(b, device=img.device)
    carry = (m0, s0) * 3
    for lo, hi in blocks:
        carry = run_block(lse_block, *carry, img[lo:hi], txt[lo:hi],
                          valid[lo:hi], remat=True)
    z_sim, z_log, z_logT = (m + torch.log(s)
                            for m, s in zip(carry[::2], carry[1::2]))

    def acc_block(acc_txt, acc_img, ci, ct, cv, cz):
        sim, logits, logits_t = _soft_scores(img, txt, ci, ct, t)
        # Invalid columns are masked before the exp, not after: a padded
        # row's own similarity can exceed its normaliser by more than fp32's
        # exp range, and the backward of exp(inf) masked afterwards is NaN.
        p_sim = torch.exp(_mask_cols(sim - z_sim[:, None], cv))
        t_cols = torch.exp(_mask_cols(sim - cz[None, :], cv))
        return (acc_txt + (p_sim * logits).sum(dim=1),
                acc_img + (t_cols * (z_logT[:, None] - logits_t)).sum(dim=1))

    acc_txt = acc_img = torch.zeros(b, device=img.device)
    for lo, hi in blocks:
        acc_txt, acc_img = run_block(acc_block, acc_txt, acc_img,
                                     img[lo:hi], txt[lo:hi], valid[lo:hi],
                                     z_sim[lo:hi], remat=True)
    return _mean_valid((acc_img + z_log - acc_txt) / 2.0, valid)


def clip_hard_ce_loss_chunked(image_embeddings: torch.Tensor,
                              text_embeddings: torch.Tensor,
                              temperature=1.0,
                              valid: Optional[torch.Tensor] = None,
                              chunk_size: int = 1024) -> torch.Tensor:
    """``clip_hard_ce_loss`` in one pass over blocks of ``chunk_size``
    columns: the online log-sum-exp of both orientations' rows, and each
    row's positive logit taken from the block that holds its column."""
    img = l2_normalize(image_embeddings.float())
    txt = l2_normalize(text_embeddings.float())
    b = img.shape[0]
    if valid is None:
        valid = torch.ones(b, dtype=torch.bool, device=img.device)
    t = temperature

    def block(m_txt, s_txt, m_img, s_img, ci, ct, cv, lo, hi):
        x_txt = (txt @ ci.T) / t       # texts over this block's images
        x_img = (img @ ct.T) / t       # images over this block's texts
        # The positives are copied out: a view would keep the whole
        # (B, chunk) block alive until the backward.
        return (*_online_lse(m_txt, s_txt, x_txt, cv),
                *_online_lse(m_img, s_img, x_img, cv),
                x_txt[lo:hi].diagonal().clone(),
                x_img[lo:hi].diagonal().clone())

    m0 = torch.full((b,), -torch.inf, device=img.device)
    s0 = torch.zeros(b, device=img.device)
    carry = (m0, s0, m0, s0)
    own_txt, own_img = [], []
    for lo, hi in _chunks(b, chunk_size):
        *carry, o_txt, o_img = run_block(block, *carry, img[lo:hi],
                                         txt[lo:hi], valid[lo:hi], lo, hi,
                                         remat=True)
        own_txt.append(o_txt)
        own_img.append(o_img)
    z_txt = carry[0] + torch.log(carry[1])
    z_img = carry[2] + torch.log(carry[3])
    per_row = ((z_txt - torch.cat(own_txt))
               + (z_img - torch.cat(own_img))) / 2.0
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


def contrastive_loss_fn(cfg, chunk_size: int = 0) -> Callable:
    """The contrastive loss ``cfg`` selects, as ``fn(img, txt, valid,
    extras)``; ``extras`` is ``loss_extras(model)``, which the softmax
    losses at a fixed temperature ignore. With ``chunk_size > 0`` the
    softmax losses take their chunked forms; SigLIP's sum over pairs has
    no row normaliser to stream and stays as it is."""
    if cfg.contrastive_loss == "siglip":
        return lambda img, txt, valid, extras: siglip_loss(
            img, txt, extras["logit_scale"], extras["logit_bias"], valid)
    hard = cfg.contrastive_loss == "clip"
    if chunk_size > 0:
        chunked = (clip_hard_ce_loss_chunked if hard
                   else clip_soft_ce_loss_chunked)

        def local_fn(img, txt, temperature, valid):
            return chunked(img, txt, temperature, valid, chunk_size)
    else:
        local_fn = clip_hard_ce_loss if hard else clip_soft_ce_loss

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
