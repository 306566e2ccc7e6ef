"""The train and eval steps (``mae_clip_tpu/train/loop.py``, single step).

``make_train_step(model, optimizer, cfg)`` returns ``step(state, batch,
masking=None) -> metrics``: uint8 images are prepared in the step, the
model runs in train mode (the MAE masks drawn from ``state.generator``
unless ``masking`` is given), the loss is the contrastive loss
``cfg.contrastive_loss`` selects (with the model's ``logit_scale`` /
``logit_bias``) plus ``cfg.mae.loss_weight`` times the MAE loss, then one
backward pass and one update: the optimizer's step (its clip and schedule
included), then, with ``cfg.learnable_temperature``, ``logit_scale``
clamped to at most log(100) (as the JAX step clamps the parameter), then,
with ``cfg.ema_decay > 0``, the EMA update from the clamped parameters.
The metrics are 0-d tensors on the model's device; nothing in the step
waits for the card. The forward and the backward run under the profiler
spans ``train_step.forward`` and ``train_step.backward``, the optimizer's
step (its clip and schedule hooks included) under its own
(``Optimizer.step#AdamW.step``, ``#Lamb.step``, ``#Lion.step``), and the
clamp and the EMA update, where there are any, under
``train_step.post_update``. (The spans do not nest: the profiler gives
an outer span no extent on the card when an inner one holds its kernels.)

``make_mae_pretrain_step(model, optimizer, cfg)`` is the image-only MAE
objective on a standalone ``MAEViT`` (He et al., arXiv:2111.06377): the
norm-pix reconstruction loss over the masked patches, weighted by the
``valid`` rows, with the same signature, update and spans.
``make_eval_step`` and ``make_mae_eval_step`` run in eval mode without
gradients, on the EMA weights when ``cfg.ema_decay > 0 and cfg.ema_eval``
(``torch.func.functional_call``; the live weights stay as they are); their
masks come from ``state.eval_generator()``, so an eval depends on the
state alone.

Image preparation (``_prep_images``): uint8 NHWC sources at another size
than ``cfg.size`` (``mae.aug_source_size``) get a RandomResizedCrop + flip
per train step, drawn from ``state.generator``, or a full-frame resize on
eval (``ops/augment.py``); uint8 at the model's geometry is only
normalised; anything else passes through.

The contrastive loss is the local one, as the JAX step computes it without a
mesh. Not ported, and raising: gradient accumulation (GradCache) and the
chunked loss. The global loss, the Trainer and checkpoints are later
slices.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from mae_clip_torch.config import Config
from mae_clip_torch.data.images import normalize_pixels, normalize_uint8
from mae_clip_torch.data.tokenizer import pad_token_batch
from mae_clip_torch.ops import augment
from mae_clip_torch.ops import losses as losses_lib
from mae_clip_torch.ops.masking import MaskingResult
from mae_clip_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


def _as_tensors(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _prep_images(images: torch.Tensor, cfg: Config, train: bool = False,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """uint8 NHWC sources at another size than ``cfg.size``: a
    RandomResizedCrop + flip from ``generator`` (train) or a full-frame
    resize (eval) to ``cfg.size``, then ImageNet normalisation. uint8 NHWC
    at the model's size or uint8 patches: normalisation only (4x less
    host->device traffic than fp32). Anything that is not uint8 passes
    through."""
    if images.dtype != torch.uint8:
        return images
    if images.dim() == 4 and images.shape[1] != cfg.size:
        if train:
            crops = augment.random_resized_crop_flip_batch(
                images, generator, cfg.size)
        else:
            crops = augment.resize_batch(images, cfg.size)
        return normalize_pixels(crops)
    return normalize_uint8(images)


def _call(model, params: Optional[Dict[str, torch.Tensor]], *args,
          **kwargs):
    """``model(*args, **kwargs)``, with ``params`` (the EMA weights) in
    place of the parameters they name where given."""
    if params is None:
        return model(*args, **kwargs)
    return torch.func.functional_call(model, params, args, kwargs)


def _forward(model, batch: Dict[str, torch.Tensor], train: bool,
             generator: Optional[torch.Generator], cfg: Config,
             masking: Optional[MaskingResult] = None,
             params: Optional[Dict[str, torch.Tensor]] = None) -> Metrics:
    batch = dict(batch, image=_prep_images(batch["image"], cfg, train,
                                           generator))
    return _call(model, params, batch, train=train, masking=masking,
                 generator=generator, compute_contrastive=False)


def _mae_images_and_forward(model, batch: Dict[str, torch.Tensor],
                            train: bool, generator: torch.Generator,
                            cfg: Config,
                            masking: Optional[MaskingResult],
                            params: Optional[Dict[str, torch.Tensor]] = None
                            ) -> torch.Tensor:
    """The image-only MAE loss of a standalone ``MAEViT``: the crops, then
    the masks, from ``generator``; padded rows (``valid`` false) weigh
    nothing."""
    if train != model.training:
        model.train(train)
    images = _prep_images(batch["image"], cfg, train, generator)
    out = _call(model, params, images, generator=generator, masking=masking)
    weight = out.mask
    if "valid" in batch:
        weight = weight * batch["valid"][:, None].to(weight.dtype)
    return losses_lib.mae_reconstruction_loss(
        out.pred_patches, out.target_patches, weight,
        norm_pix=cfg.mae.norm_pix_loss)


def _clip_loss_fn(cfg: Config) -> Callable:
    """The local contrastive loss: ``fn(img, txt, valid, extras)``."""
    if cfg.loss_chunk_size > 0:
        raise NotImplementedError("the chunked global contrastive loss is "
                                  "not ported")
    return losses_lib.contrastive_loss_fn(cfg)


def _metrics(cfg: Config, out: Metrics, clip_loss: torch.Tensor) -> Metrics:
    metrics = {"clip_loss": clip_loss, "loss": clip_loss}
    if "mae_loss" in out:
        metrics["mae_loss"] = out["mae_loss"]
        metrics["loss"] = clip_loss + cfg.mae.loss_weight * out["mae_loss"]
    return metrics


def _update(state: TrainState, cfg: Config) -> None:
    """The optimizer's step, the learnable temperature's clamp, the EMA."""
    state.optimizer.step()
    clamp = cfg.learnable_temperature and hasattr(state.model, "logit_scale")
    if clamp or state.ema is not None:
        with record_function("train_step.post_update"), torch.no_grad():
            if clamp:
                state.model.logit_scale.clamp_(max=math.log(100.0))
            if state.ema is not None:
                state.update_ema(cfg.ema_decay)
    state.step += 1


def make_train_step(model, optimizer: torch.optim.Optimizer, cfg: Config,
                    accum_steps: int = 1):
    """``step(state, batch, masking=None) -> metrics``; updates the model in
    place and adds one to ``state.step``."""
    if accum_steps != 1:
        raise NotImplementedError("accum_steps > 1 (GradCache accumulation) "
                                  "is not ported")
    clip_loss_fn = _clip_loss_fn(cfg)

    def step(state: TrainState, batch,
             masking: Optional[MaskingResult] = None) -> Metrics:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer")
        with record_function("train_step.forward"):
            batch = _as_tensors(batch, model.device)
            out = _forward(model, batch, True, state.generator, cfg, masking)
            metrics = _metrics(cfg, out, clip_loss_fn(
                out["image_embeddings"], out["text_embeddings"],
                batch.get("valid"), losses_lib.loss_extras(model)))
        with record_function("train_step.backward"):
            optimizer.zero_grad(set_to_none=True)
            metrics["loss"].backward()
        _update(state, cfg)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(model, cfg: Config):
    """``step(state, batch, masking=None) -> metrics``: eval mode (no
    dropout), no gradients, the same masking convention as training, on
    ``state.eval_params(cfg)``."""
    clip_loss_fn = _clip_loss_fn(cfg)

    @torch.no_grad()
    def step(state: TrainState, batch,
             masking: Optional[MaskingResult] = None) -> Metrics:
        batch = _as_tensors(batch, model.device)
        params = state.eval_params(cfg)
        out = _forward(model, batch, False, state.eval_generator(), cfg,
                       masking, params)
        return _metrics(cfg, out, clip_loss_fn(
            out["image_embeddings"], out["text_embeddings"],
            batch.get("valid"), losses_lib.loss_extras(model, params)))

    return step


def make_mae_pretrain_step(model, optimizer: torch.optim.Optimizer,
                           cfg: Config):
    """Image-only MAE pretraining: ``step(state, batch, masking=None) ->
    {"loss", "mae_loss"}`` on a standalone ``MAEViT`` (``mae_vit_for``, so
    its weights later load into a CLIP image tower); updates the model in
    place and adds one to ``state.step``."""

    def step(state: TrainState, batch,
             masking: Optional[MaskingResult] = None) -> Metrics:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer")
        with record_function("train_step.forward"):
            batch = _as_tensors(batch, model.device)
            loss = _mae_images_and_forward(model, batch, True,
                                           state.generator, cfg, masking)
        with record_function("train_step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        _update(state, cfg)
        loss = loss.detach()
        return {"loss": loss, "mae_loss": loss}

    return step


def make_mae_eval_step(model, cfg: Config):
    """The eval twin of ``make_mae_pretrain_step``: eval mode, no
    gradients, the full-frame resize, masks from
    ``state.eval_generator()``, on ``state.eval_params(cfg)``."""

    @torch.no_grad()
    def step(state: TrainState, batch,
             masking: Optional[MaskingResult] = None) -> Metrics:
        batch = _as_tensors(batch, model.device)
        loss = _mae_images_and_forward(model, batch, False,
                                       state.eval_generator(), cfg, masking,
                                       state.eval_params(cfg))
        return {"loss": loss, "mae_loss": loss}

    return step


def precompute_text_features(model, dataset,
                             batch_size: int = 512) -> np.ndarray:
    """One pass of the frozen text tower over a caption set, the LiT-style
    cache the flagship step reads as ``text_features``. ``dataset`` needs
    ``input_ids`` and ``attention_mask`` arrays (N, S). Returns (N, 768)
    float32 CLS features, before projection."""
    cfg = model.cfg
    if cfg.text_trainable or not cfg.frozen_text_eval_mode:
        raise ValueError(
            "text-feature caching requires a frozen text tower in eval "
            "mode (text_trainable=False, frozen_text_eval_mode=True); "
            "otherwise the tower output is not constant across steps")
    ids_all = np.asarray(dataset.input_ids)
    mask_all = np.asarray(dataset.attention_mask)
    out = []
    for start in range(0, len(ids_all), batch_size):
        count = min(batch_size, len(ids_all) - start)
        ids, mask = pad_token_batch(ids_all[start:start + batch_size],
                                    mask_all[start:start + batch_size],
                                    batch_size)
        with torch.no_grad():
            feats = model.encode_text(
                torch.as_tensor(ids, dtype=torch.long, device=model.device),
                torch.as_tensor(mask, device=model.device))
        out.append(feats.float().cpu().numpy()[:count])
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)
