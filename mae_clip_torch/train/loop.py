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

The contrastive loss is the one-device form of the JAX step's
(``_clip_loss_fn``): with ``cfg.global_contrastive`` and
``cfg.loss_chunk_size > 0`` the softmax losses stream their columns in
blocks (``ops/losses.py``, the JAX step's 1-device-mesh route), SigLIP
keeps its local loss, and ``global_contrastive=False`` keeps the local
losses whatever the chunk size.

``make_train_step(..., accum_steps=k)`` splits the batch into k equal
microbatches for one update. With ``true_global_contrastive`` (the
default) it is GradCache (Gao et al., arXiv:2101.06983), as the JAX step:
the MAE masks drawn once for the whole batch (or the caller's) and cut per
microbatch; pass 1 embeds each microbatch without gradients; the
contrastive loss over the whole batch gives the embeddings' gradients and
the loss-only parameters' (``logit_scale``, ``logit_bias``); pass 2 runs
each microbatch again and back-propagates those gradients, and
``mae.loss_weight / k`` into its MAE loss. Each microbatch's RNG states
(``state.generator`` for the crops, torch's for dropout) are saved before
pass 1 and restored for pass 2, so both passes draw the same. The MAE
loss is the mean of the microbatch means, as in JAX; it equals the whole
batch's only when every microbatch holds as many valid rows. Without
``true_global_contrastive`` each microbatch has its own loss and
gradients, both averaged over k (the JAX step's legacy mode; each
microbatch draws its own masks). Under GradCache the two spans cover
pass 1 with the loss and pass 2; the legacy mode opens them once per
microbatch.

The Trainer, checkpoints and the cross-device losses are later slices.
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
from mae_clip_torch.ops.masking import MaskingResult, random_masking
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
    """The step's contrastive loss, ``fn(img, txt, valid, extras)``: the
    chunked softmax losses with ``cfg.global_contrastive`` and
    ``cfg.loss_chunk_size > 0``, else the local ones."""
    chunk = cfg.loss_chunk_size if cfg.global_contrastive else 0
    return losses_lib.contrastive_loss_fn(cfg, chunk)


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


def _microbatches(batch: Dict[str, torch.Tensor],
                  masking: Optional[MaskingResult], k: int) -> list:
    """``k`` equal slices of the batch along its rows, each with its slice
    of ``masking`` (or None)."""
    rows = batch["image"].shape[0]
    if rows % k:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{k} equal microbatches")
    size = rows // k
    return [({name: v[i * size:(i + 1) * size] for name, v in batch.items()},
             None if masking is None else MaskingResult(
                 *(x[i * size:(i + 1) * size] for x in masking)))
            for i in range(k)]


def _rng_states(generator: torch.Generator) -> tuple:
    """The states of ``generator`` and of torch's default generators (the
    CPU's and, on the card, the card's) that a microbatch draws from."""
    device = generator.device
    return (generator.get_state(), torch.get_rng_state(),
            torch.cuda.get_rng_state(device) if device.type == "cuda"
            else None)


def _set_rng_states(generator: torch.Generator, states: tuple) -> None:
    gen, cpu, card = states
    generator.set_state(gen)
    torch.set_rng_state(cpu)
    if card is not None:
        torch.cuda.set_rng_state(card, generator.device)


def _full_batch_masking(model, rows: int, generator: torch.Generator
                        ) -> Optional[MaskingResult]:
    """The MAE masks of the whole batch, drawn as the model draws them in
    one step (``MAEViT.forward``), or None without MAE."""
    if not model.cfg.mae.enabled:
        return None
    enc = model.image_encoder
    return random_masking(rows, enc.config.num_patches, enc.mask_ratio,
                          generator)


def make_train_step(model, optimizer: torch.optim.Optimizer, cfg: Config,
                    accum_steps: int = 1,
                    true_global_contrastive: bool = True):
    """``step(state, batch, masking=None) -> metrics``; updates the model in
    place and adds one to ``state.step``. ``accum_steps > 1`` accumulates
    over that many microbatches (GradCache with
    ``true_global_contrastive``, else the per-microbatch loss)."""
    if accum_steps < 1:
        raise ValueError("accum_steps must be >= 1")
    clip_loss_fn = _clip_loss_fn(cfg)

    def loss_of(batch, masking, generator):
        out = _forward(model, batch, True, generator, cfg, masking)
        return _metrics(cfg, out, clip_loss_fn(
            out["image_embeddings"], out["text_embeddings"],
            batch.get("valid"), losses_lib.loss_extras(model)))

    def single(state, batch, masking):
        with record_function("train_step.forward"):
            metrics = loss_of(batch, masking, state.generator)
        with record_function("train_step.backward"):
            optimizer.zero_grad(set_to_none=True)
            metrics["loss"].backward()
        return metrics

    def legacy(state, batch, masking):
        optimizer.zero_grad(set_to_none=True)
        total = {}
        for mb, mb_masking in _microbatches(batch, masking, accum_steps):
            with record_function("train_step.forward"):
                metrics = loss_of(mb, mb_masking, state.generator)
            with record_function("train_step.backward"):
                (metrics["loss"] / accum_steps).backward()
            for name, v in metrics.items():
                total[name] = total.get(name, 0.0) + v.detach()
        return {name: v / accum_steps for name, v in total.items()}

    def gradcache(state, batch, masking):
        gen = state.generator
        with record_function("train_step.forward"):
            if masking is None:
                masking = _full_batch_masking(model, batch["image"].shape[0],
                                              gen)
            micro = _microbatches(batch, masking, accum_steps)
            rng, imgs, txts, maes = [], [], [], []
            with torch.no_grad():   # pass 1: the embeddings alone
                for mb, mb_masking in micro:
                    rng.append(_rng_states(gen))
                    out = _forward(model, mb, True, gen, cfg, mb_masking)
                    imgs.append(out["image_embeddings"])
                    txts.append(out["text_embeddings"])
                    maes.append(out.get("mae_loss"))
            img = torch.cat(imgs).requires_grad_()
            txt = torch.cat(txts).requires_grad_()
            extras = losses_lib.loss_extras(model)
            clip_loss = clip_loss_fn(img, txt, batch.get("valid"), extras)
            d_img, d_txt, *d_extras = torch.autograd.grad(
                clip_loss, (img, txt, *extras.values()))
            metrics = {"clip_loss": clip_loss.detach(),
                       "loss": clip_loss.detach()}
            if cfg.mae.enabled:
                metrics["mae_loss"] = torch.stack(maes).mean()
                metrics["loss"] = (metrics["loss"]
                                   + cfg.mae.loss_weight * metrics["mae_loss"])
        with record_function("train_step.backward"):
            optimizer.zero_grad(set_to_none=True)
            mae_cot = torch.full((), cfg.mae.loss_weight / accum_steps,
                                 device=img.device)
            rows = img.shape[0] // accum_steps
            for i, (mb, mb_masking) in enumerate(micro):   # pass 2
                _set_rng_states(gen, rng[i])
                out = _forward(model, mb, True, gen, cfg, mb_masking)
                rows_i = slice(i * rows, (i + 1) * rows)
                outs = [out["image_embeddings"], out["text_embeddings"]]
                cots = [d_img[rows_i], d_txt[rows_i]]
                if "mae_loss" in out:
                    outs.append(out["mae_loss"])
                    cots.append(mae_cot)
                torch.autograd.backward(outs, cots)
            # The loss-only parameters do not reach the embeddings: their
            # gradients are the loss pass's alone.
            for p, g in zip(extras.values(), d_extras):
                p.grad = g
        return metrics

    run = (single if accum_steps == 1
           else gradcache if true_global_contrastive else legacy)

    def step(state: TrainState, batch,
             masking: Optional[MaskingResult] = None) -> Metrics:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer")
        metrics = run(state, _as_tensors(batch, model.device), masking)
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
