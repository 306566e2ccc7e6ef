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

A BatchNorm tower (ResNet) trains on each forward's batch statistics and
updates its running ones as the JAX step does: once a step in one pass;
under accumulation once per microbatch, one after another (torch's
gradient-accumulation semantics), in pass 1 alone under GradCache, whose
pass 2 re-runs each microbatch in train mode and then puts back the
buffers pass 1 left (JAX feeds pass 2 the step's first statistics and
drops what it returns). The eval
steps read the running statistics; on EMA weights too, since EMA
averages parameters, not buffers (JAX's ``_eval_variables``).
``Config.validate`` still refuses a ResNet with ``accum_steps > 1``, as
JAX's does; the step factory runs one when called directly.

``Trainer`` runs the epochs (reference main.py:85-126), as the JAX
package's: ``fit`` runs train and valid epochs with count-weighted
meters, steps the plateau scheduler (per epoch with recipe ``notebook``
only, the reference's quirk, or per batch), saves the best-validation
epochs (``checkpoint_every``) and rolling mid-epoch step checkpoints
(``checkpoint_every_steps``), stops early (``early_stop_patience``),
calls ``eval_fn`` every ``eval_every`` epochs and writes each epoch's
scalars, the phase timings included. ``restore`` and
``restore_mid_epoch`` resume a run; resumed mid-epoch it continues bit
for bit. The losses stay on the model's device and are read
``metric_fetch_every`` at a time in one ``torch.stack(...).tolist()``
(every step when the batch scheduler or the progress bar needs them).
Batches come from a host loader (pinned, then copied with
``non_blocking``, the next one while the current step runs) or, as
``{indices, valid}``, from a ``DeviceStore`` gathered on the card. With a
store, ``steps_per_call`` K (JAX's K steps a call) only widens the read:
the losses are read max(``metric_fetch_every``, K) at a time, and the
losses, meters and state are those of K = 1. The cross-device paths (a
mesh of more than one device) are not ported and raise.
"""

from __future__ import annotations

import inspect
import math
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mae_clip_torch.config import Config
from mae_clip_torch.data.images import normalize_pixels, normalize_uint8
from mae_clip_torch.data.tokenizer import pad_token_batch
from mae_clip_torch.models.layers import BatchNorm
from mae_clip_torch.ops import augment
from mae_clip_torch.ops import losses as losses_lib
from mae_clip_torch.ops.masking import MaskingResult, random_masking
from mae_clip_torch.train.metrics import AvgMeter, MetricWriter, Throughput
from mae_clip_torch.train.optim import (ReduceLROnPlateau, current_lr,
                                        make_optimizer, set_lr_scale)
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


def _batch_norm_buffers(model) -> list:
    """The running statistics and counts of ``model``'s BatchNorms."""
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in m.buffers()]


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
            stats = _batch_norm_buffers(model)
            kept = [b.clone() for b in stats]
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
            if stats:
                with torch.no_grad():
                    torch._foreach_copy_(stats, kept)
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


def _mesh_devices(cfg: Config) -> int:
    """How many devices ``cfg.mesh`` asks for explicitly (-1, "all
    remaining", is the one the model is on)."""
    return max(cfg.mesh.data, 1) * max(cfg.mesh.model, 1)


class Trainer:
    """The epoch loop over ``model`` on its device (module docstring).
    ``objective``: ``"clip"`` (a ``CLIPModel``) or ``"mae"`` (a standalone
    ``MAEViT``; batches need only ``image`` and ``valid``). ``optimizer``
    defaults to ``make_optimizer(cfg, model)``."""

    def __init__(self, cfg: Config, model, optimizer=None,
                 checkpoint_manager=None,
                 writer: Optional[MetricWriter] = None,
                 progress: bool = False, objective: str = "clip",
                 train_store=None, valid_store=None,
                 step_checkpoint_manager=None):
        if objective not in ("clip", "mae"):
            raise ValueError(f"unknown objective {objective!r}")
        if _mesh_devices(cfg) > 1:
            raise NotImplementedError(
                f"a mesh of {_mesh_devices(cfg)} devices: the port trains "
                "on one device")
        self.cfg, self.model = cfg, model
        self.device = next(model.parameters()).device
        self.optimizer = (optimizer if optimizer is not None
                          else make_optimizer(cfg, model))
        self.state = TrainState.create(model, self.optimizer, seed=cfg.seed,
                                       cfg=cfg)
        if objective == "mae":
            if cfg.accum_steps > 1:
                raise ValueError(
                    "accum_steps > 1 is a contrastive-memory recipe "
                    "(GradCache); MAE pretraining has no cross-microbatch "
                    "coupling: lower batch_size instead")
            self.train_step = make_mae_pretrain_step(model, self.optimizer,
                                                     cfg)
            self.eval_step = make_mae_eval_step(model, cfg)
        else:
            self.train_step = make_train_step(model, self.optimizer, cfg,
                                              accum_steps=cfg.accum_steps)
            self.eval_step = make_eval_step(model, cfg)
        self.scheduler = ReduceLROnPlateau(cfg.patience, cfg.factor)
        self.checkpoint_manager = checkpoint_manager
        self.step_checkpoint_manager = step_checkpoint_manager
        self._epoch = 0
        self._ckpt_mark = 0
        self.writer = writer
        self.best_loss = float("inf")
        self.progress = progress
        self.throughput = Throughput(num_chips=1, device=self.device)
        self.train_store, self.valid_store = train_store, valid_store

    # -- batches -----------------------------------------------------------
    def _fetch_every(self, train: bool) -> int:
        """How many losses are read at once: 1 where the batch scheduler
        or the progress bar needs each one, else ``metric_fetch_every``,
        widened to ``steps_per_call`` on the store path."""
        cfg = self.cfg
        if self.progress or (train and cfg.scheduler_step == "batch"):
            return 1
        store = self.train_store if train else self.valid_store
        k = cfg.steps_per_call if store is not None else 1
        return max(1, cfg.metric_fetch_every, k)

    def _to_device(self, v) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _prepare(self, batch, store=None) -> Dict[str, torch.Tensor]:
        if store is not None and "indices" in batch:
            out = store.gather(batch["indices"])
            out["valid"] = self._to_device(batch["valid"])
            return out
        return {k: self._to_device(v) for k, v in batch.items()
                if k != "caption"}

    def _device_prefetch(self, loader: Iterable[Dict[str, Any]], store=None):
        """Each batch is sent to the card while the step before it runs."""
        prev_raw = prev_dev = None
        for batch in loader:
            dev = self._prepare(batch, store=store)
            if prev_dev is not None:
                yield prev_raw, prev_dev
            prev_raw, prev_dev = batch, dev
        if prev_dev is not None:
            yield prev_raw, prev_dev

    @staticmethod
    def _count(batch) -> int:
        if "valid" in batch:
            return int(np.asarray(batch["valid"]).sum())
        return int(np.asarray(batch["image"]).shape[0])

    def _progress_bar(self, iterable, desc: str):
        """tqdm over ``iterable`` with ``progress=True`` (the reference's
        bars, main.py:53,66,81)."""
        if not self.progress:
            return iterable
        try:
            from tqdm import tqdm
        except ImportError:
            warnings.warn("progress=True needs tqdm, which is not "
                          "installed: no progress bar")
            return iterable
        return tqdm(iterable, desc=desc)

    @staticmethod
    def _drain_pending(pending: list, meter: AvgMeter, last: float
                       ) -> Tuple[float, int]:
        """Read the pending (loss, count) pairs in one device->host copy and
        fold them into ``meter`` in order; pairs with no valid row are
        skipped. Returns (newest loss, examples)."""
        if not pending:
            return last, 0
        vals = torch.stack([loss.float() for loss, _ in pending]).tolist()
        total = 0
        for v, (_, count) in zip(vals, pending):
            last = v
            if count:
                meter.update(v, count)
            total += count
        pending.clear()
        return last, total

    # -- epochs --------------------------------------------------------------
    def _maybe_step_checkpoint(self, batches_done: int) -> None:
        """A rolling save every ``cfg.checkpoint_every_steps`` train
        batches, keyed by the optimizer step."""
        every = self.cfg.checkpoint_every_steps
        mgr = self.step_checkpoint_manager
        if mgr is None or every <= 0:
            return
        mark = batches_done // every
        if mark <= self._ckpt_mark:
            return
        self._ckpt_mark = mark
        mgr.save(self.state.step, self.state,
                 meta={"epoch": self._epoch, "batches_done": batches_done,
                       "scheduler": self.scheduler.state_dict(),
                       "best_loss": self.best_loss})

    @staticmethod
    def _skip(loader: Iterable, n: int):
        """The loader past its first ``n`` batches (mid-epoch resume)."""
        it = iter(loader)
        for _ in range(n):
            if next(it, None) is None:
                break
        return it

    def train_epoch(self, loader: Iterable[Dict[str, Any]],
                    skip_batches: int = 0) -> AvgMeter:
        cfg = self.cfg
        meter = AvgMeter("train_loss")
        every = cfg.checkpoint_every_steps
        self._ckpt_mark = skip_batches // every if every > 0 else 0
        batches_done = skip_batches
        if skip_batches:
            loader = self._skip(loader, skip_batches)
        self.throughput.start()
        fetch_every = self._fetch_every(train=True)
        bar = self._progress_bar(
            self._device_prefetch(loader, store=self.train_store), "train")
        pending = []
        last = 0.0
        for raw, batch in bar:
            count = self._count(raw)
            batches_done += 1
            metrics = self.train_step(self.state, batch)
            pending.append((metrics["loss"], count))
            self._maybe_step_checkpoint(batches_done)
            if len(pending) >= fetch_every:
                last, _ = self._drain_pending(pending, meter, last)
            if cfg.scheduler_step == "batch":
                self._scheduler_step(last)
            self.throughput.update(count)
            if self.progress and hasattr(bar, "set_postfix"):
                bar.set_postfix(train_loss=meter.avg,
                                lr=current_lr(cfg, self.optimizer,
                                              self.state.step))
        self._drain_pending(pending, meter, last)
        self.throughput.stop()
        return meter

    def valid_epoch(self, loader: Iterable[Dict[str, Any]]) -> AvgMeter:
        meter = AvgMeter("valid_loss")
        fetch_every = self._fetch_every(train=False)
        bar = self._progress_bar(loader, "valid")
        pending = []
        for batch in bar:
            prepared = self._prepare(batch, store=self.valid_store)
            metrics = self.eval_step(self.state, prepared)
            pending.append((metrics["loss"], self._count(batch)))
            if len(pending) >= fetch_every:
                self._drain_pending(pending, meter, 0.0)
            if self.progress and hasattr(bar, "set_postfix"):
                bar.set_postfix(valid_loss=meter.avg)
        self._drain_pending(pending, meter, 0.0)
        return meter

    def _scheduler_step(self, metric: float) -> None:
        set_lr_scale(self.optimizer, self.scheduler.step(metric))

    # -- resume ----------------------------------------------------------------
    def _restored(self, meta: Dict[str, Any]) -> None:
        if meta.get("scheduler"):
            self.scheduler.load_state_dict(meta["scheduler"])
        if meta.get("best_loss") is not None:
            self.best_loss = meta["best_loss"]

    def restore(self, step: Optional[int] = None) -> int:
        """Resume from an epoch checkpoint (None: the newest): the whole
        train state, the scheduler and the best loss. Returns its epoch."""
        if self.checkpoint_manager is None:
            raise ValueError("Trainer has no checkpoint_manager")
        step = step if step is not None else \
            self.checkpoint_manager.latest_step()
        self._restored(self.checkpoint_manager.restore(self.state, step))
        return int(step)

    def restore_mid_epoch(self, step: Optional[int] = None
                          ) -> Tuple[int, int]:
        """Resume from a step checkpoint (None: the newest); returns
        ``(epoch, batches_done)`` for ``fit(start_epoch=epoch,
        skip_batches=batches_done)``, which then continues bit for bit."""
        if self.step_checkpoint_manager is None:
            raise ValueError("Trainer has no step_checkpoint_manager")
        meta = self.step_checkpoint_manager.restore(self.state, step)
        self._restored(meta)
        return int(meta["epoch"]), int(meta["batches_done"])

    @staticmethod
    def _call_loader(fn: Callable, epoch: int):
        """Loader factories take the epoch (seeded shuffles) or nothing;
        chosen by the signature, not by catching a TypeError."""
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return fn(epoch)
        try:
            sig.bind(epoch)
        except TypeError:
            return fn()
        return fn(epoch)

    def fit(self, train_loader_fn: Callable, valid_loader_fn: Callable,
            epochs: Optional[int] = None, start_epoch: int = 0,
            skip_batches: int = 0,
            eval_fn: Optional[Callable[["Trainer", int], Dict[str, float]]]
            = None) -> Dict[str, Any]:
        """Train ``epochs`` (``cfg.epochs``) epochs from ``start_epoch``,
        the first one past ``skip_batches``; returns the history (losses,
        ``best_epoch``, ``best_valid_loss``, ``stopped_early``, and each
        scalar ``eval_fn(trainer, epoch)`` returns)."""
        cfg = self.cfg
        history: Dict[str, Any] = {"train_loss": [], "valid_loss": []}
        best_epoch = start_epoch - 1
        end = epochs if epochs is not None else cfg.epochs
        for epoch in range(start_epoch, end):
            self._epoch = epoch
            t0 = time.perf_counter()
            train_meter = self.train_epoch(
                self._call_loader(train_loader_fn, epoch),
                skip_batches=skip_batches if epoch == start_epoch else 0)
            t1 = time.perf_counter()
            valid_meter = self.valid_epoch(
                self._call_loader(valid_loader_fn, epoch))
            t2 = time.perf_counter()
            # The reference's quirk: with recipe 'py' the epoch scheduler
            # never steps (main.py:60-61,107), so the lr stays constant.
            if cfg.scheduler_step == "epoch" and cfg.recipe == "notebook":
                self._scheduler_step(valid_meter.avg)
            history["train_loss"].append(train_meter.avg)
            history["valid_loss"].append(valid_meter.avg)
            is_best = valid_meter.avg < self.best_loss
            if is_best:
                self.best_loss = valid_meter.avg
                best_epoch = epoch
            last = end - 1
            every = cfg.checkpoint_every
            due = every > 0 and (is_best or epoch == last
                                 or (epoch + 1) % every == 0)
            if self.checkpoint_manager is not None and due:
                self.checkpoint_manager.save(
                    epoch=epoch, state=self.state,
                    metrics={"valid_loss": valid_meter.avg},
                    scheduler=self.scheduler.state_dict(),
                    best_loss=self.best_loss)
            t3 = time.perf_counter()
            scalars = {
                "loss/train": train_meter.avg,
                "loss/val": valid_meter.avg,
                "lr": current_lr(cfg, self.optimizer, self.state.step),
                "throughput/examples_per_sec_per_chip":
                    self.throughput.examples_per_sec_per_chip,
                "time/train_s": round(t1 - t0, 3),
                "time/valid_s": round(t2 - t1, 3),
                "time/ckpt_s": round(t3 - t2, 3),
            }
            stopping = (cfg.early_stop_patience > 0
                        and epoch - best_epoch >= cfg.early_stop_patience)
            if eval_fn is not None and (epoch == last or stopping
                                        or (epoch + 1) % cfg.eval_every == 0):
                extra = eval_fn(self, epoch) or {}
                scalars["time/eval_s"] = round(time.perf_counter() - t3, 3)
                scalars.update(extra)
                for k, v in extra.items():
                    history.setdefault(k, []).append(v)
            if self.writer is not None:
                self.writer.write_scalars(epoch, scalars)
            if stopping:
                history["stopped_early"] = True
                break
        history["best_epoch"] = best_epoch
        history["best_valid_loss"] = self.best_loss
        return history
