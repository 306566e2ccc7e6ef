"""Dual-tower CLIP model (``mae_clip_tpu/models/clip.py``).

Image tower -> ProjectionHead(384/768/2048 -> projection_dim), DistilBERT
CLS -> ProjectionHead(768 -> projection_dim). With ``model_name='resnet50'``
the image tower is the ResNet-50 (``models/resnet.py``; ``resnet_shape``
gives other stage sizes and widths, as the JAX model's field does), whose
BatchNorms take batch statistics and update their running ones in train
mode (``forward(train=True)``, ``encode_image(train=True)``) and read the
running ones otherwise. With MAE enabled the image tower is a
``MAEViT``: ``forward`` runs its masked pass (and, with
``clip_from_masked=False``, a separate full pass for the contrastive
features), ``encode_image`` its full pass. ``forward`` returns the
embeddings and the losses: the contrastive loss ``cfg.contrastive_loss``
selects (soft-target InfoNCE, the hard-label CLIP loss or SigLIP) and the
norm-pix MAE loss. The SigLIP (``logit_scale`` + ``logit_bias``) and
learnable-temperature (``logit_scale``) parameters are created as in the
JAX package and trained in the "logit" group.

``cfg.remat`` recomputes the towers' blocks in the backward (the ViT or
MAE encoder's and DistilBERT's, per block; not the MAE decoder's or a
fused stack's, nor a ResNet block's), as the JAX package's ``nn.remat``.

A frozen tower (``trainable`` / ``text_trainable`` False) has
``requires_grad`` off, and with ``frozen_text_eval_mode`` the text tower
stays in eval mode (no dropout) when the model trains.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mae_clip_torch.config import Config
from mae_clip_torch.device import resolve_device
from mae_clip_torch.models.distilbert import DistilBertConfig, TextEncoder
from mae_clip_torch.models.layers import dtype_of, init_weights
from mae_clip_torch.models.mae import MAEDecoderConfig, MAEViT
from mae_clip_torch.models.projection import ProjectionHead
from mae_clip_torch.models.resnet import ResNet, resnet50
from mae_clip_torch.models.vit import (ViTConfig, ViTEncoder,
                                       _resolved_vit_config)
from mae_clip_torch.ops import losses as losses_lib
from mae_clip_torch.ops.masking import MaskingResult


def mae_vit_for(cfg: Config, vit_config: Optional[ViTConfig] = None,
                device: str = "cuda") -> MAEViT:
    """Standalone MAEViT on ``device`` with the geometry and parameter
    names ``CLIPModel`` embeds when MAE is enabled, so weights from MAE
    pretraining load into a CLIP image tower (``interop.transfer``)."""
    if not cfg.mae.enabled:
        raise ValueError("mae_vit_for requires cfg.mae.enabled")
    if dtype_of(cfg.param_dtype) != torch.float32:
        raise ValueError("the port keeps fp32 parameters")
    dec = MAEDecoderConfig(dim=cfg.mae.decoder_dim,
                           depth=cfg.mae.decoder_depth,
                           n_heads=cfg.mae.decoder_heads,
                           gelu=cfg.mae.decoder_gelu)
    model = MAEViT(_resolved_vit_config(cfg, vit_config), decoder=dec,
                   mask_ratio=cfg.mae.mask_ratio,
                   decoder_style=cfg.mae.decoder_style,
                   dtype=dtype_of(cfg.compute_dtype),
                   block_impl=cfg.fused_blocks, remat=cfg.remat)
    return model.to(resolve_device(device))


class CLIPModel(nn.Module):
    """The CLIP model: ``forward`` (embeddings + losses) and the embedding
    entry points. Built in eval mode; ``forward(train=True)`` switches it to
    train mode."""

    def __init__(self, cfg: Config,
                 text_config: DistilBertConfig = DistilBertConfig(),
                 vit_config: Optional[ViTConfig] = None,
                 device: str = "cuda",
                 resnet_shape: Optional[Tuple[Sequence[int],
                                              Sequence[int]]] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if dtype_of(cfg.param_dtype) != torch.float32:
            raise ValueError("the port keeps fp32 parameters")
        dtype = dtype_of(cfg.compute_dtype)

        if cfg.gelu_impl is not None:
            text_config = dataclasses.replace(text_config, gelu=cfg.gelu_impl)
        if cfg.text_heads is not None and text_config.dim % cfg.text_heads == 0:
            text_config = dataclasses.replace(text_config,
                                              n_heads=cfg.text_heads)
        self.text_config, self.vit_config = text_config, vit_config
        self.resnet_shape = resnet_shape

        if cfg.model_name == "resnet50":
            if cfg.mae.enabled:
                raise ValueError("MAE requires a ViT image tower")
            self.image_encoder = (resnet50(dtype) if resnet_shape is None
                                  else ResNet(tuple(resnet_shape[0]),
                                              tuple(resnet_shape[1]), dtype))
            image_dim = self.image_encoder.out_dim
        else:
            vcfg = _resolved_vit_config(cfg, vit_config)
            self.image_encoder = (mae_vit_for(cfg, vcfg, device)
                                  if cfg.mae.enabled
                                  else ViTEncoder(vcfg, dtype,
                                                  block_impl=cfg.fused_blocks,
                                                  remat=cfg.remat))
            image_dim = vcfg.dim
        self.text_encoder = TextEncoder(text_config, dtype, remat=cfg.remat)
        self.image_projection = ProjectionHead(image_dim, cfg.projection_dim,
                                               cfg.dropout, dtype)
        self.text_projection = ProjectionHead(text_config.dim,
                                              cfg.projection_dim,
                                              cfg.dropout, dtype)
        if cfg.contrastive_loss == "siglip":
            # arXiv:2303.15343 section 4: t' = log 10, b = -10 at init.
            self.logit_scale = nn.Parameter(torch.tensor(math.log(10.0)))
            self.logit_bias = nn.Parameter(torch.tensor(-10.0))
        elif cfg.learnable_temperature:
            self.logit_scale = nn.Parameter(
                torch.tensor(math.log(1.0 / cfg.temperature)))
        if not cfg.trainable:
            self.image_encoder.requires_grad_(False)
        if not cfg.text_trainable:
            self.text_encoder.requires_grad_(False)
        self.to(device)
        self.eval()

    def train(self, mode: bool = True) -> "CLIPModel":
        """As ``nn.Module.train``, but a frozen text tower with
        ``frozen_text_eval_mode`` stays in eval mode (LiT-style)."""
        super().train(mode)
        if mode and not self.cfg.text_trainable and \
                self.cfg.frozen_text_eval_mode:
            self.text_encoder.eval()
        return self

    @property
    def device(self) -> torch.device:
        return self.text_projection.fc.weight.device

    def init_weights(self, generator: torch.Generator) -> "CLIPModel":
        """Random init from a CPU ``generator`` (``layers.init_weights``);
        the logit scalars keep their fixed initial values."""
        return init_weights(self, generator)

    def encode_image(self, images: torch.Tensor,
                     train: bool = False) -> torch.Tensor:
        """Image features before projection; the full pass for MAE towers.
        ``train`` is JAX's flag for a ResNet tower's BatchNorm: False (the
        default, serving) reads the running statistics whatever the
        module's mode."""
        if self.cfg.model_name == "resnet50":
            return self.image_encoder(images, train=train)
        if self.cfg.mae.enabled:
            return self.image_encoder.encode_full(images)
        return self.image_encoder(images)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        return self.text_encoder(input_ids, attention_mask)

    def project_image(self, feats: torch.Tensor) -> torch.Tensor:
        return self.image_projection(feats)

    def project_text(self, feats: torch.Tensor) -> torch.Tensor:
        return self.text_projection(feats)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                masking: Optional[MaskingResult] = None,
                generator: Optional[torch.Generator] = None,
                compute_contrastive: bool = True) -> Dict[str, torch.Tensor]:
        """Embeddings and losses for ``batch``: ``image`` (normalised NHWC or
        patches), and ``text_features`` (B, 768) from the frozen-tower cache
        or ``input_ids`` / ``attention_mask``; optional ``valid`` (B,) bool.

        ``train`` sets the mode (dropout on or off) as the JAX package's flag
        does. ``masking`` gives the MAE mask indices, else they are drawn
        from ``generator``. With ``compute_contrastive=False`` the caller
        computes the contrastive loss (the train step does) and only
        ``mae_loss`` is returned with the embeddings."""
        cfg = self.cfg
        if train != self.training:
            self.train(train)
        valid = batch.get("valid")
        mae_out = None
        if cfg.mae.enabled:
            mae_out = self.image_encoder(batch["image"], generator=generator,
                                         masking=masking)
            image_features = (mae_out.pooled if cfg.mae.clip_from_masked else
                              self.image_encoder.encode_full(batch["image"]))
        else:
            image_features = self.image_encoder(batch["image"])

        if "text_features" in batch:
            text_features = batch["text_features"]
        elif cfg.text_trainable:
            text_features = self.text_encoder(batch["input_ids"],
                                              batch["attention_mask"])
        else:
            with torch.no_grad():
                text_features = self.text_encoder(batch["input_ids"],
                                                  batch["attention_mask"])
        out = {"image_embeddings": self.image_projection(image_features),
               "text_embeddings": self.text_projection(text_features)}
        if compute_contrastive:
            out["clip_loss"] = out["loss"] = losses_lib.contrastive_loss_fn(
                cfg)(out["image_embeddings"], out["text_embeddings"], valid,
                     losses_lib.loss_extras(self))
        if mae_out is not None:
            mae_mask = mae_out.mask
            if valid is not None:
                mae_mask = mae_mask * valid.float()[:, None]
            out["mae_loss"] = losses_lib.mae_reconstruction_loss(
                mae_out.pred_patches, mae_out.target_patches, mae_mask,
                norm_pix=cfg.mae.norm_pix_loss)
            if compute_contrastive:
                out["loss"] = out["clip_loss"] + cfg.mae.loss_weight * \
                    out["mae_loss"]
        return out
