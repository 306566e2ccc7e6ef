"""Masked autoencoder over the ViT image tower (``mae_clip_tpu/models/mae.py``).

``MAEViT`` holds the encoder (shared with CLIP) and the decoder parameters,
so a flagship parameter tree converts whole. Only the inference entry point
is ported so far: ``encode_full`` (every patch, no decoder), the image tower
of retrieval and zero-shot. The masked training pass and the decoder raise
``NotImplementedError`` until the training path is ported.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mae_clip_torch.models.layers import Dense, LayerNorm
from mae_clip_torch.models.vit import (Mlp, PatchEmbed, ViTBlock, ViTConfig,
                                       sincos_pos_embed_2d)

_TRAINING_PATH = ("the MAE masked pass and decoder are not ported yet; they "
                  "come with the training path")


@dataclasses.dataclass(frozen=True)
class MAEDecoderConfig:
    dim: int = 256
    depth: int = 4
    n_heads: int = 2
    mlp_ratio: float = 4.0
    gelu: str = "tanh"


class CrossAttention(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.q = Dense(dim, dim, dtype)
        self.kv = Dense(dim, 2 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)


class CrossAttnBlock(nn.Module):
    """CrossMAE decoder block (parameters only; its forward is not ported)."""

    def __init__(self, config: ViTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.norm1 = LayerNorm(c.dim, 1e-6, dtype)
        self.norm_kv = LayerNorm(c.dim, 1e-6, dtype)
        self.attn = CrossAttention(c.dim, dtype)
        self.norm2 = LayerNorm(c.dim, 1e-6, dtype)
        self.mlp = Mlp(c.dim, int(c.dim * c.mlp_ratio), c.gelu, dtype)

    def forward(self, q_tokens, kv_tokens):
        raise NotImplementedError(_TRAINING_PATH)


class MAEViT(nn.Module):
    """ViT encoder (shared with CLIP) + MAE decoder parameters."""

    def __init__(self, config: ViTConfig,
                 decoder: MAEDecoderConfig = MAEDecoderConfig(),
                 mask_ratio: float = 0.75, channels: int = 3,
                 decoder_style: str = "full",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if decoder_style not in ("full", "cross"):
            raise ValueError(f"unknown decoder_style {decoder_style!r}")
        c, d = config, decoder
        self.config, self.decoder, self.mask_ratio = c, d, mask_ratio
        self.decoder_style = decoder_style

        self.patch_embed = PatchEmbed(c, channels, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.blocks = nn.ModuleList(ViTBlock(c, dtype) for _ in range(c.depth))
        self.norm = LayerNorm(c.dim, 1e-6, dtype)
        self.register_buffer("enc_pe", torch.from_numpy(
            sincos_pos_embed_2d(c.dim, c.grid_size, cls_token=True))[None],
            persistent=False)

        self.decoder_embed = Dense(c.dim, d.dim, dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d.dim))
        dec_cfg = ViTConfig(image_size=c.image_size, patch_size=c.patch_size,
                            dim=d.dim, depth=d.depth, n_heads=d.n_heads,
                            mlp_ratio=d.mlp_ratio, gelu=d.gelu)
        block = ViTBlock if decoder_style == "full" else CrossAttnBlock
        self.decoder_blocks = nn.ModuleList(
            block(dec_cfg, dtype) for _ in range(d.depth))
        self.decoder_norm = LayerNorm(d.dim, 1e-6, dtype)
        self.decoder_pred = Dense(d.dim, c.patch_size ** 2 * channels, dtype)

    def encode_full(self, images: torch.Tensor) -> torch.Tensor:
        """Full-sequence inference pass: the pooled CLS over ALL patches."""
        x = self.patch_embed(images)
        pe = self.enc_pe
        x = x + pe[:, 1:].to(x.dtype)
        cls = (self.cls_token + pe[:, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls.to(x.dtype), x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)[:, 0]

    def forward(self, images, masking=None):
        raise NotImplementedError(_TRAINING_PATH)
