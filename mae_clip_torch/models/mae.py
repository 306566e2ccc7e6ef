"""Masked autoencoder over the ViT image tower (``mae_clip_tpu/models/mae.py``).

``MAEViT`` holds the encoder (shared with CLIP) and the decoder, so a
flagship parameter tree converts whole. Two entry points over the same
parameters:

* ``forward(images, generator, masking)``: the masked training pass. The
  visible 25 % of the patches are gathered, embedded and encoded (CLS + K
  tokens). The pooled CLS feeds the contrastive loss (FLIP recipe). Then one
  of two decoders:

  - ``decoder_style='full'`` (the MAE paper's): mask tokens are scattered
    in beside the visible tokens, and self-attention blocks run over CLS +
    all N positions; pred and target for every patch, with the mask.
  - ``decoder_style='cross'`` (CrossMAE): the masked positions only, each
    mask-token query cross-attending the encoded visible tokens; pred and
    target for the masked rows, with an all-ones mask.
* ``encode_full(images)``: every patch, no decoder; the image tower of
  retrieval and zero-shot.

``use_patch_embed_kernel`` (the JAX package's ``use_pallas_patch_embed``,
off by default as there) embeds the visible patches through
``masked_patch_embed``, kernel #5 on the card.

``block_impl`` (``Config.fused_blocks``, see ``vit.use_fused_blocks``) runs
the encoder's blocks (in ``forward`` and ``encode_full``) and the
``'cross'`` decoder's blocks as fused stacks; the ``'full'`` decoder keeps
its per-block loop, as in the JAX package. ``remat`` (``Config.remat``)
recomputes the encoder's blocks in the backward, not the decoder's, as
the JAX package wraps only the encoder's in ``nn.remat``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from mae_clip_torch.models.layers import Dense, LayerNorm, init_weights
from mae_clip_torch.models.vit import (Mlp, PatchEmbed, ViTBlock, ViTConfig,
                                       fused_stack_fn, patchify,
                                       run_self_blocks, sincos_pos_embed_2d,
                                       stack_block_params, use_fused_blocks)
from mae_clip_torch.ops.attention import multi_head_attention
from mae_clip_torch.ops.masking import (MaskingResult, gather_patches,
                                        random_masking,
                                        scatter_with_mask_tokens)


@dataclasses.dataclass(frozen=True)
class MAEDecoderConfig:
    dim: int = 256
    depth: int = 4
    n_heads: int = 2
    mlp_ratio: float = 4.0
    gelu: str = "tanh"


class MAEOutput(NamedTuple):
    pooled: torch.Tensor          # (B, dim) CLS feature of the visible pass
    pred_patches: torch.Tensor    # (B, N, P*P*C) full; (B, N - K, ...) cross
    target_patches: torch.Tensor  # the same rows of the input patches
    mask: torch.Tensor            # (B, N) 1 = masked; (B, N - K) ones, cross


class CrossAttention(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.q = Dense(dim, dim, dtype)
        self.kv = Dense(dim, 2 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)


class CrossAttnBlock(nn.Module):
    """Pre-LN block whose attention is cross-attention: queries are the
    masked-position decoder tokens, keys/values the encoded visible tokens
    (CrossMAE, arXiv:2401.14391)."""

    def __init__(self, config: ViTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.norm1 = LayerNorm(c.dim, 1e-6, dtype)
        self.norm_kv = LayerNorm(c.dim, 1e-6, dtype)
        self.attn = CrossAttention(c.dim, dtype)
        self.norm2 = LayerNorm(c.dim, 1e-6, dtype)
        self.mlp = Mlp(c.dim, int(c.dim * c.mlp_ratio), c.gelu, dtype)
        self.mlp_drop = nn.Dropout(c.dropout)

    def forward(self, q_tokens: torch.Tensor,
                kv_tokens: torch.Tensor) -> torch.Tensor:
        c = self.config
        b, sq, _ = q_tokens.shape
        sk = kv_tokens.shape[1]
        dh = c.dim // c.n_heads
        q = self.attn.q(self.norm1(q_tokens))
        kv = self.attn.kv(self.norm_kv(kv_tokens)).view(b, sk, 2, c.n_heads,
                                                         dh)
        # Head splits as strided views of the linear outputs: no copies.
        ctx = multi_head_attention(
            q.view(b, sq, c.n_heads, dh).transpose(1, 2),
            kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2),
            sm_scale=1.0 / dh ** 0.5)
        x = q_tokens + self.attn.proj(ctx.transpose(1, 2).reshape(b, sq,
                                                                  c.dim))
        return x + self.mlp_drop(self.mlp(self.norm2(x)))


def collect_cross_block_weights(blocks, dtype: torch.dtype) -> dict:
    """CrossAttnBlock parameters in the ``fused_block_stack`` layout, all
    16 cast to ``dtype``."""
    names = {"ln1": "norm1", "lnkv": "norm_kv", "ln2": "norm2"}
    w = {}
    for key, mod in names.items():
        w[key + "_g"] = stack_block_params(
            blocks, lambda b, m=mod: getattr(b, m).weight, dtype)
        w[key + "_b"] = stack_block_params(
            blocks, lambda b, m=mod: getattr(b, m).bias, dtype)
    for key, get in (("q", lambda b: b.attn.q), ("kv", lambda b: b.attn.kv),
                     ("proj", lambda b: b.attn.proj),
                     ("fc1", lambda b: b.mlp.fc1),
                     ("fc2", lambda b: b.mlp.fc2)):
        w["w" + key] = stack_block_params(
            blocks, lambda b, g=get: g(b).weight, dtype)
        w["b" + key] = stack_block_params(
            blocks, lambda b, g=get: g(b).bias, dtype)
    return w


class MAEViT(nn.Module):
    """ViT encoder (shared with CLIP) + MAE decoder. Built on the CPU;
    ``mae_vit_for`` places it."""

    def __init__(self, config: ViTConfig,
                 decoder: MAEDecoderConfig = MAEDecoderConfig(),
                 mask_ratio: float = 0.75, channels: int = 3,
                 decoder_style: str = "full",
                 dtype: torch.dtype = torch.float32,
                 use_patch_embed_kernel: bool = False,
                 block_impl: str = "off", remat: bool = False):
        super().__init__()
        if decoder_style not in ("full", "cross"):
            raise ValueError(f"unknown decoder_style {decoder_style!r}")
        c, d = config, decoder
        self.config, self.decoder, self.mask_ratio = c, d, mask_ratio
        self.decoder_style = decoder_style
        use_fused_blocks(block_impl, c)  # rejects an unknown value
        self.block_impl, self.dtype, self.remat = block_impl, dtype, remat

        self.patch_embed = PatchEmbed(c, channels, dtype,
                                      masked_kernel=use_patch_embed_kernel)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.blocks = nn.ModuleList(ViTBlock(c, dtype) for _ in range(c.depth))
        self.norm = LayerNorm(c.dim, 1e-6, dtype)
        self.register_buffer("enc_pe", torch.from_numpy(
            sincos_pos_embed_2d(c.dim, c.grid_size, cls_token=True))[None],
            persistent=False)

        self.decoder_embed = Dense(c.dim, d.dim, dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d.dim))
        dec_cfg = self.dec_cfg = ViTConfig(
            image_size=c.image_size, patch_size=c.patch_size, dim=d.dim,
            depth=d.depth, n_heads=d.n_heads, mlp_ratio=d.mlp_ratio,
            gelu=d.gelu)
        block = ViTBlock if decoder_style == "full" else CrossAttnBlock
        self.decoder_blocks = nn.ModuleList(
            block(dec_cfg, dtype) for _ in range(d.depth))
        self.decoder_norm = LayerNorm(d.dim, 1e-6, dtype)
        self.decoder_pred = Dense(d.dim, c.patch_size ** 2 * channels, dtype)
        self.register_buffer("dec_pe", torch.from_numpy(
            sincos_pos_embed_2d(d.dim, c.grid_size, cls_token=True))[None],
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.decoder_pred.weight.device

    def init_weights(self, generator: torch.Generator) -> "MAEViT":
        """Random init from a CPU ``generator`` (``layers.init_weights``)."""
        return init_weights(self, generator)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """CLS (+ its position) prepended to embedded tokens, the blocks,
        the final norm."""
        cls = (self.cls_token + self.enc_pe[:, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls.to(x.dtype), x], dim=1)
        x = run_self_blocks(self.blocks, x, self.config, self.block_impl,
                            self.dtype, self.remat)
        return self.norm(x)

    def encode_full(self, images: torch.Tensor) -> torch.Tensor:
        """Full-sequence inference pass: the pooled CLS over ALL patches."""
        x = self.patch_embed(images)
        return self._encode(x + self.enc_pe[:, 1:].to(x.dtype))[:, 0]

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                masking: Optional[MaskingResult] = None) -> MAEOutput:
        """The masked pass. ``masking`` gives the mask indices (the tests
        feed the JAX package's); without it they are drawn from
        ``generator``."""
        c = self.config
        target = images if images.dim() == 3 else patchify(images,
                                                           c.patch_size)
        b = target.shape[0]
        if masking is None:
            masking = random_masking(b, c.num_patches, self.mask_ratio,
                                     generator, target.device)
        x = self.patch_embed(target, ids=masking.ids_keep)
        x = x + self.enc_pe[0, 1:][masking.ids_keep].to(x.dtype)
        encoded = self._encode(x)
        y = self.decoder_embed(encoded)
        pe = self.dec_pe

        if self.decoder_style == "full":
            # MAE-paper decoder: mask tokens scattered back to patch order,
            # CLS re-attached, self-attention over all positions.
            y = torch.cat([y[:, :1], scatter_with_mask_tokens(
                y[:, 1:], self.mask_token, masking.ids_restore)], dim=1)
            y = y + pe.to(y.dtype)
            for block in self.decoder_blocks:
                y = block(y)
            pred = self.decoder_pred(self.decoder_norm(y))[:, 1:]
            return MAEOutput(encoded[:, 0], pred, target, masking.mask)

        # CrossMAE decoder: mask-token queries at the masked positions only,
        # keys/values the decoder-embedded visible tokens (+ CLS).
        kv = y + torch.cat([pe[:, :1].expand(b, -1, -1),
                            pe[0, 1:][masking.ids_keep]], dim=1).to(y.dtype)
        q = (self.mask_token + pe[0, 1:][masking.ids_masked]).to(y.dtype)
        if use_fused_blocks(self.block_impl, self.dec_cfg):
            w = collect_cross_block_weights(self.decoder_blocks, self.dtype)
            q = fused_stack_fn(self.block_impl)(
                q, kv, w, self.dec_cfg.n_heads, self.dec_cfg.gelu, cross=True)
        else:
            for block in self.decoder_blocks:
                q = block(q, kv)
        pred = self.decoder_pred(self.decoder_norm(q))
        ones = torch.ones(masking.ids_masked.shape, device=target.device)
        return MAEOutput(encoded[:, 0], pred,
                         gather_patches(target, masking.ids_masked), ones)
