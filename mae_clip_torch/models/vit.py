"""Vision Transformer image tower (``mae_clip_tpu/models/vit.py``).

Images are NHWC ``(B, H, W, C)`` or pre-patchified ``(B, N, P*P*C)`` (row-major
patch order, channel minor), as in the JAX package. Patch embedding is one
matmul over the patch rows. Blocks are pre-LN; each block's fused qkv output
``(B, S, 3*H*Dh)`` goes straight to ``fused_qkv_attention``, which runs the
packed-qkv CUDA kernel on the card.

Parameter names follow timm's VisionTransformer (``blocks.{i}.attn.qkv``,
``blocks.{i}.mlp.fc1``, ...), except that ``patch_embed.proj`` is a linear
weight ``(D, P*P*C)`` and not timm's conv weight ``(D, C, P, P)``.

``block_impl`` (``Config.fused_blocks``) picks how a stack of blocks runs:
``'off'`` block by block; ``'on'`` as one ``fused_block_stack`` (kernels #6
and #7 on the card); ``'fwd'`` as ``fused_block_stack_fwd_plain_bwd`` (#6
forward, a per-block plain recompute backward). The fused forms need heads
of a multiple of 128, dropout 0 and a known GELU (``use_fused_blocks``);
other geometries keep the per-block path. ``'auto'`` engages only on a TPU
in the JAX package, and stays off here until measured on the card.

``remat`` (``Config.remat``) recomputes each block of the per-block path in
the backward (``layers.run_block``); the fused stacks ignore it, as the
JAX package's do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from mae_clip_torch.config import Config
from mae_clip_torch.models.layers import Dense, LayerNorm, gelu, run_block
from mae_clip_torch.ops.attention import fused_qkv_attention
from mae_clip_torch.ops.block_kernel import (fused_block_stack,
                                             fused_block_stack_fwd_plain_bwd)
from mae_clip_torch.ops.masking import gather_patches
from mae_clip_torch.ops.patch_embed import masked_patch_embed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 384
    depth: int = 12
    n_heads: int = 6
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    pos_embed: str = "learned"   # "learned" (timm-compatible) | "sincos" (MAE)
    pool: str = "cls"            # "cls" | "mean"
    gelu: str = "erf"            # "erf" | "tanh"

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2


VIT_S16 = ViTConfig(dim=384, depth=12, n_heads=6)
VIT_B16 = ViTConfig(dim=768, depth=12, n_heads=12)


def vit_config_for(cfg: Config) -> ViTConfig:
    base = {"vit_s16": VIT_S16, "vit_b16": VIT_B16}[cfg.model_name]
    pos = "sincos" if cfg.mae.enabled else base.pos_embed
    return dataclasses.replace(base, image_size=cfg.size, pos_embed=pos)


def _resolved_vit_config(cfg: Config,
                         vit_config: Optional[ViTConfig]) -> ViTConfig:
    """Apply cfg's gelu/head-geometry overrides to the ViT tower config
    (an explicitly passed custom geometry keeps its own head count)."""
    vcfg = vit_config if vit_config is not None else vit_config_for(cfg)
    if cfg.gelu_impl is not None:
        vcfg = dataclasses.replace(vcfg, gelu=cfg.gelu_impl)
    if (vit_config is None and cfg.image_heads is not None
            and vcfg.dim % cfg.image_heads == 0):
        vcfg = dataclasses.replace(vcfg, n_heads=cfg.image_heads)
    return vcfg


def sincos_pos_embed_2d(dim: int, grid_size: int,
                        cls_token: bool = False) -> np.ndarray:
    """Fixed 2D sine-cosine positional embeddings (MAE paper, appendix)."""
    if dim % 4:
        raise ValueError(f"sincos embedding needs dim % 4 == 0, got {dim}")
    pos = np.arange(grid_size, dtype=np.float64)
    omega = np.arange(dim // 4, dtype=np.float64) / (dim / 4.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("p,d->pd", pos, omega)
    emb_1d = np.concatenate([np.sin(out), np.cos(out)], axis=1)  # (g, dim/2)
    emb_h = np.repeat(emb_1d[:, None, :], grid_size, axis=1)
    emb_w = np.repeat(emb_1d[None, :, :], grid_size, axis=0)
    emb = np.concatenate([emb_h, emb_w], axis=-1).reshape(-1, dim)
    if cls_token:
        emb = np.concatenate([np.zeros((1, dim)), emb], axis=0)
    return emb.astype(np.float32)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) NHWC -> (B, N, P*P*C) patches, row-major patch order."""
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


class PatchEmbed(nn.Module):
    """Patchify + linear projection (== a stride-P conv), as one matmul.

    With ``ids`` (B, K) only those patch rows are embedded (the MAE visible
    set): by default the rows are gathered, then projected (``vit.py``'s
    default XLA route); with ``masked_kernel`` the gather and the projection
    are one ``masked_patch_embed`` call, kernel #5 on the card (the JAX
    package's ``use_pallas`` route).
    """

    def __init__(self, config: ViTConfig, channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 masked_kernel: bool = False):
        super().__init__()
        self.config = config
        self.masked_kernel = masked_kernel
        p = config.patch_size
        self.proj = Dense(p * p * channels, config.dim, dtype)

    def forward(self, images: torch.Tensor,
                ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        patches = (images if images.dim() == 3
                   else patchify(images, self.config.patch_size))
        if ids is None:
            return self.proj(patches)
        if self.masked_kernel:
            dt, proj = self.proj.compute_dtype, self.proj
            return masked_patch_embed(patches.to(dt), ids, proj.weight.to(dt),
                                      proj.bias.to(dt))
        return self.proj(gather_patches(patches, ids))


class Attention(nn.Module):
    def __init__(self, dim: int, n_heads: int, dtype: torch.dtype):
        super().__init__()
        self.n_heads = n_heads
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dh = x.shape[-1] // self.n_heads
        ctx = fused_qkv_attention(self.qkv(x), self.n_heads,
                                  sm_scale=1.0 / dh ** 0.5)
        return self.proj(ctx)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, kind: str, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x), self.kind))


class ViTBlock(nn.Module):
    """Pre-LN block: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, config: ViTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.norm1 = LayerNorm(c.dim, 1e-6, dtype)
        self.attn = Attention(c.dim, c.n_heads, dtype)
        self.norm2 = LayerNorm(c.dim, 1e-6, dtype)
        self.mlp = Mlp(c.dim, int(c.dim * c.mlp_ratio), c.gelu, dtype)
        self.mlp_drop = nn.Dropout(c.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_drop(self.mlp(self.norm2(x)))


BLOCK_IMPLS = ("off", "on", "fwd", "auto")


def use_fused_blocks(block_impl: str, cfg: ViTConfig) -> bool:
    """Whether a block stack of geometry ``cfg`` runs fused: ``'on'`` or
    ``'fwd'``, with heads of a multiple of 128, dropout 0 and a tanh or erf
    GELU (the JAX package's ``_use_fused_blocks``). ``'auto'`` stays off:
    the JAX package engages it on a TPU only."""
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    if block_impl in ("off", "auto"):
        return False
    if cfg.dim % cfg.n_heads or (cfg.dim // cfg.n_heads) % 128:
        return False
    return cfg.dropout == 0.0 and cfg.gelu in ("erf", "tanh")


def stack_block_params(blocks, get, dtype: torch.dtype) -> torch.Tensor:
    """``get(block)`` of every block, stacked on a new leading dim and cast
    to ``dtype``; gradients flow back to each block's parameter."""
    return torch.stack([get(b) for b in blocks]).to(dtype)


def collect_self_block_weights(blocks, dim: int, dtype: torch.dtype) -> dict:
    """ViTBlock parameters in the ``fused_block_stack`` layout, all 16 cast
    to ``dtype`` as the JAX package casts them: wq is the first ``dim`` rows
    of the fused qkv weight, wkv the k and v rows; lnkv repeats ln1."""
    def stack(get):
        return stack_block_params(blocks, get, dtype)

    d = dim
    w = {"ln1_g": stack(lambda b: b.norm1.weight),
         "ln1_b": stack(lambda b: b.norm1.bias),
         "wq": stack(lambda b: b.attn.qkv.weight[:d]),
         "bq": stack(lambda b: b.attn.qkv.bias[:d]),
         "wkv": stack(lambda b: b.attn.qkv.weight[d:]),
         "bkv": stack(lambda b: b.attn.qkv.bias[d:]),
         "wproj": stack(lambda b: b.attn.proj.weight),
         "bproj": stack(lambda b: b.attn.proj.bias),
         "ln2_g": stack(lambda b: b.norm2.weight),
         "ln2_b": stack(lambda b: b.norm2.bias),
         "wfc1": stack(lambda b: b.mlp.fc1.weight),
         "bfc1": stack(lambda b: b.mlp.fc1.bias),
         "wfc2": stack(lambda b: b.mlp.fc2.weight),
         "bfc2": stack(lambda b: b.mlp.fc2.bias)}
    w["lnkv_g"], w["lnkv_b"] = w["ln1_g"], w["ln1_b"]
    return w


def fused_stack_fn(block_impl: str):
    """The stack function of a fused ``block_impl``: 'fwd' or 'on'."""
    return (fused_block_stack_fwd_plain_bwd if block_impl == "fwd"
            else fused_block_stack)


def run_self_blocks(blocks, x: torch.Tensor, cfg: ViTConfig, block_impl: str,
                    dtype: torch.dtype, remat: bool = False) -> torch.Tensor:
    """A stack of ViTBlocks: fused when ``use_fused_blocks`` says so (which
    ignores ``remat``), else block by block, each recomputed in the
    backward with ``remat``."""
    if use_fused_blocks(block_impl, cfg):
        w = collect_self_block_weights(blocks, cfg.dim, dtype)
        return fused_stack_fn(block_impl)(x, x, w, cfg.n_heads, cfg.gelu,
                                          cross=False)
    for block in blocks:
        x = run_block(block, x, remat=remat)
    return x


class ViTEncoder(nn.Module):
    """Full-sequence ViT encoder producing a pooled feature vector."""

    def __init__(self, config: ViTConfig = VIT_S16,
                 dtype: torch.dtype = torch.float32,
                 block_impl: str = "off", remat: bool = False):
        super().__init__()
        c = self.config = config
        self.dtype, self.remat = dtype, remat
        use_fused_blocks(block_impl, c)  # rejects an unknown value
        self.block_impl = block_impl
        self.patch_embed = PatchEmbed(c, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        if c.pos_embed == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(1, c.num_patches + 1,
                                                      c.dim))
        else:
            self.register_buffer("sincos", torch.from_numpy(
                sincos_pos_embed_2d(c.dim, c.grid_size, cls_token=True))[None],
                persistent=False)
        self.blocks = nn.ModuleList(ViTBlock(c, dtype) for _ in range(c.depth))
        self.norm = LayerNorm(c.dim, 1e-6, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images)
        b = x.shape[0]
        cls = self.cls_token.expand(b, -1, -1).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        pe = self.pos_embed if self.config.pos_embed == "learned" else self.sincos
        x = x + pe.to(x.dtype)
        x = run_self_blocks(self.blocks, x, self.config, self.block_impl,
                            self.dtype, self.remat)
        x = self.norm(x)
        if self.config.pool == "cls":
            return x[:, 0]
        return x[:, 1:].mean(dim=1)
