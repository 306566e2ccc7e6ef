"""Primitive layers with the JAX package's math (``mae_clip_tpu/models/layers.py``).

* ``Dense`` keeps its fp32 weight in torch's ``(out, in)`` layout, casts the
  input and the weight to the compute dtype, and returns the compute dtype.
* ``LayerNorm`` takes its statistics in fp32 with biased variance, like
  ``torch.nn.LayerNorm``; the eps is chosen per call site (1e-6 ViT/MAE,
  1e-12 DistilBERT, 1e-5 projection head) and the output is in the compute
  dtype.
* ``gelu``: ``"erf"`` is torch's exact GELU, ``"tanh"`` the approximation.
* ``Embed``: a token table whose lookup is cast to the compute dtype.
* ``run_block``: a block call, rematerialised under ``Config.remat``.
* ``Conv2d``: a bias-free convolution of NCHW activations (``channels_last``
  in memory), input and weight cast to the compute dtype (cuDNN on the
  card, as XLA computes the JAX package's convolutions outside any Pallas
  kernel).
* ``BatchNorm``: flax's ``BatchNorm`` (``momentum=0.9``, eps 1e-5) on
  torch's batch-norm kernels: the statistics in fp32 with the biased
  variance, the normalisation in fp32 and one rounding to the input's
  dtype, as flax; but the running statistics are updated with the
  *biased* batch variance, ``r <- 0.9 r + 0.1 batch``, as flax does and
  torch's own update (unbiased) does not. Train mode normalises with the
  batch's statistics and updates the running ones; eval mode normalises
  with the running statistics.

Parameters are fp32; the compute dtype comes from ``Config.compute_dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def gelu(x: torch.Tensor, kind: str = "erf") -> torch.Tensor:
    if kind == "erf":
        return F.gelu(x)
    if kind == "tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown gelu {kind!r}")


class Dense(nn.Linear):
    """``y = x @ W.T + b`` in the compute dtype; W is (out, in), fp32."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics; output in the compute dtype."""

    def __init__(self, dim: int, eps: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.compute_dtype or x.dtype
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(out_dtype)


class Embed(nn.Embedding):
    """Token table (num_embeddings, dim); the lookup is cast to ``dtype``."""

    def __init__(self, num_embeddings: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, dim)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


def run_block(block: nn.Module, *args, remat: bool = False):
    """``block(*args)``. With ``remat``, while autograd records, the block
    runs under ``torch.utils.checkpoint``: its activations are dropped and
    recomputed in the backward (the JAX package's ``nn.remat``), with the
    RNG state replayed, so dropout draws the same masks twice."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


class Conv2d(nn.Conv2d):
    """Square ``k x k`` convolution without bias, padding ``k // 2`` (the
    JAX package's ``nn.Conv`` padding); weight ``(out, in, k, k)`` fp32;
    the input and the weight are cast to the compute dtype and the weight
    to ``channels_last``, the layout of the activations."""

    def __init__(self, in_channels: int, out_channels: int, k: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, k, stride=stride,
                         padding=k // 2, bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight.to(dtype=dt, memory_format=torch.channels_last)
        return F.conv2d(x.to(dt), w, None, self.stride, self.padding)


class BatchNorm(nn.Module):
    """flax's ``BatchNorm`` over the channels of an NCHW tensor (module
    docstring). torch's names: ``weight``, ``bias``, ``running_mean``,
    ``running_var`` and ``num_batches_tracked`` (counted here, 0 in a flax
    export)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            m = self.momentum
            var = (invstd.pow(-2) - self.eps).clamp_(min=0.0)  # biased
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        return y


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init of ``model`` from ``generator`` (a CPU generator, so one
    seed gives the same weights on every device), with the JAX package's
    schemes: linear and convolution weights normal(0, 1/sqrt(fan_in)), zero
    biases, unit/zero LayerNorms and BatchNorms (running mean 0, variance
    1), normal(0, 0.02) tables and tokens. Parameters named
    ``logit_*`` keep their fixed initial values. Returns ``model``."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    for mod in model.modules():
        if isinstance(mod, (nn.LayerNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(normal(mod.weight.shape, fan_in ** -0.5))
        elif isinstance(mod, nn.Linear):
            mod.weight.copy_(normal(mod.weight.shape, mod.in_features ** -0.5))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(normal(mod.weight.shape, 0.02))
        else:  # cls/mask tokens and learned positions
            for name, p in mod.named_parameters(recurse=False):
                if not name.startswith("logit_"):
                    p.copy_(normal(p.shape, 0.02))
    return model
