"""ResNet-50 image tower (``mae_clip_tpu/models/resnet.py``).

The reference's default tower, ``timm.create_model('resnet50',
num_classes=0, global_pool='avg')``: the torchvision ResNet-50 trunk with
global average pooling to a 2048-d feature. Module names are timm's and
torchvision's (``conv1``, ``bn1``, ``layer{1-4}.{i}.conv{1-3}`` /
``bn{1-3}``, ``downsample.0`` / ``downsample.1``), the names the JAX
package's exporter writes, so a timm state_dict loads as it is.

Images come NHWC ``(B, H, W, C)``, as in the JAX package; the permute to an
NCHW view is free and leaves the activations ``channels_last`` in memory,
the layout cuDNN's convolutions take. The convolutions and BatchNorms are
``layers.Conv2d`` / ``layers.BatchNorm``: flax's BatchNorm, whose running
variance takes the biased batch variance (``nn.BatchNorm2d`` would take the
unbiased one). Max-pool 3x3, stride 2, padded with -inf; the global
average pool sums in fp32 and rounds once, as ``jnp.mean`` of bf16.

``forward(images, train=None)``: BatchNorm in train mode (batch statistics,
running statistics updated) when ``train`` is True, or when it is None and
the module is in train mode; else the running statistics. No block runs
under ``torch.utils.checkpoint``: the JAX package remats no ResNet block
either, and a recompute would update the running statistics twice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mae_clip_torch.models.layers import BatchNorm, Conv2d


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with BatchNorm and ReLU; the
    shortcut is a strided 1x1 conv + BatchNorm where the shape changes."""

    expansion = 4

    def __init__(self, in_channels: int, width: int, stride: int = 1,
                 downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = width * self.expansion
        self.conv1 = Conv2d(in_channels, width, 1, 1, dtype)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride, dtype)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv2d(width, out, 1, 1, dtype)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.ModuleList([
            Conv2d(in_channels, out, 1, stride, dtype), BatchNorm(out)])
            if downsample else None)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        shortcut = x
        if self.downsample is not None:
            conv, bn = self.downsample
            shortcut = bn(conv(x), train)
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """Head-less ResNet trunk: 7x7/2 stem (64 channels), max-pool, the
    bottleneck stages, global average pool to ``widths[-1] * 4``."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, dtype)
        self.bn1 = BatchNorm(64)
        channels = 64
        for stage, (size, width) in enumerate(zip(stage_sizes, widths),
                                              start=1):
            blocks = []
            for block in range(size):
                stride = 2 if (stage > 1 and block == 0) else 1
                blocks.append(Bottleneck(channels, width, stride,
                                         downsample=(block == 0),
                                         dtype=dtype))
                channels = width * Bottleneck.expansion
            setattr(self, f"layer{stage}", nn.ModuleList(blocks))
        self.n_stages = len(stage_sizes)
        self.out_dim = channels

    def forward(self, images: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        x = images.permute(0, 3, 1, 2)      # NHWC memory: channels_last
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(1, self.n_stages + 1):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, train)
        return x.mean((2, 3), dtype=torch.float32).to(x.dtype)


def resnet50(dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), (64, 128, 256, 512), dtype)
