"""In-step image augmentation: batched RandomResizedCrop + flip
(``mae_clip_tpu/ops/augment.py``).

The MAE input path decodes each image once at a fixed square source size
(``mae.aug_source_size``) and, inside every train step, samples a fresh crop
box and flip per example and resamples the crop to the model's size on the
device. Eval resizes the full frame instead.

Sampling follows ``torchvision.transforms.RandomResizedCrop``: 10 tries of
(uniform area in ``scale``, log-uniform aspect in ``ratio``), the first that
fits wins, else the full frame. The sampling (``sample_crop_boxes``, from a
``torch.Generator``) is split from the resample (``crop_resize_flip``, given
the boxes and the flip flags), so the tests can feed the JAX package's boxes.

Bilinear resampling uses the cv2/torchvision half-pixel mapping
``src = off + (dst + 0.5) * extent / out - 0.5``, with the two neighbours
clamped to the frame independently, which replicates the edge as cv2 does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Boxes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sample_crop_boxes(generator: torch.Generator, batch: int, source: int,
                      scale: Tuple[float, float] = (0.2, 1.0),
                      ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                      tries: int = 10) -> Boxes:
    """One (i, j, ch, cw) crop box per example, float32 tensors (batch,) on
    the generator's device: the top row and left column of the crop and its
    height and width, in source pixels."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (
            hi - lo) + lo

    target = source * source * uniform((batch, tries), *scale)
    r = torch.exp(uniform((batch, tries), math.log(ratio[0]),
                          math.log(ratio[1])))
    cw = torch.round(torch.sqrt(target * r))
    ch = torch.round(torch.sqrt(target / r))
    valid = (cw > 0) & (cw <= source) & (ch > 0) & (ch <= source)
    first = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)
    full = torch.full((batch,), float(source), device=dev)
    any_valid = valid.any(dim=1)
    cw = torch.where(any_valid, cw.gather(1, first)[:, 0], full)
    ch = torch.where(any_valid, ch.gather(1, first)[:, 0], full)
    u_i = torch.rand(batch, generator=generator, device=dev)
    u_j = torch.rand(batch, generator=generator, device=dev)
    i = torch.floor(u_i * (source - ch + 1)).clamp(0, source - 1)
    j = torch.floor(u_j * (source - cw + 1)).clamp(0, source - 1)
    return i, j, ch, cw


def _axis_coords(offset: torch.Tensor, extent: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """(B, out) float source coordinates along one axis."""
    k = torch.arange(out_size, dtype=torch.float32,
                     device=offset.device)[None, :]
    # A tensor divisor: CUDA divides by a Python scalar as a product with
    # its rounded reciprocal, which moves a coordinate by an ulp, and an
    # interpolated pixel by up to 1e-2 on the 0..255 scale.
    step = extent[:, None] / torch.full_like(extent[:, None], out_size)
    return offset[:, None] + (k + 0.5) * step - 0.5


def _lerp_gather(x: torch.Tensor, coords: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """Bilinear 1-D resample of ``x`` along ``dim`` at per-example
    coordinates (B, out)."""
    n = x.shape[dim]
    c0 = torch.floor(coords)
    shape = [coords.shape[0]] + [1] * (x.dim() - 1)
    shape[dim] = coords.shape[1]
    w = (coords - c0).reshape(shape)
    # i0 and i1 clamp independently: at a negative coordinate both land on
    # row 0, as cv2 replicates the edge (i1 = i0 + 1 would blend row 1 in).
    i0 = c0.long().clamp(0, n - 1).reshape(shape)
    i1 = (c0.long() + 1).clamp(0, n - 1).reshape(shape)
    return (torch.take_along_dim(x, i0, dim) * (1 - w)
            + torch.take_along_dim(x, i1, dim) * w)


def crop_resize_flip(images: torch.Tensor, boxes: Boxes,
                     flip: Optional[torch.Tensor], out_size: int
                     ) -> torch.Tensor:
    """(B, S, S, C) images of any type -> (B, out, out, C) float32 crops of
    ``boxes``, mirrored where ``flip`` (B,) is true. Values keep the input's
    range (uint8 in -> 0..255 floats)."""
    i, j, ch, cw = boxes
    ys = _axis_coords(i, ch, out_size)
    xs = _axis_coords(j, cw, out_size)
    if flip is not None:
        xs = torch.where(flip[:, None], xs.flip(1), xs)
    x = images.to(torch.float32)
    return _lerp_gather(_lerp_gather(x, ys, 1), xs, 2)


def random_resized_crop_flip_batch(images: torch.Tensor,
                                   generator: torch.Generator, out_size: int,
                                   scale: Tuple[float, float] = (0.2, 1.0),
                                   ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                                   hflip: float = 0.5,
                                   tries: int = 10) -> torch.Tensor:
    """Per-example RandomResizedCrop + horizontal flip of square sources
    (B, S, S, C) -> (B, out, out, C) float32, the randomness drawn from
    ``generator`` (which lives on the images' device)."""
    b, s, s2, _ = images.shape
    if s != s2:
        raise ValueError(f"in-step augmentation takes square sources, got "
                         f"{tuple(images.shape)}")
    boxes = sample_crop_boxes(generator, b, s, scale, ratio, tries)
    flip = None
    if hflip:
        flip = torch.rand(b, generator=generator,
                          device=generator.device) < hflip
    return crop_resize_flip(images, boxes, flip, out_size)


def resize_batch(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Full-frame bilinear resize (B, S, S, C) -> (B, out, out, C) float32,
    the eval counterpart of the random crop (same half-pixel mapping)."""
    b, s = images.shape[:2]
    full = torch.full((b,), float(s), device=images.device)
    zero = torch.zeros(b, device=images.device)
    return crop_resize_flip(images, (zero, zero, full, full), None, out_size)
