"""A dataset held on the card, batches gathered there
(``mae_clip_tpu/data/device_store.py``).

When the decoded dataset fits in device memory, the uint8 images and the
token tables (or, for a frozen text tower in eval mode, its cached
features) are uploaded once; each step then gathers its batch on the card
from a (B,) index vector (``index_select``), so a step sends a few hundred
bytes to the card instead of the batch.

``maps`` dedups the images: caption datasets repeat each image once per
caption, so ``arrays["image"]`` may hold each image once and ``maps["image"]``
the (N,) row -> image table; the gather reads ``image[map[indices]]``. The
batches are the same as from the full array.

``build_device_store`` takes preloaded arrays; decoding image files into a
store is not ported yet and raises. ``make_index_loader`` is the JAX
package's: the same seeded order and the same padded tail (index 0,
``valid`` False). There is no sharded store and no gate on gathers from
large arrays (the JAX package unrolls those for the TPU compiler).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from mae_clip_torch.device import resolve_device

ArrayLike = Union[np.ndarray, torch.Tensor]


class DeviceStore:
    """Named (N, ...) tensors on ``device`` (the card unless the CPU is
    asked for) and their batch gather. ``maps[k]``: an (N,) row -> storage
    row table for ``arrays[k]``, which then holds the unique rows only."""

    def __init__(self, arrays: Dict[str, ArrayLike],
                 maps: Optional[Dict[str, ArrayLike]] = None,
                 device: Union[str, torch.device] = "cuda"):
        if not arrays:
            raise ValueError("DeviceStore needs at least one array")
        self.device = resolve_device(device)
        maps = dict(maps or {})
        for k in maps:
            if k not in arrays:
                raise ValueError(f"map for unknown array {k!r}")
        self.arrays = {k: torch.as_tensor(v).to(self.device)
                       for k, v in arrays.items()}
        self.maps = {k: torch.as_tensor(m).to(self.device, torch.long)
                     for k, m in maps.items()}
        ns = {k: int(v.shape[0]) for k, v in self.arrays.items()
              if k not in self.maps}
        ns.update({"map:" + k: int(m.shape[0]) for k, m in self.maps.items()})
        if len(set(ns.values())) != 1:
            raise ValueError(f"inconsistent leading dims: {ns}")
        self.n = next(iter(ns.values()))

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size()
                   for v in [*self.arrays.values(), *self.maps.values()])

    def gather(self, indices: ArrayLike) -> Dict[str, torch.Tensor]:
        """(B,) row indices (host or device) -> the batch, on the card."""
        idx = torch.as_tensor(indices).to(self.device, torch.long,
                                          non_blocking=True)
        out = {}
        for k, v in self.arrays.items():
            rows = (self.maps[k].index_select(0, idx) if k in self.maps
                    else idx)
            out[k] = v.index_select(0, rows)
        return out


def build_device_store(dataset, text_features: Optional[np.ndarray] = None,
                       images: Optional[np.ndarray] = None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> DeviceStore:
    """A store of preloaded ``images`` (N, ...) uint8 and, from
    ``dataset``, its ``input_ids`` / ``attention_mask`` tables, or
    ``text_features`` (N, D) in their place (a frozen text tower's cache:
    no token table on the card)."""
    if images is None:
        raise NotImplementedError(
            "decoding image files into a device store is not ported yet; "
            "pass the decoded images as images=")
    arrays: Dict[str, ArrayLike] = {"image": images}
    if text_features is not None:
        arrays["text_features"] = np.asarray(text_features)
    elif hasattr(dataset, "input_ids"):
        arrays["input_ids"] = np.asarray(dataset.input_ids)
        arrays["attention_mask"] = np.asarray(dataset.attention_mask)
    return DeviceStore(arrays, device=device)


def make_index_loader(n: int, batch_size: int, shuffle: bool = False,
                      seed: int = 0, drop_last: bool = False
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields ``{indices (B,) int32, valid (B,) bool}``: the rows in a
    seeded order that depends only on ``(seed, n)``, the ragged tail padded
    with index 0 and ``valid`` False (or dropped with ``drop_last``)."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    num_batches = n // batch_size if drop_last else -(-n // batch_size)
    for bi in range(num_batches):
        idx = order[bi * batch_size:(bi + 1) * batch_size]
        count = len(idx)
        pad = batch_size - count
        if pad:
            idx = np.concatenate([idx, np.zeros((pad,), idx.dtype)])
        valid = np.zeros((batch_size,), dtype=bool)
        valid[:count] = True
        yield {"indices": idx.astype(np.int32), "valid": valid}
