"""Weight transfer from MAE pretraining into a CLIP image tower
(``mae_clip_tpu/interop/transfer.py``), on ``state_dict``s.

The MAE-paper workflow is pretrain-then-transfer: the encoder of a
standalone ``MAEViT`` (``mae_vit_for``, trained by
``make_mae_pretrain_step``) initialises a CLIP model's image tower::

    sd, moved, skipped = load_mae_encoder_into_clip(clip.state_dict(),
                                                    mae.state_dict())
    clip.load_state_dict(sd)

``mae_vit_for`` gives the standalone model the names of the tower that
``CLIPModel`` embeds, so the transfer is a name-wise intersection: into a
MAE-enabled tower every tensor moves, decoder included; into a plain
``ViTEncoder`` tower the encoder moves and the decoder is reported skipped.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

StateDict = Mapping[str, torch.Tensor]


def merge_intersecting(src: StateDict, dst: StateDict
                       ) -> Tuple[Dict[str, torch.Tensor], List[str],
                                  List[str]]:
    """Copy ``src`` tensors into ``dst`` wherever the name exists in both
    and the shapes agree (in ``dst``'s type and device); ``dst``-only
    tensors keep their values. Returns ``(merged, transferred, skipped)``;
    ``skipped`` lists the ``src`` names with no destination of that
    shape."""
    merged = dict(dst)
    transferred, skipped = [], []
    for name, value in src.items():
        if name in dst and dst[name].shape == value.shape:
            merged[name] = value.to(dtype=dst[name].dtype,
                                    device=dst[name].device)
            transferred.append(name)
        else:
            skipped.append(name)
    return merged, transferred, skipped


def load_mae_encoder_into_clip(clip_state: StateDict, mae_state: StateDict
                               ) -> Tuple[Dict[str, torch.Tensor], List[str],
                                          List[str]]:
    """A ``CLIPModel`` state_dict whose ``image_encoder.*`` tensors come from
    a standalone ``MAEViT`` state_dict wherever names and shapes agree.
    Returns ``(new_clip_state, transferred, skipped)``, both name lists
    relative to the ``image_encoder`` scope."""
    prefix = "image_encoder."
    tower = {k[len(prefix):]: v for k, v in clip_state.items()
             if k.startswith(prefix)}
    if not tower:
        raise ValueError("clip_state has no 'image_encoder.' tensors")
    merged, transferred, skipped = merge_intersecting(mae_state, tower)
    out = dict(clip_state)
    out.update({prefix + k: v for k, v in merged.items()})
    return out, transferred, skipped
