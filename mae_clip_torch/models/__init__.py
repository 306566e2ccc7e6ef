"""Model towers of the port, mirroring ``mae_clip_tpu/models``."""

from mae_clip_torch.models.clip import CLIPModel, mae_vit_for
from mae_clip_torch.models.distilbert import DistilBertConfig, TextEncoder
from mae_clip_torch.models.mae import MAEDecoderConfig, MAEViT
from mae_clip_torch.models.projection import ProjectionHead
from mae_clip_torch.models.vit import (VIT_B16, VIT_S16, ViTConfig,
                                       ViTEncoder)

__all__ = ["CLIPModel", "DistilBertConfig", "MAEDecoderConfig", "MAEViT",
           "ProjectionHead", "TextEncoder", "VIT_B16", "VIT_S16", "ViTConfig",
           "ViTEncoder", "mae_vit_for"]
