"""PyTorch/CUDA port of ``mae_clip_tpu`` for NVIDIA Hopper (H100).

This first part of the port serves: text and image embedding, text->image
retrieval over an fp32 or int8 gallery, and zero-shot classification, with
the ViT/MAE image tower and the DistilBERT text tower. Attention on a CUDA
tensor runs hand-written kernels (``csrc/attention_fwd.cu``); on a CPU
tensor it runs their plain PyTorch versions. Training is not ported yet.

The package imports nothing of ``mae_clip_tpu`` or JAX.
"""

from mae_clip_torch.config import (Config, MAEConfig, MeshConfig,
                                   coco_full_config, flagship_siglip_config,
                                   flagship_tpu_config,
                                   large_batch_mesh_config,
                                   mae_pretrain_config, notebook_config,
                                   reference_py_config)

__all__ = [
    "Config", "MAEConfig", "MeshConfig", "coco_full_config",
    "flagship_siglip_config", "flagship_tpu_config",
    "large_batch_mesh_config", "mae_pretrain_config", "notebook_config",
    "reference_py_config",
]
