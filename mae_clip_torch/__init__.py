"""PyTorch/CUDA port of ``mae_clip_tpu`` for NVIDIA Hopper (H100).

It serves (text and image embedding, text->image retrieval over an fp32
or int8 gallery, zero-shot classification) and trains (the CLIP and MAE
steps with their options, GradCache accumulation, and the epoch loop
``train.Trainer`` with its checkpoints and device store) with the ViT/MAE
or ResNet-50 image tower and the DistilBERT text tower. Attention, the
masked patch embedding and the fused block stacks run hand-written
kernels on a CUDA tensor (``csrc/``) and their plain PyTorch versions on
a CPU tensor.

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
