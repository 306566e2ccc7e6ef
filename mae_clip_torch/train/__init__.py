"""Training in the port (``mae_clip_tpu/train``): optimizer and plateau
scheduler, state, the steps (``make_train_step`` / ``make_eval_step``, the
MAE pretraining pair ``make_mae_pretrain_step`` / ``make_mae_eval_step``),
the frozen-text feature cache, the epoch loop ``Trainer``, its
checkpoint managers and its metrics."""

from mae_clip_torch.train.checkpoint import (CheckpointManager,
                                             StepCheckpointManager,
                                             load_weights)
from mae_clip_torch.train.loop import (Trainer, make_eval_step,
                                       make_mae_eval_step,
                                       make_mae_pretrain_step,
                                       make_train_step,
                                       precompute_text_features)
from mae_clip_torch.train.metrics import AvgMeter, MetricWriter, Throughput
from mae_clip_torch.train.optim import (ReduceLROnPlateau, current_lr,
                                        get_lr_scale, make_optimizer,
                                        param_groups, set_lr_scale)
from mae_clip_torch.train.state import TrainState

__all__ = ["AvgMeter", "CheckpointManager", "MetricWriter",
           "ReduceLROnPlateau", "StepCheckpointManager", "Throughput",
           "TrainState", "Trainer", "current_lr", "get_lr_scale",
           "load_weights", "make_eval_step", "make_mae_eval_step",
           "make_mae_pretrain_step", "make_optimizer", "make_train_step",
           "param_groups", "precompute_text_features", "set_lr_scale"]
