"""The training steps of the port (``mae_clip_tpu/train``): optimizer,
state, the single-step ``make_train_step`` / ``make_eval_step``, the MAE
pretraining pair ``make_mae_pretrain_step`` / ``make_mae_eval_step`` and the
frozen-text feature cache."""

from mae_clip_torch.train.loop import (make_eval_step, make_mae_eval_step,
                                       make_mae_pretrain_step,
                                       make_train_step,
                                       precompute_text_features)
from mae_clip_torch.train.optim import make_optimizer, param_groups
from mae_clip_torch.train.state import TrainState

__all__ = ["TrainState", "make_eval_step", "make_mae_eval_step",
           "make_mae_pretrain_step", "make_optimizer", "make_train_step",
           "param_groups", "precompute_text_features"]
