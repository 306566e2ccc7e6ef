"""The reference recipe on the card at small sizes (no JAX here):
``chip_smoke.py``'s phase 16 (c) and 17 (a) checks on a shallow bf16
ResNet CLIP. A mid-epoch resume from a step checkpoint, with dropout in
the heads and in the frozen text tower's train mode and deterministic
cuDNN, must end bit for bit where the uninterrupted run does; one step on
the card against the CPU's fp32 step must hold phase 7's limits (losses
within 2e-2 relative, the running statistics' change within 2e-2 of its
size, in fp32 also every gradient cosine >= 0.99; in bf16 the gradients
of a train-mode BatchNorm tower at random weights drift past that limit
on the CPU too, so the card's lowest bf16 gradient cosine is held within
``chip_smoke.BF16_GRAD_MARGIN`` of the CPU's own bf16 step's,
``chip_smoke.check_resnet_step_against_cpu``). The step runs at the
recipe's 224x224: at 64x64 the last stage normalises 32 values a channel
and a bf16 step's loss is off the fp32 step's by up to 3-4 % on the CPU
alone (the shallow tower at B=8, three batches), past the 2e-2 limit
with no card involved; at 224x224 the CPU's own bf16 step is within
1.4 %. This file imports neither
JAX nor the JAX package, so it runs where those are not installed
(``pytest tests/test_torch_trainer_card.py -m cuda --noconftest``); on a
host without a card both tests skip.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = ((1, 1, 1, 1), (8, 16, 32, 64))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_mid_epoch_resume_is_bit_identical(card, tmp_path):
    result = chip_smoke.check_mid_epoch_resume(
        batch=8, size=64, train_batches=5, stop_after=3, valid_batches=1,
        resnet_shape=SMALL, directory=str(tmp_path))
    assert result["bit_identical"]


@pytest.mark.cuda
def test_card_resnet_step_against_cpu(card):
    result = chip_smoke.check_resnet_step_against_cpu(
        np.random.default_rng(0), batch=8, size=224, resnet_shape=SMALL)
    assert not result["fp32"]["misses"]
    assert (result["bf16"][-1]["min_grad_cosine"]
            >= result["cpu_bf16"]["min_grad_cosine"]
            - chip_smoke.BF16_GRAD_MARGIN)
