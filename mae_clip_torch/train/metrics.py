"""Epoch meters, throughput and the metric writer
(``mae_clip_tpu/train/metrics.py``).

``AvgMeter`` is the reference's count-weighted running mean (reference
utils.py:1-16), so epoch losses over ragged batches match. ``Throughput``
counts examples over a window of steps; the card runs asynchronously, so
``stop`` waits for it (``torch.cuda.synchronize``) before it reads the
clock. ``MetricWriter`` writes the JAX package's JSONL records, one object
a line with ``step``, ``time`` and the scalars, to ``<logdir>/metrics.jsonl``;
it mirrors them into TensorBoard event files only where
``torch.utils.tensorboard`` imports, and never needs it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Mapping, Optional

import torch


class AvgMeter:
    """Count-weighted running average (reference utils.py:1-16)."""

    def __init__(self, name: str = "Metric"):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.avg, self.sum, self.count = [0] * 3

    def update(self, val: float, count: int = 1) -> None:
        self.count += count
        self.sum += val * count
        self.avg = self.sum / self.count

    def __repr__(self) -> str:
        return f"{self.name}: {self.avg:.4f}"


class Throughput:
    """Examples a second (and per card) over a window of steps.
    ``device``: the card to wait for at ``stop`` (None: nothing to wait
    for, as on the CPU)."""

    def __init__(self, num_chips: int = 1,
                 device: Optional[torch.device] = None):
        self.num_chips = max(num_chips, 1)
        self.device = device
        self._t0: Optional[float] = None
        self._examples = 0
        self._frozen_dt: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._examples = 0
        self._frozen_dt = None

    def stop(self) -> None:
        """Freeze the window after the card has finished the work queued
        in it: reads taken later keep the train epoch's rate."""
        if self._t0 is not None:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._frozen_dt = time.perf_counter() - self._t0

    def update(self, batch_examples: int) -> None:
        if self._t0 is None:
            self.start()
        self._examples += batch_examples

    @property
    def examples_per_sec(self) -> float:
        if self._t0 is None or self._examples == 0:
            return 0.0
        dt = (self._frozen_dt if self._frozen_dt is not None
              else time.perf_counter() - self._t0)
        return self._examples / max(dt, 1e-9)

    @property
    def examples_per_sec_per_chip(self) -> float:
        return self.examples_per_sec / self.num_chips


class MetricWriter:
    """Scalars to JSONL always, and to TensorBoard where it imports."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:   # no tensorboard: the JSONL stream alone
            self._tb = None
        else:
            self._tb = SummaryWriter(logdir)

    def write_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
        rec: Dict = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
