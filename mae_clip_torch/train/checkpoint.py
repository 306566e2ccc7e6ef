"""Checkpoints of a training run (``mae_clip_tpu/train/checkpoint.py``).

The port has no orbax. A checkpoint is two files in the manager's
directory: ``<step>.pt``, ``torch.save`` of ``TrainState.state_dict()``
(parameters and BatchNorm buffers, optimizer, step, generator, EMA, torch's
RNG states), and ``<step>.json``, the step's metrics and the run's meta
(the scheduler's state, the best loss, the epoch...). Each is written to a
temporary file and renamed, the JSON last: a step counts once its JSON
exists, so a save cut short leaves no half checkpoint. A failed save
raises. Saves are synchronous (the JAX managers' ``wait`` and ``close``
have nothing to do here and are left out).

Retention follows the JAX managers' Orbax options:

* ``CheckpointManager(directory, max_to_keep=3, keep_period=None)``, keyed
  by epoch: the ``max_to_keep`` best by ``metrics["valid_loss"]`` (Orbax's
  ``BestN``, lowest first, ties to the later step) and every step that is
  a multiple of ``keep_period``; ``best_step`` is the best one kept, and a
  step at or below the newest kept one is not saved again (Orbax's
  ``should_save``);
* ``StepCheckpointManager(directory, max_to_keep=2)``, keyed by optimizer
  step for mid-epoch resume: the newest ``max_to_keep``.

``load_weights(path, cfg)`` gives the model weights a serving process
loads: the best step of a run directory (else the newest), or one ``.pt``
file, with the EMA weights in place of the parameters they average when
``cfg.ema_decay > 0 and cfg.ema_eval``. The reference's ``.pth``
state_dicts are not read yet: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import torch

from mae_clip_torch.config import Config


def _replace(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


class _Manager:
    """Files, the step index and retention shared by both managers."""

    def __init__(self, directory: str, max_to_keep: int,
                 keep_period: Optional[int], track_best: bool):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.track_best = track_best
        self._metrics: Dict[int, Optional[Dict[str, float]]] = {}
        for name in os.listdir(self.directory):
            stem, ext = os.path.splitext(name)
            if ext == ".json" and stem.isdigit():
                with open(self._path(int(stem), ".json")) as f:
                    self._metrics[int(stem)] = json.load(f)["metrics"]

    def _path(self, step: int, ext: str) -> str:
        return os.path.join(self.directory, f"{step}{ext}")

    def all_steps(self) -> List[int]:
        return sorted(self._metrics)

    def latest_step(self) -> Optional[int]:
        return max(self._metrics) if self._metrics else None

    def _by_quality(self) -> List[int]:
        """Steps with metrics, worst first (Orbax sorts by loss, reversed
        for 'min', stably: among equal losses the later step ranks
        better)."""
        scored = [s for s in self.all_steps() if self._metrics[s] is not None]
        return sorted(scored, key=lambda s: self._metrics[s]["valid_loss"],
                      reverse=True)

    def best_step(self) -> Optional[int]:
        if not self.track_best:
            return self.latest_step()
        ranked = self._by_quality()
        return ranked[-1] if ranked else None

    def _kept(self) -> set:
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return set(steps)
        if self.track_best:
            kept = set(self._by_quality()[-self.max_to_keep:]) | {
                s for s in steps if self._metrics[s] is None}
        else:
            kept = set(steps[-self.max_to_keep:])
        if self.keep_period is not None:
            kept |= {s for s in steps if s % self.keep_period == 0}
        return kept

    def _save(self, step: int, state, metrics: Optional[Dict[str, float]],
              meta: Dict[str, Any]) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        payload = state.state_dict()
        _replace(self._path(step, ".pt"),
                 lambda tmp: torch.save(payload, tmp))

        def write_json(tmp):
            with open(tmp, "w") as f:
                json.dump({"metrics": metrics, "meta": meta}, f)

        _replace(self._path(step, ".json"), write_json)
        self._metrics[step] = metrics
        for old in set(self.all_steps()) - self._kept():
            os.remove(self._path(old, ".json"))
            os.remove(self._path(old, ".pt"))
            del self._metrics[old]
        return True

    def _step_or_latest(self, step: Optional[int]) -> int:
        step = step if step is not None else self.latest_step()
        if step is None or step not in self._metrics:
            raise FileNotFoundError(
                f"no checkpoint {step} under {self.directory}")
        return step

    def peek_meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The step's meta alone (no tensors are read)."""
        with open(self._path(self._step_or_latest(step), ".json")) as f:
            return json.load(f)["meta"]

    def restore(self, state, step: Optional[int] = None) -> Dict[str, Any]:
        """Load the checkpoint of ``step`` (None: the newest) into the
        ``TrainState`` in place; returns its meta."""
        step = self._step_or_latest(step)
        state.load_state_dict(_load(self._path(step, ".pt")))
        return self.peek_meta(step)


class CheckpointManager(_Manager):
    """Epoch checkpoints kept by best validation loss (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 keep_period: Optional[int] = None):
        super().__init__(directory, max_to_keep, keep_period,
                         track_best=True)

    def save(self, epoch: int, state, metrics: Dict[str, float],
             scheduler: Optional[Dict] = None,
             best_loss: Optional[float] = None) -> bool:
        """Save ``state`` as ``epoch``, ranked by ``metrics``; False if a
        step at or after it is kept already."""
        metrics = {k: float(v) for k, v in metrics.items()}
        meta = {"scheduler": scheduler or {}, "best_loss": best_loss,
                "metrics": metrics}
        return self._save(epoch, state, metrics, meta)


class StepCheckpointManager(_Manager):
    """Rolling step checkpoints for mid-epoch resume (module docstring);
    a directory of its own, so its rotation never removes a best epoch."""

    def __init__(self, directory: str, max_to_keep: int = 2):
        super().__init__(directory, max_to_keep, None, track_best=False)

    def save(self, step: int, state, meta: Dict[str, Any]) -> bool:
        return self._save(step, state, None, meta)


def load_weights(path: str, cfg: Config) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` to serve from ``path`` (module docstring),
    on the CPU."""
    if path.endswith(".pth"):
        raise NotImplementedError(
            "reading the reference's .pth state_dicts is not ported yet")
    if os.path.isdir(path):
        mngr = CheckpointManager(path)
        step = mngr.best_step()
        if step is None:
            step = mngr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps under {path}")
        path = mngr._path(step, ".pt")
    payload = _load(path)
    weights = dict(payload["model"])
    if cfg.ema_decay > 0 and cfg.ema_eval and payload["ema"] is not None:
        weights.update(payload["ema"])
    return weights
