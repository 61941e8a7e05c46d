"""Full-state checkpoints in torch's own format.

Counterpart of the JAX package's ``train/checkpoint.py`` (an Orbax manager
there). A checkpoint is one ``torch.save`` of a train state's
``state_dict()``: params (with the BatchNorm statistics), optimizer state,
generator state, step, epoch, frozen companions and the EMA average, so
resume is bit-exact. The retention policy is the JAX package's: the latest
``max_to_keep`` saves, every save at a multiple of ``keep_every_n`` epochs
pinned for good, and the best-on-validation state in ``best.pt``. The
config that trained the checkpoints is written beside them once and never
overwritten.

Each file is written to a temporary name and renamed into place, so a
reader never sees a partial checkpoint. Saves are synchronous, so the JAX
package's ``wait=``, ``wait_until_finished()`` and ``close()`` are kept
for its callers and have nothing to wait for.

Data parallelism: given the ``mesh`` of a replicated train state, every rank
keeps the same bookkeeping but only world rank 0 writes, and a save ends
with a barrier, so the files are there for every rank when it returns.
Every rank restores from the same files. On a model axis every rank takes
the state's whole tensors (``TrainState.state_dict`` gathers the slices)
and each restores its own slices from them.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Optional

import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import (
    IrisConfig,
    config_from_json,
    config_to_json,
)
from iris_tts_tpu_torch.parallel.mesh import barrier, is_primary
from iris_tts_tpu_torch.parallel.sharding import (
    full_state_dict,
    load_full_state_dict,
)

logger = logging.getLogger(__name__)


def _atomic_save(obj: Any, path: Path) -> None:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Stage-level checkpoint manager (one directory per training stage)."""

    def __init__(
        self,
        directory: str | Path,
        config: Optional[IrisConfig] = None,
        keep_every_n: int = 5,
        max_to_keep: int = 5,
        mesh=None,
    ):
        self.mesh = mesh
        self.writer = is_primary(mesh)
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_every_n = keep_every_n
        self.max_to_keep = max_to_keep
        self._pinned_file = self.directory / "pinned_steps.json"
        self._pinned = set()
        if self._pinned_file.exists():
            self._pinned = set(json.loads(self._pinned_file.read_text()))
        self.best_metric = float("inf")
        self._best_file = self.directory / "best_metric.json"
        if self._best_file.exists():
            data = json.loads(self._best_file.read_text())
            self.best_metric = data.get("best_metric", float("inf"))
        if config is not None and self.writer:
            cfg_file = self.directory / "config.json"
            new_text = config_to_json(config)
            if not cfg_file.exists():
                cfg_file.write_text(new_text)
            elif cfg_file.read_text() != new_text:
                logger.warning(
                    "config differs from the one recorded beside the "
                    "checkpoints (%s); keeping the original record — "
                    "delete it explicitly if the change is intentional",
                    cfg_file)

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{int(step):010d}.pt"

    def _metrics_path(self, step: int) -> Path:
        return self.directory / f"step_{int(step):010d}.metrics.json"

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, metrics: Optional[dict] = None,
             val_metric: Optional[float] = None, wait: bool = False,
             epoch: Optional[int] = None) -> bool:
        """Save ``state`` at ``step``; track best-on-val separately. Returns
        True if this is a new best. ``metrics`` (scalars) are written
        beside the checkpoint as ``step_*.metrics.json``. ``epoch``
        (completed epochs) pins saves at multiples of ``keep_every_n``
        against eviction. Saves are synchronous, so ``wait`` (the JAX
        package's flag for its asynchronous saves) changes nothing: the
        checkpoint is on disk when this returns."""
        del wait
        try:
            return self._save(step, state, metrics, val_metric, epoch)
        finally:
            barrier(self.mesh)

    def wait_until_finished(self) -> None:
        """Nothing to wait for: every save has committed when it returns."""

    def _save(self, step, state, metrics, val_metric, epoch) -> bool:
        if (epoch is not None and self.keep_every_n
                and epoch % self.keep_every_n == 0):
            self._pinned.add(int(step))
            if self.writer:
                tmp = self._pinned_file.with_suffix(".tmp")
                tmp.write_text(json.dumps(sorted(self._pinned)))
                tmp.replace(self._pinned_file)
        # every rank: a state sharded over a model axis gathers its slices
        sd = state.state_dict()
        if self.writer:
            _atomic_save(sd, self._path(step))
            if metrics is not None:
                self._metrics_path(step).write_text(json.dumps(
                    {k: float(v) for k, v in metrics.items()}))
            # Orbax's policy: the latest max_to_keep saves, plus pinned ones.
            for s in self.all_steps()[: -self.max_to_keep or None]:
                if s not in self._pinned:
                    self._path(s).unlink()
                    self._metrics_path(s).unlink(missing_ok=True)
        if val_metric is None or not val_metric < self.best_metric:
            return False
        if self.writer:
            _atomic_save(sd, self.directory / "best.pt")
        # Recorded after the best state is on disk: a crash in between must
        # not leave a best metric without its state.
        self.best_metric = float(val_metric)
        if self.writer:
            self._best_file.write_text(json.dumps(
                {"best_metric": self.best_metric, "step": int(step)}))
        return True

    # -- restore -------------------------------------------------------------

    def all_steps(self) -> list:
        """Retained checkpoint steps, ascending."""
        return sorted(int(p.stem[len("step_"):])
                      for p in self.directory.glob("step_*.pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_raw(self, step: Optional[int] = None) -> dict:
        """The saved state dict (on the CPU) without a template: keys step,
        epoch, params, opt_state, rng, frozen, ema_params, ema_decay (or
        ``gen`` / ``disc`` for a GAN state)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return _load(self._path(step))

    def restore_best_raw(self) -> dict:
        best = self.directory / "best.pt"
        return _load(best) if best.exists() else self.restore_raw()

    def restore_best_params(self) -> dict:
        """The trained ``params`` state dict of the best (or latest)
        checkpoint, with no optimizer coupling."""
        return self.restore_best_raw()["params"]

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Restore into ``state_template`` (same structure) in place,
        bit-exact."""
        return state_template.load_state_dict(self.restore_raw(step))

    def restore_best(self, state_template: Any) -> Any:
        """Restore the best checkpoint (the latest if none is marked best)
        into ``state_template`` in place, bit-exact."""
        return state_template.load_state_dict(self.restore_best_raw())

    def load_config(self) -> IrisConfig:
        return config_from_json((self.directory / "config.json").read_text())

    def close(self) -> None:
        """Nothing to release: saves are synchronous and hold no handle."""


# ---------------------------------------------------------------------------
# Bare parameter save/load (inference exports)
# ---------------------------------------------------------------------------


def save_params(path: str | Path, params: nn.Module | dict) -> None:
    """Save a module's state dict (or a state dict) to one file."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    sd = full_state_dict(params) if isinstance(params, nn.Module) else params
    _atomic_save(sd, path)


def load_params(path: str | Path, template: Optional[nn.Module] = None):
    """The saved state dict, or ``template`` with it loaded (strict)."""
    sd = _load(Path(path).absolute())
    if template is None:
        return sd
    load_full_state_dict(template, sd)
    return template
