"""Generic training loop shared by all stages.

Counterpart of the JAX package's ``train/loop.py``: bucketed batches in
(staged ahead on a prefetch thread with pinned-memory copies), one step per
batch, metrics summed on the device (no per-step host sync), CSV metrics,
per-epoch validation, best/periodic full-state checkpoints, resume, and a
clean checkpoint-and-stop on SIGTERM/SIGINT.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from iris_tts_tpu_torch.data.batching import prefetch_to_device, to_device
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
from iris_tts_tpu_torch.utils.metrics import MetricsWriter, RunningMean

logger = logging.getLogger(__name__)

# Process-wide preemption marker: a program that runs several stages in one
# process must not go on to the next stage after a SIGTERM-triggered
# checkpoint-and-stop.
_PREEMPTED = False


def was_preempted() -> bool:
    """True if any TrainLoop in this process stopped on SIGTERM/SIGINT."""
    return _PREEMPTED


@dataclass
class TrainLoop:
    """Configure once, ``run()`` to train.

    Args:
        state: initial (or restored) train state (``TrainState`` or
            ``GANState``).
        train_step: ``(state, batch, *extras) → (state, metrics)``.
        batcher: object with ``epoch(i) → iterator of numpy batch dicts``.
        num_epochs: total epochs (absolute — resume continues the count).
        device: where batches go (the device of the state's params).
        checkpoints: optional CheckpointManager (full-state saves).
        eval_step: optional ``(params[, frozen], batch, *extras) →
            metrics``.
        val_batcher: batcher for validation.
        epoch_extras: ``epoch → tuple`` of extra positional args for the
            step and the eval step (e.g. the annealed KL weight).
        val_metric_key: metric minimised for best-checkpoint tracking.
        place_batch: numpy training batch → device batch (e.g. with a
            microbatch split); runs on the prefetch thread. Default:
            :func:`~iris_tts_tpu_torch.data.batching.to_device`.
        prefetch: training batches staged ahead of the step (0 disables
            the prefetch thread).

    Run from the main thread, SIGTERM/SIGINT write a full-state checkpoint
    and return cleanly. Resume granularity is the epoch: the interrupted
    epoch re-runs from its start.
    """

    state: Any
    train_step: Callable
    batcher: Any
    num_epochs: int
    device: torch.device
    checkpoints: Optional[CheckpointManager] = None
    metrics: Optional[MetricsWriter] = None
    eval_step: Optional[Callable] = None
    val_batcher: Optional[Any] = None
    epoch_extras: Optional[Callable[[int], tuple]] = None
    val_metric_key: str = "total"
    checkpoint_every: int = 5
    log_every_steps: int = 50
    start_epoch: int = 0
    uses_frozen_in_eval: bool = True
    place_batch: Optional[Callable] = None
    prefetch: int = 2

    history: list = field(default_factory=list)
    preempted: bool = field(default=False, init=False)

    def run(self):
        global _PREEMPTED
        _PREEMPTED = False  # a past loop's preemption is not this one's
        stop = threading.Event()
        old_handlers = {}
        if threading.current_thread() is threading.main_thread():
            def _on_signal(signum, frame):
                logger.warning("received %s — will checkpoint and stop",
                               signal.Signals(signum).name)
                stop.set()

            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, _on_signal)
        try:
            return self._run(self.state, stop)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    def _preempt_save(self, state) -> None:
        global _PREEMPTED
        _PREEMPTED = True
        self.preempted = True
        if self.checkpoints is None:
            return
        if self.checkpoints.latest_step() == state.step:
            logger.info("step %d already checkpointed; clean stop",
                        state.step)
            return
        try:
            self.checkpoints.save(state.step, state)
        except Exception:  # noqa: BLE001 — a failed save must not mask exit
            logger.exception("preemption checkpoint failed at step %d",
                             state.step)
            return
        logger.info("preemption checkpoint written at step %d (epoch "
                    "counter %d — the interrupted epoch re-runs on resume)",
                    state.step, state.epoch)

    def _place(self, batch):
        return to_device(batch, self.device)

    def _train_batches(self, epoch: int):
        place = self.place_batch or self._place
        if self.prefetch <= 0:
            return (place(b) for b in self.batcher.epoch(epoch))
        return prefetch_to_device(self.batcher.epoch(epoch),
                                  size=self.prefetch, place=place)

    def _run(self, state, stop: threading.Event):
        for epoch in range(self.start_epoch, self.num_epochs):
            extras = self.epoch_extras(epoch) if self.epoch_extras else ()
            t0 = time.time()
            n_steps = 0
            sums: Optional[Dict[str, torch.Tensor]] = None
            for batch in self._train_batches(epoch):
                if stop.is_set():
                    self._preempt_save(state)
                    return state
                state, m = self.train_step(state, batch, *extras)
                n_steps += 1
                sums = m if sums is None else {k: sums[k] + m[k]
                                               for k in sums}
                if (self.metrics and self.log_every_steps
                        and n_steps % self.log_every_steps == 0):
                    self.metrics.write(state.step,
                                       {k: float(v) for k, v in m.items()})
            train_means = ({k: float(v) / n_steps for k, v in sums.items()}
                           if sums else {})
            wall = time.time() - t0

            val_means: Dict[str, float] = {}
            if self.eval_step and self.val_batcher is not None:
                vm = RunningMean()
                for batch in self.val_batcher.epoch(0):
                    batch = self._place(batch)
                    if self.uses_frozen_in_eval and state.frozen is not None:
                        m = self.eval_step(state.params, state.frozen, batch,
                                           *extras)
                    else:
                        m = self.eval_step(state.params, batch, *extras)
                    vm.update({f"val_{k}": float(v) for k, v in m.items()})
                val_means = vm.means()

            logger.info(
                "epoch %d/%d (%.1fs, %d steps): train=%s val=%s",
                epoch + 1, self.num_epochs, wall, n_steps,
                {k: round(v, 5) for k, v in train_means.items()},
                {k: round(v, 5) for k, v in val_means.items()})
            self.history.append({**train_means, **val_means, "epoch": epoch})
            if self.metrics:
                self.metrics.write(state.step, {**train_means, **val_means})

            state.epoch = epoch + 1
            if self.checkpoints is not None:
                val_metric = val_means.get(f"val_{self.val_metric_key}",
                                           train_means.get(
                                               self.val_metric_key))
                periodic = ((self.checkpoint_every
                             and (epoch + 1) % self.checkpoint_every == 0)
                            or epoch + 1 == self.num_epochs)
                new_best = (val_metric is not None
                            and val_metric < self.checkpoints.best_metric)
                if periodic or new_best:
                    if self.checkpoints.save(state.step, state,
                                             val_metric=val_metric,
                                             epoch=epoch + 1):
                        logger.info("new best val_%s=%.5f",
                                    self.val_metric_key, val_metric)
            if stop.is_set():
                self._preempt_save(state)
                return state
        return state


def resume_if_available(ckpt: CheckpointManager, template,
                        steps_per_epoch: int = 0):
    """Restore the latest checkpoint into ``template`` if one exists;
    returns (state, start_epoch) with the epoch from the checkpointed
    counter (``steps_per_epoch`` is unused and kept for the JAX package's
    call sites)."""
    del steps_per_epoch
    if ckpt.latest_step() is None:
        return template, 0
    state = ckpt.restore(template)
    logger.info("resumed from step %d (epoch %d)", state.step, state.epoch)
    return state, state.epoch
