"""Profiling and numerical-guard utilities.

Counterpart of the JAX package's ``utils/prof.py``: a trace context
(``torch.profiler``, written as a Chrome trace), a step timer, and finite
checks. In JAX ``guard_finite`` is a ``jax.debug.callback`` inside a jitted
step; eager PyTorch has no trace to hide it in, so here it is a host check
that waits for the device. Nothing on the training or synthesis path calls
it, in either package.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn as nn


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU, and the CUDA device
    when there is one) and write a Chrome trace into ``log_dir``
    (``trace_<pid>_<ns>.json``; Perfetto and ``chrome://tracing`` read it):
    ``with trace('/tmp/trace'): run_step()``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock step timing with warmup discard (first calls excluded).
    The host clock: end each timed step with ``torch.cuda.synchronize()``
    for a device step's time."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._seen = 0
        self._total = 0.0
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._total += dt
            self._count += 1
        return False

    @property
    def mean_s(self) -> float:
        return self._total / max(1, self._count)


def guard_finite(name: str, x: torch.Tensor) -> torch.Tensor:
    """NaN/Inf tripwire: prints a warning when ``x`` holds a non-finite
    value. Returns ``x``. Reads one flag back, so it waits for the
    device."""
    if not bool(torch.isfinite(x).all()):
        print(f"[guard_finite] {name}: non-finite values!")
    return x


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a module (its state dict), a state dict, or a nested
    dict / list / tuple of tensors."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [torch.as_tensor(tree)]


def tree_finite(tree) -> bool:
    """True iff every tensor of ``tree`` (a module, a state dict or a dict
    of tensors) is finite."""
    return all(bool(torch.isfinite(x).all()) for x in _leaves(tree))


def grad_norm(tree) -> float:
    """Global L2 norm of a gradient tree (host-side diagnostic): a dict or
    state dict of gradients, or a module, whose parameters' ``.grad`` are
    read (parameters without one are skipped)."""
    if isinstance(tree, nn.Module):
        tree = [p.grad for p in tree.parameters() if p.grad is not None]
    total = sum(float(torch.sum(torch.square(x.float())))
                for x in _leaves(tree))
    return total ** 0.5


def profile_stats(metrics: Dict[str, float], step_time_s: float,
                  tokens_or_frames: int) -> Dict[str, float]:
    """Standard per-step perf scalars for MetricsWriter."""
    out = dict(metrics)
    out["step_time_s"] = step_time_s
    out["frames_per_sec"] = tokens_or_frames / max(step_time_s, 1e-9)
    return out
