"""Profiling, the synthesis path's spans and counters, and numerical
guards.

Counterpart of the JAX package's ``utils/prof.py``: a trace context
(``torch.profiler``, written as a Chrome trace) and finite checks. In JAX
``guard_finite`` is a ``jax.debug.callback`` inside a jitted step; eager
PyTorch has no trace to hide it in, so here it is a host check that waits
for the device. Nothing on the training or synthesis path calls it, in
either package.

Spans and counters. Tracing is on exactly while the autograd profiler
records (:func:`tracing`): inside :func:`trace`, any
``torch.profiler.profile`` or ``torch.autograd.profiler.emit_nvtx``.
There is no other switch. With tracing off, :func:`span` returns one
shared no-op context manager and :func:`count` returns at once (one flag
test each).
With tracing on, ``span(name)`` opens ``record_function("iris." + name)``,
so the span lies on the profiler's own clock beside the device's kernels
and copies, and nests under the span open around it; ``count(name, n)``
adds ``n`` to an in-memory counter, which :func:`counters` returns (a copy,
summed over every traced stretch of the process).

The bulk path (``scripts/batch_synthesize.synthesize_batches``) opens,
per call::

    iris.job           the call
      iris.frontend    its texts → ids sweep
      iris.encode      a batch's padded ids (TTSPipeline._encode_texts)
      iris.stage_a     copies in, encoder, durations (_stage_a_device)
      iris.bucket      the host reads stage A's totals, groups by bucket
      iris.stage_b     a batch's device work (_stage_b), holding
        iris.acoustic  noise, length regulation, VAE, PostNet (_acoustic)
        iris.vocoder   HiFiGAN or BigVGAN (_vocode_device)
          iris.amp_act each of BigVGAN's anti-aliased activations
      iris.collect     the copy to the host and the trim (_fetch_rows)

and counts ``stage_b.frames_useful`` (each distinct utterance's own frames)
and ``stage_b.frames_padded`` (each batch's rows × its frame bucket), whose
ratio is the share of stage B's frames that are speech. The vocoder counts
its layers by the path that ran them: HiFiGAN's resblock layers as
``vocoder.fused_layers`` / ``vocoder.library_layers``, BigVGAN's
activations as ``vocoder.amp_fused`` / ``vocoder.amp_library``. The
pipeline's other entry points open the same method spans. No span sits in a
module-level function (``stage_a``, ``acoustic``, ``fused_synthesis``,
...): those are what ``torch.export`` traces and ``serve/export.py``
captures as CUDA graphs.

To read a bulk run::

    with prof.trace("traces/bulk"):
        synthesize_batches(pipe, texts, 32, seed)
    c = prof.counters()
    fill = c["stage_b.frames_useful"] / c["stage_b.frames_padded"]

and, in the Chrome trace, set each gap between the device's kernels and
copies against the innermost ``iris.`` span the host had open over it:
``iris.frontend`` and ``iris.collect`` are the host's own work, the rest of
``iris.job`` is dispatch, and the time outside ``iris.job`` is the
caller's.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from pathlib import Path
from typing import ContextManager, Dict, Iterator, List

import torch
import torch.nn as nn
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "iris."
_OFF = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}
_COUNTERS_LOCK = threading.Lock()


def tracing() -> bool:
    """True while the autograd profiler records: spans open and counters
    advance."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str) -> ContextManager:
    """``with span("stage_a"): ...``: a profiler range ``iris.stage_a``
    while tracing is on, else a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _COUNTERS_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A copy of the counters: what :func:`count` added while tracing was
    on, since the process started."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


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
