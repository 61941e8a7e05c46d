"""The benchmark of ``iris_tts_tpu_torch`` on the card.

One command runs one cell once (``python3 -m perfbench.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``, from the root of a
checkout; see ``run.py``). ``BENCHMARK.json`` at the root lists the
configurations, the cells (a configuration under a traffic mix), the
end-to-end metrics with their bounds and the per-layer metrics. Nothing
here imports JAX or the JAX package ``iris_tts_tpu``; ``reference/``
imports nothing of the port either.

Everything is found by name, so a later change adds files and entries and
edits none:

- a configuration: ``configs/<name>.json`` (its widths as run, its weights:
  an artifact directory and the modules drawn from the seed, its bucket
  ladders, its precision; ``weights.py`` reads it) and an entry under
  ``configs`` in ``BENCHMARK.json``;
- a traffic mix: ``workloads/<traffic>.json``, the parameters that one
  general generator reads; it names its generator
  (``traffic/<generator>.py``, a class ``Generator(params, seed)`` with
  ``job()``) and its driver (``drivers/<driver>.py``: ``run``, which sets
  up the program, runs the window and returns the run's record with a
  sample for the check, and ``check``, which compares that sample with
  the plain reference; ``run.run_cell`` lists the record's common keys,
  and metrics read the driver's own);
- a cell: an entry under ``workloads`` in ``BENCHMARK.json`` and its
  limits, ``limits/<cell>.json``: each number the check compares
  (``check.py``) and the largest value that passes;
- a metric: ``metrics/<name>.py``, a function ``read(ctx)`` that returns
  the number or None when it finds nothing to read (the metric is then left
  out of the line), and an entry under ``end_to_end`` or ``per_layer``.

The plain reference (``reference/``) is a frozen copy of the port's
inference math, text frontend and artifact reader; ``check.py`` runs it
on a speech driver's sample after the window, and ``speech.py`` derives
from a speech driver's record what its metrics share. ``cost.py`` counts FLOPs over it
on the ``meta`` device and holds the card's peaks; ``devtrace.py`` holds
the benchmark's own spans and the reading of the profiler's trace;
``calibrate.py`` gives the readings the limits are set from.

Build caches, each at a fixed path inside the checkout so that only a
checkout's first run builds: the reference's zstd decoder in
``build/perfbench/`` (g++), the port's own C++ libraries in
``build/iris_tts_tpu_torch/``; ``run.py`` points ``TORCH_EXTENSIONS_DIR``
and ``TRITON_CACHE_DIR`` at ``build/perfbench/torch_extensions`` and
``build/perfbench/triton``. The tests are in ``tests/``
(``python -m pytest perfbench/tests``; the ``cuda``-marked control test
runs on the card only).
"""
