"""Scalar metrics logging for training runs.

The port's own copy of the CSV writer and running means of the JAX
package's ``utils/metrics.py`` (one row per (step, name, value), greppable
and plottable). The audio-quality measures there (MCD, LSD,
``quality_report``) are not part of this package yet.
"""

from __future__ import annotations

import csv
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict


class MetricsWriter:
    """Append-only CSV of (step, name, value) scalars."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._new = not self.path.exists()
        self._fh = open(self.path, "a", newline="")
        self._writer = csv.writer(self._fh)
        if self._new:
            self._writer.writerow(["step", "name", "value", "wall_time"])

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        now = time.time()
        for name, value in scalars.items():
            self._writer.writerow([step, name, float(value), now])
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class RunningMean:
    """Streaming means for per-epoch loss aggregation."""

    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def update(self, scalars: Dict[str, float]) -> None:
        for k, v in scalars.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def means(self) -> Dict[str, float]:
        return {k: self._sums[k] / self._counts[k] for k in self._sums}
