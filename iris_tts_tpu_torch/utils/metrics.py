"""Scalar metrics logging for training runs, audio-quality measures and
the synthesis meter.

The port's own copy of the JAX package's ``utils/metrics.py``: the CSV
writer and running means (one row per (step, name, value), greppable and
plottable), mel-cepstral distortion and log-spectral distance with an
optional DTW alignment (``quality_report``), and ``SynthesisMeter`` (RTF,
mel frames a second, latency percentiles). The quality measures are
host-side numpy in float64, evaluation only; the DTW is the same
O(T1·T2) Python loop, which sets the evaluation's host time.
"""

from __future__ import annotations

import csv
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


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


# ---------------------------------------------------------------------------
# Audio-quality metrics (host-side numpy: evaluation only)
# ---------------------------------------------------------------------------

_LOG_TO_DB = 20.0 / np.log(10.0)  # natural-log spectra → decibels


def mel_cepstra(log_mel: np.ndarray, n_coeffs: int = 13) -> np.ndarray:
    """Log-mel [T, n_mels] (natural log) → mel-cepstral coefficients
    c1..c_{n_coeffs} [T, n_coeffs] via an orthonormal DCT-II over the mel
    axis. c0 (frame energy) is dropped, the standard choice for MCD so
    loudness differences don't mask spectral envelope differences."""
    log_mel = np.asarray(log_mel, np.float64)
    t, m = log_mel.shape
    # Orthonormal DCT-II basis [m, m]: basis[k, n] = s_k cos(pi(n+.5)k/m)
    n = np.arange(m)
    k = np.arange(m)[:, None]
    basis = np.cos(np.pi * (n[None, :] + 0.5) * k / m)
    basis *= np.where(k == 0, np.sqrt(1.0 / m), np.sqrt(2.0 / m))
    cep = log_mel @ basis.T  # [T, m]
    return cep[:, 1: n_coeffs + 1]


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic alignment path through a [T1, T2] frame-cost matrix
    (classic O(T1·T2) dynamic-time-warping DP; steps ↓, →, ↘)."""
    t1, t2 = cost.shape
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, t1 + 1):
        row = cost[i - 1]
        for j in range(1, t2 + 1):
            acc[i, j] = row[j - 1] + min(
                acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1]
            )
    path_a, path_b = [], []
    i, j = t1, t2
    while i > 0 and j > 0:
        path_a.append(i - 1)
        path_b.append(j - 1)
        moves = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        best = int(np.argmin(moves))
        if best == 0:
            i, j = i - 1, j - 1
        elif best == 1:
            i -= 1
        else:
            j -= 1
    return np.array(path_a[::-1]), np.array(path_b[::-1])


def _aligned(a: np.ndarray, b: np.ndarray, align: str):
    """Frame pairs of two [T, D] arrays: the common prefix ("trim") or the
    DTW path over their Euclidean frame distances ("dtw")."""
    if align == "dtw":
        cost = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
        ia, ib = dtw_path(cost)
        return a[ia], b[ib]
    n = min(len(a), len(b))
    return a[:n], b[:n]


def mel_cepstral_distortion(
    log_mel_a: np.ndarray,
    log_mel_b: np.ndarray,
    n_coeffs: int = 13,
    align: str = "trim",
) -> float:
    """Mel-cepstral distortion (dB) between two log-mel spectrograms
    [T, n_mels] (natural-log convention).

    MCD = (10/ln10)·√2 · mean_t ‖c_a(t) − c_b(t)‖₂  over c1..c_{n_coeffs}.

    align: "trim" (compare the common prefix — right when frames already
    correspond, e.g. generation with ground-truth durations) or "dtw"
    (dynamic-time-warp frames first — for predicted-duration output whose
    frame count differs from the reference).
    """
    if len(log_mel_a) == 0 or len(log_mel_b) == 0:
        return float("nan")  # no frames to compare (explicit, no warnings)
    ca, cb = _aligned(mel_cepstra(log_mel_a, n_coeffs),
                      mel_cepstra(log_mel_b, n_coeffs), align)
    dist = np.sqrt(((ca - cb) ** 2).sum(axis=1))
    return float((10.0 / np.log(10.0)) * np.sqrt(2.0) * dist.mean())


def log_spectral_distance(
    log_spec_a: np.ndarray, log_spec_b: np.ndarray, align: str = "trim"
) -> float:
    """Log-spectral distance (dB): mean over frames of the RMS dB gap
    across bins. Works on any natural-log spectra sharing a bin axis
    ([T, bins] log-mel or log-magnitude STFT)."""
    a = np.asarray(log_spec_a, np.float64)
    b = np.asarray(log_spec_b, np.float64)
    if len(a) == 0 or len(b) == 0:
        return float("nan")
    a, b = _aligned(a, b, align)
    diff_db = (a - b) * _LOG_TO_DB
    return float(np.sqrt((diff_db ** 2).mean(axis=1)).mean())


def quality_report(
    log_mel_gen: np.ndarray, log_mel_ref: np.ndarray, align: str = "trim"
) -> Dict[str, float]:
    """The standard generated-vs-reference quality bundle."""
    n = min(len(log_mel_gen), len(log_mel_ref))
    return {
        "mcd_db": mel_cepstral_distortion(log_mel_gen, log_mel_ref,
                                          align=align),
        "lsd_db": log_spectral_distance(log_mel_gen, log_mel_ref,
                                        align=align),
        "mel_l1": float(
            np.mean(np.abs(
                np.asarray(log_mel_gen)[:n] - np.asarray(log_mel_ref)[:n]
            ))
        ) if n else float("nan"),
    }


class SynthesisMeter:
    """Serving metrics: realtime factor, mel frames a second and
    per-utterance latency percentiles, on the host clock."""

    def __init__(self, sample_rate: int = 22050, hop_length: int = 256):
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.latencies: list[float] = []
        self.audio_seconds = 0.0
        self.frames = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self, n_samples: int) -> float:
        dt = time.time() - self._t0
        self.latencies.append(dt)
        self.audio_seconds += n_samples / self.sample_rate
        self.frames += n_samples // self.hop_length
        return dt

    def summary(self) -> Dict[str, float]:
        total = sum(self.latencies) or 1e-9
        lat = sorted(self.latencies)

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

        return {
            "rtf": self.audio_seconds / total,
            "mel_frames_per_sec": self.frames / total,
            "p50_latency_s": pct(0.50),
            "p90_latency_s": pct(0.90),
            "audio_seconds": self.audio_seconds,
            "wall_seconds": total,
        }
