"""Render loss curves from the per-stage metrics.csv files of a
train_full_pipeline run into one PNG per stage (evidence artifacts).
matplotlib is imported only when a plot is drawn.

Usage:
    python -m iris_tts_tpu_torch.scripts.plot_training_curves \
        --run outputs/full_run --out docs/curves
"""

from __future__ import annotations

import argparse
import csv
import sys
from collections import defaultdict
from pathlib import Path

from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import add_device_arg

STAGES = ("encoder", "vae", "postnet", "hifigan_gan")


def read_metrics(path: Path):
    """metrics.csv (step,name,value,wall_time) → {name: [(step, value)]}."""
    series = defaultdict(list)
    with open(path) as f:
        for row in csv.DictReader(f):
            try:
                series[row["name"]].append(
                    (int(row["step"]), float(row["value"]))
                )
            except (KeyError, ValueError):
                continue
    return series


def plot_stage(csv_path: Path, dest: Path, title: str) -> bool:
    """Render one stage's metrics.csv as a log-scale curve PNG at dest.

    Returns False (and writes nothing) when the csv is missing or empty.
    """
    if not csv_path.exists():
        return False
    series = read_metrics(csv_path)
    if not series:
        return False

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    for name, pts in sorted(series.items()):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], label=name,
                linewidth=1.2)
    ax.set_xlabel("step")
    ax.set_ylabel("value")
    ax.set_yscale("log")
    ax.set_title(title)
    ax.legend(fontsize=7, ncol=2)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    dest.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(dest, dpi=110)
    plt.close(fig)
    return True


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Plots are drawn on the host; the device is resolved as every driver
    # resolves it.
    resolve_device(args.device)
    args.out.mkdir(parents=True, exist_ok=True)
    made = 0
    for stage in STAGES:
        csv_path = args.run / stage / "metrics.csv"
        dest = args.out / f"curves_{stage}.png"
        if plot_stage(csv_path, dest, f"{stage} training metrics"):
            print(f"wrote {dest}")
            made += 1
        else:
            print(f"skip {stage}: no data in {csv_path}", file=sys.stderr)
    if not made:
        sys.exit("no metrics found")
    return made


if __name__ == "__main__":
    main()
