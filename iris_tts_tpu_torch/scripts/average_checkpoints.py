"""Average the params of the last K checkpoints of a training stage.

Checkpoint averaging (Polyak-style, over saved steps rather than every
update) is the standard cheap quality lift when no EMA was tracked during
the run. The mean is taken in float64 on ``--device`` and written in
float32 with ``train.checkpoint.save_params`` (one ``torch.save`` file of
the port's format; ``load_params`` reads it back). A GAN stage's
checkpoints average the generator's params. Integer buffers are taken from
the last chosen checkpoint.

Usage:
    python -m iris_tts_tpu_torch.scripts.average_checkpoints \
        --stage_dir outputs/vae/checkpoints --last 5 --output avg_params.pt
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_device_arg,
    setup_logging,
)
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager, save_params

logger = logging.getLogger(__name__)


def _params_of(raw: dict) -> dict:
    """The trained params of a restored checkpoint (a GAN checkpoint's
    generator)."""
    return raw["params"] if "params" in raw else raw["gen"]["params"]


def average_stage_params(stage_dir: str | Path, last: int = 5,
                         steps: list[int] | None = None,
                         device: torch.device = torch.device("cpu")):
    """Mean of the params over checkpoint ``steps`` (default: the last
    ``last`` retained steps). Returns (avg_params on the CPU, used
    steps)."""
    mgr = CheckpointManager(Path(stage_dir))
    all_steps = mgr.all_steps()
    if not all_steps:
        raise FileNotFoundError(f"no checkpoints in {stage_dir}")
    if steps is None:
        steps = all_steps[-last:]
    missing = sorted(set(steps) - set(all_steps))
    if missing:
        raise ValueError(f"steps {missing} not retained (have {all_steps})")
    acc: dict = {}
    for s in steps:
        for k, v in _params_of(mgr.restore_raw(s)).items():
            if v.is_floating_point():
                v = v.to(device, torch.float64)
                acc[k] = v if k not in acc else acc[k] + v
            else:
                acc[k] = v
    inv = 1.0 / len(steps)
    avg = {k: (v * inv).to(torch.float32).cpu() if v.is_floating_point()
           else v for k, v in acc.items()}
    return avg, list(steps)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stage_dir", required=True,
                    help="a stage checkpoint dir (CheckpointManager root)")
    ap.add_argument("--last", type=int, default=5)
    ap.add_argument("--steps", type=int, nargs="+", default=None,
                    help="explicit checkpoint steps to average")
    ap.add_argument("--output", required=True,
                    help="output file for the averaged bare params")
    add_device_arg(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()
    avg, used = average_stage_params(args.stage_dir, args.last, args.steps,
                                     resolve_device(args.device))
    save_params(args.output, avg)
    logger.info("averaged %d checkpoints (steps %s) -> %s",
                len(used), used, args.output)
    return used


if __name__ == "__main__":
    main()
