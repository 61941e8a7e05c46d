"""Shared command-line plumbing of the drivers: one config tree and one
argument pattern across every stage (the JAX package's
``scripts/common.py``).

``--device`` selects the torch device (default: the CUDA device; without
one the driver raises, it never carries on on the CPU). ``--checkify``
runs each train step under ``torch.autograd.detect_anomaly`` and raises at
the first non-finite metric, the counterpart of JAX's checkify float
checks. Mesh placement (``--mesh``, ``--model_parallel``) is not here yet.
"""

from __future__ import annotations

import argparse
import logging
from dataclasses import replace
from pathlib import Path

import torch

from iris_tts_tpu_torch.config import IrisConfig, load_config, save_config


def setup_logging(verbose: bool = False) -> None:
    # force=True: a library may have installed a root handler already,
    # which would silently turn basicConfig into a no-op.
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        force=True,
    )


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device (default: the CUDA device, and an error without "
        "one: runtime.resolve_device; 'cpu' runs on the CPU)",
    )


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--config", type=str, default=None,
        help="Path to an IrisConfig JSON (defaults to built-in production "
        "config; stage checkpoints persist the config they trained with)",
    )
    parser.add_argument("--data_root", type=str, default="data/LJSpeech-1.1")
    parser.add_argument("--alignment_dir", type=str, default="data/aligned")
    parser.add_argument("--cache_dir", type=str, default="outputs/cache")
    parser.add_argument("--output_dir", type=str, default="outputs")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None,
                        help="training seed (default: config value)")
    parser.add_argument("--verbose", action="store_true")
    add_device_arg(parser)


def resolve_config(args: argparse.Namespace) -> IrisConfig:
    cfg = load_config(args.config) if args.config else IrisConfig()
    train = cfg.train
    if getattr(args, "batch_size", None):
        train = replace(train, batch_size=args.batch_size)
    if getattr(args, "num_epochs", None):
        train = replace(train, num_epochs=args.num_epochs)
    if getattr(args, "learning_rate", None):
        train = replace(train, learning_rate=args.learning_rate)
    if getattr(args, "seed", None) is not None:
        train = replace(train, seed=args.seed)
    return replace(cfg, train=train)


def persist_config(cfg: IrisConfig, output_dir: str | Path, name: str) -> None:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_config(cfg, out / name)


def add_accum_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--accum_steps", type=int, default=1,
        help="gradient-accumulation microbatches per optimizer update "
        "(effective batch = accum_steps * batch_size)",
    )


def add_bf16_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--bf16", action="store_true",
        help="mixed-precision training: bf16 module compute, f32 "
        "params/grads/optimizer",
    )


def compute_dtype_of(args: argparse.Namespace):
    return torch.bfloat16 if getattr(args, "bf16", False) else None


def add_checkify_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--checkify", action="store_true",
        help="debug mode: run each train step under torch.autograd."
        "detect_anomaly (a NaN in the backward pass raises with the "
        "operation that made it) and raise at the first non-finite step "
        "metric instead of silently poisoning the run (slower)",
    )


def checked_step(step_fn):
    """``step_fn`` under ``torch.autograd.detect_anomaly``, raising
    ``FloatingPointError`` when a returned metric is not finite."""

    def step(state, batch, *extras):
        with torch.autograd.detect_anomaly():
            state, metrics = step_fn(state, batch, *extras)
        bad = sorted(k for k, v in metrics.items()
                     if not bool(torch.isfinite(torch.as_tensor(v)).all()))
        if bad:
            raise FloatingPointError(
                f"non-finite train metrics {bad} at step {state.step}")
        return state, metrics

    return step


def run_loop(loop, checkify: bool = False):
    """Run a stage's ``TrainLoop`` (each step checked with ``--checkify``)
    and return the final state."""
    if checkify:
        loop.train_step = checked_step(loop.train_step)
    return loop.run()
