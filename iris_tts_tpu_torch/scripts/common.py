"""Shared command-line plumbing of the drivers: one config tree and one
argument pattern across every stage (the JAX package's
``scripts/common.py``).

``--device`` selects the torch device (default: the CUDA device; without
one the driver raises, it never carries on on the CPU). ``--checkify``
runs each train step under ``torch.autograd.detect_anomaly`` and raises at
the first non-finite metric, the counterpart of JAX's checkify float
checks.

``--mesh`` trains (or synthesizes) data-parallel over the processes of a
``torch.distributed`` group, one process per device: launch the driver
under ``torchrun --nproc_per_node N -m iris_tts_tpu_torch.scripts.<name>
--mesh ...`` and each rank takes ``cuda:{LOCAL_RANK}``.
``--force_cpu_devices N`` is the counterpart of the JAX package's N virtual
CPU devices: the driver starts N gloo ranks on the CPU, each running the
driver with ``--mesh --device cpu``, and waits for them.
``--model_parallel N`` (with ``--mesh``) lays the ranks out as a
``(world / N, N)`` mesh: each group of N consecutive ranks shares a data
coordinate and splits the wide layers' output channels (params, Adam
moments and EMA alike) between them, as the JAX package's flag does.
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from iris_tts_tpu_torch.config import (
    IrisConfig,
    MeshConfig,
    load_config,
    save_config,
)
from iris_tts_tpu_torch.parallel.mesh import (
    Mesh,
    build_mesh,
    initialize_multihost,
    is_primary,
    local_rows,
    world_size,
)


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


def device_label(device: torch.device) -> str:
    """``device`` with the card's name where it is a CUDA device, so a
    measurement names what it ran on."""
    if device.type != "cuda":
        return str(device)
    return f"{device} ({torch.cuda.get_device_name(device)})"


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
    if not is_primary():
        return
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


def sync(out) -> None:
    """Wait for the device work behind ``out``: ``torch.cuda.synchronize``
    when any tensor in it lies on a CUDA device (the CPU computes eagerly,
    so nothing is owed there)."""
    from torch.utils._pytree import tree_leaves

    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def avg_ms(fn, args_cycle, n: int = 30) -> float:
    """Wall time per call: one warm-up call, then ``n`` calls queued over
    the inputs of ``args_cycle`` in turn (each a tuple of arguments, or one
    argument), then one device barrier, so the launches overlap the device
    work as a caller's loop would."""
    args_cycle = [a if isinstance(a, tuple) else (a,) for a in args_cycle]
    sync(fn(*args_cycle[0]))
    t0 = time.perf_counter()
    out = None
    for i in range(n):
        out = fn(*args_cycle[i % len(args_cycle)])
    sync(out)
    return 1000 * (time.perf_counter() - t0) / n


# -- multi-device ------------------------------------------------------------

# How long a --force_cpu_devices launch waits for its ranks.
RANK_DEADLINE_S = 1800.0


def add_mesh_arg(parser: argparse.ArgumentParser,
                 model_parallel: bool = True) -> None:
    parser.add_argument(
        "--mesh", action="store_true",
        help="run data-parallel over the processes of the torch.distributed "
        "group (torchrun's environment; one process per device): batches "
        "split over the ranks, the state is replicated from rank 0 and the "
        "gradients are summed over the ranks before clipping")
    if model_parallel:
        parser.add_argument(
            "--model_parallel", type=int, default=1,
            help="with --mesh: split the mesh (world/N, N) and shard wide "
            "trailing parameter dims (conv output channels, FFN widths) "
            "over the model axis; params, optimizer moments and their "
            "gradients then live sharded, each rank computing its slice of "
            "the channels")
    parser.add_argument(
        "--force_cpu_devices", type=int, default=0,
        help="start N gloo ranks on the CPU, each running this driver with "
        "--mesh --device cpu, and wait for them (testing without cards)")


def mesh_from_args(args: argparse.Namespace,
                   device: torch.device) -> Optional[Mesh]:
    """The mesh ``--mesh`` asks for (None without it): joins the process
    group from torchrun's environment when it is not up yet. A device
    without an index (``cuda``) means each rank's ``cuda:{LOCAL_RANK}``.
    ``--model_parallel`` without ``--mesh``, or a model axis that does not
    divide the world, raises."""
    mp = getattr(args, "model_parallel", 1)
    if not args.mesh:
        if mp > 1:
            raise ValueError("--model_parallel needs --mesh")
        return None
    initialize_multihost(device=device)
    devices = None
    if device.type != "cuda" or device.index is not None:
        devices = [device] * world_size()
    return build_mesh(MeshConfig(model_parallel=mp), devices)


def mesh_training_placement(state, accum_steps: int = 1,
                            model_parallel: int = 1,
                            mesh: Optional[Mesh] = None):
    """Place a train state and its batches for mesh training.

    Returns ``(state, place_batch)``: the state placed on ``mesh`` (default:
    a ``(world / model_parallel, model_parallel)`` mesh of the process
    group's ranks, each on the state's device), and a function that takes
    a host or device batch, every rank passing the same global batch, to
    this rank's rows of the data axis on the mesh's device (axis 1 when
    gradient accumulation stacks microbatches in front, so each
    microbatch spreads over the data axis). The train step itself is
    unchanged: it reads ``state.mesh``. Masked losses stay exact under the
    batcher's padded remainder rows because their denominators are global
    mask sums.

    On a model axis wider than one rank the state is also tensor-sharded
    (``TrainState.place_on``): every column-parallel layer the JAX rule
    picks keeps its slice of the output channels, so its Adam moments and
    EMA are slices too, and the ranks of a model group take the same
    rows."""
    if mesh is None:
        device = (state.gen if hasattr(state, "gen") else state).generator
        mesh = build_mesh(MeshConfig(model_parallel=model_parallel),
                          [device.device] * world_size())
    state.place_on(mesh)
    axis = 1 if accum_steps > 1 else 0

    def place_batch(batch):
        return {k: torch.as_tensor(local_rows(v, mesh, axis)).to(mesh.device)
                for k, v in batch.items()}

    logging.getLogger(__name__).info(
        "mesh training on %s (%s)", mesh.shape,
        "data+tensor parallel" if mesh.model_size > 1 else "data parallel")
    return state, place_batch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_argv(argv: Sequence[str]) -> list:
    """``argv`` without ``--force_cpu_devices``/``--device``, plus
    ``--mesh --device cpu``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        name = a.split("=", 1)[0]
        if name in ("--force_cpu_devices", "--device"):
            skip = "=" not in a
            continue
        out.append(a)
    if "--mesh" not in out:
        out.append("--mesh")
    return out + ["--device", "cpu"]


def spawn_cpu_ranks(module: str, argv: Optional[Sequence[str]],
                    n: int) -> int:
    """Run ``python -m module`` as ``n`` gloo ranks on the CPU (each with
    ``--mesh --device cpu``) and wait for all of them, at most
    :data:`RANK_DEADLINE_S`: a rank that fails or outlives the deadline
    fails the launch and every rank still running is killed. Returns 0."""
    argv = list(sys.argv[1:] if argv is None else argv)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n))
    # The ranks share the host's cores.
    threads = max(1, (os.cpu_count() or 1) // n)
    env.setdefault("OMP_NUM_THREADS", str(threads))
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *_rank_argv(argv)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(n)]
    deadline = time.monotonic() + RANK_DEADLINE_S
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"{module}: rank {bad[0][0]} exited "
                                   f"with {bad[0][1]}")
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                raise TimeoutError(f"{module}: ranks still running after "
                                   f"{RANK_DEADLINE_S} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_as_script(main) -> None:
    """``main()`` as a program: the process group (if any) is left
    cleanly at exit."""
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
