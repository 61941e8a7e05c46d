"""Memory analysis of the training steps: a device-memory budgeting tool.

The port's counterpart of the JAX package's ``scripts/mem_analysis.py``.
For each training step at the given shapes, with and without remat (and
with ``--bf16``), it runs one warm-up step (which creates the Adam moments
and picks the kernels) and then measures one step, printing three sizes in
MiB, one JSON row a step:

* ``args_mib``: what is live before the step, the train state (params,
  buffers, Adam moments, frozen companions) and the batch;
* ``out_mib``: what the step returns, the state it updated in place and
  its metrics;
* ``temp_mib``: the peak during the step above ``args``, less the outputs
  the step newly allocated: live activations and workspace, the number
  that decides whether a shape fits.

On a CUDA device these are the caching allocator's numbers
(``memory_allocated`` before the step, ``max_memory_allocated`` after
``reset_peak_memory_stats``); on the CPU they are a tracker's, a dispatch
mode that adds the bytes of each storage an aten op creates and subtracts
them when the storage is freed. Neither is a compiler's plan. The tracker
sees only tensors that aten ops return, so it misses the workspaces
libraries allocate themselves (cuDNN, cuBLAS) and the allocator's rounding.

Usage:
    python -m iris_tts_tpu_torch.scripts.mem_analysis [--stage vae|gan] \
        [--batch_size 8] [--frames 1024] [--phonemes 64] [--bf16] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import threading
import weakref
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.models import PhonemeEncoder, TextConditionedVAE
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.runtime import (
    pin_math_precision,
    resolve_device,
    seeded_generator,
)
from iris_tts_tpu_torch.scripts.common import add_device_arg
from iris_tts_tpu_torch.train.gan import make_gan_steps
from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
from iris_tts_tpu_torch.train.steps import make_vae_train_step

MIB = 2 ** 20


class LiveBytes(TorchDispatchMode):
    """Live bytes of the storages created inside it, and their peak.

    Each storage an aten op returns that is not one of its inputs' (a view
    or an in-place result) adds its bytes; a ``weakref.finalize`` on the
    storage subtracts them when it is freed, on whichever thread frees it
    (the autograd engine's, in a backward pass)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._tracked = set()
        self._lock = threading.Lock()

    def _free(self, key: int, nbytes: int) -> None:
        with self._lock:
            self._tracked.discard(key)
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = {id(t.untyped_storage()) for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        with self._lock:
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                st = t.untyped_storage()
                key = id(st)
                if key in inputs or key in self._tracked:
                    continue
                self._tracked.add(key)
                weakref.finalize(st, self._free, key, st.nbytes())
                self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        return out


def storage_bytes(obj, device: torch.device) -> Dict[int, int]:
    """{data_ptr: bytes} of every storage on ``device`` that ``obj`` holds:
    tensors, modules (parameters, their gradients, buffers), optimizers
    (their state), dataclasses (a train state), and dicts, lists and tuples
    of these."""
    found: Dict[int, int] = {}

    def add(t: torch.Tensor) -> None:
        if t.device.type == device.type:
            st = t.untyped_storage()
            found[st.data_ptr()] = st.nbytes()

    def walk(o) -> None:
        if isinstance(o, torch.Tensor):
            add(o)
        elif isinstance(o, nn.Module):
            for p in o.parameters():
                add(p)
                if p.grad is not None:
                    add(p.grad)
            for b in o.buffers():
                add(b)
        elif isinstance(o, torch.optim.Optimizer):
            walk(list(o.state.values()))
        elif isinstance(o, dict):
            walk(list(o.values()))
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            walk([getattr(o, f.name) for f in dataclasses.fields(o)])

    walk(obj)
    return found


def measure_step(run: Callable, inputs, device: torch.device,
                 method: str, base: int = 0) -> Dict[str, float]:
    """``temp_mib``, ``args_mib`` and ``out_mib`` of the call ``run()``
    (a train step on ``inputs``: its state and batch), measured on its
    second call by ``method``: ``"allocator"`` (the CUDA caching
    allocator; ``args`` is what it holds above ``base`` bytes) or
    ``"tracker"`` (:class:`LiveBytes`; ``args`` is the bytes of
    ``inputs``)."""
    cuda = method == "allocator"
    if cuda and device.type != "cuda":
        raise ValueError("the allocator's numbers need a CUDA device")
    run()
    gc.collect()
    before = storage_bytes(inputs, device)
    if cuda:
        torch.cuda.synchronize(device)
        live = torch.cuda.memory_allocated(device)
        args = live - base
        torch.cuda.reset_peak_memory_stats(device)
        result = run()
        torch.cuda.synchronize(device)
        above = torch.cuda.max_memory_allocated(device) - live
    else:
        args = sum(before.values())
        tracker = LiveBytes()
        with tracker:
            result = run()
        above = tracker.peak
    returned = storage_bytes(result, device)
    new_out = sum(n for p, n in returned.items() if p not in before)
    return {"temp_mib": round((above - new_out) / MIB, 1),
            "args_mib": round(args / MIB, 1),
            "out_mib": round(sum(returned.values()) / MIB, 1)}


def analysis_rows(stage: str, batch_size: int, frames: int, phonemes: int,
                  bf16: bool, device: torch.device,
                  method: Optional[str] = None) -> list:
    """The JAX tool's rows for ``stage`` (``"vae"``: the VAE step without
    and with remat; ``"gan"``: the generator step without and with remat,
    and the discriminator step) at its zero batches, each with ``B``,
    ``T``, ``dtype``, ``stage``, ``remat`` and :func:`measure_step`'s
    sizes. ``method`` defaults to the allocator on a CUDA device and the
    tracker elsewhere. On the allocator ``args_mib`` is what the device
    holds before the step beyond what it held before this call."""
    method = method or ("allocator" if device.type == "cuda" else "tracker")
    pin_math_precision()  # as the training stages run
    base = 0
    if method == "allocator":
        gc.collect()
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    cfg = IrisConfig()
    dt = torch.bfloat16 if bf16 else None
    B, P, T = batch_size, phonemes, frames
    rows = []

    def add(name, remat, run, inputs):
        rows.append({"B": B, "T": T, "dtype": "bf16" if bf16 else "f32",
                     "stage": name, "remat": remat,
                     **measure_step(run, inputs, device, method, base)})

    if stage == "vae":
        enc, vae = PhonemeEncoder(cfg.encoder), TextConditionedVAE(cfg.vae)
        for m in (enc, vae):
            init_params(m, seeded_generator(0, "cpu"))
        st = TrainState.create(vae.to(device), adam_clipped(1e-3), 0,
                               frozen={"encoder": enc.to(device)})
        batch = {
            "phoneme_ids": torch.zeros((B, P), dtype=torch.int64,
                                       device=device),
            "phoneme_mask": torch.ones((B, P), device=device),
            "durations": torch.full((B, P), T / P, device=device),
            "mel": torch.zeros((B, T, cfg.vae.n_mels), device=device),
        }
        for remat in (False, True):
            step = make_vae_train_step(cfg, compute_dtype=dt, remat=remat)
            add("vae", remat, lambda: step(st, batch, 0.01), (st, batch))
    elif stage == "gan":
        gen, disc = HiFiGANGenerator(cfg.hifigan), HiFiGANDiscriminators()
        init_params(gen, seeded_generator(0, "cpu"))
        init_params(disc, seeded_generator(1, "cpu"))
        tx = adam_clipped(1e-4, clip_norm=None)  # optax.adam(1e-4)
        gs = TrainState.create(gen.to(device), tx, 0)
        ds = TrainState.create(disc.to(device), tx, 1)
        batch = {"mel": torch.zeros((B, T, cfg.hifigan.in_channels),
                                    device=device),
                 "audio": torch.zeros((B, T * cfg.audio.hop_length),
                                      device=device)}
        # Both optimizers' moments exist before any row, as JAX's states
        # hold theirs from the start: each row's warm-up creates only its
        # own side's.
        make_gan_steps(cfg, compute_dtype=dt)[0](gs, ds, batch)
        for remat in (False, True):
            d_step, g_step = make_gan_steps(cfg, compute_dtype=dt,
                                            remat=remat)
            add("gan_gen", remat, lambda: g_step(gs, ds, batch),
                (gs, ds, batch))
            if not remat:  # the discriminator step has no remat knob
                add("gan_disc", False, lambda: d_step(gs, ds, batch),
                    (gs, ds, batch))
    else:
        raise ValueError(f"unknown stage {stage!r}")
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--stage", choices=["vae", "gan"], default="vae")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--frames", type=int, default=1024,
                    help="mel frames (vae) / segment frames (gan)")
    ap.add_argument("--phonemes", type=int, default=64)
    ap.add_argument("--bf16", action="store_true")
    add_device_arg(ap)
    return ap


def main(argv=None) -> list:
    """Prints one JSON row a measured step and returns the rows."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    rows = analysis_rows(args.stage, args.batch_size, args.frames,
                         args.phonemes, args.bf16, device)
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
