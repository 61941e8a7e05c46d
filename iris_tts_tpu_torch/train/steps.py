"""Train, eval and reconstruction steps for the duration, VAE and PostNet
stages.

Counterpart of the JAX package's ``train/steps.py``: one
``(TrainState, batch, *extras) → (TrainState, metrics)`` function per stage,
built by a factory that closes over the config. Each step computes the
stage's loss (dropout and noise from the state's generator), back-propagates
into the state's params and applies one optimizer update. Metrics are 0-d
tensors on the device, so a step forces no host sync. The loss functions
are public so a caller can take gradients of the same loss without the
update (``deterministic=True``: dropout off, VAE at its posterior mean).

Batches are dicts of tensors with static bucket shapes:

* duration stage: ``phoneme_ids [B,P] int32, durations [B,P] f32,
  phoneme_mask [B,P] f32``
* VAE and PostNet stages: adds ``mel [B,T,n_mels] f32`` (time-major),
  with T a multiple of the VAE down factor

``accum_steps > 1``: the step takes batches shaped ``[accum, B, ...]``
(:func:`split_microbatches`) and averages gradients and metrics over the
microbatches before its single optimizer update.

``compute_dtype=torch.bfloat16`` (duration, VAE and PostNet train steps)
is mixed-precision training as in the JAX package: the modules, frozen
ones included, compute in bf16 for the step's forward and backward
passes (``models/layers.computing``), while the params, their gradients,
the Adam state and the loss reductions stay f32, so the f32 master copy
is the parameter itself; bf16's f32 exponent range needs no loss scaling.
``remat=True`` (VAE) recomputes the WaveNet blocks' activations in the
backward pass, dropout masks replayed (``layers.checkpoint_block``). The
eval and reconstruction steps compute in f32, as JAX's do.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from iris_tts_tpu_torch.config import IrisConfig
from iris_tts_tpu_torch.models.layers import computing
from iris_tts_tpu_torch.ops.length import length_regulate
from iris_tts_tpu_torch.ops.losses import (
    duration_huber_loss,
    masked_l1_loss,
    vae_loss,
)
from iris_tts_tpu_torch.runtime import DtypeLike, resolve_dtype
from iris_tts_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Gradient accumulation
# ---------------------------------------------------------------------------


def split_microbatches(batch, accum_steps: int):
    """Reshape a ``[accum·B, ...]`` batch (numpy or torch) into the
    ``[accum, B, ...]`` layout the accumulating steps loop over."""
    def split(x):
        if x.shape[0] % accum_steps:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"accum_steps={accum_steps}")
        return x.reshape(accum_steps, x.shape[0] // accum_steps,
                         *x.shape[1:])

    return {k: split(v) for k, v in batch.items()}


def _accumulated_grads(loss_fn: Callable[[Batch], Tuple[torch.Tensor,
                                                        Metrics]],
                       batch: Batch, accum_steps: int) -> Metrics:
    """Back-propagate ``loss_fn`` into ``.grad``. With ``accum_steps > 1``
    over each microbatch of ``batch`` in turn (one live microbatch of
    activations at a time), each weighted ``1/accum_steps``: the gradients
    and the returned metrics are the microbatch means, the JAX package's
    accumulation convention."""
    if accum_steps == 1:
        loss, metrics = loss_fn(batch)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}
    sums: Optional[Metrics] = None
    for i in range(accum_steps):
        loss, m = loss_fn({k: v[i] for k, v in batch.items()})
        (loss / accum_steps).backward()
        m = {k: v.detach() for k, v in m.items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    return {k: v / accum_steps for k, v in sums.items()}


# ---------------------------------------------------------------------------
# Stage 1: encoder + duration head
# ---------------------------------------------------------------------------


def duration_loss(params: nn.Module, batch: Batch, cfg: IrisConfig,
                  deterministic: bool = False,
                  generator: Optional[torch.Generator] = None):
    """Huber duration loss of ``params`` (``encoder`` + ``duration``)."""
    enc = params["encoder"](batch["phoneme_ids"],
                            padding_mask=batch["phoneme_mask"],
                            deterministic=deterministic, generator=generator)
    pred = params["duration"](enc, deterministic=deterministic,
                              generator=generator)
    loss = duration_huber_loss(pred, batch["durations"],
                               batch["phoneme_mask"],
                               delta=cfg.train.duration_huber_delta)
    return loss, {"duration_loss": loss}


def make_duration_train_step(cfg: IrisConfig, accum_steps: int = 1,
                             compute_dtype: DtypeLike = None):
    dt = resolve_dtype(compute_dtype)

    def step(state: TrainState, batch: Batch):
        with computing((state.params, state.frozen), dt):
            metrics = _accumulated_grads(
                lambda b: duration_loss(state.params, b, cfg, False,
                                        state.generator),
                batch, accum_steps)
        return state.apply_gradients(), metrics

    return step


def make_duration_eval_step(cfg: IrisConfig):
    @torch.no_grad()
    def step(params: nn.Module, batch: Batch) -> Metrics:
        with computing([params], torch.float32):
            enc = params["encoder"](batch["phoneme_ids"],
                                    padding_mask=batch["phoneme_mask"])
            pred = params["duration"](enc)
        mask = batch["phoneme_mask"]
        loss = duration_huber_loss(pred, batch["durations"], mask,
                                   delta=cfg.train.duration_huber_delta)
        lin = torch.exp(pred) - 1.0
        mae = torch.sum((lin - batch["durations"]).abs() * mask) / (
            torch.sum(mask) + 1e-8)
        return {"duration_loss": loss, "duration_mae_frames": mae}

    return step


# ---------------------------------------------------------------------------
# Stage 2: VAE with frozen encoder
# ---------------------------------------------------------------------------


@torch.no_grad()
def _frame_condition(encoder: nn.Module, batch: Batch):
    """Frame conditioning from the frozen encoder and length regulation:
    (cond [B, T, E], frame_mask [B, T])."""
    enc = encoder(batch["phoneme_ids"], padding_mask=batch["phoneme_mask"])
    durations = (batch["durations"].to(torch.int32)
                 * batch["phoneme_mask"].to(torch.int32))
    return length_regulate(enc, durations, batch["mel"].shape[1])


def vae_stage_loss(vae: nn.Module, frozen: nn.ModuleDict, batch: Batch,
                   kl_weight, cfg: IrisConfig, deterministic: bool = False,
                   generator: Optional[torch.Generator] = None):
    """L1 + kl_weight·KL of ``vae`` on ``batch`` (the KL against the flow
    prior in ``flow_prior`` mode)."""
    cond, frame_mask = _frame_condition(frozen["encoder"], batch)
    flow_prior = cfg.vae.flow_prior
    out = vae(batch["mel"], cond, deterministic=deterministic,
              return_u=flow_prior, generator=generator)
    recon, (mean, logvar) = out[0], out[1]
    return vae_loss(batch["mel"], recon, mean, logvar, frame_mask,
                    cfg.vae.down_factor, kl_weight,
                    u=out[3] if flow_prior else None)


def make_vae_train_step(cfg: IrisConfig, accum_steps: int = 1,
                        compute_dtype: DtypeLike = None, remat: bool = False):
    dt = resolve_dtype(compute_dtype)

    def step(state: TrainState, batch: Batch, kl_weight):
        with computing((state.params, state.frozen), dt, remat=remat):
            metrics = _accumulated_grads(
                lambda b: vae_stage_loss(state.params, state.frozen, b,
                                         kl_weight, cfg, False,
                                         state.generator),
                batch, accum_steps)
        return state.apply_gradients(), metrics

    return step


def make_vae_recon_step(cfg: IrisConfig):
    """Deterministic reconstruction (posterior mean): (params, frozen,
    batch) → (recon [B, T, n_mels], frame_mask [B, T])."""
    @torch.no_grad()
    def step(params: nn.Module, frozen: nn.ModuleDict, batch: Batch):
        with computing([params, frozen], torch.float32):
            cond, frame_mask = _frame_condition(frozen["encoder"], batch)
            return params(batch["mel"], cond)[0], frame_mask

    return step


def make_vae_eval_step(cfg: IrisConfig):
    @torch.no_grad()
    def step(params: nn.Module, frozen: nn.ModuleDict, batch: Batch,
             kl_weight) -> Metrics:
        with computing([params, frozen], torch.float32):
            return vae_stage_loss(params, frozen, batch, kl_weight, cfg,
                                  deterministic=True)[1]

    return step


# ---------------------------------------------------------------------------
# Stage 3: PostNet over the frozen encoder and VAE
# ---------------------------------------------------------------------------


def postnet_stage_loss(postnet: nn.Module, frozen: nn.ModuleDict,
                       batch: Batch, deterministic: bool = False,
                       generator: Optional[torch.Generator] = None):
    """Masked L1 of the PostNet refining the frozen VAE's reconstruction
    (posterior mean). The PostNet runs in batch-statistics mode, so this
    also updates its running statistics."""
    cond, frame_mask = _frame_condition(frozen["encoder"], batch)
    with torch.no_grad():
        recon = frozen["vae"](batch["mel"], cond)[0]
    refined = postnet(recon, deterministic=deterministic,
                      use_running_average=False, generator=generator)
    loss = masked_l1_loss(batch["mel"], refined, frame_mask)
    return loss, {"postnet_l1": loss}


def make_postnet_train_step(cfg: IrisConfig,
                            compute_dtype: DtypeLike = None):
    del cfg  # the PostNet's config lives in its module
    dt = resolve_dtype(compute_dtype)

    def step(state: TrainState, batch: Batch):
        with computing((state.params, state.frozen), dt):
            metrics = _accumulated_grads(
                lambda b: postnet_stage_loss(state.params, state.frozen, b,
                                             False, state.generator),
                batch, 1)
        return state.apply_gradients(), metrics

    return step
