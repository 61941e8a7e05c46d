"""Train state: params + optimizer + RNG + step in one checkpointable object.

Counterpart of the JAX package's ``train/state.py``. The JAX state is an
immutable pytree updated by ``apply_gradients``; here the parameters live in
an ``nn.Module`` and ``apply_gradients`` updates it in place from the
gradients in ``.grad``, with optax's semantics:

* global-norm clipping scales by ``c / ‖g‖`` only when ``‖g‖ ≥ c``
  (``optax.clip_by_global_norm``; ``clip_grad_norm_`` would scale by
  ``c / (‖g‖ + 1e-6)`` always);
* Adam (or AdamW with decoupled weight decay on every parameter) with eps
  outside the square root, at the learning rate of the update count
  *before* the update, as optax's schedules read it;
* a parameter without a gradient is updated with a zero gradient, as
  ``jax.grad`` gives one;
* the EMA of the parameters is updated after the optimizer step.

Each state owns one ``torch.Generator`` on its device; dropout masks and the
VAE's noise come from it, and checkpoints carry its state, so a resumed run
draws the same noise as an uninterrupted one.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn

LearningRate = Union[float, Callable[[int], float]]


@dataclass(frozen=True)
class Tx:
    """The optimizer recipe (what the JAX package builds as
    ``optax.chain(clip_by_global_norm, adam | adamw)``)."""

    learning_rate: LearningRate
    clip_norm: Optional[float] = 1.0
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999

    def lr(self, count: int) -> float:
        """Learning rate of the update made at ``count`` prior updates."""
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(self.learning_rate)

    def build(self, params) -> torch.optim.Optimizer:
        cls = torch.optim.AdamW if self.weight_decay else torch.optim.Adam
        return cls(params, lr=self.lr(0), betas=(self.b1, self.b2),
                   eps=1e-8, weight_decay=self.weight_decay)


def adam_clipped(
    learning_rate: LearningRate,
    clip_norm: Optional[float] = 1.0,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
) -> Tx:
    """Adam with global-norm clipping — the optimizer of every stage
    (HiFi-GAN's sides use b1=0.8, b2=0.99)."""
    return Tx(learning_rate, clip_norm, weight_decay, b1, b2)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: when the global norm is at
    least ``max_norm`` every gradient becomes ``g / ‖g‖ · max_norm``. Stays
    on the device (no host sync). Returns the norm before clipping."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def _frozen(modules: Optional[Dict[str, nn.Module]]
            ) -> Optional[nn.ModuleDict]:
    if modules is None:
        return None
    frozen = nn.ModuleDict(modules)
    for p in frozen.parameters():
        p.requires_grad_(False)
    return frozen


@dataclass(eq=False)
class TrainState:
    """Train state of any stage (encoder+duration / VAE / PostNet / GAN
    generator or discriminator).

    ``params``: the trained module (its BatchNorm buffers are the JAX
    ``batch_stats``). ``frozen``: companion modules the stage reads but does
    not train (e.g. the trained encoder during VAE training). ``epoch``:
    completed epochs, advanced by the training loop."""

    params: nn.Module
    tx: Tx
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    epoch: int = 0
    frozen: Optional[nn.ModuleDict] = None
    ema_params: Optional[nn.Module] = None
    ema_decay: float = 0.0

    @classmethod
    def create(
        cls,
        params: nn.Module,
        tx: Tx,
        seed: int,
        frozen: Optional[Dict[str, nn.Module]] = None,
        ema_decay: Optional[float] = None,
    ) -> "TrainState":
        """A fresh state on the device of ``params``. ``ema_decay`` (e.g.
        0.999) enables EMA tracking, seeded with a copy of ``params``."""
        device = next(params.parameters()).device
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
        ema = None
        if ema_decay:
            ema = copy.deepcopy(params)
            for p in ema.parameters():
                p.requires_grad_(False)
        return cls(params=params, tx=tx,
                   optimizer=tx.build(params.parameters()),
                   generator=generator, frozen=_frozen(frozen),
                   ema_params=ema, ema_decay=float(ema_decay or 0.0))

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The running statistics of the BatchNorm layers (empty if none)."""
        return {k: v for k, v in self.params.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    @property
    def serving_params(self) -> nn.Module:
        """What inference should load: the EMA average when tracked, the raw
        params otherwise."""
        return self.ema_params if self.ema_params is not None else self.params

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the gradients in ``.grad``; clears
        them and advances ``step``."""
        params = [p for p in self.params.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.tx.clip_norm:
            clip_by_global_norm_([p.grad for p in params], self.tx.clip_norm)
        lr = self.tx.lr(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema_params.parameters(),
                                self.params.parameters()):
                    e.mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1
        return self

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "epoch": self.epoch,
            "params": self.params.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "rng": self.generator.get_state(),
            "frozen": (self.frozen.state_dict()
                       if self.frozen is not None else None),
            "ema_params": (self.ema_params.state_dict()
                           if self.ema_params is not None else None),
            "ema_decay": self.ema_decay,
        }

    def load_state_dict(self, sd: dict) -> "TrainState":
        """Restore in place (bit-exact). Raises if the checkpoint and this
        state disagree on whether an EMA is tracked."""
        if bool(sd["ema_decay"]) != bool(self.ema_decay):
            raise ValueError(
                f"checkpoint trained with ema_decay={sd['ema_decay']} but "
                f"this state has ema_decay={self.ema_decay}: pass the "
                "matching ema_decay (a mismatched state would silently drop "
                "the saved EMA average)")
        self.params.load_state_dict(sd["params"])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.generator.set_state(sd["rng"].cpu())
        if self.frozen is not None:
            self.frozen.load_state_dict(sd["frozen"])
        if self.ema_params is not None:
            self.ema_params.load_state_dict(sd["ema_params"])
        self.step, self.epoch = int(sd["step"]), int(sd["epoch"])
        return self
