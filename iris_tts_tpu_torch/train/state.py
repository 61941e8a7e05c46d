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

Data parallelism: :meth:`TrainState.place_on` replicates a state over a
mesh of processes (``parallel/mesh.py``), every rank then holding the same
parameters and generator state, and ``apply_gradients`` sums the gradients
over the data axis in one flat all-reduce before clipping, so every rank
applies the same update. A parameter without a gradient counts as zeros, so
the flat buffer has one layout on every rank.

The model axis: on a mesh whose model axis is wider than one rank,
``place_on`` also shards the params, the frozen companions and the EMA by
JAX's rule (``parallel.sharding.tp_param_sharding``). A sharded parameter
is this rank's slice, so its Adam moments and its EMA are slices too. The
gradient sum over the data axis runs over the data sub-group (the ranks of
this rank's model coordinate, which hold the same slices), and the global
norm for clipping sums the squares of the sharded gradients over the model
group and counts each whole one once: every rank of a model group holds the
whole gradient of an unsharded parameter, equal on each (the column
layers add a whole bias after their gather, so no rank uses one in part).
``state_dict`` and ``load_state_dict`` read and write whole tensors
(params, moments, frozen companions, EMA), so a checkpoint moves between a
model axis and one process either way.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from iris_tts_tpu_torch.parallel.mesh import (
    COLLECTIVES,
    all_reduce_flat_,
    broadcast_flat_,
    local_only,
)
from iris_tts_tpu_torch.parallel.sharding import (
    full_state_dict,
    load_full_state_dict,
    local,
    sharded_params,
    tp_param_sharding,
    whole,
)
from iris_tts_tpu_torch.parallel.tp import ModelAxis, model_axis

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
def clip_by_global_norm_(grads, max_norm: float,
                         sharded: Optional[Sequence[bool]] = None,
                         axis: Optional[ModelAxis] = None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place: when the global norm is at
    least ``max_norm`` every gradient becomes ``g / ‖g‖ · max_norm``. Stays
    on the device (no host sync). Returns the norm before clipping. On a
    model ``axis`` the gradients flagged ``sharded`` are this rank's
    slices: their squares are summed over the axis, the others' counted
    once."""
    if axis is None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    else:
        parts = torch.zeros(2, dtype=torch.float32, device=grads[0].device)
        for g, split in zip(grads, sharded):
            parts[0 if split else 1] += torch.sum(g.float() * g.float())
        part = parts[:1].clone()
        COLLECTIVES[("grad_norm", "all_reduce", axis.backend)] += 1
        dist.all_reduce(part, group=axis.group)
        norm = torch.sqrt(part[0] + parts[1])
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
    # The data-parallel mesh of place_on (None: one process).
    mesh: Any = None

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

    def place_on(self, mesh) -> "TrainState":
        """Replicate the state over ``mesh`` from world rank 0 (params,
        their buffers, the frozen companions, the EMA average and the
        generator state), shard it on a model axis (moments already held
        are sliced with their params), and reduce its gradients over the
        data axis from now on. The state must already be on the mesh's
        device."""
        if self.generator.device != mesh.device:
            raise ValueError(f"the train state is on {self.generator.device}"
                             f", the mesh rank on {mesh.device}")
        for m in (self.params, self.frozen, self.ema_params):
            if m is not None:
                tp_param_sharding(m, mesh)
        for key, (layer, name) in sharded_params(self.params).items():
            st = self.optimizer.state.get(getattr(layer, name), {})
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim():
                    st[k] = local(self.params, key, v)
        if not local_only(mesh):
            rng = self.generator.get_state().to(mesh.device)
            broadcast_flat_([rng], mesh.world_group, mesh.backend,
                            "replicate")
            self.generator.set_state(rng.cpu())
        self.mesh = mesh
        return self

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
        all_reduce_flat_([p.grad for p in params], self.mesh, "gradients")
        if self.tx.clip_norm:
            axis = model_axis(self.mesh)
            split = None
            if axis is not None:
                ids = {id(getattr(layer, name)) for layer, name in
                       sharded_params(self.params).values()}
                split = [id(p) in ids for p in params]
            clip_by_global_norm_([p.grad for p in params], self.tx.clip_norm,
                                 split, axis)
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

    def _opt_state_dict(self, whole_tensors: bool) -> dict:
        """The optimizer's state dict, each sharded parameter's moments
        whole (``whole_tensors``) or sliced to this rank."""
        sd = self.optimizer.state_dict()
        sharded = sharded_params(self.params)
        if not sharded:
            return sd
        order = [p for g in self.optimizer.param_groups for p in g["params"]]
        key_of = {id(getattr(layer, name)): key
                  for key, (layer, name) in sharded.items()}
        fix = whole if whole_tensors else local
        state = {}
        for idx, st in sd["state"].items():
            key = key_of.get(id(order[idx]))
            state[idx] = st if key is None else {
                k: fix(self.params, key, v)
                if torch.is_tensor(v) and v.dim() else v
                for k, v in st.items()}
        return {**sd, "state": state}

    def state_dict(self) -> dict:
        """The whole state (sharded leaves gathered: on a model axis every
        rank calls it)."""
        return {
            "step": self.step,
            "epoch": self.epoch,
            "params": full_state_dict(self.params),
            "opt_state": self._opt_state_dict(True),
            "rng": self.generator.get_state(),
            "frozen": (full_state_dict(self.frozen)
                       if self.frozen is not None else None),
            "ema_params": (full_state_dict(self.ema_params)
                           if self.ema_params is not None else None),
            "ema_decay": self.ema_decay,
        }

    def load_state_dict(self, sd: dict) -> "TrainState":
        """Restore in place (bit-exact) from whole tensors. Raises if the
        checkpoint and this state disagree on whether an EMA is tracked."""
        if bool(sd["ema_decay"]) != bool(self.ema_decay):
            raise ValueError(
                f"checkpoint trained with ema_decay={sd['ema_decay']} but "
                f"this state has ema_decay={self.ema_decay}: pass the "
                "matching ema_decay (a mismatched state would silently drop "
                "the saved EMA average)")
        load_full_state_dict(self.params, sd["params"])
        self.optimizer.load_state_dict(sd["opt_state"])
        if sharded_params(self.params):
            self.optimizer.load_state_dict(self._opt_state_dict(False))
        self.generator.set_state(sd["rng"].cpu())
        if self.frozen is not None:
            load_full_state_dict(self.frozen, sd["frozen"])
        if self.ema_params is not None:
            load_full_state_dict(self.ema_params, sd["ema_params"])
        self.step, self.epoch = int(sd["step"]), int(sd["epoch"])
        return self
