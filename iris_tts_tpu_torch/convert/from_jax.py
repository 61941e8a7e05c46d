"""Carry the JAX pipeline's weights across to the port.

:func:`state_dict_from_jax` takes the JAX ``TTSPipeline.params`` tree with
numpy leaves (``encoder``, ``duration``, ``vae``, ``postnet`` with
``params`` and ``batch_stats``, ``hifigan``) and returns the state dict of
:class:`~iris_tts_tpu_torch.models.pipeline.SynthesisModel`;
:func:`module_state_from_jax` does the same for one module's tree (e.g. the
discriminators), and :func:`load_train_state_from_jax` fills a port train
state from the pieces of a JAX one. They take numpy only: turning JAX
arrays into numpy (``jax.tree_util.tree_map(np.asarray, params)``) is the
caller's business, so this package never imports JAX.

The port names its submodules after the flax modules, so a flax path maps
to a state-dict key by joining with dots; only the leaf and its layout
change:

=====================  ==============================  ==================
flax leaf              where                            torch
=====================  ==============================  ==================
``kernel`` [in, out]   Dense                            ``weight`` = kernel.T
``kernel`` [K,Ci,Co]   Conv1d                           ``weight`` [Co,Ci,K]
``kernel`` [K,Ci,Co]   HiFiGAN ``ups_i`` (transposed)   ``weight`` [Ci,Co,K],
                                                        no flip
``kernel`` [kh,kw,Ci,Co]  MPD Conv2d                    ``weight``
                                                        [Co,Ci,kh,kw]
``kernel`` [E,H,D]     attention query/key/value        [H·D, E]
                       (any of ``ATTENTION_NAMES``)
``kernel`` [H,D,E]     attention out                    [E, H·D]
``bias`` [H, D]        attention query/key/value        [H·D]
``scale``              LayerNorm / BatchNorm            ``weight``
``embedding``          Embed                            ``weight``
``mean`` / ``var``     PostNet ``batch_stats``          ``running_mean`` /
                                                        ``running_var``
=====================  ==============================  ==================
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_QKV = ("query", "key", "value")
# flax attention modules by name: the encoders' ``attention``, the G2P
# decoder's ``self_attention`` and ``cross_attention``.
ATTENTION_NAMES = ("attention", "self_attention", "cross_attention")


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if hasattr(tree, "items"):  # dict or flax FrozenDict
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _convert_leaf(path: Tuple[str, ...], value: np.ndarray
                  ) -> Tuple[str, np.ndarray]:
    """(module path, flax leaf) → (torch key, torch-layout array)."""
    *mod, leaf = path
    parent = mod[-1] if mod else ""
    in_attention = len(mod) >= 2 and mod[-2] in ATTENTION_NAMES
    if isinstance(value, torch.Tensor):  # a bfloat16 leaf of convert/orbax
        value = value.float().numpy()
    a = np.asarray(value)
    if leaf == "kernel":
        name = "weight"
        if in_attention and parent in _QKV and a.ndim == 3:
            a = a.reshape(a.shape[0], -1).T
        elif in_attention and parent == "out" and a.ndim == 3:
            a = a.reshape(-1, a.shape[-1]).T
        elif a.ndim == 2:
            a = a.T
        elif a.ndim == 3 and parent.startswith("ups_"):
            a = a.transpose(1, 2, 0)
        elif a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel {'/'.join(path)} {a.shape}")
    elif leaf == "bias":
        name = "bias"
        if in_attention and parent in _QKV and a.ndim == 2:
            a = a.reshape(-1)
        elif a.ndim != 1:
            raise ValueError(f"unexpected bias {'/'.join(path)} {a.shape}")
    elif leaf in ("scale", "embedding"):
        name = "weight"
    elif leaf == "mean":
        name = "running_mean"
    elif leaf == "var":
        name = "running_var"
    else:
        raise ValueError(f"unconsumed JAX leaf {'/'.join(path)}")
    return ".".join(mod + [name]), np.ascontiguousarray(a)


def _convert_trees(trees) -> Dict[str, torch.Tensor]:
    """[(path prefix, numpy tree)] → torch state dict; raises on a leaf it
    cannot place or on two leaves mapping to one key. BatchNorm's
    ``num_batches_tracked`` has no flax counterpart and is set to 0."""
    out: Dict[str, torch.Tensor] = {}
    for prefix, tree in trees:
        for path, value in _leaves(tree, prefix):
            key, arr = _convert_leaf(path, value)
            if key in out:
                raise ValueError(f"two JAX leaves map to {key}")
            out[key] = torch.from_numpy(arr.astype(np.float32))
    for key in [k for k in out if k.endswith(".running_var")]:
        out[key[: -len("running_var")] + "num_batches_tracked"] = (
            torch.zeros((), dtype=torch.long))
    return out


def _check_covers(out: Dict[str, torch.Tensor], module: nn.Module) -> None:
    want = module.state_dict()
    missing = sorted(set(want) - set(out))
    unknown = sorted(set(out) - set(want))
    if missing or unknown:
        raise ValueError(
            f"JAX params do not cover the torch module: missing "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}, unknown "
            f"{unknown[:8]}{'...' if len(unknown) > 8 else ''}"
        )
    bad = [(k, tuple(out[k].shape), tuple(v.shape))
           for k, v in want.items() if out[k].shape != v.shape]
    if bad:
        raise ValueError(f"shape mismatch (key, jax, torch): {bad[:8]}")


def state_dict_from_jax(
    params: Dict[str, Any], module: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """JAX pipeline params (numpy leaves) → torch state dict.

    Raises on any leaf it cannot place. With ``module`` given it also
    raises on any key of ``module.state_dict()`` left unset, any key the
    module does not have, and any shape mismatch.
    """
    trees = []
    for top, sub in params.items():
        if top == "postnet":
            trees += [(("postnet",), sub["params"]),
                      (("postnet",), sub["batch_stats"])]
            extra = set(sub) - {"params", "batch_stats"}
            if extra:
                raise ValueError(f"unconsumed JAX postnet entries {extra}")
        else:
            trees.append(((top,), sub))
    out = _convert_trees(trees)
    if module is not None:
        _check_covers(out, module)
    return out


def module_state_from_jax(
    params: Any, batch_stats: Any = None, module: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """One flax module's ``params`` tree (and ``batch_stats``), numpy
    leaves → the state dict of its port module, e.g. the discriminators'
    or a train stage's. Checks against ``module`` as
    :func:`state_dict_from_jax` does."""
    trees = [((), params)]
    if batch_stats is not None:
        trees.append(((), batch_stats))
    out = _convert_trees(trees)
    if module is not None:
        _check_covers(out, module)
    return out


def load_train_state_from_jax(
    state,
    params: Any,
    batch_stats: Any = None,
    frozen: Optional[Mapping[str, Any]] = None,
    step: int = 0,
    epoch: int = 0,
):
    """Fill a port ``TrainState`` (built for the same stage and config) from
    the numpy pieces of a JAX one: ``params`` (and the PostNet's
    ``batch_stats``) into ``state.params``, each ``frozen`` companion into
    ``state.frozen[name]``, and the step and epoch counters. The optimizer
    state and the generator stay as ``state`` has them (fresh for a new
    state): optax and torch share no format for them."""
    state.params.load_state_dict(
        module_state_from_jax(params, batch_stats, state.params),
        strict=True)
    for name, tree in (frozen or {}).items():
        target = state.frozen[name]
        target.load_state_dict(module_state_from_jax(tree, module=target),
                               strict=True)
    state.step, state.epoch = int(step), int(epoch)
    return state
