"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Each parity test builds the JAX module, carries its weights into the port
with ``state_dict_from_jax``, runs both on the same numpy inputs on the
CPU, and compares.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

import iris_tts_tpu.config as jcfg
import iris_tts_tpu_torch.config as tcfg
from iris_tts_tpu_torch.convert.from_jax import state_dict_from_jax


def small_config(cfg_module=jcfg):
    """A few layers and narrow widths; HiFiGAN keeps the rates (8, 8, 2, 2)
    so hop stays 256, and n_mels stays 80 so a log-mel vocodes."""
    m = cfg_module
    return m.IrisConfig(
        encoder=m.EncoderConfig(embed_dim=32, num_blocks=2, num_heads=2),
        duration=m.DurationConfig(hidden_dim=16, num_layers=2),
        vae=m.VAEConfig(cond_dim=32, model_channels=16, latent_dim=4,
                        num_wavenet_blocks=2, decoder_blocks=1,
                        flow_layers=2, flow_hidden=8),
        postnet=m.PostNetConfig(num_layers=3, channels=8),
        hifigan=m.HiFiGANConfig(upsample_initial_channel=32,
                                resblock_kernel_sizes=(3, 7),
                                resblock_dilations=((1, 3), (1, 3))),
    )


def port_config(jax_config):
    """The same config as the port's dataclasses (via the JSON round-trip
    both packages share)."""
    return tcfg.config_from_json(jcfg.config_to_json(jax_config))


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def load_port_module(module: torch.nn.Module, name: str, jax_params):
    """Load one JAX module's params (``{"params": ...}`` contents, or the
    ``{"params", "batch_stats"}`` pair for the PostNet) into ``module``."""
    sd = state_dict_from_jax({name: numpy_tree(jax_params)})
    prefix = name + "."
    module.load_state_dict(
        {k[len(prefix):]: v for k, v in sd.items()}, strict=True
    )
    return module.eval()


def max_abs(a, b) -> float:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def jax_params_from_port(template, state_dict):
    """The inverse of ``state_dict_from_jax``: the port's tensors laid out
    as the JAX ``TTSPipeline.params`` tree ``template`` (numpy leaves). Each
    leaf's layout change is read off the converter itself, by converting an
    array of flat indices."""
    from iris_tts_tpu_torch.convert.from_jax import _convert_leaf

    def leaf(path, value):
        shape = np.shape(value)
        key, perm = _convert_leaf(path, np.arange(np.size(value)).reshape(
            shape))
        out = np.empty(np.size(value), np.float32)
        out[perm.ravel()] = state_dict[key].detach().cpu().numpy().ravel()
        return out.reshape(shape)

    def tree(t, path):
        return {k: tree(v, path + (k,)) if hasattr(v, "items")
                else leaf(path + (k,), v) for k, v in t.items()}

    return {top: ({part: tree(sub[part], (top,)) for part in sub}
                  if top == "postnet" else tree(sub, (top,)))
            for top, sub in template.items()}
