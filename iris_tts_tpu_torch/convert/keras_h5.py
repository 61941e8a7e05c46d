"""Import the reference's Keras ``.weights.h5`` checkpoints into the port.

The port's counterpart of the JAX package's ``convert/keras_h5.py``. The
reference trains each stage as a Keras 3 model and persists
``save_weights(...)`` HDF5 files; this module reads that layout directly
(``h5py``, imported only inside :func:`read_weights_h5`; no keras) and
returns the state dict of the matching port module. Each converter lays
the file out as the JAX module's flax ``params`` tree first, exactly as
the JAX converter does, then carries it across with
``convert.from_jax.module_state_from_jax``.

HDF5 layout contract (the JAX package's, pinned there against the
reference classes):

* Keras 3 ``save_weights`` walks model attributes in sorted order and
  saves each sublayer at the first path that reaches it. Attributes
  sorting before the built-in ``layers`` property keep their attribute
  name (``/final_norm``, ``/conv_out``, ``/in_proj``, ...); everything
  else lands under ``/layers/<snake_case_class_name>{_i}`` where the
  counter replays sublayer **creation order** per class — e.g. the
  reference VAE's ``out_proj`` is always ``/layers/conv1d_2`` because
  exactly two Conv1D direct children (in_proj, down_cond_proj) precede it.
* Each layer's variables live at ``<group>/vars/{0,1,...}`` in
  ``layer.weights`` order: Dense/Conv (kernel, bias), LayerNormalization
  (gamma, beta), BatchNormalization (gamma, beta, moving_mean,
  moving_var), Embedding (embeddings,).

Weight layouts: Keras Conv1D kernels are [k, C_in, C_out] and Dense
[in, out], as flax's, copied as they are. Keras Conv1DTranspose is
[k, C_out, C_in] and transposes to flax's [k, C_in, C_out]. The
reference's attention projections are Dense ``[E, E]`` kernels; the flax
module's are ``[E, H, D]``: ``from_jax`` lays either out as the same torch
weight.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np
import torch

from iris_tts_tpu_torch.convert.from_jax import module_state_from_jax

__all__ = [
    "read_weights_h5",
    "convert_encoder",
    "convert_duration",
    "convert_postnet",
    "convert_vae",
    "convert_keras_vocoder",
    "load_keras_stage_weights",
]

StateDict = Dict[str, torch.Tensor]


def read_weights_h5(path: str | Path) -> Dict[str, List[np.ndarray]]:
    """Flatten a ``.weights.h5`` into {layer group path: [vars in order]}.

    Paths are '/'-joined group names without the trailing ``/vars/N``.
    """
    import h5py

    out: Dict[str, List[np.ndarray]] = {}

    def visit(group, prefix):
        for key in group:
            node = group[key]
            p = f"{prefix}/{key}"
            if isinstance(node, h5py.Group):
                if key == "vars":
                    arrs = [
                        np.asarray(node[str(i)]) for i in range(len(node))
                    ]
                    if arrs:
                        out[prefix] = arrs
                else:
                    visit(node, p)

    with h5py.File(path, "r") as f:
        visit(f, "")
    return out


def _sfx(i: int) -> str:
    """Keras duplicate-name suffix: '', '_1', '_2', ..."""
    return "" if i == 0 else f"_{i}"


def _get(w: Mapping[str, List[np.ndarray]], path: str) -> List[np.ndarray]:
    if path not in w:
        close = [k for k in w if k.rsplit("/", 1)[-1] == path.rsplit("/", 1)[-1]]
        raise KeyError(
            f"layer {path!r} not found in checkpoint; similar keys: {close}"
        )
    return w[path]


def _dense(w, path) -> Dict[str, np.ndarray]:
    kernel, bias = _get(w, path)
    return {"kernel": kernel, "bias": bias}


def _norm(w, path) -> Dict[str, np.ndarray]:
    gamma, beta = _get(w, path)
    return {"scale": gamma, "bias": beta}


def _encoder_tree(
    w: Mapping[str, List[np.ndarray]], num_blocks: int
) -> Dict:
    """Reference PhonemeEncoder ``.weights.h5`` → the JAX PhonemeEncoder's
    flax params tree. Reference class: encoder.py:115-225."""
    params: Dict = {
        "phoneme_embedding": {"embedding": _get(w, "/layers/embedding")[0]},
        "position_embedding": {
            "embedding": _get(
                w, "/layers/positional_embedding/position_embedding"
            )[0]
        },
        "output_norm": _norm(w, "/final_norm"),
    }
    for i in range(num_blocks):
        blk = f"/layers/transformer_block{_sfx(i)}"
        att = {}
        for ours, theirs in (
            ("query", "query_dense"),
            ("key", "key_dense"),
            ("value", "value_dense"),
            ("out", "output_dense"),
        ):
            att[ours] = _dense(w, f"{blk}/attention/{theirs}")
        params[f"block_{i}"] = {
            "attention": att,
            "attn_norm": _norm(w, f"{blk}/attention_norm"),
            "ffn_in": _dense(w, f"{blk}/ffn/layers/dense"),
            "ffn_out": _dense(w, f"{blk}/ffn/layers/dense_1"),
            "ffn_norm": _norm(w, f"{blk}/ffn_norm"),
        }
    return params


def _duration_tree(
    w: Mapping[str, List[np.ndarray]], num_layers: int
) -> Dict:
    """Reference DurationPredictor → the JAX module's flax params tree.
    Reference class: encoder.py:228-326 (convs in ``conv_layers``, norms
    reached via the ``layers`` property, output conv = the
    ``num_layers``-th Conv1D created)."""
    params: Dict = {}
    for i in range(num_layers):
        params[f"conv_{i}"] = _dense(w, f"/conv_layers/conv1d{_sfx(i)}")
        params[f"norm_{i}"] = _norm(
            w, f"/layers/layer_normalization{_sfx(i)}"
        )
    params["output_proj"] = _dense(w, f"/layers/conv1d{_sfx(num_layers)}")
    return params


def _postnet_tree(w: Mapping[str, List[np.ndarray]], num_layers: int) -> Dict:
    """Reference PostNet → the JAX PostNet's {params, batch_stats}.
    Reference class: postnet.py:8-80; keras BatchNormalization vars are
    (gamma, beta, moving_mean, moving_variance)."""
    params: Dict = {}
    stats: Dict = {}

    def bn(path, name):
        gamma, beta, mean, var = _get(w, path)
        params[name] = {"scale": gamma, "bias": beta}
        stats[name] = {"mean": mean, "var": var}

    for i in range(num_layers - 1):
        params[f"conv_{i}"] = _dense(w, f"/convs/conv1d{_sfx(i)}")
        bn(f"/bns/batch_normalization{_sfx(i)}", f"bn_{i}")
    params["conv_out"] = _dense(w, "/conv_out")
    bn("/bn_out", "bn_out")
    return {"params": params, "batch_stats": stats}


def _wavenet_block(w, path) -> Dict:
    return {
        "conv": _dense(w, f"{path}/conv"),
        "film": {"proj": _dense(w, f"{path}/film/proj")},
        "res_proj": _dense(w, f"{path}/res_proj"),
    }


def _vae_tree(
    w: Mapping[str, List[np.ndarray]],
    num_wavenet_blocks: int,
    decoder_blocks: int,
    down_stages: int,
    flow_layers: int,
) -> Dict:
    """Reference TextConditionedVAE → the JAX module's flax params tree.
    Reference class: vae.py:255-352. ``out_proj`` / ``residual_proj`` are
    reached through the ``layers`` property as the 3rd Conv1D / 4th Dense
    created (see module docstring)."""
    params: Dict = {
        "in_proj": _dense(w, "/in_proj"),
        "down_cond_proj": _dense(w, "/down_cond_proj"),
        "latent_mean_proj": _dense(w, "/latent_mean_proj"),
        "latent_logvar_proj": _dense(w, "/latent_logvar_proj"),
        "latent_dec_proj": _dense(w, "/latent_dec_proj"),
        "out_proj": _dense(w, "/layers/conv1d_2"),
        "residual_proj": _dense(w, "/layers/dense_3"),
    }
    for i in range(num_wavenet_blocks):
        params[f"enc_block_{i}"] = _wavenet_block(
            w, f"/enc_blocks/wave_net_res_block{_sfx(i)}"
        )
    for i in range(decoder_blocks):
        params[f"dec_block_{i}"] = _wavenet_block(
            w, f"/dec_blocks/wave_net_res_block{_sfx(i)}"
        )
    params["downsample"] = {
        f"conv_{i}": _dense(w, f"/downsample/blocks/conv1d{_sfx(i)}")
        for i in range(down_stages)
    }
    params["upsample"] = {
        f"conv_{i}": _dense(
            w, f"/layers/temporal_upsample/refine/conv1d{_sfx(i)}"
        )
        for i in range(down_stages)
    }
    params["vpflow"] = {
        f"ap_{i}": {
            "cond_proj": _dense(
                w, f"/flow/layers_list/ap_coupling{_sfx(i)}/cond_proj"
            ),
            "film": {
                "proj": _dense(
                    w, f"/flow/layers_list/ap_coupling{_sfx(i)}/film/proj"
                )
            },
            "net_pre": _dense(
                w, f"/flow/layers_list/ap_coupling{_sfx(i)}/net_pre"
            ),
            "net_post": _dense(
                w, f"/flow/layers_list/ap_coupling{_sfx(i)}/net_post"
            ),
        }
        for i in range(flow_layers)
    }
    return params


def _conv_transpose(w, path) -> Dict[str, np.ndarray]:
    kernel, bias = _get(w, path)
    # keras Conv1DTranspose kernel [k, C_out, C_in] → flax [k, C_in, C_out]
    return {"kernel": np.transpose(kernel, (0, 2, 1)), "bias": bias}


def _keras_vocoder_tree(
    w: Mapping[str, List[np.ndarray]],
    upsample_rates,
    resblock_kernel_sizes,
    resblock_dilations,
) -> Dict:
    """Reference Keras HiFiGANGenerator (vocoder.py:52-142, the trainable
    one) → the JAX HiFiGANGenerator's flax params tree."""
    params: Dict = {
        "conv_pre": _dense(w, "/conv_pre"),
        "conv_post": _dense(w, "/conv_post"),
    }
    nk = len(resblock_kernel_sizes)
    for i in range(len(upsample_rates)):
        params[f"ups_{i}"] = _conv_transpose(
            w, f"/layers/conv1d_transpose{_sfx(i)}"
        )
        for j in range(nk):
            rb = f"/layers/res_block{_sfx(i * nk + j)}"
            tree: Dict = {}
            for p in range(len(resblock_dilations[j])):
                tree[f"convs1_{p}"] = _dense(w, f"{rb}/convs1/conv1d{_sfx(p)}")
                tree[f"convs2_{p}"] = _dense(w, f"{rb}/convs2/conv1d{_sfx(p)}")
            params[f"resblocks_{i * nk + j}"] = tree
    return params


def convert_encoder(w: Mapping[str, List[np.ndarray]],
                    num_blocks: int) -> StateDict:
    """Reference PhonemeEncoder ``.weights.h5`` → the port's
    ``PhonemeEncoder`` state dict."""
    return module_state_from_jax(_encoder_tree(w, num_blocks))


def convert_duration(w: Mapping[str, List[np.ndarray]],
                     num_layers: int) -> StateDict:
    """Reference DurationPredictor → the port's ``DurationPredictor``
    state dict."""
    return module_state_from_jax(_duration_tree(w, num_layers))


def convert_postnet(w: Mapping[str, List[np.ndarray]],
                    num_layers: int) -> StateDict:
    """Reference PostNet → the port's ``PostNet`` state dict (BatchNorm
    moving statistics as running statistics)."""
    tree = _postnet_tree(w, num_layers)
    return module_state_from_jax(tree["params"], tree["batch_stats"])


def convert_vae(w: Mapping[str, List[np.ndarray]], num_wavenet_blocks: int,
                decoder_blocks: int, down_stages: int,
                flow_layers: int) -> StateDict:
    """Reference TextConditionedVAE → the port's ``TextConditionedVAE``
    state dict."""
    return module_state_from_jax(_vae_tree(
        w, num_wavenet_blocks, decoder_blocks, down_stages, flow_layers))


def convert_keras_vocoder(w: Mapping[str, List[np.ndarray]], upsample_rates,
                          resblock_kernel_sizes,
                          resblock_dilations) -> StateDict:
    """Reference Keras HiFiGANGenerator (the trainable one) → the port's
    ``HiFiGANGenerator`` state dict. For the torch/speechbrain pretrained
    checkpoint use :mod:`iris_tts_tpu_torch.convert.hifigan_torch`."""
    return module_state_from_jax(_keras_vocoder_tree(
        w, upsample_rates, resblock_kernel_sizes, resblock_dilations))


def load_keras_stage_weights(
    config,
    encoder_path: str | Path | None = None,
    duration_path: str | Path | None = None,
    vae_path: str | Path | None = None,
    postnet_path: str | Path | None = None,
    vocoder_path: str | Path | None = None,
) -> Dict[str, StateDict]:
    """Convert any subset of reference stage checkpoints into state dicts
    of the pipeline's networks, keyed as ``SynthesisModel``'s submodules
    (encoder / duration / vae / postnet / hifigan). ``config`` is the
    matching :class:`iris_tts_tpu_torch.config.IrisConfig`."""
    out: Dict[str, StateDict] = {}
    if encoder_path is not None:
        out["encoder"] = convert_encoder(
            read_weights_h5(encoder_path), config.encoder.num_blocks)
    if duration_path is not None:
        out["duration"] = convert_duration(
            read_weights_h5(duration_path), config.duration.num_layers)
    if vae_path is not None:
        out["vae"] = convert_vae(
            read_weights_h5(vae_path),
            config.vae.num_wavenet_blocks,
            config.vae.decoder_blocks,
            config.vae.down_stages,
            config.vae.flow_layers,
        )
    if postnet_path is not None:
        out["postnet"] = convert_postnet(
            read_weights_h5(postnet_path), config.postnet.num_layers)
    if vocoder_path is not None:
        out["hifigan"] = convert_keras_vocoder(
            read_weights_h5(vocoder_path),
            config.hifigan.upsample_rates,
            config.hifigan.resblock_kernel_sizes,
            config.hifigan.resblock_dilations,
        )
    return out
