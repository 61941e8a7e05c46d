"""Model configurations and their weights, as the benchmark hands them to
the program and to the reference.

A configuration file (``configs/<name>.json``) states the model's widths
(``model``: the sections of the JAX package's ``config.json``), where its
weights come from (``weights``: an artifact directory of the JAX package,
and the modules whose weights are drawn from the run's seed instead), the
phoneme and frame bucket ladders, and the precision. Sections that come
from the artifact must equal the artifact's own ``config.json``, so the
file is the configuration as it runs.

The weights are one parameter tree in the JAX package's layout (numpy
leaves), read from the artifact with the reference's frozen reader and, for
each seeded module, drawn on the device from the seed. The program gets it
through ``TTSPipeline.from_jax_params``, or, when nothing is seeded, loads
the artifact itself with ``TTSPipeline.load`` as a user does; the
reference maps the same tree onto its own model.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from perfbench.reference.model import SynthesisModel, flax_shapes
from perfbench.reference.reader.orbax import read_tree

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = Path(__file__).resolve().parent / "configs"
MODULES = ("encoder", "duration", "vae", "postnet", "hifigan")
# HiFiGAN's published init (jik876/hifi-gan, ``init_weights``): N(0, 0.01).
HIFIGAN_STD = 0.01


def load_config(name: str, path: Optional[Path] = None) -> Dict[str, Any]:
    """The configuration ``name`` (``configs/<name>.json`` unless ``path``
    is given), checked against its artifact; raises on a section that
    differs from the artifact's without being seeded."""
    cfg = json.loads((path or CONFIG_DIR / f"{name}.json").read_text())
    weights = cfg["weights"]
    unknown = set(weights["seeded"]) - set(MODULES)
    if unknown:
        raise ValueError(f"{name}: unknown seeded modules {sorted(unknown)}")
    art = weights.get("artifact")
    if art is None:
        if set(weights["seeded"]) != set(MODULES):
            raise ValueError(f"{name}: without an artifact every module "
                             "must be seeded")
        return cfg
    art_dir = ROOT / art
    art_cfg = json.loads((art_dir / "config.json").read_text())
    for section in ("audio",) + MODULES:
        if section in weights["seeded"]:
            continue
        if cfg["model"][section] != art_cfg[section]:
            raise ValueError(f"{name}: model.{section} differs from "
                             f"{art}/config.json")
    meta = json.loads((art_dir / "meta.json").read_text())
    if (cfg["buckets"]["phoneme"] != meta["phoneme_buckets"]
            or cfg["buckets"]["frame"] != meta["frame_buckets"]):
        raise ValueError(f"{name}: buckets differ from {art}/meta.json")
    return cfg


def vocab(cfg: Dict[str, Any]) -> Dict[str, int]:
    return json.loads((ROOT / cfg["weights"]["vocab"]).read_text())


def _init_std(top: str, path: tuple, shape: tuple) -> float:
    """Scale of a drawn leaf: HiFiGAN kernels N(0, 0.01); other kernels
    and embeddings 1/sqrt(fan in); biases, means 0; scales, variances 1
    (returned as NaN: filled, not drawn)."""
    leaf = path[-1]
    if leaf in ("bias", "mean", "scale", "var"):
        return math.nan
    if top == "hifigan":
        return HIFIGAN_STD
    if leaf == "embedding":
        return 1.0 / math.sqrt(shape[-1])
    if len(path) >= 3 and path[-3] == "attention" and path[-2] != "out":
        return 1.0 / math.sqrt(shape[0])
    return 1.0 / math.sqrt(int(np.prod(shape[:-1])))


def seeded_modules(cfg: Dict[str, Any], seed: int,
                   device: torch.device) -> Dict[str, Any]:
    """The seeded modules' parameter trees, drawn on ``device`` from one
    ``torch.Generator`` in a single call, in float32."""
    modules = cfg["weights"]["seeded"]
    if not modules:
        return {}
    with torch.device("meta"):
        ref = SynthesisModel(cfg["model"])
    heads = cfg["model"]["encoder"]["num_heads"]
    leaves = []
    for top in modules:
        for path, shape in flax_shapes(getattr(ref, top), top, heads).items():
            leaves.append((top, path, shape))
    sizes = [int(np.prod(s)) for _, _, s in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    trees: Dict[str, Any] = {}
    for (top, path, shape), part in zip(leaves, torch.split(draw, sizes)):
        std = _init_std(top, path, shape)
        if math.isnan(std):
            value = torch.ones(shape) if path[-1] in ("scale", "var") \
                else torch.zeros(shape)
        else:
            value = (part * std).reshape(shape)
        node = trees.setdefault(top, {})
        if top == "postnet":  # flax keeps BatchNorm statistics apart
            node = node.setdefault(
                "batch_stats" if path[-1] in ("mean", "var") else "params",
                {})
        for key in path[1:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.cpu().numpy()
    return trees


def parameter_tree(cfg: Dict[str, Any], seed: int,
                   device: torch.device) -> Dict[str, Any]:
    """The whole parameter tree: the artifact's, with the seeded modules
    drawn from ``seed``."""
    art = cfg["weights"].get("artifact")
    tree = dict(read_tree(ROOT / art / "params")) if art else {}
    tree.update(seeded_modules(cfg, seed, device))
    return tree


def program_pipeline(cfg: Dict[str, Any], tree: Optional[Dict[str, Any]],
                     device: torch.device):
    """The program under test: ``TTSPipeline.load`` of the artifact when
    nothing is seeded (``tree`` unused), else
    ``TTSPipeline.from_jax_params`` of ``tree``, with the configuration's
    bucket ladders."""
    from iris_tts_tpu_torch.config import config_from_json
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

    if cfg["precision"] != {"compute": "float32", "tf32": False}:
        raise ValueError(f"unsupported precision {cfg['precision']}")
    if not cfg["weights"]["seeded"]:
        return TTSPipeline.load(ROOT / cfg["weights"]["artifact"],
                                device=device)
    model_cfg = config_from_json(json.dumps(cfg["model"]))
    pipe = TTSPipeline.from_jax_params(
        tree, model_cfg, device=device, vocab=PhonemeVocab(vocab(cfg)))
    pipe.phoneme_buckets = tuple(cfg["buckets"]["phoneme"])
    pipe.frame_buckets = tuple(cfg["buckets"]["frame"])
    return pipe
