"""Closed-loop bulk synthesis through the port's own bulk tool, with
BigVGAN-v2 as the vocoder.

The window, the warm-up, the trace and the sample for the check follow
``bulk_synthesize.run`` rule for rule, and the record has its keys, so the
metrics that read a speech driver's record read this one unchanged. What
differs is the weights and the check:

- the parameter tree is the artifact's acoustic modules (and any other
  module the configuration seeds, drawn as ``weights.seeded_modules``
  draws them); the vocoder is a BigVGAN state dict drawn on the device
  from the seed (:func:`draw_bigvgan`): convs N(0, 0.01) and zero biases
  as BigVGAN's ``init_weights``, log-α and log-β N(0, 0.5) where BigVGAN
  starts them at 0, so that every channel's activation differs. One copy
  goes to the program (``TTSPipeline.from_jax_params(...,
  vocoder_state_dict=...)``), one to the reference;
- the check is ``check_bigvgan.compare``: the reference BigVGAN in place
  of the reference HiFiGAN.

The program's configuration is parsed before anything is read, so a port
that has no BigVGAN refuses the cell at once.
"""

from __future__ import annotations

import gc
import json
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.check_bigvgan import compare
from perfbench.drivers.bulk_synthesize import (
    _buckets,
    _Capture,
    _profiler,
    _to_host,
)
from perfbench.reference.bigvgan import BigVGAN

# The drawn log-α and log-β: N(0, SNAKE_LOG_STD).
SNAKE_LOG_STD = 0.5


def draw_bigvgan(hifigan_cfg: Dict[str, Any], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """The vocoder's parameters, by the reference's names, drawn on
    ``device`` from one ``torch.Generator`` in a single call, float32."""
    with torch.device("meta"):
        params = list(BigVGAN(hifigan_cfg).named_parameters())
    sizes = [p.numel() for _, p in params]
    gen = torch.Generator(device=device)
    gen.manual_seed((2 * int(seed) + 1) % 2**63)  # not the acoustic draw's
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, p), part in zip(params, torch.split(draw, sizes)):
        if name.endswith((".alpha", ".beta")):
            value = part * SNAKE_LOG_STD
        elif name.endswith(".bias"):
            value = torch.zeros_like(part)
        else:
            value = part * weights.HIFIGAN_STD
        out[name] = value.reshape(p.shape)
    return out


def bigvgan_weights(cfg: Dict[str, Any], seed: int, device: torch.device):
    """(the acoustic parameter tree, the vocoder's state dict) of ``seed``."""
    seeded = [m for m in cfg["weights"]["seeded"] if m != "hifigan"]
    tree = weights.parameter_tree(
        {**cfg, "weights": {**cfg["weights"], "seeded": seeded}}, seed,
        device)
    tree.pop("hifigan", None)
    return tree, draw_bigvgan(cfg["model"]["hifigan"], seed, device)


def run(cfg: Dict[str, Any], traffic: Dict[str, Any], make_generator,
        seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, tf32: bool = False) -> Dict[str, Any]:
    """Set-up, the window and the sample for the check. Returns the run's
    record (the keys of ``bulk_synthesize.run``'s)."""
    from iris_tts_tpu_torch.config import config_from_json
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.scripts.batch_synthesize import synthesize_batches
    from iris_tts_tpu_torch.text.phonemes import PhonemeVocab

    if cfg["precision"] != {"compute": "float32", "tf32": False}:
        raise ValueError(f"unsupported precision {cfg['precision']}")
    model_cfg = config_from_json(json.dumps(cfg["model"]))
    batch = int(traffic["batch_size"])
    marks = {"imported": time.perf_counter() - t_start}
    tree, vocoder = bigvgan_weights(cfg, seed, device)
    pipe = TTSPipeline.from_jax_params(
        tree, model_cfg, device=device,
        vocab=PhonemeVocab(weights.vocab(cfg)), vocoder_state_dict=vocoder)
    pipe.phoneme_buckets = tuple(cfg["buckets"]["phoneme"])
    pipe.frame_buckets = tuple(cfg["buckets"]["frame"])
    marks["pipeline"] = time.perf_counter() - t_start
    if tf32:  # the control: the timed path in TF32
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    gen = make_generator(traffic, seed)
    rng = np.random.default_rng(int(seed) % 2**64 + 1)
    capture = _Capture(pipe.model)
    marks["generator"] = time.perf_counter() - t_start
    synthesize_batches(pipe, gen.job(), batch, int(rng.integers(2**31)))
    marks["warm-up job"] = time.perf_counter() - t_start
    warmed = _buckets(*capture.take())
    texts = gen.job()
    k = int(traffic["check_batches"])
    reservoir: List[Dict[str, Any]] = []
    longest = None
    n_seen = 0
    lengths: List[int] = []
    texts_done: List[str] = []
    missing = 0
    job_shapes: List[List[tuple]] = []
    unwarmed = set()
    drawn: List[List[str]] = []
    prof = None
    trace_jobs = int(traffic["trace_jobs"])
    if trace:  # the profiler's first start takes seconds: not in the window
        with _profiler():
            torch.ones(1, device=device).sum().item()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    w0 = time.perf_counter()
    j = 0
    paused_s = 0.0  # drawing jobs, starting and stopping the profiler
    trace_t = [None, None]
    while True:
        if trace and j == 1:
            p0 = time.perf_counter()
            drawn = [gen.job() for _ in range(trace_jobs - 1)]
            prof = _profiler()
            prof.__enter__()
            trace_t[0] = time.perf_counter()
            paused_s += trace_t[0] - p0
        audio, plan = synthesize_batches(pipe, texts, batch,
                                         int(rng.integers(2**31)))
        if prof is not None and j == trace_jobs:
            trace_t[1] = time.perf_counter()
            prof.__exit__(None, None, None)
            paused_s += time.perf_counter() - trace_t[1]
        j += 1
        stage_a, mels = capture.take()
        if len(mels) != len(plan):
            raise RuntimeError(f"the PostNet ran {len(mels)} times for "
                               f"{len(plan)} batches")
        job_shapes.append([tuple(m.shape[:2]) for m in mels])
        unwarmed |= _buckets(stage_a, mels) - warmed
        for i, text in enumerate(texts):
            a = audio.get(i)
            if a is None or not np.isfinite(a).all():
                missing += 1
                lengths.append(0)
            else:
                lengths.append(len(a))
            texts_done.append(text)
        for (idxs, batch_seed), mel in zip(plan, mels):
            item = {"texts": [texts[i] for i in idxs], "seed": batch_seed,
                    "mel": mel, "stage_a": stage_a,
                    "audio": [audio.get(i) for i in idxs]}
            n_seen += 1
            if longest is None or mel.shape[1] > longest["mel"].shape[1]:
                longest = item
            if len(reservoir) < k - 1:
                reservoir.append(item)
            else:
                slot = int(rng.integers(n_seen))
                if slot < k - 1:
                    reservoir[slot] = item
        if (time.perf_counter() - w0 - paused_s >= seconds
                and (not trace or trace_t[1] is not None)):
            break
        d0 = time.perf_counter()
        texts = drawn.pop(0) if drawn else gen.job()
        paused_s += time.perf_counter() - d0
    window_s = time.perf_counter() - w0 - paused_s

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    capture.remove()
    sample = [it for it in reservoir if it is not longest] + [longest]
    batches = [_to_host(it) for it in sample]
    del pipe, reservoir, longest, sample, capture
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary = (f"{j} jobs in {window_s:.3f} s; set-up to: "
               + " ".join(f"{k} {v:.3f} s" for k, v in marks.items())
               + f"; buckets warmed {sorted(warmed)}, reached unwarmed "
               f"{sorted(unwarmed)}")
    return {
        "seed": seed, "setup_s": setup_s, "window_s": window_s, "jobs": j,
        "attempted": len(texts_done), "failed": missing,
        "samples": lengths, "texts": texts_done,
        "batches": batches, "tree": (tree, vocoder),
        "memory_peak_bytes": memory_peak,
        "profile": prof, "trace_window_s": (
            trace_t[1] - trace_t[0] if trace_t[1] is not None else None),
        "spans": None, "summary": summary, "job_shapes": job_shapes,
        "trace_jobs": list(range(1, trace_jobs + 1)) if trace else [],
    }


def check(cfg: Dict[str, Any], record: Dict[str, Any],
          device: torch.device) -> Dict[str, float]:
    """The numbers compared: the sampled batches against the plain
    reference with BigVGAN on the same weights, and ``missing``. Frees the
    record's weights and sample."""
    tree, vocoder = record.pop("tree")
    numbers = compare(cfg, tree, vocoder, weights.vocab(cfg),
                      record.pop("batches"), device)
    numbers["missing"] = record["failed"]
    return numbers
