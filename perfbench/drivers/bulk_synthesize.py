"""Closed-loop bulk synthesis through the port's own bulk tool.

The window drives ``iris_tts_tpu_torch.scripts.batch_synthesize
.synthesize_batches(pipe, texts, batch_size, seed)`` with one job after
another (each job ``utterances_per_job`` new sentences from the traffic's
generator), until ``seconds`` have passed; the job in flight then runs to
its end. The next job's sentences are drawn between jobs, and the time
that takes (milliseconds a job) is taken out of the window's time, as is
the time the profiler takes to start and stop in a traced run.

Set-up, timed as ``setup_s`` by the caller: the weights, the program's
pipeline, and one warm-up job from the same generator through the same
call, which reaches the phoneme and frame buckets that the window's jobs
reach (every job asks for the same sizes, in another order). A bucket that
a window job reaches and the warm-up did not is named in the run's
summary. The memory peak is the window's own: it is reset when the window
opens.

What the window produces is kept for the check: forward hooks on the
program's encoder, duration head and PostNet hold each batch's ids,
log-durations and mel; a reservoir drawn from the seed keeps
``check_batches`` batches, the longest-framed one always among them.
``check`` compares them with the plain reference (``perfbench/check.py``).

With ``trace``, the profiler records jobs 1 to ``trace_jobs`` (the first
job after the window opens is left out; the profiler has been started and
stopped once in set-up, since its first start takes seconds; the traced
jobs' sentences are drawn before it starts), with ``pb.`` ranges around
the encoder, duration head, VAE (its ``generate``), PostNet and HiFiGAN,
and around the pipeline's text → ids calls and its collects.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.check import compare
from perfbench.devtrace import Spans


class _Capture:
    """Holds what the program produced, by forward hooks on its modules."""

    def __init__(self, model):
        self.stage_a: List[Dict[str, Any]] = []
        self.mels: List[torch.Tensor] = []

        def on_encoder(_m, args, kwargs):
            self.stage_a.append({"ids": args[0]})

        def on_duration(_m, _args, out):
            self.stage_a[-1]["log_dur"] = out

        def on_postnet(_m, _args, out):
            self.mels.append(out)

        self.handles = [
            model.encoder.register_forward_pre_hook(on_encoder,
                                                    with_kwargs=True),
            model.duration.register_forward_hook(on_duration),
            model.postnet.register_forward_hook(on_postnet),
        ]

    def take(self):
        out = self.stage_a, self.mels
        self.stage_a, self.mels = [], []
        return out

    def remove(self):
        for h in self.handles:
            h.remove()


def _profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _spans(pipe) -> Spans:
    spans = Spans()
    for name in ("encoder", "duration", "postnet", "hifigan"):
        spans.module(name, getattr(pipe.model, name))
    spans.method("vae", pipe.model.vae, "generate")
    spans.method("frontend", pipe, "_text_to_ids_cached")
    spans.method("collect", pipe, "_batched_collect")
    return spans


def run(cfg: Dict[str, Any], traffic: Dict[str, Any], make_generator,
        seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, tf32: bool = False) -> Dict[str, Any]:
    """Set-up, the window and the sample for the check. Returns the run's
    record (see the keys at the end)."""
    from iris_tts_tpu_torch.scripts.batch_synthesize import synthesize_batches

    batch = int(traffic["batch_size"])
    marks = {"imported": time.perf_counter() - t_start}
    tree = (weights.parameter_tree(cfg, seed, device)
            if cfg["weights"]["seeded"] else None)
    pipe = weights.program_pipeline(cfg, tree, device)
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
    spans = _spans(pipe) if trace else None
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
            # the traced jobs' sentences, drawn before the trace opens
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
    if spans is not None:
        spans.remove()
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
        "batches": batches, "tree": tree, "memory_peak_bytes": memory_peak,
        "profile": prof, "trace_window_s": (
            trace_t[1] - trace_t[0] if trace_t[1] is not None else None),
        "spans": spans, "summary": summary, "job_shapes": job_shapes,
        "trace_jobs": list(range(1, trace_jobs + 1)) if trace else [],
    }


def check(cfg: Dict[str, Any], record: Dict[str, Any],
          device: torch.device) -> Dict[str, float]:
    """The numbers compared: the sampled batches against the plain
    reference on the same weights, and ``missing``, the utterances with no
    or non-finite audio. Frees the record's weights and sample."""
    tree = record.pop("tree")
    if tree is None:
        tree = weights.parameter_tree(cfg, record["seed"], device)
    numbers = compare(cfg, tree, weights.vocab(cfg), record.pop("batches"),
                      device)
    numbers["missing"] = record["failed"]
    return numbers


def _buckets(stage_a: List[Dict[str, Any]], mels: List[torch.Tensor]):
    """The phoneme and frame buckets of a job's stage-A and stage-B calls."""
    return ({f"P{c['ids'].shape[1]}" for c in stage_a}
            | {f"T{m.shape[1]}" for m in mels})


def _to_host(item: Dict[str, Any]) -> Dict[str, Any]:
    """A sampled batch on the host, with every stage-A capture of its job as
    a candidate: the check takes the one whose ids are the batch's own."""
    return {"texts": item["texts"], "seed": item["seed"],
            "mel": item["mel"].float().cpu().numpy(),
            "audio": item["audio"],
            "candidates": [(c["ids"].cpu().numpy(),
                            c["log_dur"].float().cpu().numpy())
                           for c in item["stage_a"]]}
