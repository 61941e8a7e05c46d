"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port (``iris_tts_tpu_torch``) through the entry points a user
calls, at the full default width with seeded random weights, and holds
every kernel against its plain PyTorch version:

1. build the log-mel kernel (``iris_tts_tpu_torch/ops/csrc/log_mel.cu``)
   from the sources in this checkout;
2. kernel vs plain version on 10 s audio, a 4000-sample clip, a
   300-sample clip (both frames in the padding), a batch of 3 with an odd
   length and a batch of 8 × 10 s (max-abs ≤ 2e-3), with the times of the
   kernel, the plain version and a cuFFT yardstick (``torch.stft`` then
   magnitude, mel matmul and log; the port never calls it) and the
   kernel's bound;
3. synthesis at full width: the fused path (one sentence) and the
   two-stage path (a batch of 4), with their latencies;
4. copy synthesis: log-mel of the phase-3 audio through the kernel, then
   ``vocode``;
5. the same pipeline on the card and on the CPU at temperature 0: equal
   frame counts, waveform max-abs ≤ 1e-3 (catches TF32);
6. training at full width (``IrisConfig()`` plus full-width MPD/MSD): a
   32-utterance synthetic corpus; its mel cache built on the card through
   the log-mel kernel (one launch a clip) and held against the plain
   version (max-abs ≤ 2e-3); one epoch of each stage through the port's
   ``TrainLoop`` at batch 16 (duration; VAE with the frozen encoder and the
   annealed KL weight; PostNet with the frozen encoder and VAE; GAN on 16
   segments of 8192 samples); 20 steps on one fixed batch per stage, whose
   loss must drop (step time, peak memory, first and last loss printed); a
   bit-exact checkpoint round trip; ``TTSPipeline.from_checkpoints`` and one
   synthesized sentence; one step of each stage's loss at a small width on
   the card and on the CPU, losses and gradients held together (≤ 1e-4 of
   the largest |g|);
7. serving at full width (``IrisConfig()``, seeded random weights with
   ``conv_post`` scaled so the peak lies near 0.5, since unscaled random
   weights quantize to PCM16 zeros): ``warmup_fused`` and
   ``warmup_batched`` over batch buckets (1, 2, 4, 8) on ladders cut to
   phoneme buckets (16 … 128) and frame buckets (128 … 1536), run by
   ``TTSServer.start()`` on the batcher's device thread; the
   server (127.0.0.1, device-side PCM16) answers three bursts of 16
   ``POST /synthesize`` from 8 client threads (every WAV 22 050 Hz, chunks
   × 256 samples plus gaps, not silent) and one ``POST
   /synthesize_stream`` (de-chunked, chunk and gap lengths checked, time
   to first audio); a seeded request through the server equals
   ``synthesize`` on the card (≤ 1e-6 of the peak through PCM16); then,
   with the server stopped, two 8-row slices with and without the
   dispatch/collect overlap, a warmed shape's first call on a new thread,
   ``vocode_streaming`` (64-frame chunks) vs
   ``vocode`` on 700 frames (≤ 1e-5 of the peak, and the PCM16 variant),
   and ``save``/``load`` on the card (bitwise at temperature 0; ``half``
   within 1e-2 of the peak). The server stops in a ``finally``.

Three paths drive the kernel, or not: synthesis (phases 3 and 4),
training (phase 6) and serving (phase 7, which computes no log-mel: 0
launches). Each path's launch counts are zeroed just before it and read
just after, and a kernel of the path that was not launched fails the run.
The last three lines are the card's name and power limit, a
``{"kernels": [...]}`` JSON line, and ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero; so does a host without a CUDA device.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import torch

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): f32 on
# the CUDA cores and HBM3 bandwidth. bound_ms is work / peak.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

SENTENCE = "Hello world, this is the iris text to speech system."
BATCH = [
    "The quick brown fox jumps over the lazy dog.",
    "Dr. Smith paid $12.50 on January 3, 1984.",
    "Speech synthesis on a graphics card.",
    "Short one.",
]
SHORT = "Hello world."
TRAIN_SENTENCE = "The old gardener found a basket of apples near the station."
# Phase 7's traffic: short and medium sentences and one three-sentence text
# (two chunks at the 128-phoneme cap).
SERVE_TEXTS = [
    "Hello there.",
    "Good morning.",
    "Thank you very much.",
    "See you soon.",
    "The quick brown fox jumps over the lazy dog.",
    "Dr. Smith paid $12.50 on January 3, 1984.",
    "Speech synthesis on a graphics card is fast.",
    ("The old gardener found a basket of apples near the railway station "
     "on a cold morning in early November. He carried it home along the "
     "river, past the mill and the church, and set it down beside the "
     "kitchen door. By evening the whole village had heard about the "
     "apples, and nobody could say where they had come from."),
]
# Phase 7's depth cut: the ladders are cut so the warmup fits the run's
# time; widths stay full.
SERVE_PHONEME_BUCKETS = (16, 32, 64, 128)
SERVE_FRAME_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536)
SERVE_BATCH_BUCKETS = (1, 2, 4, 8)
BURST_ROUNDS = 3
# The loss each stage's fixed-batch check follows.
STAGE_LOSS = {"duration": "duration_loss", "vae": "total",
              "postnet": "postnet_l1", "gan": "gen_mel_l1"}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def time_cuda_ms(fn, reps: int = 200, warmup: int = 5,
                 graph: bool = True) -> float:
    """Device time of one call: ``reps`` calls between one pair of CUDA
    events, divided by ``reps``, after a warm-up. With ``graph`` the calls
    are captured in one CUDA graph and replayed, so the host side of each
    call (Python, allocation, the launch) stays out of the window even
    where it takes longer than the device work; without it the calls are
    issued eagerly back to back, which is what a caller in a loop sees."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_host_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median wall time of a call that returns host data (so the device
    work is done when it returns)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs(a, b) -> float:
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
    return float((a - b).abs().max()) if a.numel() else 0.0


def profile_line(label: str, fn, card: str) -> None:
    """Run ``fn`` (which returns host data) once under ``torch.profiler``
    and print its wall time, the device's busy time and share, and the
    kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernel rows only: a CPU op's row repeats the device time of the
    # kernels it launched.
    dev_rows = [(e.key, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
    dev_us = sum(t for _, t in dev_rows)
    if dev_us > 0:
        top = sorted(dev_rows, key=lambda r: -r[1])[:6]
        print(f"profile {label} (profiler on): wall {wall_us / 1e3:.2f} ms, "
              f"device busy {dev_us / 1e3:.2f} ms "
              f"({100 * dev_us / wall_us:.1f}%); top device time: "
              + "; ".join(f"{k[:60]} {t / 1e3:.2f} ms" for k, t in top)
              + f" ({card})", flush=True)
    else:
        print(f"profile {label}: the profiler recorded no device time (not "
              "measured)", flush=True)


def log_mel_work(batch: int, n_samples: int, cfg, tables):
    """(operations, bytes) the log-mel function needs at least: per frame a
    real FFT (2.5 n log2 n), the window (n), the magnitude (3 per bin), the
    mel projection (2 per filterbank nonzero) and the log (1 per mel); the
    audio read once, the output written once, and the window, twiddle and
    sparse filterbank tables (``tables``, as the kernel reads them)."""
    n = cfg.n_fft
    t = 1 + n_samples // cfg.hop_length
    per_frame = (2.5 * n * math.log2(n) + n + 3 * (n // 2 + 1)
                 + 2 * tables.fb_weights.size + cfg.n_mels)
    nbytes = (4 * (batch * n_samples + batch * t * cfg.n_mels)
              + sum(a.nbytes for a in tables))
    return batch * t * per_frame, nbytes


def dense_dft_work(batch: int, n_samples: int, cfg):
    """(operations, bytes) of the dense-DFT formulation, the yardstick of
    the kernel's first design: two [T, n_fft] @ [n_fft, n_freqs]
    contractions and one [T, n_freqs] @ [n_freqs, n_mels] per row; audio,
    both DFT matrices and the filterbank read once, the output written
    once."""
    t = 1 + n_samples // cfg.hop_length
    n_freqs = cfg.n_fft // 2 + 1
    flops = batch * t * (2 * 2 * cfg.n_fft * n_freqs
                         + 2 * n_freqs * cfg.n_mels)
    nbytes = 4 * (batch * n_samples + 2 * cfg.n_fft * n_freqs
                  + n_freqs * cfg.n_mels + batch * t * cfg.n_mels)
    return flops, nbytes


def bound(flops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the larger of work over peak."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def log_mel_library(audio, cfg, window, fb_t):
    """The same function from library calls (the yardstick, never called
    by the port): cuFFT through ``torch.stft``, the floored magnitude, the
    mel matmul and the clamped log, in f32."""
    spec = torch.stft(audio, cfg.n_fft, cfg.hop_length, cfg.n_fft, window,
                      center=True, pad_mode="constant", return_complex=True)
    mag = torch.sqrt(torch.view_as_real(spec).square().sum(-1) + 1e-12)
    mel = fb_t @ mag
    return torch.log(torch.clamp(mel, min=cfg.log_clip_min)).transpose(-1, -2)


def _small_stage_grads(device, cfg):
    """Loss and gradients of each stage's loss at a small width, dropout
    off and the VAE at its posterior mean, for one seeded batch on
    ``device``: {name: (loss, {param: grad})}."""
    import numpy as np
    import torch.nn as nn

    from iris_tts_tpu_torch.models.discriminators import (
        HiFiGANDiscriminators,
    )
    from iris_tts_tpu_torch.models.encoder import (
        DurationPredictor,
        PhonemeEncoder,
    )
    from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from iris_tts_tpu_torch.models.layers import init_params
    from iris_tts_tpu_torch.models.postnet import PostNet
    from iris_tts_tpu_torch.models.vae import TextConditionedVAE
    from iris_tts_tpu_torch.train.gan import disc_loss, frozen_params, gen_loss
    from iris_tts_tpu_torch.train.steps import (
        duration_loss,
        postnet_stage_loss,
        vae_stage_loss,
    )

    def make(module, seed):
        init_params(module, torch.Generator().manual_seed(seed))
        return module.to(device)

    rng = np.random.default_rng(0)
    b, p, t = 4, 12, 64
    mask = (np.arange(p)[None] < rng.integers(6, p + 1, (b, 1)))
    batch = {k: torch.from_numpy(v).to(device) for k, v in {
        "phoneme_ids": (rng.integers(2, cfg.encoder.vocab_size, (b, p))
                        * mask).astype(np.int32),
        "durations": (rng.integers(1, 5, (b, p)) * mask).astype(np.float32),
        "phoneme_mask": mask.astype(np.float32),
        "mel": rng.standard_normal((b, t, 80)).astype(np.float32),
        "audio": (0.3 * rng.standard_normal((b, 32 * 256))
                  ).astype(np.float32),
    }.items()}
    gan_batch = {"mel": batch["mel"][:, :32], "audio": batch["audio"]}
    enc = make(PhonemeEncoder(cfg.encoder), 1)
    frozen = nn.ModuleDict({"encoder": enc,
                            "vae": make(TextConditionedVAE(cfg.vae), 2)})
    for q in frozen.parameters():
        q.requires_grad_(False)
    gen = make(HiFiGANGenerator(cfg.hifigan), 3)
    disc = make(HiFiGANDiscriminators(width=0.125), 4)
    out = {}
    cases = [
        ("duration", make(nn.ModuleDict({
            "encoder": PhonemeEncoder(cfg.encoder),
            "duration": DurationPredictor(cfg.encoder.embed_dim,
                                          cfg.duration)}), 5),
         lambda m: duration_loss(m, batch, cfg, deterministic=True)),
        ("vae", make(TextConditionedVAE(cfg.vae), 6),
         lambda m: vae_stage_loss(m, frozen, batch, 0.01, cfg,
                                  deterministic=True)),
        ("postnet", make(PostNet(cfg.postnet), 7),
         lambda m: postnet_stage_loss(m, frozen, batch, deterministic=True)),
        ("gan_disc", disc, lambda m: disc_loss(m, gen, gan_batch)),
    ]
    for name, module, loss_fn in cases:
        loss, _ = loss_fn(module)
        loss.backward()
        out[name] = (float(loss.detach()), {k: q.grad.detach().cpu().double()
                                   for k, q in module.named_parameters()
                                   if q.grad is not None})
        module.zero_grad(set_to_none=True)
    with frozen_params(disc):
        loss, _ = gen_loss(gen, disc, gan_batch, cfg)
        loss.backward()
    out["gan_gen"] = (float(loss.detach()), {k: q.grad.detach().cpu().double()
                                    for k, q in gen.named_parameters()})
    return out


def phase6_training(dev, card: str) -> int:
    """Training at full width (see the module docstring). Returns the
    log-mel kernel's launches on this path."""
    import numpy as np

    from iris_tts_tpu_torch import config as C
    from iris_tts_tpu_torch.data.audio_io import load_audio
    from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
    from iris_tts_tpu_torch.data.synthetic_speech import (
        CorpusSpec,
        generate_corpus,
    )
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram_plain
    from iris_tts_tpu_torch.train import stages
    from iris_tts_tpu_torch.train.checkpoint import CheckpointManager

    mel_cuda.log_mel_cuda.launches = 0
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    root = Path(tmp.name)
    try:
        # 1. corpus
        t0 = time.perf_counter()
        corpus, aligned = generate_corpus(
            root / "corpus", CorpusSpec(n_utterances=32, seed=3),
            progress_every=0)
        n_wavs = len(list((corpus / "wavs").glob("*.wav")))
        check(n_wavs == 32, f"32 utterances generated ({n_wavs})")
        print(f"phase 6 corpus: {n_wavs} utterances in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # 2. mel cache through the kernel, held against the plain version
        cache = root / "cache"
        audio_cfg = C.AudioConfig()
        sets = [LJSpeechVAEDataset(corpus, aligned, split=split,
                                   cache_dir=cache, audio=audio_cfg,
                                   device=dev)
                for split in ("train", "val")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_clips = sum(ds.precompute_mels() for ds in sets)
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
        launches = mel_cuda.log_mel_cuda.launches
        check(n_clips == 32 and launches == n_clips,
              f"one kernel launch per cached clip ({launches}, {n_clips})")
        worst = 0.0
        for ds in sets:
            for sid in ds.sample_ids:
                cached = np.load(ds._mel_path(sid))
                audio = load_audio(corpus / "wavs" / f"{sid}.wav")
                want = log_mel_spectrogram_plain(
                    torch.from_numpy(audio).to(dev), audio_cfg)
                check(bool(np.isfinite(cached).all()), f"finite mel {sid}")
                worst = max(worst, max_abs(cached, want))
        check(worst <= 2e-3, f"cached mel vs plain max-abs {worst} <= 2e-3")
        print(f"phase 6 mel cache: {n_clips} clips through the kernel "
              f"({launches} launches) in {cache_s:.3f} s, "
              f"{1e3 * cache_s / n_clips:.3f} ms a clip (host wall: wav "
              f"read, pad, launch, copy back, np.save); max-abs vs plain "
              f"{worst:.3e} ({card})", flush=True)

        # 3-4. the four stages, then 20 steps on one fixed batch each
        cfg = C.IrisConfig()
        cfg = replace(cfg, train=replace(cfg.train, batch_size=16,
                                         num_epochs=1, warmup_epochs=0))
        out = root / "run"
        kw = dict(cache_dir=cache, device=dev)
        stage_fns = [
            ("duration", stages.duration_stage, {}),
            ("vae", stages.vae_stage, {}),
            ("postnet", stages.postnet_stage, {}),
            ("gan", stages.gan_stage, dict(segment_frames=32)),
        ]
        states = {}
        for name, build, extra in stage_fns:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loop = build(cfg, corpus, aligned, out, **kw, **extra)
            state = loop.run()
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            epoch_steps = state.step
            check(epoch_steps >= 1 and state.epoch == 1,
                  f"{name}: one epoch ran ({epoch_steps} steps)")
            check(all(math.isfinite(v) for v in loop.history[0].values()),
                  f"{name}: finite epoch metrics {loop.history[0]}")
            batch = loop.place_batch(next(iter(loop.batcher.epoch(0))))
            extras = loop.epoch_extras(0) if loop.epoch_extras else ()
            losses, times = [], []
            for _ in range(20):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, m = loop.train_step(state, batch, *extras)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
                losses.append({k: float(v) for k, v in m.items()})
            key = STAGE_LOSS[name]
            check(all(math.isfinite(v) for l in losses for v in l.values()),
                  f"{name}: finite losses over 20 steps")
            first, last = losses[0][key], losses[-1][key]
            check(last < first, f"{name}: {key} drops on a fixed batch "
                                f"({first} -> {last})")
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            n_params = sum(q.numel() for q in state.params.parameters())
            shape = tuple(batch["mel" if "mel" in batch
                                else "phoneme_ids"].shape)
            print(f"phase 6 stage {name}: {n_params / 1e6:.2f} M trained "
                  f"params; epoch of {epoch_steps} steps in {epoch_s:.2f} s "
                  f"(build, mel cache reads, checkpoint); fixed batch "
                  f"{shape}: median step {statistics.median(times[3:]):.2f} ms "
                  f"(steps 4-20), peak memory {peak_mb:.1f} MiB, {key} "
                  f"{first:.5f} -> {last:.5f} ({card})", flush=True)
            states[name] = state
            if name == "duration":
                duration_step, duration_batch = loop.train_step, batch

        # 5. checkpoint round trip on the card
        state = states["duration"]
        before = {k: v.clone() for k, v in
                  state.params.state_dict().items()}
        opt_before = [{k: torch.as_tensor(v).clone() for k, v in st.items()}
                      for st in state.optimizer.state_dict()["state"].values()]
        rng_before = state.generator.get_state()
        ckpt = CheckpointManager(root / "roundtrip")
        ckpt.save(state.step, state)
        step_before = state.step
        state, _ = duration_step(state, duration_batch)
        check(state.step == step_before + 1, "a step after the save")
        ckpt.restore(state)
        check(state.step == step_before, "restored step")
        check(all(torch.equal(v, state.params.state_dict()[k])
                  for k, v in before.items()), "restored params bit-exact")
        opt_after = [{k: torch.as_tensor(v) for k, v in st.items()}
                     for st in state.optimizer.state_dict()["state"].values()]
        check(all(torch.equal(a[k], b[k]) for a, b in
                  zip(opt_before, opt_after) for k in a),
              "restored optimizer state bit-exact")
        check(torch.equal(rng_before, state.generator.get_state()),
              "restored generator state bit-exact")
        check(next(state.params.parameters()).device.type == dev.type,
              "restored onto the card")
        print(f"phase 6 checkpoint round trip on the card: params, "
              f"optimizer, generator state bit-exact", flush=True)

        # 6. assemble the trained stages and synthesize
        pipe = TTSPipeline.from_checkpoints(
            out / "encoder" / "checkpoints", out / "vae" / "checkpoints",
            out / "postnet" / "checkpoints",
            out / "hifigan_gan" / "checkpoints",
            vocab_path=cache / "phoneme_vocab.json", device=dev)
        audio = pipe.synthesize(TRAIN_SENTENCE, seed=0)
        hop = pipe.config.hifigan.total_upsample
        check(len(audio) > 0 and len(audio) % hop == 0,
              "trained pipeline audio length")
        check(bool(np.isfinite(audio).all()), "trained pipeline audio finite")
        check(float(np.abs(audio).max()) > 0.0, "trained audio not silent")
        print(f"phase 6 from_checkpoints: synthesized {len(audio)} samples "
              f"({len(audio) // hop} frames), rms "
              f"{float(np.sqrt(np.mean(audio ** 2))):.3e}", flush=True)
        train_launches = mel_cuda.log_mel_cuda.launches
        check(train_launches >= n_clips,
              "the training path launched the log-mel kernel")

        # 7. card vs CPU, one step of each stage's loss at a small width
        small = C.IrisConfig(
            encoder=C.EncoderConfig(embed_dim=32, num_blocks=2, num_heads=2),
            duration=C.DurationConfig(hidden_dim=16, num_layers=2),
            vae=C.VAEConfig(cond_dim=32, model_channels=16, latent_dim=4,
                            num_wavenet_blocks=2, decoder_blocks=1,
                            flow_layers=2, flow_hidden=8),
            postnet=C.PostNetConfig(num_layers=3, channels=8),
            hifigan=C.HiFiGANConfig(upsample_initial_channel=32,
                                    resblock_kernel_sizes=(3, 7),
                                    resblock_dilations=((1, 3), (1, 3))))
        on_card = _small_stage_grads(dev, small)
        on_cpu = _small_stage_grads(torch.device("cpu"), small)
        for name, (loss_c, grads_c) in on_cpu.items():
            loss_g, grads_g = on_card[name]
            check(set(grads_g) == set(grads_c), f"{name}: same grads")
            scale = max(float(g.abs().max()) for g in grads_c.values())
            err = max(float((grads_g[k] - g).abs().max())
                      for k, g in grads_c.items())
            rel_loss = abs(loss_g - loss_c) / max(abs(loss_c), 1e-30)
            check(scale > 0 and err <= 1e-4 * scale,
                  f"{name}: card vs CPU grads {err} <= 1e-4 x {scale}")
            check(rel_loss <= 1e-4, f"{name}: card vs CPU loss {rel_loss}")
            print(f"phase 6 card vs CPU {name}: loss {loss_c:.6f} "
                  f"(relative {rel_loss:.2e}), grads max-abs {err:.3e} = "
                  f"{err / scale:.2e} of max |g|", flush=True)
        return train_launches
    finally:
        tmp.cleanup()


def _post(host, port, path, body, timeout=300):
    """One HTTP request → (status, headers dict, body bytes, seconds)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data, \
            time.perf_counter() - t0
    finally:
        conn.close()


def _wav_pcm(body: bytes):
    import io
    import wave

    import numpy as np

    with wave.open(io.BytesIO(body)) as w:
        return w.getframerate(), np.frombuffer(
            w.readframes(w.getnframes()), "<i2")


def _pct(values, p):
    v = sorted(values)
    return v[min(len(v) - 1, int(p * len(v)))]


def phase7_serving(dev, card: str) -> int:
    """Serving on the card (see the module docstring). Returns the log-mel
    kernel's launches on this path (serving computes no log-mel)."""
    import http.client
    import threading

    import numpy as np

    from iris_tts_tpu_torch import IrisConfig
    from iris_tts_tpu_torch.models.hifigan import receptive_radius_frames
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.serve import TTSServer

    mel_cuda.log_mel_cuda.launches = 0
    t0 = time.perf_counter()
    pipe = TTSPipeline.initialize(IrisConfig(), seed=0, device=dev)
    pipe.phoneme_buckets = SERVE_PHONEME_BUCKETS
    pipe.frame_buckets = SERVE_FRAME_BUCKETS
    hop = pipe.config.hifigan.total_upsample
    sr = pipe.config.audio.sample_rate
    # Random HiFiGAN weights give rms ~6.5e-6, which PCM16 quantizes to
    # zeros: scale the output conv so the peak lies near 0.5 and the
    # PCM16 comparisons below see real samples.
    probe = pipe.synthesize(SENTENCE, temperature=0.0)
    scale = 0.5 / float(np.abs(probe).max())
    with torch.no_grad():
        pipe.model.hifigan.conv_post.weight.mul_(scale)
        pipe.model.hifigan.conv_post.bias.mul_(scale)
    peak = float(np.abs(pipe.synthesize(SENTENCE, temperature=0.0)).max())
    check(0.3 < peak < 0.8, f"scaled peak {peak} near 0.5")
    print(f"phase 7 pipeline: IrisConfig() at full width, seeded random "
          f"weights, conv_post scaled x{scale:.4g} for all of phase 7 so "
          f"the peak lies near 0.5 (now {peak:.3f}; unscaled random weights "
          f"quantize to PCM16 zeros), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 1. warmup on the batcher's device thread, on the cut ladders
    print(f"phase 7 depth cut: phoneme buckets {pipe.phoneme_buckets} (of "
          f"16 … 512), frame buckets {pipe.frame_buckets} (of 128 … 4096), "
          f"batch buckets {SERVE_BATCH_BUCKETS}; widths full", flush=True)
    server = TTSServer(pipe, host="127.0.0.1", port=0,
                       max_batch=max(SERVE_BATCH_BUCKETS), max_wait_ms=5.0,
                       pcm16_transfer=True)
    check(server.batcher._batch_buckets == list(SERVE_BATCH_BUCKETS),
          "the server's batch buckets")
    n_fused = len(pipe.fused_bucket_pairs())
    try:
        server.start()
        n_warmed = server.batcher.n_warmed
        check(n_warmed > n_fused, f"warmup ran {n_warmed} shapes")
        print(f"phase 7 warmup (warmup_fused, then warmup_batched over the "
              f"batch buckets, on the batcher's device thread): {n_fused} "
              f"fused and {n_warmed - n_fused} two-stage shapes in "
              f"{server.batcher.warmup_s:.2f} s ({card})", flush=True)
        host, port = server.address[:2]
        gap = int(round(server.batcher._gap_ms / 1000.0 * sr))
        n_chunks = {t: len(server.batcher.chunk_text(t)) for t in SERVE_TEXTS}
        three = SERVE_TEXTS[-1]
        check(n_chunks[three] >= 2, f"the long text streams in "
                                    f"{n_chunks[three]} chunks")

        # 2. a burst of 16 requests from 8 client threads, three times:
        # with 16 requests a round's p95 is its maximum, so each round is
        # printed and the 48 latencies are also pooled
        jobs = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(16)]
        pooled, rounds = [], []
        for rnd in range(BURST_ROUNDS):
            results = [None] * len(jobs)
            errors = []

            def client(k):
                try:
                    for i in range(k, len(jobs), 8):
                        results[i] = _post(host, port, "/synthesize",
                                           {"text": jobs[i]})
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(8)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            burst_s = time.perf_counter() - t0
            check(not errors and not any(t.is_alive() for t in threads),
                  f"burst clients finished ({errors})")
            audio_s = 0.0
            for text, (status, headers, body, _) in zip(jobs, results):
                check(status == 200 and headers.get("Content-Type") ==
                      "audio/wav", f"burst status {status}")
                rate, pcm = _wav_pcm(body)
                check(rate == sr, f"WAV rate {rate}")
                n = n_chunks[text]
                check(len(pcm) > 0 and (len(pcm) - (n - 1) * gap) % hop == 0,
                      f"WAV length {len(pcm)} = chunks x {hop} + gaps")
                check(bool(np.isfinite(pcm.astype(np.float32)).all()),
                      "WAV samples finite")
                check(int(np.abs(pcm).max()) > 0, "WAV not silent")
                audio_s += len(pcm) / sr
            lats = [r[3] * 1e3 for r in results]
            pooled += lats
            rounds.append(f"round {rnd + 1}: {burst_s:.3f} s, "
                          f"{audio_s / burst_s:.1f}x realtime, p50 "
                          f"{_pct(lats, 0.5):.2f} ms, max {max(lats):.2f} ms")
        st = server.batcher.stats()
        print(f"phase 7 burst: {BURST_ROUNDS} rounds of {len(jobs)} POST "
              f"/synthesize from 8 client threads ({audio_s:.2f} s of audio "
              f"a round); " + "; ".join(rounds) + f"; all "
              f"{len(pooled)} client latencies p50 {_pct(pooled, 0.5):.2f} "
              f"ms, p95 {_pct(pooled, 0.95):.2f} ms, max {max(pooled):.2f} "
              f"ms; batch_size_hist (all rounds) {st['batch_size_hist']}, "
              f"mean_batch_size {st['mean_batch_size']:.3f}, server "
              f"latency_ms {st['latency_ms']} ({card})", flush=True)

        # 3. one stream, read chunk by chunk
        conn = http.client.HTTPConnection(host, port, timeout=300)
        t0 = time.perf_counter()
        conn.request("POST", "/synthesize_stream",
                     body=json.dumps({"text": three}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"stream status {resp.status}")
        pieces, ttfa_ms = [], None
        while True:
            size = int(resp.fp.readline().strip(), 16)
            if size == 0:
                resp.fp.readline()
                break
            pieces.append(np.frombuffer(resp.fp.read(size), "<i2"))
            resp.fp.readline()
            if ttfa_ms is None:
                ttfa_ms = (time.perf_counter() - t0) * 1e3
        stream_ms = (time.perf_counter() - t0) * 1e3
        conn.close()
        n = n_chunks[three]
        check(len(pieces) == 2 * n - 1, f"{len(pieces)} stream chunks for "
                                        f"{n} sentence chunks")
        audio = pieces[0::2]
        check(all(len(a) > 0 and len(a) % hop == 0 for a in audio),
              "stream chunk lengths = frames x hop")
        check(all(len(g) == gap and not g.any() for g in pieces[1::2]),
              "stream gaps are silence of the stated length")
        total = sum(len(x) for x in pieces)
        check(total == sum(len(a) for a in audio) + (n - 1) * gap,
              "stream length = chunks + gaps")
        print(f"phase 7 stream: {n} chunks, {total} samples; client time to "
              f"first audio {ttfa_ms:.2f} ms, whole response "
              f"{stream_ms:.2f} ms; server ttfa_ms "
              f"{server.batcher.stats()['ttfa_ms']} ({card})", flush=True)

        # the stream's first chunk alone through the server (fused path)
        first = pipe._chunk_long_text(three, pipe.phoneme_buckets[-1])[0]
        first_req_ms = statistics.median(
            _post(host, port, "/synthesize", {"text": first, "seed": 0})[3]
            * 1e3 for _ in range(5))

        # 4. a seeded request through the server
        seeded_text, seed = SERVE_TEXTS[5], 1234
        status, _, body, _ = _post(host, port, "/synthesize",
                                   {"text": seeded_text, "seed": seed})
        check(status == 200, f"seeded status {status}")
        served = _wav_pcm(body)[1]
    finally:
        server.stop()
    check(not server.batcher.healthy(), "server stopped")
    direct = pipe.synthesize(seeded_text, seed=seed, fused=True)
    want = host_pcm16(direct)
    check(len(served) == len(want), "seeded lengths")
    d_peak = float(np.abs(direct).max())
    err = float(np.abs(served.astype(np.float64) - want).max()) / 32767.0
    check(err <= 1e-6 * d_peak,
          f"server vs direct {err} <= 1e-6 x peak {d_peak}")
    print(f"phase 7 seeded request: server WAV vs synthesize(seed={seed}, "
          f"fused=True) on the card, both through PCM16: max-abs {err:.3e} "
          f"(peak {d_peak:.3f}); bitwise equal "
          f"{bool(np.array_equal(served, want))}", flush=True)

    # dispatch/collect overlap: two slices of 8 rows, back to back vs
    # slice 2 dispatched before slice 1 is collected (the batcher's order)
    rows = [SERVE_TEXTS[4 + i % 3] for i in range(8)]

    def sequential():
        for _ in range(2):
            pipe._batched_collect(pipe._batched_dispatch(rows, seed=0,
                                                         pcm16=True))

    def overlapped():
        h1 = pipe._batched_dispatch(rows, seed=0, pcm16=True)
        h2 = pipe._batched_dispatch(rows, seed=0, pcm16=True)
        pipe._batched_collect(h1)
        pipe._batched_collect(h2)

    seq_ms = time_host_ms(sequential)
    ovl_ms = time_host_ms(overlapped)
    seq2_ms = time_host_ms(sequential)
    print(f"phase 7 two slices of 8 rows: dispatch+collect back to back "
          f"{seq_ms:.2f} / {seq2_ms:.2f} ms, slice 2 dispatched before "
          f"slice 1 is collected {ovl_ms:.2f} ms (median of 5; {card})",
          flush=True)
    # cuDNN's execution plans are kept per thread: a shape warmed on this
    # thread is cold on a new one
    def on_new_thread():
        times = []

        def run():
            with torch.inference_mode():
                for _ in range(2):
                    t1 = time.perf_counter()
                    pipe.synthesize(first, seed=0, fused=True, pcm16=True)
                    times.append((time.perf_counter() - t1) * 1e3)

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=300)
        check(len(times) == 2, "new-thread calls finished")
        return times

    warm_ms = time_host_ms(lambda: pipe.synthesize(first, seed=0, fused=True,
                                                   pcm16=True))
    cold = on_new_thread()
    print(f"phase 7 per-thread warmup: the first stream chunk's fused shape, "
          f"warmed on this thread, {warm_ms:.2f} ms here (median of 5); on a "
          f"new thread its first call {cold[0]:.2f} ms, second "
          f"{cold[1]:.2f} ms ({card})", flush=True)

    # what the stream's time to first audio is made of
    chunk_ms = time_host_ms(lambda: pipe._chunk_long_text(
        three, pipe.phoneme_buckets[-1]))
    first_ms = time_host_ms(lambda: pipe.synthesize(
        first, seed=0, fused=True, pcm16=True))
    n_ids = len(pipe._text_to_ids_cached(first))
    budget = pipe._fused_frame_budget(np.asarray([n_ids]))
    print(f"phase 7 stream parts: sentence chunking of the text (host "
          f"frontend, on the handler thread) {chunk_ms:.2f} ms; fused "
          f"synthesize of the first chunk ({n_ids} phonemes, frame budget "
          f"{budget}, {len(pipe.synthesize(first, seed=0)) // hop} frames "
          f"kept) {first_ms:.2f} ms; the same chunk as one POST "
          f"/synthesize {first_req_ms:.2f} ms (medians of 5; {card})",
          flush=True)
    profile_line("phase 7 two slices of 8 rows, overlapped", overlapped, card)
    profile_line("phase 7 fused request (first stream chunk)",
                 lambda: pipe.synthesize(first, seed=0, fused=True,
                                         pcm16=True), card)

    # 5. streaming vocoding against the whole-mel call
    rng = np.random.default_rng(7)
    n_mels = pipe.config.hifigan.in_channels
    mel = rng.normal(-3.0, 2.0, (700, n_mels)).astype(np.float32)
    full = pipe.vocode(mel)
    chunks = list(pipe.vocode_streaming(mel, chunk_frames=64))
    got = np.concatenate(chunks)
    check(got.shape == full.shape, "streamed length")
    v_peak = float(np.abs(full).max())
    v_err = float(np.abs(got.astype(np.float64) - full).max())
    check(v_err <= 1e-5 * v_peak,
          f"vocode_streaming vs vocode {v_err} <= 1e-5 x peak {v_peak}")
    pcm_chunks = np.concatenate(list(pipe.vocode_streaming(
        mel, chunk_frames=64, pcm16=True)))
    check(bool(np.array_equal(pcm_chunks, host_pcm16(got))),
          "pcm16 streaming = host PCM16 of the float stream")
    lsb = int(np.abs(pcm_chunks.astype(np.int32) - host_pcm16(full)).max())
    check(lsb <= 1, f"pcm16 streaming vs PCM16 of vocode: {lsb} LSB")
    ctx = receptive_radius_frames(pipe.config.hifigan)
    window = 64 + 2 * ctx
    with torch.inference_mode():
        mel_d = torch.from_numpy(mel).to(dev)
        win_ms = time_cuda_ms(lambda: pipe._vocode_window(
            mel_d[None, 100:100 + window], ctx * hop, 64 * hop, False),
            reps=20, warmup=3, graph=False)
        full_ms = time_cuda_ms(lambda: pipe._vocode_device(mel_d[None]),
                               reps=20, warmup=3, graph=False)
    print(f"phase 7 vocode_streaming: 700 frames in {len(chunks)} chunks of "
          f"64 frames ({window}-frame windows) vs vocode: max-abs "
          f"{v_err:.3e} = {v_err / v_peak:.3e} of the peak {v_peak:.3f}; "
          f"pcm16 variant (conv_post scaled, as above) equals the host "
          f"PCM16 of the float stream and is within {lsb} LSB of PCM16 "
          f"vocode; one window {win_ms:.3f} ms, whole mel {full_ms:.3f} ms "
          f"(device, 20 calls back to back; {card})", flush=True)

    # 6. save and load on the card
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_save_")
    try:
        want = pipe.synthesize(SENTENCE, temperature=0.0)
        pipe.save(Path(tmp.name) / "full")
        pipe.save(Path(tmp.name) / "half", half=True)
        again = TTSPipeline.load(Path(tmp.name) / "full", device=dev)
        check(next(again.model.parameters()).device.type == dev.type,
              "loaded onto the card")
        same = np.array_equal(again.synthesize(SENTENCE, temperature=0.0),
                              want)
        check(same, "save/load synthesize bitwise equal")
        half = TTSPipeline.load(Path(tmp.name) / "half", device=dev)
        h = half.synthesize(SENTENCE, temperature=0.0)
        check(h.shape == want.shape, "half-precision length")
        h_err = float(np.abs(h.astype(np.float64) - want).max())
        w_peak = float(np.abs(want).max())
        check(h_err <= 1e-2 * w_peak,
              f"half-precision load {h_err} <= 1e-2 x peak {w_peak}")
        print(f"phase 7 save/load on the card: temperature 0 bitwise equal "
              f"{same}; half=True max-abs {h_err:.3e} = "
              f"{h_err / w_peak:.3e} of the peak", flush=True)
    finally:
        tmp.cleanup()
    return mel_cuda.log_mel_cuda.launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    import iris_tts_tpu_torch
    from iris_tts_tpu_torch import AudioConfig, IrisConfig
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.ops.stft import (
        log_mel_spectrogram,
        log_mel_spectrogram_plain,
        mel_filterbank,
        padded_window,
    )

    card = card_line()
    dev = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = mel_cuda.build_library()
    mel_cuda._library()
    build_s = time.perf_counter() - t0
    ptxas = lib_path.with_suffix(".ptxas.txt")
    ptxas_info = " | ".join(
        ln.strip() for ln in ptxas.read_text().splitlines()
        if "registers" in ln or "spill" in ln) if ptxas.exists() else "n/a"
    print(f"phase 1 build: log_mel.cu -> {lib_path.name} in {build_s:.1f} s; "
          f"ptxas: {ptxas_info}", flush=True)

    # -- 2. kernel vs plain, with the cuFFT yardstick ----------------------
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in f32
    cfg = AudioConfig()
    tables = mel_cuda.kernel_tables(cfg)
    window = torch.from_numpy(padded_window(cfg.n_fft, cfg.win_length)).to(dev)
    fb_t = torch.from_numpy(mel_filterbank(
        cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax).T.copy()
    ).to(dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    sr = cfg.sample_rate
    t = torch.arange(10 * sr) / sr
    tone = 0.4 * torch.sin(2 * torch.pi * 440 * t)

    def clip(*shape):
        return tone[:shape[-1]] + 0.05 * torch.randn(*shape, generator=gen)

    inputs = {
        "single_10s": clip(10 * sr),
        "short": clip(4000),          # 16 frames: one group of the kernel
        "tiny_300": clip(300),        # 2 frames, both in the padding
        "batch3_odd": clip(3, 70001),  # odd row length
        "batch8_10s": clip(8, 10 * sr),
    }
    worst = 0.0
    timing = {}
    for name, audio in inputs.items():
        a = audio.to(dev)
        got = log_mel_spectrogram(a, cfg)
        torch.cuda.synchronize()
        want = log_mel_spectrogram_plain(a, cfg)
        lib = log_mel_library(a, cfg, window, fb_t)
        err = max_abs(got, want)
        lib_err = max_abs(lib, want)
        worst = max(worst, err)
        check(bool(torch.isfinite(got).all()), f"finite log-mel ({name})")
        check(err <= 2e-3, f"kernel vs plain max-abs {err} <= 2e-3 ({name})")
        check(lib_err <= 2e-3,
              f"yardstick vs plain max-abs {lib_err} <= 2e-3 ({name})")
        k_ms = time_cuda_ms(lambda: mel_cuda.log_mel_cuda(a, cfg))
        p_ms = time_cuda_ms(lambda: log_mel_spectrogram_plain(a, cfg))
        l_ms = time_cuda_ms(lambda: log_mel_library(a, cfg, window, fb_t))
        e_ms = time_cuda_ms(lambda: mel_cuda.log_mel_cuda(a, cfg),
                            graph=False)
        flops, nbytes = log_mel_work(a.shape[0] if a.dim() > 1 else 1,
                                     a.shape[-1], cfg, tables)
        b_ms, b_by = bound(flops, nbytes)
        timing[name] = (k_ms, p_ms, l_ms, b_ms, b_by)
        print(f"phase 2 log-mel {name} {tuple(a.shape)} -> "
              f"{tuple(got.shape)}: max-abs {err:.3e} (yardstick "
              f"{lib_err:.3e}); kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
              f"cuFFT yardstick {l_ms:.5f} ms, bound {b_ms:.5f} ms "
              f"({b_by}; {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB), "
              f"kernel/bound {k_ms / b_ms:.2f}x; kernel issued eagerly "
              f"{e_ms:.5f} ms a call (device times: CUDA graph of 200 "
              f"calls; {card})", flush=True)
    b8 = inputs["batch8_10s"]
    k_ms, p_ms, l_ms, bound_ms, bound_by = timing["batch8_10s"]
    d_flops, d_bytes = dense_dft_work(b8.shape[0], b8.shape[1], cfg)
    d_ms, d_by = bound(d_flops, d_bytes)
    print(f"phase 2 bound at batch8_10s: FFT count {bound_ms:.5f} ms "
          f"({bound_by}), kernel {k_ms / bound_ms:.2f}x it; the dense-DFT "
          f"count of the first design {d_flops / 1e9:.2f} GFLOP, "
          f"{d_bytes / 1e6:.2f} MB -> {d_ms:.4f} ms ({d_by}); worst kernel "
          f"max-abs {worst:.3e}",
          flush=True)

    # -- main path: phases 3 and 4 ------------------------------------------
    mel_cuda.log_mel_cuda.launches = 0

    # 3. synthesis at full width
    t0 = time.perf_counter()
    pipe = TTSPipeline.initialize(IrisConfig(), seed=0)
    print(f"phase 3 init: full-width pipeline "
          f"({sum(p.numel() for p in pipe.model.parameters()) / 1e6:.2f} M "
          f"params) in {time.perf_counter() - t0:.1f} s", flush=True)
    hop = pipe.config.hifigan.total_upsample
    audio, mel = pipe.synthesize(SENTENCE, seed=1, return_mel=True)
    check(len(audio) == mel.shape[0] * hop and len(audio) > 0,
          "fused audio length = n_frames x hop")
    check(bool(np.isfinite(audio).all()), "fused audio finite")
    check(float(np.abs(audio).max()) > 0.0, "fused audio not silent")
    fused_ms = time_host_ms(lambda: pipe.synthesize(SENTENCE, seed=1))
    print(f"phase 3 fused: {len(audio)} samples ({mel.shape[0]} frames), "
          f"rms {float(np.sqrt(np.mean(audio ** 2))):.3e}; latency "
          f"{fused_ms:.2f} ms (median of 5; {card})", flush=True)
    outs, mels = pipe.synthesize(BATCH, seed=2, return_mel=True)
    check(len(outs) == len(BATCH), "batch row count")
    for a, m in zip(outs, mels):
        check(len(a) == m.shape[0] * hop and len(a) > 0,
              "batch audio length = n_frames x hop")
        check(bool(np.isfinite(a).all()), "batch audio finite")
        check(float(np.abs(a).max()) > 0.0, "batch audio not silent")
    batch_ms = time_host_ms(lambda: pipe.synthesize(BATCH, seed=2))
    print(f"phase 3 two-stage batch of {len(BATCH)}: frames "
          f"{[m.shape[0] for m in mels]}; latency {batch_ms:.2f} ms "
          f"(median of 5; {card})", flush=True)

    # 4. copy synthesis through the kernel
    feats = log_mel_spectrogram(torch.from_numpy(audio).to(dev), cfg)
    check(feats.shape == (1 + len(audio) // hop, cfg.n_mels),
          "log-mel shape")
    resynth = pipe.vocode(feats)
    check(len(resynth) == feats.shape[0] * hop, "vocoded length")
    check(bool(np.isfinite(resynth).all()), "vocoded audio finite")
    print(f"phase 4 copy synthesis: {len(audio)} samples -> log-mel "
          f"{tuple(feats.shape)} -> {len(resynth)} samples", flush=True)
    launches = mel_cuda.log_mel_cuda.launches
    check(launches >= 1, "the main path launched the log-mel kernel")

    # -- 5. card vs CPU ----------------------------------------------------
    cpu = TTSPipeline.initialize(IrisConfig(), seed=0, device="cpu")
    a_gpu, m_gpu = pipe.synthesize(SHORT, temperature=0.0, return_mel=True)
    a_cpu, m_cpu = cpu.synthesize(SHORT, temperature=0.0, return_mel=True)
    check(m_gpu.shape == m_cpu.shape, "card and CPU frame counts")
    wave_err, mel_err = max_abs(a_gpu, a_cpu), max_abs(m_gpu, m_cpu)
    peak = float(np.abs(a_cpu).max())
    check(wave_err <= 1e-3, f"card vs CPU waveform max-abs {wave_err}")
    # Random-weight audio is small (HiFiGAN's normal(0.01) init), so hold
    # the error relative to the peak to the same 1e-3 as well.
    check(wave_err <= 1e-3 * peak,
          f"card vs CPU waveform max-abs {wave_err} <= 1e-3 x peak {peak}")
    check(mel_err <= 1e-3, f"card vs CPU mel max-abs {mel_err}")
    print(f"phase 5 card vs CPU ({m_cpu.shape[0]} frames): waveform max-abs "
          f"{wave_err:.3e} (peak {peak:.3e}, relative "
          f"{wave_err / max(peak, 1e-30):.3e}), mel max-abs {mel_err:.3e}",
          flush=True)

    # -- 6. training at full width (the training path) ----------------------
    train_launches = phase6_training(dev, card)

    # -- 7. serving at full width (the serving path) ------------------------
    serve_launches = phase7_serving(dev, card)

    # -- where the time goes: one fused synthesize under the profiler --------
    profile_line("fused synthesize", lambda: pipe.synthesize(SENTENCE, seed=1),
                 card)

    jax_pkg = iris_tts_tpu_torch.__name__.removesuffix("_torch")
    kernels = [{
        "name": "log_mel",
        "route": "cuda",
        "source": "iris_tts_tpu_torch/ops/csrc/log_mel.cu",
        "replaces": f"{jax_pkg}/ops/mel_pallas.py:110",
        "launches": launches + train_launches + serve_launches,
        "launches_by_path": {"synthesis": launches,
                             "training": train_launches,
                             "serving": serve_launches},
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": l_ms,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
