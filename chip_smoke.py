"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port (``iris_tts_tpu_torch``) through the entry points a user
calls, at the full default width with seeded random weights (phase 17:
the shipped trained weights, at the same widths), and holds every kernel
against its plain PyTorch version:

1. build the log-mel kernel (``iris_tts_tpu_torch/ops/csrc/log_mel.cu``)
   from the sources in this checkout;
2. kernel vs plain version on 10 s audio, a 4000-sample clip, a
   300-sample clip (both frames in the padding), a batch of 3 with an odd
   length and a batch of 8 × 10 s (max-abs ≤ 2e-3), with the times of the
   kernel, the plain version and a cuFFT yardstick (``torch.stft`` then
   magnitude, mel matmul and log; the port never calls it) and the
   kernel's bound;
2b. build the MRF resblock kernel (``ops/csrc/mrf_resblock.cu``) and hold
   it against its plain version (the cuDNN + elementwise composition it
   replaces) at the main path's shapes, 32 rows x 742 frames: V2's 16- and
   8-channel stages on the narrow plan, V1's four stages (256 to 32
   channels) and V2's 64- and 32-channel ones on the wide plan, unit-gain
   weights (max-abs <= 1e-5 of the peak), with the times of both and the
   kernel's FFMA bound;
2c. build the anti-aliased activation kernel (``ops/csrc/
   amp_activation.cu``) and hold it against its plain version (the
   composition of pads, depthwise convs and SnakeBeta it replaces) at
   BigVGAN-v2's six stage shapes, 32 rows x 768 frames, TF32 off
   (max-abs <= 1e-5 of the peak), with the times of both and the
   kernel's byte bound; then one sentence and a batch of 4 through a
   full-width BigVGAN-v2 pipeline (seeded weights), its launches zeroed
   just before and read just after: 109 a vocoder call;
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
   the card and on the CPU (HiFiGAN at V2's widths, 64 to 8 channels, the
   narrowest the MRF kernel takes in the discriminator step's no-grad
   generation), losses and gradients held together (≤ 1e-4 of the largest
   |g|);
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
   within 1e-2 of the peak). The server stops in a ``finally``;
8. ahead-of-time serving at full width (phase 7's seeded, scaled weights):
   ``export_pipeline`` on the card for batch (1, 8) × phoneme buckets
   (16 … 128) and a 64-frame vocoder window into a temporary directory;
   ``AotPipeline`` loads the programs (no model code) and captures each as
   a CUDA graph, the smallest first and the rest on a background thread,
   and one request to the captured bucket while the rest capture (it
   replays under the replay lock, not behind a capture);
   every bucket's graph vs the live fused function at the bucket's frame
   budget (≤ 1e-6 of the peak); ``AotPipeline.synthesize`` of one sentence
   and of a batch of 3 vs the live fused ``synthesize`` (equal lengths;
   ≤ 1e-6 of the peak for the sentence, ≤ 1e-5 for the batch, which runs
   in the B=8 program); one request's latency,
   live eager beside graph replay (and the replay's device time); a
   bucket's first replay on a new thread; ``TTSServer`` over the artifact
   (phase 7's bursts, stream and a seeded request, printed beside phase
   7's); ``python -m iris_tts_tpu_torch.serve --aot`` in a child process
   (boots, clamps the batch, answers one request bitwise as
   ``AotPipeline.synthesize``, exits 0 on SIGINT); the window program vs
   the live ``vocode_streaming`` (≤ 1e-6 of the peak). Both servers stop
   in a ``finally``;
9. bf16 and remat: phase 3's pipeline in bf16 over the same weights against
   f32 at temperature 0 under the JAX package's gate (mel max|Δ| < 0.05,
   mean < 0.01, audio < 1e-3), fused for the sentence and two-stage for the
   batch of 4; per-phoneme frames equal wherever the f32 value is clear of
   a rounding boundary, and a text whose frame count bf16 moves is gated
   on f32's integer frames; fused latency and two 8-row slices in both
   dtypes, with profiles and the bf16-kernel share of device time; the VAE
   step and the GAN round on phase 6's fixed batches in f32, bf16 and bf16
   + remat (median step of steps 4–20, peak memory, falling losses, f32
   params); one bf16 AOT bucket (B=1, P=32) whose graph replay equals the
   live bf16 fused function bitwise; bf16 copy synthesis through the
   log-mel kernel, and the kernel on bf16 audio against the plain version
   (bf16 out, within one bf16 ulp or the kernel's 2e-3);
10. the command-line drivers, in-process through their ``main(argv)`` at
   full width on their default device (the card): ``make_synthetic_corpus
   --n 32``; ``train_full_pipeline`` (batch 16, one epoch a stage, GAN on
   16 × 32-frame segments, four eval samples, fp16 artifact) with finite
   held-out MCD/LSD/control/duration MAE, the artifact's smoke-eval, stage
   and eval seconds and the DTW's share; the log-mel launches on this path
   counted exactly (one a cached clip, one a scored resynthesis), every
   cached mel and each resynthesis mel within 2e-3 of the plain version;
   ``python -m iris_tts_tpu_torch.scripts.synthesize --artifact`` in a child
   process (wall time from cold), ``--use_griffin_lim`` (60 iterations,
   timed on the card); ``batch_synthesize --random_weights
   --num_utterances 64 --batch_size 16`` twice (cold, warm) with the
   meter's realtime factor, mel frames a second and p50 / p90;
11. multi-device on the one card (``iris_tts_tpu_torch.parallel``), its
   ranks child processes of this script (``--mesh-rank``), each joined
   by a deadline and killed in a ``finally``; a failed rank fails the
   phase. 11a: NCCL at world size 1 (``IrisConfig()``, phase 7's scaled
   weights): ``use_mesh`` synthesis of 8 sentences at temperature 0.667
   (two-stage and fused) and ``vocode_sharded`` of 700 frames bitwise the
   off-mesh calls; one SGD step of each stage (duration, VAE with the
   frozen encoder, PostNet, GAN round; batch 16, full-width MPD/MSD)
   through ``mesh_training_placement`` bitwise the one-process step (with
   deterministic kernels), every collective of those paths called on NCCL
   (a process group's one-rank mesh still calls them) and listed by path;
   the train loop's host-agreed stop flag and the NCCL all-reduce of the
   full model's gradient bucket, timed. 11b: gloo at world size 2, both ranks on
   ``cuda:0`` (NCCL refuses two ranks on one GPU): the same 8 sentences,
   4 a rank, against the one-process batch (≤ 1e-5 of the peak, equal
   lengths); ``vocode_sharded`` of 700 frames against ``vocode`` (≤ 1e-5)
   and its PCM16 variant (≤ 1 LSB); ``PipelineParallelSynthesizer(split=
   1)`` on three batches against the fused path (≤ 1e-5); three SGD steps
   of each stage, 8 rows a rank, against one process (params, and
   PostNet's running statistics apart, within ``MESH_TRAIN_SHARE`` of the
   largest change the one-process steps made; metrics within 1e-5
   relative), while the same steps with the gradient all-reduce planted
   out must read above that limit, with the step times; the stop flag and
   the gloo all-reduce of the gradient bucket, timed; ``train_full_pipeline --mesh`` with phase 10's flags on
   a 32-utterance corpus: the log-mel launches counted exactly (32 for
   the cache on rank 0, 0 on rank 1, then rank 0's eval), every cached mel
   within 2e-3 of the plain version, only rank 0 evaluating and writing
   the artifact, its held-out MCD/LSD beside phase 10's; which collective
   each path took, and each rank's wall time. 11c: the model axis, gloo
   at world size 2 on the one card as a 1×2 (data, model) mesh
   (``IrisConfig()``, phase 7's scaled weights): ``use_mesh`` two-stage and
   fused on the 8 sentences, the fused sentence and ``vocode_sharded`` of
   700 frames against one process (≤ 1e-5 of the peak); the parameter
   bytes a rank (the sharded leaves exactly half, counted), each rank's
   peak memory, one-process vs tensor-parallel ms; three SGD steps of each
   stage (GAN round with both states sharded) against one process within
   ``MESH_TRAIN_SHARE``, and the same steps with the model axis'
   input-gradient sum planted out reading above it; the collectives by
   path. 11d: ``python -m iris_tts_tpu_torch.serve --mesh --backend gloo``
   as two rank processes on the card (data axis; rank 0 serves, rank 1
   follows) answers a burst of 8 seeded requests from 8 threads, each WAV
   within 1e-5 of the peak of a one-process ``TTSServer``'s on the same
   weights, with both p50s, and the follower's device calls equal rank
   0's; rank 0 stops on SIGINT and both exit 0;
12. G2P training, the checkpoint converters and native WAV IO: 12a the
   shipped G2P checkpoint greedy-decodes the whole held-out split
   (crc32 % 50 == 0) on the card in batches of 512, at most 0.1% of the
   words apart from the host NumPy decoder, PER and exact match beside the
   manifest's; 12b ``train_g2p.main`` at the default ``G2PConfig`` on the
   whole dictionary, batch 512, two epochs into a temporary file (loss by
   epoch falling, epoch seconds, a synchronized fixed-batch step, val PER,
   peak memory; the checkpoint's keys and shapes are the shipped one's and
   ``NeuralG2P`` decodes with it; the shipped file stays as it was); 12c
   the oracle ``TorchGenerator`` at ``HiFiGANConfig()``, seeded, saved in
   speechbrain nesting, through ``load_pretrained_hifigan`` on the card,
   87 frames against the oracle's forward there (max-abs ≤ 1e-3), then
   ``TTSPipeline.from_checkpoints`` over phase 10's trained stages with
   ``hifigan_checkpoint=`` synthesizes a sentence; 12d ``demo_vocoder``
   on the card (its one log-mel launch counted, the kernel held against
   the plain version on its tone to 1e-4 of each frame's peak in linear
   mel: most of a pure tone's bins sit near the log floor) and
   ``hifigan_integration`` exits 0; 12e
   the native WAV library builds from the port's ``wavio.cpp`` and
   ``read_wav_batch`` of 32 clips equals the Python reader exactly, with
   both times;
13. the C++ serving host (``iris_tts_tpu_torch/serve/csrc/aoti_runner.cpp``)
   at full width (phase 7's seeded, scaled weights, f32):
   ``export_pipeline(native=True)`` on the card for batch 1 × phoneme
   buckets (16, 32) (AOTInductor compile seconds a bucket; no TF32 in the
   generated code) while g++ builds the host from the checkout
   (``serve/native.build_host``; no libpython among its NEEDED entries),
   both in a child process of this script (``--native-export DIR``)
   started before phase 11, so that the compile overlaps phases 11 and 12;
   the host's ``--probe``; then ``--artifact DIR --device cuda:0 --npy`` as
   a child process over stdin: the JAX host's three requests
   (``tests/test_pjrt_runner.py``) and a seeded burst of 16 text requests
   whose durations lie clear of a rounding boundary; no error reply, WAVs
   of 22 050 Hz with n_frames × 256 samples, routing 16 → 32, each reply's
   ids the Python frontend's and its n_frames and deficit
   ``ExportedSynthesizer``'s, each audio within 1e-5 of the peak of
   ``ExportedSynthesizer`` on the same seed and temperature; boot to the
   ready line, server-side and client-side request ms and the device
   memory the host took, beside the same text requests through
   ``AotPipeline``'s graph replay and ``ExportedSynthesizer``'s eager
   programs on the same artifact, and phase 8's ``serve --aot`` child;
14. the diagnostics and pre-flight tools, in-process through their
   ``main(argv)`` at full width on the card, over phase 10's corpus and
   stage checkpoints: ``test_encoder_setup`` (the corpus, ``SETUP OK``),
   ``test_vae_setup`` (shapes, zero-initialised logvar, ``generate()``,
   flow invertibility), ``debug_vae_loss`` (the train step, its recompute
   and the raw arithmetic agree), ``test_trained_encoder`` (duration MAE
   / RMSE / correlation and the verdict), ``validate_vae_checkpoint``
   (eval metrics, posterior-mean MCD/LSD, the verdict, the generation
   smoke check), ``analyze_vae`` (per-utterance reconstruction, prior and
   random-conditioning generations), ``test_synthesis`` (ground-truth
   durations, MSE/MAE, quality, Griffin-Lim on the card, both wavs) and
   ``example``; each tool that reads the validation mels gets a fresh
   cache, so they go through the kernel: its launches counted exactly
   and every cached mel within 2e-3 of the plain version;
15. the speed-of-light, memory and vocoder-profile tools, in-process
   through their ``main(argv)`` on the card: ``roofline`` at B=8, T=1024,
   P=256 in f32 and bf16 (each stage's FLOPs and eager bytes, its bound at
   the data-sheet peaks), the same fused dispatch's device time (CUDA
   events) and t_sol / measured; the f32 vocoder's count at B=1, T=32 on
   the card equal to the CPU's; ``mem_analysis`` for the VAE and GAN steps
   at the JAX tool's defaults in f32 and bf16 (the allocator's rows beside
   the tracker's for the same steps, phase 9's GAN round peaks beside
   them); ``profile_vocoder`` at 12 s × 8 in bf16 and f32; after the
   profile line, phase 3's sentence counted at its fused frame budget
   beside the profile's device busy time;
16. the benchmark drivers, in-process through their ``main(argv)`` on the
   card: ``python -m iris_tts_tpu_torch.bench`` (its two cold-start child
   processes, the AOT export and a fresh process to first audio; B=8 and
   B=128 × 1024 frames in bf16, the fused and public-API p50s, the
   roofline of the B=128 dispatch: ``sol_fraction`` ≤ 1),
   ``bench_batch_sweep --batches 1,8,32``, ``bench_serve`` on phase 7's
   cut ladders (closed loop of 16 clients × 8 requests in-process and over
   ``--http``, and ``--ab_max_batch_limit 16`` at 20 req/s open loop, 300
   requests a configuration: every request completed; then what the
   slowest requests wait for: the same closed loop twice on one batcher,
   its text frontend cold and then warm, and each text through a fresh
   frontend alone, the neural G2P's checkpoint load on the first
   out-of-lexicon word),
   ``bench_stream`` in f32 and ``--pcm16`` (the stream within
   1e-5 of the full pass's peak, one LSB), ``bench_train`` for the VAE
   step and the GAN round in f32 and ``--bf16``, and ``bench_mel`` at its
   defaults (the kernel's launches counted exactly, every output within
   2e-3 of the plain version); each JSON line parsed, its rates and
   times positive, and the phase's wall time;
17. the shipped trained model (``release/pipeline_artifact``, the JAX
   package's orbax directory, float16 params) through the port alone:
   the zstd decoder built with g++ from ``convert/csrc/zstd_decode.cpp``;
   ``convert/orbax.read_tree`` (decode and assembly seconds, MB/s) and
   its SHA-256 equal to ``RELEASE_PARAMS_SHA256``, which a CPU test
   computes from orbax's own restore; ``TTSPipeline.load`` onto the card
   (seconds); ``tests/test_torch_release.py``'s four sentences at
   temperature 0: f32 frame totals exactly 99, 65, 111 and 216, bf16
   totals equal per phoneme away from a rounding boundary (phase 9's
   rule), f32 audio within 1e-3 of the port's CPU run of the same load;
   the log-mel kernel on the trained f32 audio (held against the plain
   version) and the mean L1 between that log-mel and the model's mel,
   beside the same L1 through phase 3's random weights;
   ``synthesize --artifact`` in a child process (cold seconds to the wav);
   eight concurrent requests through a ``DynamicBatcher`` over the
   trained pipeline, warmed on phase 7's cut ladders (p50 and max).

Fifteen paths drive the kernel, or not: synthesis (phases 3 and 4),
training (phase 6), serving (phase 7), AOT serving (phase 8), bf16
(phase 9's copy synthesis), the command line (phase 10), the data-axis
mesh (phases 11a and 11b, counted in their rank processes), the model
axis (11c, counted in its rank processes), ``serve --mesh`` (11d,
counted in its two rank processes, read from their logs), the demo
vocoder (12d), the C++ host (13), the diagnostics (14), the analysis
tools (15), the benchmark drivers (16, where ``bench_mel`` alone
computes log-mels) and the trained model (17: the four sentences and
the same through phase 3's weights, 8 launches); the serving paths, the
model axis, the C++ host and the analysis tools compute no log-mel: 0
launches. Each path's
launch counts are zeroed just before it and read just after, and a
kernel of the path that was not launched fails the run. The MRF kernel's
launches are counted the same way, path by path; synthesis (a multiple
of 72 a V1 vocoder call: two a layer, a conv each, of its four stages),
serving, the analysis tools
and the trained model must launch it. The activation
kernel runs on BigVGAN's path alone (phase 2c); the HiFiGAN paths above
do not launch it.
The last three lines are the card's name and power limit, a
``{"kernels": [...]}`` JSON line, and ``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero; so does a host without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import signal
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
# Phase 8's grid: batch buckets x SERVE_PHONEME_BUCKETS, and the vocoder
# window's chunk (the depth cut; widths stay full).
AOT_BATCH_SIZES = (1, 8)
AOT_WINDOW_CHUNK = 64
# AotPipeline.synthesize vs the live fused synthesize, of the peak: one
# sentence runs at the live path's batch of 1; a batch of 3 runs in the
# B=8 program, where cuDNN picks other convolution algorithms than for the
# live path's B=3 (2.2e-6 measured on the H100; at equal shapes the graphs
# are bitwise equal to the live function).
AOT_LIVE_LIMIT = 1e-6
AOT_PADDED_BATCH_LIMIT = 1e-5
# Phase 10's corpus (make_synthetic_corpus --n).
CLI_CORPUS = 32
# Phase 2b: the MRF kernel's stages at the main path's shapes, 32 rows x
# 742 frames (the bulk benchmark's batch and frame bucket): name ->
# (channels, samples a frame). Every stage of V1 and V2.
MRF_ROWS, MRF_FRAMES = 32, 742
MRF_STAGES = {"v2_32ch": (32, 64), "v2_16ch": (16, 128), "v2_8ch": (8, 256),
              "v1_32ch": (32, 256), "v1_256ch": (256, 8),
              "v1_128ch": (128, 64), "v1_64ch": (64, 128),
              "v2_64ch": (64, 8)}
MRF_LIMIT = 1e-5  # kernel vs plain max-abs, of the plain output's peak
# A V1 vocoder call's MRF kernel launches: 3 resblocks of 3 layers a stage,
# two (a conv each) a layer at 32-256 channels.
V1_MRF_LAUNCHES = 4 * 9 * 2
# Phase 2c: the activation kernel at BigVGAN-v2's six stages, 32 rows x 768
# frames (the bulk benchmark's batch and frame bucket): name -> (channels,
# samples a frame); the published generator's vocoder config; a call's
# launches (6 stages x 3 resblocks x 6 activations, and activation_post).
AMP_ROWS, AMP_FRAMES = 32, 768
AMP_STAGES = {"768ch": (768, 4), "384ch": (384, 16), "192ch": (192, 32),
              "96ch": (96, 64), "48ch": (48, 128), "24ch": (24, 256)}
AMP_LIMIT = 1e-5  # kernel vs plain max-abs, of the plain output's peak
BIGVGAN_V2 = dict(upsample_rates=(4, 4, 2, 2, 2, 2),
                  upsample_kernel_sizes=(8, 8, 4, 4, 4, 4),
                  upsample_initial_channel=1536, activation="snakebeta")
BIGVGAN_AMP_LAUNCHES = 109
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


def profile_line(label: str, fn, card: str) -> list:
    """Run ``fn`` (which returns host data) once under ``torch.profiler``
    and print its wall time, the device's busy time and share, and the
    kernels with the most device time. Returns the (kernel, device µs)
    rows."""
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
              + "; ".join(f"{k[:110]} {t / 1e3:.2f} ms" for k, t in top)
              + f" ({card})", flush=True)
    else:
        print(f"profile {label}: the profiler recorded no device time (not "
              "measured)", flush=True)
    return dev_rows


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


def mrf_work(batch: int, channels: int, t: int, blocks):
    """(operations, bytes) a stage's MRF needs at least: each conv's
    multiply-adds (two operations each); each layer's input read and
    output written once, the running sum read by the later blocks' last
    layers, and the weights."""
    from iris_tts_tpu_torch.ops import mrf_cuda

    shapes = [tuple(conv.weight.shape) for b in blocks
              for pair in b.layers() for conv in pair]
    flops, _ = mrf_cuda.composition_cost((batch, channels, t), shapes,
                                         len(blocks))
    layers = len(shapes) // 2
    params = sum(co * ci * k + co for co, ci, k in shapes)
    nbytes = 4 * ((2 * layers + len(blocks) - 1) * batch * channels * t
                  + params)
    return flops, nbytes


def phase2b_mrf(dev, card: str) -> dict:
    """The MRF kernel against its plain version (the library composition it
    replaces: cuDNN's convs and PyTorch's elementwise kernels) at the main
    path's shapes (:data:`MRF_STAGES`), with unit-gain weights so every
    layer moves its input; max-abs within :data:`MRF_LIMIT` of the peak,
    and the times of both beside the kernel's bound. Returns the worst
    error and each stage's (ms, plain ms, bound ms, bound by, error)."""
    from iris_tts_tpu_torch.models.hifigan import ResBlock
    from iris_tts_tpu_torch.ops import mrf_cuda
    from iris_tts_tpu_torch.runtime import pin_math_precision

    # The plain version as the port runs it: cuDNN's convs with TF32 off
    # (the kernel ignores the switch; with it on the plain version reads
    # ~2e-4 of the peak away).
    pin_math_precision()
    t_build = time.perf_counter()
    lib_path = mrf_cuda.build_library()
    mrf_cuda._library()
    print(f"phase 2b build: mrf_resblock.cu -> {lib_path.name} in "
          f"{time.perf_counter() - t_build:.1f} s", flush=True)
    g = torch.Generator().manual_seed(20)
    worst, stages = 0.0, {}
    for name, (c, per_frame) in MRF_STAGES.items():
        blocks = []
        for k in (3, 7, 11):
            block = ResBlock(c, k, (1, 3, 5))
            with torch.no_grad():
                for pname, prm in block.named_parameters():
                    std = (0.1 if pname.endswith("bias")
                           else (prm.shape[1] * prm.shape[2]) ** -0.5)
                    prm.copy_(torch.randn(prm.shape, generator=g) * std)
            blocks.append(block.to(dev))
        t = MRF_FRAMES * per_frame
        x = torch.randn((MRF_ROWS, c, t), generator=g).to(dev)
        with torch.inference_mode():
            got = mrf_cuda.mrf_cuda(x, blocks)
            want = mrf_cuda.mrf_plain(x, blocks)
            err = max_abs(got, want)
            peak = float(want.abs().max())
            del got, want
            check(err <= MRF_LIMIT * peak, f"MRF kernel vs plain max-abs "
                  f"{err} <= {MRF_LIMIT} x peak {peak} ({name})")
            # 3 calls after 1: the wide stages take 5-180 ms a call
            k_ms = time_cuda_ms(lambda: mrf_cuda.mrf_cuda(x, blocks), reps=3,
                                warmup=1, graph=False)
            p_ms = time_cuda_ms(lambda: mrf_cuda.mrf_plain(x, blocks),
                                reps=3, warmup=1, graph=False)
        flops, nbytes = mrf_work(MRF_ROWS, c, t, blocks)
        b_ms, b_by = bound(flops, nbytes)
        worst = max(worst, err)
        stages[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "max_abs_err": err, "peak": peak}
        print(f"phase 2b MRF {name} [{MRF_ROWS}, {c}, {t}]: max-abs "
              f"{err:.3e} ({err / peak:.2e} of the peak); kernel {k_ms:.3f} "
              f"ms, plain (cuDNN + elementwise) {p_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}; {flops / 1e12:.4f} TFLOP, "
              f"{nbytes / 1e9:.3f} GB), kernel/bound {k_ms / b_ms:.2f}x, "
              f"plain/kernel {p_ms / k_ms:.2f}x (device times: CUDA events "
              f"around 3 eager calls; {card})", flush=True)
        del x, blocks
        torch.cuda.empty_cache()
    return {"worst": worst, "stages": stages}


def phase2c_amp(dev, card: str) -> dict:
    """The anti-aliased activation kernel against its plain version (the
    composition it replaces: replicate pads, cuDNN's depthwise transposed
    and strided convs, SnakeBeta's elementwise passes) at BigVGAN-v2's
    stage shapes (:data:`AMP_STAGES`), with drawn log-α and log-β; max-abs
    within :data:`AMP_LIMIT` of the peak, and the times of both beside the
    kernel's byte bound. Then a full-width BigVGAN-v2 pipeline synthesizes
    a sentence and a batch, the kernel's launches zeroed just before and
    read just after (:data:`BIGVGAN_AMP_LAUNCHES` a vocoder call). Returns
    the worst error, each stage's (ms, plain ms, bound ms, bound by,
    error) and the synthesis path's launches."""
    import numpy as np

    from iris_tts_tpu_torch import HiFiGANConfig, IrisConfig
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.ops import amp_cuda
    from iris_tts_tpu_torch.runtime import pin_math_precision

    pin_math_precision()  # the plain version's depthwise convs in f32
    t_build = time.perf_counter()
    lib_path = amp_cuda.build_library()
    amp_cuda._library()
    print(f"phase 2c build: amp_activation.cu -> {lib_path.name} in "
          f"{time.perf_counter() - t_build:.1f} s", flush=True)
    g = torch.Generator().manual_seed(21)
    h = amp_cuda.FILTER.to(dev)
    worst, stages = 0.0, {}
    for name, (c, per_frame) in AMP_STAGES.items():
        t = AMP_FRAMES * per_frame
        x = torch.randn((AMP_ROWS, c, t), generator=g).to(dev)
        alpha = (torch.randn(c, generator=g) * 0.5).to(dev)
        beta = (torch.randn(c, generator=g) * 0.5).to(dev)
        with torch.inference_mode():
            got = amp_cuda.amp_cuda(x, alpha, beta)
            want = amp_cuda.amp_plain(x, alpha, beta, h)
            err = max_abs(got, want)
            peak = float(want.abs().max())
            del got, want
            check(err <= AMP_LIMIT * peak, f"activation kernel vs plain "
                  f"max-abs {err} <= {AMP_LIMIT} x peak {peak} ({name})")
            k_ms = time_cuda_ms(lambda: amp_cuda.amp_cuda(x, alpha, beta),
                                reps=5, warmup=2, graph=False)
            p_ms = time_cuda_ms(
                lambda: amp_cuda.amp_plain(x, alpha, beta, h), reps=5,
                warmup=2, graph=False)
        flops, nbytes = amp_cuda.amp_cost(tuple(x.shape))
        b_ms, b_by = bound(flops, nbytes)
        worst = max(worst, err)
        stages[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "max_abs_err": err, "peak": peak}
        print(f"phase 2c activation {name} [{AMP_ROWS}, {c}, {t}]: max-abs "
              f"{err:.3e} ({err / peak:.2e} of the peak); kernel {k_ms:.3f} "
              f"ms, plain (pads + depthwise convs + SnakeBeta) {p_ms:.3f} "
              f"ms, bound {b_ms:.3f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e9:.3f} GB), kernel/bound {k_ms / b_ms:.2f}x, "
              f"plain/kernel {p_ms / k_ms:.2f}x (device times: CUDA events "
              f"around 5 eager calls; {card})", flush=True)
        del x
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pipe = TTSPipeline.initialize(
        IrisConfig(hifigan=HiFiGANConfig(**BIGVGAN_V2)), seed=0)
    n_voc = sum(p.numel() for p in pipe.model.hifigan.parameters())
    print(f"phase 2c init: BigVGAN-v2 pipeline ({n_voc / 1e6:.2f} M vocoder "
          f"params) in {time.perf_counter() - t0:.1f} s", flush=True)
    hop = pipe.config.hifigan.total_upsample
    amp_cuda.amp_cuda.launches = 0
    audio = pipe.synthesize(SENTENCE, seed=1)
    outs = pipe.synthesize(BATCH, seed=2)
    torch.cuda.synchronize()
    launches = amp_cuda.amp_cuda.launches
    for a in [audio] + list(outs):
        check(len(a) > 0 and len(a) % hop == 0,
              "BigVGAN audio length a multiple of the hop")
        check(bool(np.isfinite(a).all()) and float(np.abs(a).max()) <= 1.0,
              "BigVGAN audio finite and clamped")
    check(launches >= BIGVGAN_AMP_LAUNCHES
          and launches % BIGVGAN_AMP_LAUNCHES == 0,
          f"BigVGAN synthesis launched the activation kernel "
          f"{BIGVGAN_AMP_LAUNCHES} times a vocoder call ({launches})")
    print(f"phase 2c BigVGAN synthesis: {len(audio)} samples, a batch of "
          f"{len(outs)} ({[len(a) for a in outs]} samples); activation "
          f"kernel launches {launches} ({launches // BIGVGAN_AMP_LAUNCHES} "
          f"vocoder calls x {BIGVGAN_AMP_LAUNCHES})", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return {"worst": worst, "stages": stages,
            "launches_by_path": {"synthesis_bigvgan": launches}}


@contextlib.contextmanager
def mrf_launches(by_path: dict, path: str):
    """Zero the MRF kernel's launch count, run the block, and keep the
    count under ``path`` in ``by_path``."""
    from iris_tts_tpu_torch.ops import mrf_cuda

    mrf_cuda.mrf_cuda.launches = 0
    yield
    by_path[path] = mrf_cuda.mrf_cuda.launches


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


def phase6_training(dev, card: str):
    """Training at full width (see the module docstring). Returns the
    log-mel kernel's launches on this path, and what phase 9 trains on:
    the config, the VAE stage's fixed batch, KL weight and frozen encoder,
    and the GAN stage's fixed batch."""
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
        states, handoff = {}, {"cfg": cfg}
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
            handoff[name] = (batch, extras, state.frozen)

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
            hifigan_gan_checkpoint=out / "hifigan_gan" / "checkpoints",
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
            hifigan=C.HiFiGANConfig(upsample_initial_channel=128,
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
        return train_launches, handoff
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


def _bursts_and_stream(server, label: str, card: str) -> dict:
    """BURST_ROUNDS bursts of 16 ``POST /synthesize`` from 8 client threads
    (every WAV checked), then one ``POST /synthesize_stream`` of the long
    text read chunk by chunk; prints both and returns their numbers."""
    import http.client
    import threading

    import numpy as np

    host, port = server.address[:2]
    sr = server.batcher._pipe.config.audio.sample_rate
    hop = server.batcher._pipe.config.hifigan.total_upsample
    gap = int(round(server.batcher._gap_ms / 1000.0 * sr))
    n_chunks = {t: len(server.batcher.chunk_text(t)) for t in SERVE_TEXTS}
    three = SERVE_TEXTS[-1]
    check(n_chunks[three] >= 2, f"the long text streams in "
                                f"{n_chunks[three]} chunks")

    # a burst of 16 requests from 8 client threads, three times: with 16
    # requests a round's p95 is its maximum, so each round is printed and
    # the 48 latencies are also pooled
    jobs = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(16)]
    pooled, rounds, xrt = [], [], []
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
        xrt.append(audio_s / burst_s)
        rounds.append(f"round {rnd + 1}: {burst_s:.3f} s, "
                      f"{audio_s / burst_s:.1f}x realtime, p50 "
                      f"{_pct(lats, 0.5):.2f} ms, max {max(lats):.2f} ms")
    st = server.batcher.stats()
    print(f"{label} burst: {BURST_ROUNDS} rounds of {len(jobs)} POST "
          f"/synthesize from 8 client threads ({audio_s:.2f} s of audio "
          f"a round); " + "; ".join(rounds) + f"; all "
          f"{len(pooled)} client latencies p50 {_pct(pooled, 0.5):.2f} "
          f"ms, p95 {_pct(pooled, 0.95):.2f} ms, max {max(pooled):.2f} "
          f"ms; batch_size_hist (all rounds) {st['batch_size_hist']}, "
          f"mean_batch_size {st['mean_batch_size']:.3f}, server "
          f"latency_ms {st['latency_ms']} ({card})", flush=True)

    # one stream, read chunk by chunk
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
    print(f"{label} stream: {n} chunks, {total} samples; client time to "
          f"first audio {ttfa_ms:.2f} ms, whole response "
          f"{stream_ms:.2f} ms; server ttfa_ms "
          f"{server.batcher.stats()['ttfa_ms']} ({card})", flush=True)
    return {"p50": _pct(pooled, 0.5), "p95": _pct(pooled, 0.95),
            "max": max(pooled), "xrt": xrt, "hist": st["batch_size_hist"],
            "ttfa_ms": ttfa_ms, "stream_ms": stream_ms}


def _serving_pipeline(dev, label: str):
    """``IrisConfig()`` at full width with seeded random weights on the cut
    serving ladders. Random HiFiGAN weights give rms ~6.5e-6, which PCM16
    quantizes to zeros: the output conv is scaled so the peak lies near
    0.5 and the PCM16 comparisons see real samples."""
    import numpy as np

    from iris_tts_tpu_torch import IrisConfig
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline

    t0 = time.perf_counter()
    pipe = TTSPipeline.initialize(IrisConfig(), seed=0, device=dev)
    pipe.phoneme_buckets = SERVE_PHONEME_BUCKETS
    pipe.frame_buckets = SERVE_FRAME_BUCKETS
    probe = pipe.synthesize(SENTENCE, temperature=0.0)
    scale = 0.5 / float(np.abs(probe).max())
    with torch.no_grad():
        pipe.model.hifigan.conv_post.weight.mul_(scale)
        pipe.model.hifigan.conv_post.bias.mul_(scale)
    peak = float(np.abs(pipe.synthesize(SENTENCE, temperature=0.0)).max())
    check(0.3 < peak < 0.8, f"scaled peak {peak} near 0.5")
    print(f"{label} pipeline: IrisConfig() at full width, seeded random "
          f"weights, conv_post scaled x{scale:.4g} for all of {label} so "
          f"the peak lies near 0.5 (now {peak:.3f}; unscaled random weights "
          f"quantize to PCM16 zeros), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return pipe


def phase7_serving(dev, card: str):
    """Serving on the card (see the module docstring). Returns the log-mel
    kernel's launches on this path (serving computes no log-mel) and the
    numbers phase 8 prints beside its own."""
    import threading

    import numpy as np

    from iris_tts_tpu_torch.models.hifigan import receptive_radius_frames
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.serve import TTSServer

    mel_cuda.log_mel_cuda.launches = 0
    pipe = _serving_pipeline(dev, "phase 7")
    hop = pipe.config.hifigan.total_upsample

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
        served_7 = _bursts_and_stream(server, "phase 7", card)
        three = SERVE_TEXTS[-1]

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
    return mel_cuda.log_mel_cuda.launches, dict(
        served_7, win_ms=win_ms, thread_warm_ms=warm_ms, thread_cold_ms=cold)


def phase8_aot(dev, card: str, ref=None) -> int:
    """Ahead-of-time serving at full width (see the module docstring):
    export, load, per-bucket CUDA graphs, parity with the live path,
    latency, the HTTP server over the artifact and the window program.
    ``ref`` is phase 7's numbers from the same run, printed beside these.
    Returns the log-mel kernel's launches on this path."""
    import threading

    import numpy as np

    from iris_tts_tpu_torch.models.pipeline import host_pcm16, prior_noise
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.serve import TTSServer
    from iris_tts_tpu_torch.serve.export import AotPipeline, export_pipeline

    ref = ref or {}
    mel_cuda.log_mel_cuda.launches = 0
    pipe = _serving_pipeline(dev, "phase 8")
    cfg = pipe.config
    hop = cfg.hifigan.total_upsample
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_aot_")
    try:
        # export on the card, then load: no model code is built
        root = Path(tmp.name)
        t0 = time.perf_counter()
        export_pipeline(pipe, root, batch_sizes=AOT_BATCH_SIZES,
                        phoneme_buckets=SERVE_PHONEME_BUCKETS,
                        vocode_chunk_frames=AOT_WINDOW_CHUNK)
        export_s = time.perf_counter() - t0
        manifest = json.loads((root / "manifest.json").read_text())
        sizes = {e["file"]: e["bytes"] for e in manifest["entries"]}
        sizes[manifest["vocode_window"]["file"]] = \
            manifest["vocode_window"]["bytes"]
        print(f"phase 8 export: {len(sizes)} programs (batch "
              f"{AOT_BATCH_SIZES} x phoneme {SERVE_PHONEME_BUCKETS}, frame "
              f"budgets {sorted({e['frame_bucket'] for e in manifest['entries']})}"
              f", and a {AOT_WINDOW_CHUNK}-frame vocoder window) in "
              f"{export_s:.1f} s; bytes "
              + ", ".join(f"{k} {v}" for k, v in sizes.items())
              + f"; total {sum(sizes.values()) / 1e6:.1f} MB", flush=True)
        t0 = time.perf_counter()
        aot = AotPipeline(root, text_processor=pipe.text_processor,
                          device=dev)
        load_s = time.perf_counter() - t0

        # 1. progressive warmup: the smallest bucket here, the rest behind
        t0 = time.perf_counter()
        n_first = aot.warmup(block=False)
        first_s = time.perf_counter() - t0
        # a request to the bucket captured first while the rest capture:
        # it replays under the replay lock, not behind a capture
        t1 = time.perf_counter()
        warm_audio = aot.synthesize(SERVE_TEXTS[0], seed=3)
        warm_req_ms = (time.perf_counter() - t1) * 1e3
        ready_then, in_flight = len(aot._ready), not aot.warm_all_done()
        check(warm_audio.size > 0 and bool(np.isfinite(warm_audio).all()),
              "a warm bucket's request during progressive warmup")
        while not aot.warm_all_done():
            check(time.perf_counter() - t0 < 600, "background capture done")
            time.sleep(0.01)
        all_s = time.perf_counter() - t0
        check(n_first == 1 and not aot.warmup_errors,
              f"warmup: {n_first} first, errors {aot.warmup_errors}")
        check(len(aot._ready) == len(aot._programs) and all(
            p.graph is not None for p in aot._programs.values()),
            "every program captured as a CUDA graph")
        pool = aot.graph_pool_bytes()
        print(f"phase 8 load + warmup: load {load_s:.2f} s; warmup("
              f"block=False): first bucket live after {first_s:.3f} s, all "
              f"{len(aot._programs)} graphs after {all_s:.3f} s; graph pool "
              f"reserved "
              + ("not measured" if pool is None else f"{pool / 2**20:.1f} MiB")
              + f", card memory reserved "
              f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB ({card})",
              flush=True)
        print(f"phase 8 warm request during progressive warmup: "
              f"{SERVE_TEXTS[0]!r} to the bucket captured first took "
              f"{warm_req_ms:.2f} ms with {ready_then} of "
              f"{len(aot._programs)} graphs captured (captures still in "
              f"flight when it returned: {in_flight}); run F2's --aot "
              f"child's first request took 1230.85 ms behind the single "
              f"capture/replay lock ({card})", flush=True)

        # 2. every bucket's graph against the live fused function at the
        # bucket's own frame budget, same noise, temperature 0.667
        worst = 0.0
        texts = SERVE_TEXTS[:-1]
        for (b, p), prog in sorted((k, v) for k, v in aot._programs.items()
                                   if k != "vocwin"):
            entry = aot._entries[(b, p)]
            t_frames = entry["frame_bucket"]
            id_lists = [pipe._text_to_ids_cached(texts[i % len(texts)])[:p]
                        for i in range(b)]
            ids = np.full((b, p), pipe.vocab.pad_id, np.int64)
            lengths = np.array([len(x) for x in id_lists], np.int64)
            for row, x in zip(ids, id_lists):
                row[:len(x)] = x
            eps = prior_noise(b, cfg.vae.latent_dim, t_frames,
                              cfg.vae.down_factor, 77, dev)
            with torch.inference_mode():
                live, _ = pipe._fused_device(ids, lengths, t_frames, 77,
                                             0.667, False)
                live_audio = live.audio.cpu().numpy()
            with aot._lock:
                ids_t, len_t, eps_t, temp_t = prog.inputs
                ids_t.copy_(torch.from_numpy(ids))
                len_t.copy_(torch.from_numpy(lengths))
                eps_t.copy_(eps)
                temp_t.fill_(0.667)
                got = prog.run()[0].cpu().numpy()
            err = float(np.abs(got.astype(np.float64) - live_audio).max())
            rel = err / float(np.abs(live_audio).max())
            worst = max(worst, rel)
            check(rel <= 1e-6, f"bucket ({b}, {p}) graph vs live {rel} <= "
                               "1e-6 of the peak")
        print(f"phase 8 buckets: each of the {len(aot._entries)} graphs vs "
              f"the live fused function at its own frame budget (same "
              f"noise, temperature 0.667): worst {worst:.3e} of the peak",
              flush=True)

        # 3. AotPipeline.synthesize against the live fused synthesize
        batch3 = [SERVE_TEXTS[4], SERVE_TEXTS[1], SERVE_TEXTS[6]]
        got1 = aot.synthesize(SENTENCE, seed=11)
        want1 = pipe.synthesize(SENTENCE, seed=11, fused=True)
        gotb = aot.synthesize(batch3, seed=12)
        wantb = pipe.synthesize(batch3, seed=12, fused=True)
        errs = []
        for g, w in zip([got1] + gotb, [want1] + wantb):
            check(len(g) == len(w) and len(g) > 0,
                  f"AOT vs live lengths {len(g)} vs {len(w)}")
            errs.append(float(np.abs(g.astype(np.float64) - w).max())
                        / float(np.abs(w).max()))
        n_live = len(pipe._text_to_ids_cached(SENTENCE))
        print(f"phase 8 AotPipeline.synthesize vs live synthesize(fused="
              f"True), temperature 1: one sentence ({n_live} phonemes, "
              f"frame budget {pipe._fused_frame_budget(np.asarray([n_live]))}"
              f" live vs {aot._entries[(1, 64)]['frame_bucket']} in the "
              f"bucket) {errs[0]:.3e} of the peak; batch of 3 (bucket 8) "
              + ", ".join(f"{e:.3e}" for e in errs[1:]), flush=True)
        check(errs[0] <= AOT_LIVE_LIMIT,
              f"AOT vs live {errs[0]} <= {AOT_LIVE_LIMIT} of the peak")
        check(max(errs[1:]) <= AOT_PADDED_BATCH_LIMIT,
              f"AOT batch of 3 (B=8 program) vs live {max(errs[1:])} <= "
              f"{AOT_PADDED_BATCH_LIMIT} of the peak")

        # 4. one fused request: live eager vs graph replay
        live_ms = time_host_ms(lambda: pipe.synthesize(SENTENCE, seed=1),
                               reps=20)
        aot_ms = time_host_ms(lambda: aot.synthesize(SENTENCE, seed=1),
                              reps=20)
        live2_ms = time_host_ms(lambda: pipe.synthesize(SENTENCE, seed=1),
                                reps=20)
        aot2_ms = time_host_ms(lambda: aot.synthesize(SENTENCE, seed=1),
                               reps=20)
        prog = aot._programs[(1, 64)]
        with aot._lock:
            replay_ms = time_cuda_ms(prog.run, reps=20, warmup=3,
                                     graph=False)
        print(f"phase 8 one fused request ({n_live} phonemes), host clock, "
              f"median of 20: live eager synthesize {live_ms:.2f} / "
              f"{live2_ms:.2f} ms, AotPipeline.synthesize (graph replay) "
              f"{aot_ms:.2f} / {aot2_ms:.2f} ms; the bucket's replay alone "
              f"{replay_ms:.3f} ms of device time (20 replays back to back "
              f"between CUDA events; {card})", flush=True)
        profile_line("phase 8 AotPipeline.synthesize (graph replay)",
                     lambda: aot.synthesize(SENTENCE, seed=1), card)
        profile_line("phase 8 live synthesize (eager), same request",
                     lambda: pipe.synthesize(SENTENCE, seed=1), card)

        # 5. a captured bucket's first replay on a new thread
        first = aot._chunk_long_text(SERVE_TEXTS[-1],
                                     aot.phoneme_buckets[-1])[0]
        warm_ms = time_host_ms(lambda: aot.synthesize(first, seed=0))
        cold = []

        def run():
            for _ in range(2):
                t1 = time.perf_counter()
                aot.synthesize(first, seed=0)
                cold.append((time.perf_counter() - t1) * 1e3)

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=300)
        check(len(cold) == 2, "new-thread calls finished")
        eager = (f"phase 7, eager, this run: warm {ref['thread_warm_ms']:.2f}"
                 f" ms, new thread {ref['thread_cold_ms'][0]:.2f} / "
                 f"{ref['thread_cold_ms'][1]:.2f} ms" if ref
                 else "phase 7 not run")
        print(f"phase 8 per-thread: the first stream chunk's bucket, warm "
              f"here {warm_ms:.2f} ms (median of 5); on a new thread its "
              f"first call {cold[0]:.2f} ms, second {cold[1]:.2f} ms "
              f"({eager}; {card})", flush=True)

        # 6. the HTTP server over the artifact
        server = TTSServer(aot, host="127.0.0.1", port=0,
                           max_batch=max(SERVE_BATCH_BUCKETS),
                           max_wait_ms=5.0, pcm16_transfer=True)
        try:
            server.start()
            served_8 = _bursts_and_stream(server, "phase 8", card)
            host, port = server.address[:2]
            seeded_text, seed = SERVE_TEXTS[5], 1234
            status, _, body, _ = _post(host, port, "/synthesize",
                                       {"text": seeded_text, "seed": seed})
            check(status == 200, f"seeded status {status}")
            served = _wav_pcm(body)[1]
        finally:
            server.stop()
        check(not server.batcher.healthy(), "server stopped")
        direct = aot.synthesize(seeded_text, seed=seed, pcm16=True)
        check(np.array_equal(served, direct),
              "seeded request through the server = AotPipeline.synthesize")
        if ref:
            print(f"phase 8 vs phase 7 (same run): pooled p50 "
                  f"{served_8['p50']:.2f} vs {ref['p50']:.2f} ms, p95 "
                  f"{served_8['p95']:.2f} vs {ref['p95']:.2f} ms, max "
                  f"{served_8['max']:.2f} vs {ref['max']:.2f} ms; x realtime "
                  + "/".join(f"{x:.1f}" for x in served_8["xrt"]) + " vs "
                  + "/".join(f"{x:.1f}" for x in ref["xrt"])
                  + f"; batch_size_hist {served_8['hist']} vs {ref['hist']};"
                  f" stream time to first audio {served_8['ttfa_ms']:.2f} vs "
                  f"{ref['ttfa_ms']:.2f} ms ({card})", flush=True)

        # the command-line server over the artifact, in a child process
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "iris_tts_tpu_torch.serve", "--aot",
             str(root), "--host", "127.0.0.1", "--port", "0",
             "--max_batch", "16"],
            cwd=Path(__file__).resolve().parent, stderr=subprocess.PIPE,
            text=True)
        try:
            lines = []

            def read_log():
                for ln in iter(proc.stderr.readline, ""):
                    lines.append(ln)

            threading.Thread(target=read_log, daemon=True).start()
            port = None
            while port is None and time.perf_counter() - t0 < 300:
                check(proc.poll() is None, "the --aot server is running: "
                      + "".join(lines)[-2000:])
                found = [ln for ln in lines if "serving on" in ln]
                port = int(found[0].rsplit(":", 1)[1]) if found else None
                time.sleep(0.05)
            check(port is not None, "the --aot server opened its port")
            boot_s = time.perf_counter() - t0
            status, _, body, req_s = _post("127.0.0.1", port, "/synthesize",
                                           {"text": SENTENCE, "seed": 11})
            check(status == 200, f"--aot server status {status}")
            cli_pcm = _wav_pcm(body)[1]
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
        check(rc == 0, f"--aot server exit code {rc}")
        check(any("clamping max_batch 16 -> 8" in ln for ln in lines),
              "--aot clamps the batch to the largest exported bucket")
        want_pcm = aot.synthesize(SENTENCE, seed=11, pcm16=True)
        check(len(cli_pcm) == len(want_pcm), "--aot server WAV length")
        lsb = int(np.abs(cli_pcm.astype(np.int32) - want_pcm).max())
        check(lsb <= 1, f"--aot server WAV vs AotPipeline.synthesize: {lsb} "
                        "LSB")
        AOT_CHILD.update(boot_s=boot_s, req_ms=req_s * 1e3)
        print(f"phase 8 python -m iris_tts_tpu_torch.serve --aot: serving "
              f"{boot_s:.2f} s after the process started (load, first "
              f"capture); one request {req_s * 1e3:.2f} ms, its WAV vs "
              f"AotPipeline.synthesize here: {lsb} LSB (bitwise "
              f"{bool(np.array_equal(cli_pcm, want_pcm))}); SIGINT exit 0 "
              f"({card})", flush=True)

        # 7. the window program against the live streaming vocoder
        rng = np.random.default_rng(7)
        mel = rng.normal(-3.0, 2.0, (700, cfg.hifigan.in_channels)
                         ).astype(np.float32)
        got = np.concatenate(list(aot.vocode_streaming(mel)))
        want = np.concatenate(list(pipe.vocode_streaming(
            mel, chunk_frames=AOT_WINDOW_CHUNK)))
        check(got.shape == want.shape, "window program streamed length")
        v_peak = float(np.abs(want).max())
        v_err = float(np.abs(got.astype(np.float64) - want).max())
        check(v_err <= 1e-6 * v_peak, f"window graph vs live "
                                      f"vocode_streaming {v_err} <= 1e-6 x "
                                      f"peak {v_peak}")
        check(np.array_equal(
            np.concatenate(list(aot.vocode_streaming(mel, pcm16=True))),
            host_pcm16(got)), "window program pcm16 = host PCM16")
        win = aot._programs["vocwin"]
        with aot._lock:
            win_ms = time_cuda_ms(win.run, reps=20, warmup=3, graph=False)
        print(f"phase 8 window program: 700 frames in 64-frame chunks vs "
              f"live vocode_streaming {v_err:.3e} = {v_err / v_peak:.3e} of "
              f"the peak; one window replay {win_ms:.3f} ms of device time "
              f"(20 back to back, as phase 7 times it) vs the eager window "
              + (f"{ref['win_ms']:.3f} ms (phase 7, this run)"
                 if "win_ms" in ref else "(phase 7 not run)")
              + f" ({card})", flush=True)
        check(not aot.warmup_errors, f"no capture failed {aot.warmup_errors}")
    finally:
        tmp.cleanup()
    return mel_cuda.log_mel_cuda.launches

# Phase 9's bf16 gate: the JAX package's tests/test_pipeline.py::
# test_bfloat16_parity_with_float32 (bf16 against f32 at temperature 0).
BF16_MEL_MAX, BF16_MEL_MEAN, BF16_AUDIO_MAX = 0.05, 0.01, 1e-3
# Phase 9's training steps: the VAE step and the GAN round, each in f32,
# bf16 and bf16 + remat, 20 steps on phase 6's fixed batch.
TRAIN_VARIANTS = (("f32", None, False), ("bf16", torch.bfloat16, False),
                  ("bf16+remat", torch.bfloat16, True))


def _bf16_ulp(x):
    """bf16's spacing at each value of ``x`` (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _tensor_core_share(rows) -> str:
    """The share of profiled device time in kernels whose names say bf16
    (cuDNN/cuBLAS tensor-core kernels name their types), and the largest
    such kernel."""
    total = sum(t for _, t in rows)
    bf = [(k, t) for k, t in rows if "bf16" in k.lower()]
    if not total:
        return "not measured"
    top = max(bf, key=lambda r: r[1])[0][:70] if bf else "none"
    return (f"{100 * sum(t for _, t in bf) / total:.1f}% of device time in "
            f"{len(bf)} bf16-named kernels (largest: {top})")


def stage_a_frames(p, texts):
    """Stage A of pipeline ``p`` on ``texts`` → (encoder output, integer
    frames per phoneme, x = exp(log-duration) - 1 in f32, lengths); the
    frames are round(x) clipped, as the pipeline sets them."""
    from iris_tts_tpu_torch.models.pipeline import stage_a

    ids, lengths = p._encode_texts(texts)
    ids_t, len_t = p._to_device(ids, lengths)
    with torch.inference_mode():
        enc, frames, _ = stage_a(p.model, ids_t, len_t)
        x = torch.exp(p.model.duration(enc).float()) - 1.0
    return enc, frames, x, lengths


def bf16_frames_moved(texts, lengths, x32, fr32, fr16) -> list:
    """bf16 against f32 frames per phoneme (``stage_a_frames`` of each). A
    bf16 log-duration one rounding step off can move a frame where the f32
    value x sits near a .5 boundary: the frames must agree for every
    phoneme clear of one (checked). → per text, the f32 x of the phonemes
    whose frames moved."""
    moved = []
    for i, t in enumerate(texts):
        n = int(lengths[i])
        x, a, b = x32[i, :n].cpu(), fr32[i, :n].cpu(), fr16[i, :n].cpu()
        near = ((x - x.floor()) - 0.5).abs() <= 0.05 * (1.0 + x)
        check(bool((a == b)[~near].all()),
              f"bf16 frames of {t!r} equal f32's away from a rounding "
              "boundary")
        moved.append(x[a != b])
    return moved


def phase9_bf16(dev, card: str, pipe, handoff) -> int:
    """bf16 and remat on the card (see the module docstring): synthesis in
    bf16 against f32 under the JAX package's gate with both timed,
    training steps in f32 / bf16 / bf16 + remat, one bf16 AOT bucket
    against the live bf16 function, and bf16 copy synthesis through the
    log-mel kernel. Returns the kernel's launches on this path (the copy
    synthesis)."""
    import dataclasses

    import numpy as np

    from iris_tts_tpu_torch.models.discriminators import (
        HiFiGANDiscriminators,
    )
    from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
    from iris_tts_tpu_torch.models.layers import init_params
    from iris_tts_tpu_torch.models.pipeline import fused_synthesis, pick_bucket
    from iris_tts_tpu_torch.models.vae import TextConditionedVAE
    from iris_tts_tpu_torch.ops.length import round_up_to_multiple
    from iris_tts_tpu_torch.ops import mel_cuda, mrf_cuda
    from iris_tts_tpu_torch.ops.stft import (
        log_mel_spectrogram,
        log_mel_spectrogram_plain,
    )
    from iris_tts_tpu_torch.serve.export import AotPipeline, export_pipeline
    from iris_tts_tpu_torch.train.gan import GANState, make_gan_train_step
    from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
    from iris_tts_tpu_torch.train.steps import make_vae_train_step

    t_phase = time.perf_counter()
    mel_cuda.log_mel_cuda.launches = 0
    pipe16 = dataclasses.replace(pipe, dtype=torch.bfloat16)
    check(all(p.dtype == torch.float32 for p in pipe16.model.parameters()),
          "a bf16 pipeline keeps f32 params")

    # 1. synthesis: bf16 against f32 under JAX's gate, temperature 0;
    # frame counts under stage_a_frames / bf16_frames_moved's rule, and a
    # flipped text held to the gate on f32's integer frames (stage B).
    def gate(label, n, x32, x16, y32, y16):
        d_mel = np.abs(y32 - y16)
        d_audio = float(np.abs(x32 - x16).max())
        check(0 < d_mel.max() < BF16_MEL_MAX and d_mel.mean() < BF16_MEL_MEAN
              and d_audio < BF16_AUDIO_MAX,
              f"bf16 vs f32 under JAX's gate ({label}): mel max "
              f"{d_mel.max()}, mean {d_mel.mean()}, audio {d_audio}")
        check(x16.dtype == np.float32 and y16.dtype == np.float32,
              "the public API returns f32 from a bf16 pipeline")
        return (label, n, float(d_mel.max()), float(d_mel.mean()), d_audio,
                float(np.abs(x32).max()))

    gaps, flips = [], []
    factor = pipe.config.vae.down_factor
    for label, texts, fused in (("fused", [SENTENCE], True),
                                ("two-stage", BATCH, False)):
        a32, m32 = pipe.synthesize(texts, seed=1, temperature=0.0,
                                   return_mel=True, fused=fused)
        a16, m16 = pipe16.synthesize(texts, seed=1, temperature=0.0,
                                     return_mel=True, fused=fused)
        enc32, fr32, x32, lengths = stage_a_frames(pipe, texts)
        enc16, fr16, _, _ = stage_a_frames(pipe16, texts)
        moved = bf16_frames_moved(texts, lengths, x32, fr32, fr16)
        for i, t in enumerate(texts):
            if m32[i].shape == m16[i].shape:
                gaps.append(gate(label, m16[i].shape[0], a32[i], a16[i],
                                 m32[i], m16[i]))
                continue
            flips.append(f"{t!r} {m32[i].shape[0]} -> {m16[i].shape[0]} "
                         f"frames ({len(moved[i])} phoneme(s), f32 value(s) "
                         + ", ".join(f"{float(v):.3f}" for v in moved[i])
                         + ")")
            total = int(fr32[i].sum())
            t_bucket = pick_bucket(round_up_to_multiple(max(total, factor),
                                                        factor),
                                   pipe.frame_buckets)
            with torch.inference_mode():
                outs = [p._fetch_rows(p._stage_b(
                    e[i:i + 1], fr32[i:i + 1], t_bucket, 1, 0.0, False, 1,
                    return_mel=True)) for p, e in ((pipe, enc32),
                                                   (pipe16, enc16))]
            (b32, c32), (b16, c16) = outs
            gaps.append(gate(f"{label}, stage B on f32's frames", total,
                             b32[0], b16[0], c32[0], c16[0]))
    print("phase 9 bf16 vs f32 at temperature 0 (JAX's gate: mel max < "
          f"{BF16_MEL_MAX}, mean < {BF16_MEL_MEAN}, audio max < "
          f"{BF16_AUDIO_MAX}): "
          + "; ".join(f"{l} {n} frames: mel max {mx:.4f}, mean {mn:.5f}, "
                      f"audio max {au:.3e} (peak {pk:.3e})"
                      for l, n, mx, mn, au, pk in gaps)
          + "; frame counts moved by bf16 at a rounding boundary: "
          + ("; ".join(flips) if flips else "none"), flush=True)

    rows = [SERVE_TEXTS[4 + i % 3] for i in range(8)]
    times = {}
    for _ in range(2):  # f32, bf16, f32, bf16: same call, both orders
        for tag, p in (("f32", pipe), ("bf16", pipe16)):
            def two_slices(p=p):
                for _ in range(2):
                    p._batched_collect(p._batched_dispatch(rows, seed=0,
                                                           pcm16=True))
            times.setdefault(tag, []).append((
                time_host_ms(lambda p=p: p.synthesize(SENTENCE, seed=1)),
                time_host_ms(two_slices)))
    print("phase 9 times, host clock, median of 5, measured twice "
          "alternating: fused one sentence f32 "
          + " / ".join(f"{f:.2f}" for f, _ in times["f32"]) + " ms, bf16 "
          + " / ".join(f"{f:.2f}" for f, _ in times["bf16"])
          + " ms; two 8-row two-stage slices back to back f32 "
          + " / ".join(f"{s:.2f}" for _, s in times["f32"]) + " ms, bf16 "
          + " / ".join(f"{s:.2f}" for _, s in times["bf16"])
          + f" ms ({card})", flush=True)
    fused_rows = profile_line("phase 9 bf16 fused synthesize",
                              lambda: pipe16.synthesize(SENTENCE, seed=1),
                              card)

    def two_slices16():
        for _ in range(2):
            pipe16._batched_collect(pipe16._batched_dispatch(rows, seed=0,
                                                             pcm16=True))

    slice_rows = profile_line("phase 9 bf16 two 8-row slices", two_slices16,
                              card)
    print(f"phase 9 tensor cores: fused call {_tensor_core_share(fused_rows)}"
          f"; two slices {_tensor_core_share(slice_rows)} ({card})",
          flush=True)

    # 2. training: the VAE step and the GAN round, f32 / bf16 / bf16+remat
    cfg = handoff["cfg"]
    vae_batch, vae_extras, vae_frozen = handoff["vae"]
    gan_batch = handoff["gan"][0]

    def vae_run(dtype, remat):
        vae = TextConditionedVAE(cfg.vae)
        init_params(vae, torch.Generator().manual_seed(cfg.train.seed))
        state = TrainState.create(vae.to(dev), adam_clipped(
            cfg.train.learning_rate, clip_norm=cfg.train.clip_norm),
            cfg.train.seed, frozen=dict(vae_frozen.items()))
        step = make_vae_train_step(cfg, compute_dtype=dtype, remat=remat)
        return state, lambda st: step(st, vae_batch, *vae_extras), "total"

    def gan_run(dtype, remat):
        gen = HiFiGANGenerator(cfg.hifigan)
        init_params(gen, torch.Generator().manual_seed(cfg.train.seed))
        disc = HiFiGANDiscriminators()
        init_params(disc, torch.Generator().manual_seed(cfg.train.seed + 1))
        tx = adam_clipped(cfg.train.learning_rate,
                          clip_norm=cfg.train.clip_norm, b1=0.8, b2=0.99)
        state = GANState(TrainState.create(gen.to(dev), tx, cfg.train.seed),
                         TrainState.create(disc.to(dev), tx,
                                           cfg.train.seed + 1))
        step = make_gan_train_step(cfg, compute_dtype=dtype, remat=remat)
        return state, lambda st: step(st, gan_batch), "gen_mel_l1"

    train_lines = []
    for name, build in (("VAE step", vae_run), ("GAN round", gan_run)):
        for tag, dtype, remat in TRAIN_VARIANTS:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, run, key = build(dtype, remat)
            losses, step_ms = [], []
            for _ in range(20):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, m = run(state)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                losses.append(float(m[key]))
            peak = torch.cuda.max_memory_allocated()
            if name == "GAN round":  # phase 15 prints these beside its own
                handoff.setdefault("gan_round_peak_mib", {})[tag] = (
                    peak / 2**20)
            if name == "GAN round" and not remat:
                profile_line(f"phase 9 GAN round {tag}",
                             lambda: float(run(state)[1][key]), card)
            params = (state.params.parameters() if name == "VAE step"
                      else list(state.gen.params.parameters())
                      + list(state.disc.params.parameters()))
            check(all(q.dtype == torch.float32 for q in params),
                  f"{name} {tag}: params stay f32")
            check(all(math.isfinite(v) for v in losses),
                  f"{name} {tag}: finite losses")
            check(losses[-1] < losses[0], f"{name} {tag}: {key} falls "
                                          f"({losses[0]} -> {losses[-1]})")
            train_lines.append(
                f"{name} {tag}: median {statistics.median(step_ms[3:]):.2f} "
                f"ms (steps 4-20), peak {peak / 2**20:.1f} MiB "
                f"(+{(peak - base) / 2**20:.1f} over the "
                f"{base / 2**20:.1f} MiB live before), {key} "
                f"{losses[0]:.5f} -> {losses[-1]:.5f}")
            del state, run
    print(f"phase 9 training at full width, batch 16 (phase 6's fixed "
          f"batches: VAE {tuple(vae_batch['mel'].shape)}, GAN "
          f"{tuple(gan_batch['audio'].shape)}): " + "; ".join(train_lines)
          + f" ({card})", flush=True)

    # 3. one bf16 AOT bucket against the live bf16 fused function
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_aot16_")
    try:
        root = Path(tmp.name)
        t0 = time.perf_counter()
        export_pipeline(pipe16, root, batch_sizes=(1,), phoneme_buckets=(32,))
        export_s = time.perf_counter() - t0
        manifest = json.loads((root / "manifest.json").read_text())
        check(manifest["dtype"] == "bfloat16", "the manifest records bf16")
        aot = AotPipeline(root, text_processor=pipe.text_processor,
                          device=dev)
        aot.warmup()
        prog = aot._programs[(1, 32)]
        check(prog.graph is not None, "the bf16 bucket captured as a graph")
        t_frames = aot._entries[(1, 32)]["frame_bucket"]
        ids_np, lengths_np = pipe16._encode_texts([SERVE_TEXTS[5]])
        ids = np.full((1, 32), pipe16.vocab.pad_id, np.int64)
        ids[0, :min(32, ids_np.shape[1])] = ids_np[0, :32]
        lengths = np.minimum(lengths_np, 32)
        eps = pipe16._prior_noise(1, t_frames, 21)
        with torch.inference_mode():
            want = fused_synthesis(pipe16.model, torch.from_numpy(ids).to(dev),
                                   torch.from_numpy(lengths).to(dev), eps, 0.667,
                                   t_frames, pipe16.use_postnet,
                                   pipe16.upsample)
            want = [w.clone() for w in want]
        with aot._lock:
            ids_t, len_t, eps_t, temp_t = prog.inputs
            check(eps_t.dtype == torch.bfloat16, "the bf16 noise input")
            ids_t.copy_(torch.from_numpy(ids))
            len_t.copy_(torch.from_numpy(lengths))
            eps_t.copy_(eps)
            temp_t.fill_(0.667)
            got = [g.clone() for g in prog.run()]
        for name, g, w in zip(("audio", "mel", "n_frames", "deficit"),
                              got, want):
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"bf16 graph replay vs live bf16 fused function: {name} "
                  f"bitwise")
        print(f"phase 9 AOT: the bf16 pipeline's (B=1, P=32) bucket "
              f"({t_frames} frames) exported in {export_s:.1f} s, manifest "
              f"dtype {manifest['dtype']}; its graph replay equals the live "
              f"bf16 fused function bitwise (audio {got[0].dtype}, mel, "
              f"frame counts, deficit; temperature 0.667)", flush=True)
        del aot, prog
    finally:
        tmp.cleanup()

    # 4. bf16 copy synthesis through the log-mel kernel (the path's launch),
    # then the kernel against the plain version on the same bf16 audio
    cfg_a = pipe.config.audio
    audio16 = torch.from_numpy(pipe16.synthesize(SENTENCE, seed=1)).to(
        dev).to(torch.bfloat16)
    feats = log_mel_spectrogram(audio16, cfg_a)
    resynth = pipe16.vocode(feats)
    check(feats.dtype == torch.bfloat16, "bf16 audio gives a bf16 log-mel")
    check(len(resynth) == feats.shape[0] * pipe.config.hifigan.total_upsample
          and bool(np.isfinite(resynth).all()), "bf16 copy synthesis")
    launches = mel_cuda.log_mel_cuda.launches
    t = torch.arange(70000, device=dev) / cfg_a.sample_rate
    noisy = 0.4 * torch.sin(2 * torch.pi * 440 * t) + 0.05 * torch.randn(
        (3, 70000), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    for label, a in (("synthesized", audio16),
                     ("tone + noise", noisy.to(torch.bfloat16))):
        k16 = mel_cuda.log_mel_cuda(a, cfg_a)
        p16 = log_mel_spectrogram_plain(a, cfg_a)
        check(k16.dtype == p16.dtype == torch.bfloat16, "bf16 log-mel")
        diff = (k16.float() - p16.float()).abs()
        ulp = _bf16_ulp(p16.float())
        over = int((diff > ulp).sum())
        # within one bf16 ulp, or within the kernel's f32 tolerance where a
        # value lies so near 0 that its ulp is below that tolerance
        check(bool((diff <= torch.maximum(ulp, torch.full_like(ulp, 2e-3))
                    ).all()), f"bf16 log-mel kernel vs plain ({label})")
        print(f"phase 9 log-mel kernel on bf16 audio ({label}, "
              f"{tuple(a.shape)}): bf16 out, {int((diff == 0).sum())} of "
              f"{diff.numel()} values equal to the plain version, "
              f"{diff.numel() - over - int((diff == 0).sum())} one ulp "
              f"apart, {over} beyond one ulp (each within 2e-3; max "
              f"{float(diff.max()):.3e})", flush=True)
    print(f"phase 9 done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase10_cli(dev, card: str):
    """The command-line path on the card, through the drivers' ``main(argv)``
    in-process (see the module docstring). Returns the log-mel kernel's
    launches on this path (one a cached clip, one a scored resynthesis),
    the held-out eval's summary, and the trained stages' directories (with
    the temporary directory that holds them, which the caller cleans
    up)."""
    import numpy as np

    from iris_tts_tpu_torch.data.audio_io import load_audio, read_wav
    from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.ops.griffin_lim import griffin_lim_from_log_mel
    from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram_plain
    from iris_tts_tpu_torch.scripts import (
        batch_synthesize,
        make_synthetic_corpus,
        synthesize,
        train_full_pipeline,
    )
    from iris_tts_tpu_torch.utils.metrics import quality_report

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    root = Path(tmp.name)
    try:
        # 1. corpus, then the four stages, the evaluation and the artifact
        # in one driver call; the kernel's launches count from here to the
        # path's last driver
        mel_cuda.log_mel_cuda.launches = 0
        t0 = time.perf_counter()
        make_synthetic_corpus.main(["--root", str(root / "corpus"),
                                    "--n", str(CLI_CORPUS)])
        corpus_s = time.perf_counter() - t0
        data_root = root / "corpus" / "LJSpeech-1.1"
        aligned = root / "corpus" / "aligned"
        cache, out = root / "cache", root / "run"
        t0 = time.perf_counter()
        summary = train_full_pipeline.main([
            "--data_root", str(data_root), "--alignment_dir", str(aligned),
            "--cache_dir", str(cache), "--output_dir", str(out),
            "--batch_size", "16", "--encoder_epochs", "1",
            "--vae_epochs", "1", "--postnet_epochs", "1",
            "--gan_epochs", "1", "--gan_batch", "16",
            "--segment_frames", "32", "--eval_samples", "4",
            "--artifact_half"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        for key in ("mcd_db", "lsd_db", "control_mcd_db", "control_lsd_db",
                    "duration_mae_frames", "resynth_mcd_db"):
            check(summary[key] is not None and math.isfinite(summary[key]),
                  f"finite {key} ({summary[key]})")
        on_disk = json.loads((out / "eval" / "summary.json").read_text())
        check(on_disk["artifact_smoke"]["ok"] and on_disk["artifact_smoke"][
            "params_dtype"] == "float16", "fp16 artifact smoke-eval ok")
        timings = json.loads((out / "timings.json").read_text())
        check(set(timings) == {"encoder_s", "vae_s", "postnet_s", "gan_s",
                               "eval_s"}, f"stage timings {timings}")
        print(f"phase 10 train_full_pipeline (IrisConfig(), corpus of "
              f"{CLI_CORPUS} from make_synthetic_corpus in {corpus_s:.1f} s, "
              f"batch 16, one epoch a stage, GAN 16 x 32 frames, fp16 "
              f"artifact): {run_s:.1f} s in all; stage seconds "
              + ", ".join(f"{k[:-2]} {v}" for k, v in timings.items())
              + f"; DTW-aligned MCD/LSD {summary['quality_s']} s of the "
              f"eval ({100 * summary['quality_s'] / timings['eval_s']:.0f}%)"
              f" ({card})", flush=True)
        print(f"phase 10 held-out eval ({summary['eval_samples']} of "
              f"{summary['val_utterances']} val utterances): MCD "
              f"{summary['mcd_db']:.3f} dB (control "
              f"{summary['control_mcd_db']:.3f}), LSD {summary['lsd_db']:.3f}"
              f" dB (control {summary['control_lsd_db']:.3f}), duration MAE "
              f"{summary['duration_mae_frames']:.3f} frames, resynthesis MCD "
              f"{summary['resynth_mcd_db']:.3f} dB; artifact smoke max delta "
              f"{on_disk['artifact_smoke']['max_abs_delta_db']} dB (tol "
              f"{on_disk['artifact_smoke']['tol_db']})", flush=True)

        # 2. synthesize from the artifact in a child process, from cold;
        # then the Griffin-Lim vocoder in-process
        pipe = train_full_pipeline.build_pipeline(out, cache, dev)
        audio_cfg = pipe.config.audio
        art = out / "pipeline_artifact"
        wav = root / "child.wav"
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "iris_tts_tpu_torch.scripts.synthesize",
             "--artifact", str(art), "--text", TRAIN_SENTENCE,
             "--output_wav", str(wav), "--device", str(dev)],
            capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        check(r.returncode == 0, f"synthesize child: {r.stderr[-1500:]}")
        samples, sr = read_wav(wav)
        hop = audio_cfg.hop_length
        check(sr == audio_cfg.sample_rate and len(samples) > 0
              and len(samples) % hop == 0, "child wav")
        gl_wav = root / "gl.wav"
        t0 = time.perf_counter()
        gl = synthesize.main(["--artifact", str(art), "--text",
                              TRAIN_SENTENCE, "--use_griffin_lim",
                              "--output_wav", str(gl_wav)])
        gl_host_s = time.perf_counter() - t0
        mel = torch.from_numpy(pipe.synthesize_mel(TRAIN_SENTENCE, seed=0))
        mel = mel.to(dev)
        check(bool(np.isfinite(gl).all()) and len(gl) % hop == 0,
              "Griffin-Lim audio")
        gl_ms = time_cuda_ms(
            lambda: griffin_lim_from_log_mel(mel, 60, audio_cfg), reps=5,
            warmup=1, graph=False)
        print(f"phase 10 synthesize --artifact in a child process: "
              f"{child_s:.2f} s wall from cold ({len(samples)} samples); "
              f"--use_griffin_lim in-process {gl_host_s:.2f} s wall "
              f"({len(gl)} samples); Griffin-Lim alone, 60 iterations on "
              f"{mel.shape[0]} frames: {gl_ms:.2f} ms on the card (events "
              f"around 5 eager calls; {card})", flush=True)

        # 3. bulk synthesis: the meter's numbers, cold then warm
        for run in ("cold", "warm"):
            s = batch_synthesize.main([
                "--random_weights", "--num_utterances", "64",
                "--batch_size", "16"])
            check(s["rtf"] > 0 and s["audio_seconds"] > 0, "batch summary")
            print(f"phase 10 batch_synthesize --random_weights, 64 "
                  f"utterances in batches of 16 ({run}): rtf "
                  f"{s['rtf']:.2f}, {s['mel_frames_per_sec']:.1f} mel "
                  f"frames/s, p50 {s['p50_latency_s']:.3f} s, p90 "
                  f"{s['p90_latency_s']:.3f} s (one meter window over the "
                  f"run), {s['audio_seconds']:.2f} s of audio ({card})",
                  flush=True)

        # 4. the path's launches, read after its last driver, then its
        # kernel outputs against the plain version: every cached mel, and
        # each scored resynthesis again (its mel is scored, not kept) with
        # its MCD against the run's
        launches = mel_cuda.log_mel_cuda.launches
        mel_files = sorted((cache / "mels").glob("*.npy"))
        n_resynth = min(4, summary["eval_samples"])
        check(len(mel_files) == CLI_CORPUS,
              f"a cached mel per clip ({len(mel_files)})")
        check(launches == len(mel_files) + n_resynth,
              f"log-mel launches on the CLI path: {launches} == "
              f"{len(mel_files)} cached clips + {n_resynth} scored "
              f"resynthesis")
        worst = 0.0
        for f in mel_files:
            audio = load_audio(data_root / "wavs" / f"{f.stem}.wav")
            want = log_mel_spectrogram_plain(
                torch.from_numpy(audio).to(dev), audio_cfg)
            cached = np.load(f)
            check(bool(np.isfinite(cached).all()), f"finite mel {f.stem}")
            worst = max(worst, max_abs(cached, want))
        val = LJSpeechVAEDataset(data_root, aligned, split="val",
                                 cache_dir=cache, audio=audio_cfg, device=dev)
        resynth = []
        for i in range(n_resynth):
            gt = val[i]
            a = torch.from_numpy(pipe.vocode(gt.mel)).to(dev)
            got = mel_cuda.log_mel_cuda(a, audio_cfg)
            worst = max(worst, max_abs(got, log_mel_spectrogram_plain(
                a, audio_cfg)))
            mel_r = got.cpu().numpy()[: gt.mel.shape[0]]
            resynth.append(quality_report(
                mel_r, gt.mel[: mel_r.shape[0]], align="trim")["mcd_db"])
        # the smoke-eval's first row again: frames before and after the
        # fp16 round trip of the weights
        smoke = on_disk["artifact_smoke"]["samples"][0]
        frames = [len(p.synthesize_mel(val[0].text, seed=0, temperature=0.0))
                  for p in (pipe, TTSPipeline.load(art, device=dev))]
        print(f"phase 10 artifact smoke-eval, val[0]: {frames[0]} frames "
              f"before the fp16 round trip, {frames[1]} after; MCD "
              f"{smoke['pre_save_mcd_db']} -> {smoke['mcd_db']} dB (delta "
              f"{smoke['delta_db']}, tol "
              f"{on_disk['artifact_smoke']['tol_db']})", flush=True)
        drift = abs(float(np.mean(resynth)) - summary["resynth_mcd_db"])
        check(worst <= 2e-3, f"CLI path mels vs plain max-abs {worst}")
        check(drift <= 1e-3, f"resynthesis MCD again {drift} dB off")
        print(f"phase 10 log-mel kernel on the CLI path: {launches} launches "
              f"({len(mel_files)} cached clips + {n_resynth} scored "
              f"resynthesis); every cached and resynthesis mel within "
              f"{worst:.3e} of the plain version (resynthesis MCD again "
              f"within {drift:.1e} dB)", flush=True)
    except BaseException:
        tmp.cleanup()
        raise
    print(f"phase 10 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    stage_dirs = {"encoder": out / "encoder" / "checkpoints",
                  "vae": out / "vae" / "checkpoints",
                  "postnet": out / "postnet" / "checkpoints",
                  "vocab": cache / "phoneme_vocab.json", "tmp": tmp,
                  "data_root": data_root, "aligned": aligned,
                  "audio": audio_cfg}
    return launches, summary, stage_dirs


# -- phase 12: G2P training, the checkpoint converters and native IO -----------

G2P_DECODE_BATCH = 512
G2P_DIFF_LIMIT = 1e-3  # share of held-out words the card may decode apart
G2P_EPOCHS = 2
NATIVE_CLIPS = 32


def _median_step_ms(step, n: int = 20) -> float:
    """Median of steps 4..n of ``step()``, each ended by a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[3:])


def _host_g2p_decode(checkpoint: str, chars, batch: int):
    """The shipped G2P's host NumPy decode of ``chars`` (a child process
    of phase 12: it runs beside the card's work) → (tokens, seconds)."""
    import numpy as np

    from iris_tts_tpu_torch.text.neural_g2p import _NumpyG2P, _read_checkpoint

    t0 = time.perf_counter()
    flat, cfg, _ = _read_checkpoint(checkpoint)
    net = _NumpyG2P(flat, cfg)
    toks = np.concatenate([net.greedy_decode(chars[i:i + batch])
                           for i in range(0, len(chars), batch)])
    return toks, time.perf_counter() - t0


def phase12_g2p(dev, card: str, root: Path) -> None:
    """12a: the shipped G2P decoded on the card against the host decoder
    (which runs in a child process meanwhile); 12b: ``train_g2p`` at full
    width on the whole dictionary."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from iris_tts_tpu_torch.convert.from_jax import module_state_from_jax
    from iris_tts_tpu_torch.models.g2p import G2PTransformer
    from iris_tts_tpu_torch.scripts import train_g2p
    from iris_tts_tpu_torch.text.neural_g2p import DEFAULT_CHECKPOINT, load_g2p

    # 12a. the shipped checkpoint on the card, the held-out split; the host
    # decoder's run (tens of seconds of NumPy) overlaps 12a and 12b
    shipped_bytes = DEFAULT_CHECKPOINT.read_bytes()
    params, cfg, meta = load_g2p(DEFAULT_CHECKPOINT)
    chars, pin, pout, is_val = train_g2p.build_dataset(cfg)
    chars_val, pout_val = chars[is_val], pout[is_val]
    check(len(chars_val) > 2000, f"held-out split {len(chars_val)}")
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        host = pool.submit(_host_g2p_decode, str(DEFAULT_CHECKPOINT),
                           chars_val, G2P_DECODE_BATCH)
        model = G2PTransformer(cfg)
        model.load_state_dict(module_state_from_jax(params["params"],
                                                    module=model),
                              strict=True)
        model = model.to(dev).eval()
        train_g2p.decode_tokens(model, chars_val[:G2P_DECODE_BATCH])  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_toks = train_g2p.decode_tokens(model, chars_val,
                                            G2P_DECODE_BATCH)
        card_s = time.perf_counter() - t0
        per, exact = train_g2p.score_tokens(card_toks, pout_val)
        print(f"phase 12a G2P shipped checkpoint on the card "
              f"({cfg.embed_dim} wide, {cfg.enc_blocks}+{cfg.dec_blocks} "
              f"blocks): {len(chars_val)} held-out words in batches of "
              f"{G2P_DECODE_BATCH} in {card_s:.3f} s; PER {per:.4f}, exact "
              f"{exact:.4f} (manifest, f32 before the fp16 save: "
              f"{meta.get('val_per')} / {meta.get('val_exact')}) ({card})",
              flush=True)
        step = _phase12b_train(dev, card, root, cfg, chars, pin, pout,
                               is_val, shipped_bytes)
        host_toks, host_s = host.result()
    # one fixed batch, the host to itself: the step alone, synchronized, as
    # phase 6 times it
    step_ms = _median_step_ms(step)
    print(f"phase 12b one fixed batch of 512: {step_ms:.2f} ms a step "
          f"(median of steps 4-20, synchronized) ({card})", flush=True)
    profile_line("G2P train step (batch 512)", lambda: float(step()), card)
    differ = float(np.mean(np.any(card_toks != host_toks, axis=1)))
    check(differ <= G2P_DIFF_LIMIT,
          f"G2P card vs host decoder: {differ:.4%} of words differ")
    print(f"phase 12a G2P card vs host NumPy decoder: {differ:.4%} of "
          f"{len(chars_val)} held-out words decode apart (limit "
          f"{G2P_DIFF_LIMIT:.1%}); the host decode took {host_s:.3f} s in "
          f"a child process beside 12b ({card})", flush=True)


def _phase12b_train(dev, card: str, root: Path, cfg, chars, pin, pout,
                    is_val, shipped_bytes: bytes):
    """12b: ``train_g2p`` at full width, two epochs on the whole
    dictionary, into a temporary file. Returns a fixed-batch step (a
    callable) for timing once the host decoder's child process is done."""
    import numpy as np

    from iris_tts_tpu_torch.scripts import train_g2p
    from iris_tts_tpu_torch.text.lexicon import ARPABET
    from iris_tts_tpu_torch.text.neural_g2p import DEFAULT_CHECKPOINT, NeuralG2P

    out = root / "g2p_trained.npz"
    live_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = train_g2p.main(["--epochs", str(G2P_EPOCHS), "--batch_size",
                              "512", "--eval_every", str(G2P_EPOCHS),
                              "--output", str(out), "--device", str(dev)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20 - live_mb
    losses, epoch_s = summary["losses"], summary["epoch_s"]
    check(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"G2P loss falls by epoch: {losses}")
    state, n = summary["state"], summary["steps_per_epoch"]
    with np.load(out) as z, np.load(DEFAULT_CHECKPOINT) as ref:
        shapes = {k: z[k].shape for k in z.files}
        want = {k: ref[k].shape for k in ref.files}
    check(shapes == want, "trained checkpoint's keys and shapes are the "
          "shipped one's")
    phones = NeuralG2P(out)("wug")
    check(bool(phones) and all(p in ARPABET for p in phones),
          f"NeuralG2P on the trained checkpoint: {phones}")
    check(DEFAULT_CHECKPOINT.read_bytes() == shipped_bytes,
          "the shipped checkpoint is untouched")
    print(f"phase 12b train_g2p (G2PConfig(), {summary['train_entries']} "
          f"entries, batch 512, {n} steps an epoch): loss by epoch "
          + ", ".join(f"{x:.4f}" for x in losses)
          + "; epoch s " + ", ".join(f"{x:.2f}" for x in epoch_s)
          + f" ({1e3 * epoch_s[-1] / n:.2f} ms a step in the epoch, the "
          f"host decoder's child process running beside it); val PER "
          f"{summary['val_per']:.4f}, exact {summary['val_exact']:.4f}; "
          f"{run_s:.1f} s in all with the eval and the save; peak "
          f"{peak_mb:.1f} MiB over what was live before ({live_mb:.1f} "
          f"MiB); NeuralG2P('wug') = {' '.join(phones)} ({card})",
          flush=True)
    c, yi, yo = (torch.from_numpy(a[~is_val][:512].astype(np.int64)).to(dev)
                 for a in (chars, pin, pout))
    return lambda: train_g2p.train_step(state, c, yi, yo)


def phase12_converters(dev, card: str, root: Path, stage_dirs) -> int:
    """12c: a torch HiFiGAN checkpoint through the converter on the card
    against the oracle, and into ``from_checkpoints`` with phase 10's
    stages; 12d: the demo vocoder (its log-mel launch counted) and the
    integration check. Returns the demo's log-mel launches."""
    import numpy as np

    from iris_tts_tpu_torch.config import AudioConfig, HiFiGANConfig
    from iris_tts_tpu_torch.convert.hifigan_torch import (
        load_pretrained_hifigan,
    )
    from iris_tts_tpu_torch.convert.torch_oracle import TorchGenerator
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram_plain
    from iris_tts_tpu_torch.scripts import demo_vocoder, hifigan_integration

    # 12c. the production generator, seeded, saved in speechbrain nesting
    cfg = HiFiGANConfig()
    torch.manual_seed(0)
    oracle = TorchGenerator(cfg).eval()
    path = root / "generator.ckpt"
    torch.save({f"{k.rsplit('.', 1)[0]}.conv.{k.rsplit('.', 1)[1]}": v
                for k, v in oracle.state_dict().items()}, path)
    t0 = time.perf_counter()
    vocoder = load_pretrained_hifigan(path, cfg, device=dev)
    load_s = time.perf_counter() - t0
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 87, cfg.in_channels)).astype(np.float32)).to(dev)
    with torch.no_grad():
        want = oracle.to(dev)(mel.transpose(1, 2))[:, 0]
    got = vocoder(mel[0].T)
    torch.cuda.synchronize()
    err, peak = max_abs(got, want[0]), float(want.abs().max())
    check(err <= 1e-3, f"converted HiFiGAN vs oracle max-abs {err}")
    pipe = TTSPipeline.from_checkpoints(
        stage_dirs["encoder"], stage_dirs["vae"],
        postnet_checkpoint=stage_dirs["postnet"], hifigan_checkpoint=path,
        vocab_path=stage_dirs["vocab"], device=dev)
    audio = pipe.synthesize(TRAIN_SENTENCE, seed=0)
    check(len(audio) > 0 and bool(np.isfinite(audio).all())
          and float(np.abs(audio).max()) > 0, "from_checkpoints with the "
          "torch HiFiGAN synthesizes")
    print(f"phase 12c torch HiFiGAN checkpoint (HiFiGANConfig(), seeded "
          f"oracle, speechbrain nesting, {path.stat().st_size / 1e6:.1f} MB): "
          f"load_pretrained_hifigan {load_s:.2f} s; vocoding 87 frames on "
          f"the card vs the oracle there max-abs {err:.3e} (peak "
          f"{peak:.3e}, {err / max(peak, 1e-30):.3e} of it; limit 1e-3); "
          f"from_checkpoints(phase 10's stages, hifigan_checkpoint=) "
          f"synthesized {len(audio)} samples ({card})", flush=True)

    # 12d. the demo vocoder (one log-mel launch on its path) and the
    # integration check
    mel_cuda.log_mel_cuda.launches = 0
    wav = demo_vocoder.main(["--output_wav", str(root / "demo.wav"),
                             "--device", str(dev)])
    launches = mel_cuda.log_mel_cuda.launches
    check(launches == 1, f"demo vocoder log-mel launches {launches} == 1")
    acfg = AudioConfig()
    t = np.arange(acfg.sample_rate) / acfg.sample_rate
    tone = torch.from_numpy((0.5 * np.sin(2 * np.pi * 220 * t) + 0.25 * np.sin(
        2 * np.pi * 440 * t)).astype(np.float32)).to(dev)
    got = mel_cuda.log_mel_cuda(tone, acfg)
    want = log_mel_spectrogram_plain(tone, acfg)
    demo_err = max_abs(got, want)
    # A pure tone leaves most mel bins near the 1e-5 floor, where a float32
    # rounding of the magnitude is a large step in log: held, as the mel
    # cache is, in linear mel to 1e-4 of each frame's peak.
    lin = (got.exp() - want.exp()).abs().amax(-1) / want.exp().amax(-1)
    demo_lin = float(lin.max())
    check(demo_lin <= 1e-4, f"demo log-mel vs plain {demo_lin} of a frame's "
          f"peak in linear mel")
    check(len(wav) == 87 * acfg.hop_length and bool(np.isfinite(wav).all()),
          "demo waveform")
    rc = hifigan_integration.main(["--device", str(dev)])
    check(rc == 0, f"hifigan_integration exit {rc}")
    print(f"phase 12d demo_vocoder on the card: {launches} log-mel launch, "
          f"kernel vs plain on its tone max-abs {demo_err:.3e} in log, "
          f"{demo_lin:.3e} of a frame's peak in linear mel (limit 1e-4); "
          f"{len(wav)} samples written; hifigan_integration exit {rc}",
          flush=True)
    return launches


def phase12_native(card: str, root: Path) -> None:
    """12e: the native WAV library built from the port's source, its batch
    read exact against the pure-Python reader."""
    import numpy as np

    from iris_tts_tpu_torch.data import audio_io, native
    from iris_tts_tpu_torch.utils import cxx

    prebuilt = sorted(cxx.BUILD_DIR.glob("libiriswav_*.so"))
    t0 = time.perf_counter()
    lib = native.build_library()
    build_s = time.perf_counter() - t0
    check(native.native_available(), "native WAV library loads")
    how = (f"found already built ({len(prebuilt)} in {cxx.BUILD_DIR})"
           if lib in prebuilt else f"built with g++ in {build_s:.2f} s")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(NATIVE_CLIPS):
        n = int(rng.integers(22050, 3 * 22050))
        clip = (0.3 * rng.standard_normal(n)).clip(-1, 1).astype(np.float32)
        p = root / f"clip_{i:02d}.wav"
        audio_io.write_wav(p, clip, 22050,
                           subtype="pcm16" if i % 2 else "float32")
        paths.append(p)
    max_samples = 3 * 22050

    def python_batch():
        out = np.zeros((len(paths), max_samples), np.float32)
        for i, p in enumerate(paths):
            mono = audio_io.to_mono(audio_io.read_wav(p)[0])
            out[i, :len(mono)] = mono
        return out

    got, lengths, rates = native.read_wav_batch(paths, max_samples)
    want = python_batch()
    check(bool(np.array_equal(got, want)), "native batch read == Python")
    check(bool((rates == 22050).all()), "native rates")
    native_ms = time_host_ms(lambda: native.read_wav_batch(paths,
                                                           max_samples))
    python_ms = time_host_ms(python_batch)
    print(f"phase 12e native WAV: {lib.name} from the port's wavio.cpp "
          f"{how}; read_wav_batch of {NATIVE_CLIPS} clips "
          f"(1-3 s, PCM16 and float32) equals the Python reader exactly; "
          f"{native_ms:.2f} ms native (8 threads) vs {python_ms:.2f} ms "
          f"Python (median of 5, host clock; {card})", flush=True)


def phase12(dev, card: str, stage_dirs) -> int:
    """Phase 12 (see the module docstring). Returns the demo vocoder's
    log-mel launches."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p12_") as tmp:
        root = Path(tmp)
        phase12_g2p(dev, card, root)
        launches = phase12_converters(dev, card, root, stage_dirs)
        phase12_native(card, root)
    print(f"phase 12 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# -- phase 13: the C++ serving host ---------------------------------------------

# The JAX host's own test requests (tests/test_pjrt_runner.py, artifact host
# on device): (verb, name, seed, temperature, payload).
NATIVE_JAX_REQUESTS = [
    ("synth", "req1", 0, 1.0, "hello world"),
    ("synth", "req2", 7, 0.8, "the quick brown fox jumps over the dog"),
    ("ids", "req3", 0, 1.0, "4,9,12,9"),
]
NATIVE_BUCKETS = (16, 32)
NATIVE_BURST = 16
# Words of the burst's seeded sentences (all in the port's CMUdict).
NATIVE_WORDS = ("the a small house stood near green water while two old "
                "friends walked slowly home after dinner and talked about "
                "music books travel rain summer morning light").split()
# The host's audio against ExportedSynthesizer's, of the peak.
NATIVE_LIMIT = 1e-5
# Phase 8's `serve --aot` child, printed beside phase 13's host.
AOT_CHILD: dict = {}
# Seconds from the export child's start to its end, at most.
NATIVE_EXPORT_DEADLINE_S = 900


def _tf32_in_packages(files) -> list:
    """Members of the AOTInductor packages whose generated code asks for
    TF32 (``allow_tf32=True``, ``input_precision="tf32"``)."""
    import re
    import zipfile

    pat = re.compile(rb"(?i)(allow_tf32\W{0,4}[=:]\W{0,4}true|"
                     rb"input_precision\W{0,4}=\W{0,4}.tf32)")
    hits = []
    for f in files:
        with zipfile.ZipFile(f) as z:
            for name in z.namelist():
                if name.endswith((".cpp", ".py", ".h", ".json", ".txt")) \
                        and pat.search(z.read(name)):
                    hits.append(f"{f.name}:{name}")
    return hits


def _min_half_distance(pipe, id_lists) -> float:
    """The smallest distance of any predicted duration exp(p) − 1 to a .5
    rounding boundary, over ``id_lists`` (one row each): two programs of
    the same math may round a value that close differently."""
    import numpy as np

    from iris_tts_tpu_torch.ops.length import padding_mask

    best = 1.0
    with torch.no_grad():
        for ids in id_lists:
            t = torch.as_tensor(np.asarray(ids, np.int64), device=pipe.device)
            ln = torch.tensor([len(ids)], device=pipe.device)
            mask = padding_mask(ln, len(ids))
            log_dur = pipe.model.duration(pipe.model.encoder(
                t[None], padding_mask=mask))
            x = torch.exp(log_dur.double()) - 1.0
            best = min(best, float(((x - x.floor()) - 0.5).abs().min()))
    return best


def _native_requests(pipe, tp, vocab):
    """JAX's three requests, then a seeded burst of NATIVE_BURST text
    requests whose predicted durations lie clear of a rounding boundary
    (drawn until 16 are)."""
    import numpy as np

    rng = np.random.default_rng(13)
    reqs = list(NATIVE_JAX_REQUESTS)
    while len(reqs) < len(NATIVE_JAX_REQUESTS) + NATIVE_BURST:
        text = " ".join(rng.choice(NATIVE_WORDS, int(rng.integers(2, 7))))
        ids = tp.text_to_ids(text, vocab)
        if len(ids) <= NATIVE_BUCKETS[-1] and \
                _min_half_distance(pipe, [ids]) > 1e-3:
            reqs.append(("synth", f"burst{len(reqs):02d}",
                         int(rng.integers(0, 2**31 - 1)),
                         float(rng.choice([0.0, 0.667, 1.0])), text))
    return reqs


def native_export(root: Path, device: str = "cuda") -> int:
    """Phase 13's export, run as a child process of this script
    (``--native-export DIR``) beside phases 11 and 12: phase 7's weights
    exported as batch 1 × ``NATIVE_BUCKETS`` with AOTInductor packages
    into ``DIR/artifact`` while g++ builds the host; ``DIR/export.json``
    records the seconds and the host's path."""
    import threading

    from iris_tts_tpu_torch.serve import native
    from iris_tts_tpu_torch.serve.export import export_pipeline

    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(root / "inductor")
    pipe = _serving_pipeline(torch.device(device), "phase 13 export")
    built = {}

    def build():
        t0 = time.perf_counter()
        try:
            built["host"] = str(native.build_host())
        except Exception as e:  # noqa: BLE001 — raised below
            built["error"] = e
        built["build_s"] = time.perf_counter() - t0

    build_thread = threading.Thread(target=build)
    build_thread.start()  # g++ runs while AOTInductor compiles
    t0 = time.perf_counter()
    export_pipeline(pipe, root / "artifact", batch_sizes=(1,),
                    phoneme_buckets=NATIVE_BUCKETS, native=True)
    export_s = time.perf_counter() - t0
    build_thread.join()
    if "error" in built:
        raise built["error"]
    (root / "export.json").write_text(json.dumps(
        {"export_s": export_s, **built}))
    return 0


def start_native_export():
    """Start :func:`native_export` in a child process → (its directory,
    the process, its log, the start time)."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_p13_")
    log = open(Path(tmp.name) / "export.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--native-export",
         tmp.name], stdout=log, stderr=subprocess.STDOUT,
        cwd=Path(__file__).resolve().parent)
    return tmp, proc, log, time.perf_counter()


def stop_native_export(job) -> None:
    """Kill the export child if it still runs and remove its directory
    (a second call does nothing)."""
    tmp, proc, log, _ = job
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()
    tmp.cleanup()


def phase13_native(dev, card: str, job=None) -> int:
    """13: the C++ host (``serve/csrc/aoti_runner.cpp``) serving text at
    full width from AOTInductor packages (see the module docstring).
    ``job`` is the export child :func:`start_native_export` started before
    phase 11 (None: start it now and wait for it). Returns the log-mel
    kernel's launches on this path."""
    import threading
    import wave

    import numpy as np

    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.serve.export import (
        AotPipeline,
        ExportedSynthesizer,
    )
    from iris_tts_tpu_torch.text.frontend import create_text_processor

    t_phase = time.perf_counter()
    mel_cuda.log_mel_cuda.launches = 0
    job = job or start_native_export()
    tmp, export_proc, _, t_started = job
    proc = None
    try:
        pipe = _serving_pipeline(dev, "phase 13")
        tp = create_text_processor(use_g2p=False)
        lexicon = (Path(__file__).resolve().parent / "iris_tts_tpu_torch"
                   / "text" / "data" / "cmu_dict.txt")
        root = Path(tmp.name)
        t0 = time.perf_counter()
        left = NATIVE_EXPORT_DEADLINE_S - (t0 - t_started)
        try:
            rc = export_proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            rc = None
        waited_s = time.perf_counter() - t0
        check(rc == 0, f"the export child's exit code {rc}: "
              + (root / "export.log").read_text()[-3000:])
        info = json.loads((root / "export.json").read_text())
        host, art = Path(info["host"]), root / "artifact"
        manifest = json.loads((art / "manifest.json").read_text())
        compile_s = {e["native_file"]: e["native_compile_s"]
                     for e in manifest["entries"]}
        tf32 = _tf32_in_packages([art / f for f in compile_s])
        check(not tf32, f"no TF32 in the compiled packages: {tf32}")
        print(f"phase 13 export --native (a child process started before "
              f"phase 11): {len(compile_s)} buckets (batch 1 x phoneme "
              f"{NATIVE_BUCKETS}) in {info['export_s']:.1f} s, of which "
              f"this phase waited {waited_s:.1f} s; AOTInductor compile s "
              f"per bucket "
              + ", ".join(f"{k} {v:.1f}" for k, v in compile_s.items())
              + "; package MB "
              + ", ".join(f"{e['native_file']} {e['native_bytes'] / 1e6:.1f}"
                          for e in manifest["entries"])
              + f"; host {host.name} built with g++ in "
              f"{info['build_s']:.1f} s (beside the compile) ({card})",
              flush=True)
        probe = subprocess.run([str(host), "--probe"], capture_output=True,
                               text=True, timeout=120)
        check(probe.returncode == 0, f"host --probe: {probe.stderr[-500:]}")
        needed = [ln for ln in subprocess.run(
            ["readelf", "-d", str(host)], capture_output=True,
            text=True).stdout.splitlines() if "(NEEDED)" in ln]
        check(bool(needed) and not any("libpython" in ln for ln in needed),
              f"the host links no libpython: {needed}")
        print(f"phase 13 host --probe: {probe.stdout.strip()}", flush=True)

        reqs = _native_requests(pipe, tp, pipe.vocab)
        torch.cuda.synchronize()
        free_before = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [str(host), "--artifact", str(art), "--lexicon", str(lexicon),
             "--device", "cuda:0" if dev.type == "cuda" else "cpu", "--npy"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1)
        log = []
        threading.Thread(target=lambda: log.extend(iter(
            proc.stderr.readline, "")), daemon=True).start()
        ready = json.loads(proc.stdout.readline() or "{}")
        boot_s = time.perf_counter() - t0
        check(ready.get("ready") is True,
              f"host ready line {ready}: " + "".join(log)[-2000:])
        check(ready["buckets"] == [[1, p] for p in NATIVE_BUCKETS],
              f"host buckets {ready['buckets']}")
        replies, client_ms, used = [], [], 0
        for verb, name, seed, temp, payload in reqs:
            t1 = time.perf_counter()
            proc.stdin.write(f"{verb}\t{root / name}\t{seed}\t{temp}\t"
                             f"{payload}\n")
            proc.stdin.flush()
            line = proc.stdout.readline()
            client_ms.append((time.perf_counter() - t1) * 1e3)
            check(bool(line), "host reply: " + "".join(log)[-2000:])
            replies.append(json.loads(line))
            used = max(used, free_before - torch.cuda.mem_get_info()[0])
        proc.stdin.close()
        rc = proc.wait(timeout=120)
        check(rc == 0, f"host exit code {rc}: " + "".join(log)[-2000:])

        # the Python reference on the same artifact and card
        ref = ExportedSynthesizer(art, text_processor=tp, device=dev)
        errs, frames, eager_ms = [], [], []
        for (verb, name, seed, temp, payload), rep in zip(reqs, replies):
            check("error" not in rep, f"{name}: {rep}")
            ids = ([int(i) for i in payload.split(",")] if verb == "ids"
                   else tp.text_to_ids(payload, ref.vocab).tolist())
            check(rep["ids"] == ids, f"{name}: host ids = Python frontend's")
            t1 = time.perf_counter()
            want, _, n, deficit = ref._synthesize_ids(np.asarray(ids), seed,
                                                       temp)
            eager_ms.append((time.perf_counter() - t1) * 1e3)
            check((rep["n_frames"], rep["deficit"]) == (n, deficit),
                  f"{name}: n_frames/deficit {rep['n_frames']}/"
                  f"{rep['deficit']} vs Python {n}/{deficit}")
            got = np.load(root / f"{name}_audio.npy")
            with wave.open(str(root / f"{name}.wav")) as w:
                check(w.getframerate() == 22050, f"{name}: 22050 Hz WAV")
                check(w.getnframes() == rep["n_frames"] * 256,
                      f"{name}: WAV has n_frames x 256 samples")
            peak = float(np.abs(want).max())
            check(got.shape == want.shape and peak > 0, f"{name}: shape")
            errs.append(float(np.abs(got.astype(np.float64) - want).max())
                        / peak)
            frames.append(n)
        check(max(errs) <= NATIVE_LIMIT,
              f"host vs ExportedSynthesizer {max(errs):.3e} <= "
              f"{NATIVE_LIMIT} of the peak")
        check(replies[0]["bucket"] == [1, 16] and replies[1]["bucket"]
              == [1, 32], "routing 16 -> 32")
        # the same text requests through Python's graph replay of the same
        # buckets' programs (AotPipeline), for the host's latency
        aot = AotPipeline(art, text_processor=tp, device=dev)
        aot.warmup()
        replay_ms = []
        for verb, name, seed, temp, payload in reqs:
            if verb == "synth":
                t1 = time.perf_counter()
                aot.synthesize(payload, seed=seed, temperature=temp)
                replay_ms.append((time.perf_counter() - t1) * 1e3)
        del aot, ref
        torch.cuda.empty_cache()
        server = [r["total_ms"] for r in replies]
        run = [r["run_ms"] for r in replies]
        print(f"phase 13 host over stdin: ready {boot_s:.2f} s after the "
              f"process started (cold_start_ms {ready['cold_start_ms']:.1f}: "
              f"loading {len(compile_s)} packages {ready['load_ms']:.1f} ms, "
              f"their first runs {ready['first_run_ms']:.1f} ms); "
              f"{len(replies)} requests (JAX's three, then a seeded burst "
              f"of {NATIVE_BURST}), frames {frames}; server-side total ms "
              f"p50 {_pct(server, 0.5):.2f} max {max(server):.2f} (run "
              f"p50 {_pct(run, 0.5):.2f}, upload p50 "
              f"{_pct([r['upload_ms'] for r in replies], 0.5):.3f}, fetch "
              f"p50 {_pct([r['fetch_ms'] for r in replies], 0.5):.3f}); "
              f"client-side ms p50 {_pct(client_ms, 0.5):.2f} max "
              f"{max(client_ms):.2f}; device memory the host took "
              f"{used / 2**20:.1f} MiB (free-memory drop over its run); "
              f"every audio vs ExportedSynthesizer <= {max(errs):.3e} of "
              f"the peak, ids, n_frames and deficit exact ({card})",
              flush=True)
        print(f"phase 13 the same requests in Python on the same artifact "
              f"(host clock, text in, host audio out): AotPipeline graph "
              f"replay p50 {_pct(replay_ms, 0.5):.2f} max "
              f"{max(replay_ms):.2f} ms ({len(replay_ms)} synth requests); "
              f"ExportedSynthesizer's eager program p50 "
              f"{_pct(eager_ms, 0.5):.2f} max {max(eager_ms):.2f} ms; the "
              f"host, client-side, p50 {_pct(client_ms, 0.5):.2f} ms "
              f"({card})", flush=True)
        if AOT_CHILD:
            print(f"phase 13 vs phase 8's serve --aot child (same run): "
                  f"ready {boot_s:.2f} vs {AOT_CHILD['boot_s']:.2f} s (the "
                  f"child serves once its first graph is captured); a "
                  f"request {_pct(client_ms, 0.5):.2f} ms (client p50, "
                  f"stdin) vs the child's one and first HTTP request "
                  f"{AOT_CHILD['req_ms']:.2f} ms ({card})", flush=True)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        stop_native_export(job)
    print(f"phase 13 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return mel_cuda.log_mel_cuda.launches


# -- phase 14: the diagnostics and pre-flight tools -----------------------------


def phase14_diagnostics(dev, card: str, stage_dirs) -> int:
    """The diagnostics path on the card (see the module docstring): tools
    4-11 of ``iris_tts_tpu_torch.scripts`` in-process through their
    ``main(argv)`` at full width, on phase 10's corpus and stage
    checkpoints. Each tool that reads the validation mels gets a fresh
    cache directory holding only the training vocab, so its mels go
    through the log-mel kernel. Returns the kernel's launches on this
    path, checked exactly."""
    import numpy as np

    from iris_tts_tpu_torch.data.audio_io import load_audio, read_wav
    from iris_tts_tpu_torch.data.ljspeech import LJSpeechDurationDataset
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram_plain
    from iris_tts_tpu_torch.scripts import (
        analyze_vae,
        debug_vae_loss,
        example,
        test_encoder_setup,
        test_synthesis,
        test_trained_encoder,
        test_vae_setup,
        validate_vae_checkpoint,
    )

    t_phase = time.perf_counter()
    root = Path(stage_dirs["tmp"].name) / "diagnostics"
    root.mkdir()
    corpus = ["--data_root", str(stage_dirs["data_root"]),
              "--alignment_dir", str(stage_dirs["aligned"])]
    stages = ["--encoder_checkpoint", str(stage_dirs["encoder"]),
              "--vae_checkpoint", str(stage_dirs["vae"])]
    mel_caches = []

    def cache(name: str, mels: bool) -> list:
        """A fresh cache directory with the training vocab in it."""
        d = root / f"cache_{name}"
        d.mkdir()
        shutil.copy(stage_dirs["vocab"], d / "phoneme_vocab.json")
        if mels:
            mel_caches.append(d / "mels")
        return ["--cache_dir", str(d)]

    times = {}

    def run(name, argv, module):
        t0 = time.perf_counter()
        out = module.main(argv)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    n_val = len(LJSpeechDurationDataset(
        stage_dirs["data_root"], stage_dirs["aligned"], split="val",
        cache_dir=stage_dirs["vocab"].parent, audio=stage_dirs["audio"]))
    check(n_val >= 1, f"a validation split ({n_val})")
    mel_cuda.log_mel_cuda.launches = 0

    s = run("test_encoder_setup", corpus + [
        "--cache_dir", str(root / "cache_setup")], test_encoder_setup)
    check(s["failures"] == 0 and math.isfinite(s["loss"]),
          f"test_encoder_setup {s}")
    print(f"phase 14 test_encoder_setup: SETUP OK, {s['samples']} corpus "
          f"samples, vocab {s['vocab_size']}, {s['n_params']:,} encoder "
          f"params, Huber loss {s['loss']:.4f} "
          f"({times['test_encoder_setup']:.2f} s)", flush=True)

    s = run("test_vae_setup", [], test_vae_setup)
    check(s["failures"] == 0, f"test_vae_setup {s}")
    print(f"phase 14 test_vae_setup: SETUP OK, generate() std "
          f"{s['gen_std']:.4f}, flow invertibility max-abs "
          f"{s['flow_err']:.3e} (< {test_vae_setup.FLOW_LIMIT}) "
          f"({times['test_vae_setup']:.2f} s)", flush=True)

    s = run("debug_vae_loss", [], debug_vae_loss)
    check(s["agree"], f"debug_vae_loss derivations agree {s}")
    print(f"phase 14 debug_vae_loss (IrisConfig()): step {s['step']}, "
          f"recompute {s['manual']}, raw numpy {s['raw']}; the three agree "
          f"within {debug_vae_loss.AGREE_LIMIT} "
          f"({times['debug_vae_loss']:.2f} s)", flush=True)

    s = run("test_trained_encoder", corpus + cache("encoder", False) + [
        "--encoder_checkpoint", str(stage_dirs["encoder"])],
        test_trained_encoder)
    check(s and s["n_samples"] == n_val and math.isfinite(s["mae_frames"]),
          f"test_trained_encoder {s}")
    print(f"phase 14 test_trained_encoder ({s['n_samples']} val "
          f"utterances): MAE {s['mae_frames']:.3f} frames "
          f"({s['mae_ms']:.1f} ms), RMSE {s['rmse_frames']:.3f}, corr "
          f"{s['corr']:.3f} -> {s['verdict']} "
          f"({times['test_trained_encoder']:.2f} s)", flush=True)

    s = run("validate_vae_checkpoint", corpus + stages
            + cache("validate", True), validate_vae_checkpoint)
    check(s and s["n_batches"] >= 1 and all(
        math.isfinite(v) for v in s["means"].values())
        and s["generate"]["finite"], f"validate_vae_checkpoint {s}")
    m = s["means"]
    print(f"phase 14 validate_vae_checkpoint ({s['n_batches']} batch): "
          f"recon L1 {m['recon_l1']:.4f} -> {s['verdict']}, KL "
          f"{m['kl']:.4f}, posterior-mean MCD {m['mcd_db']:.3f} dB, LSD "
          f"{m['lsd_db']:.3f} dB; generate() std "
          f"{s['generate']['std']:.4f}, mode collapse "
          f"{s['generate']['collapse']} "
          f"({times['validate_vae_checkpoint']:.2f} s)", flush=True)

    rows = run("analyze_vae", corpus + stages + cache("analyze", True),
               analyze_vae)
    check(len(rows) == min(4, n_val) and all(
        math.isfinite(r["mse"]) and math.isfinite(r["delta"]) for r in rows),
        f"analyze_vae {rows}")
    for r in rows:
        print(f"phase 14 analyze_vae [{r['file_id']}]: recon MSE "
              f"{r['mse']:.4f} ({r['rubric']}), recon std "
              f"{r['recon_std']:.3f} vs {r['target_std']:.3f}, posterior "
              f"|mean| {r['posterior_abs_mean']:.3f}; prior std "
              f"{r['gen_std']:.3f}; random-conditioning |delta| "
              f"{r['delta']:.3f} (live {r['live']}) "
              f"({times['analyze_vae']:.2f} s)", flush=True)

    s = run("test_synthesis", corpus + stages + cache("synthesis", True)
            + ["--output_dir", str(root / "synthesis")], test_synthesis)
    sr = stage_dirs["audio"].sample_rate
    for name in ("reference", "generated"):
        audio, rate = read_wav(s[name])
        check(rate == sr and len(audio) > 0
              and bool(np.isfinite(audio).all()), f"test_synthesis {name}")
    check(all(math.isfinite(s[k]) for k in ("mse", "mae", "mcd_db",
                                            "lsd_db")), f"test_synthesis {s}")
    print(f"phase 14 test_synthesis [{s['file_id']}] (Griffin-Lim, 60 "
          f"iterations on the card): MSE {s['mse']:.4f}, MAE {s['mae']:.4f},"
          f" MCD {s['mcd_db']:.3f} dB, LSD {s['lsd_db']:.3f} dB; "
          f"reference.wav and generated.wav written "
          f"({times['test_synthesis']:.2f} s)", flush=True)

    s = run("example", ["--output_wav", str(root / "example.wav")], example)
    audio, rate = read_wav(root / "example.wav")
    check(rate == sr and len(audio) == s["file_samples"] > 0
          and s["samples"] > 0, f"example {s}")
    print(f"phase 14 example (IrisConfig(), random weights): "
          f"{s['samples']} samples ({s['seconds']:.2f} s), "
          f"{s['file_samples']} to example.wav "
          f"({times['example']:.2f} s)", flush=True)

    # the path's launches, read after its last tool: one a val utterance
    # for validate_vae_checkpoint's cache, one an analyzed utterance, one
    # for test_synthesis's sample; then every cached mel against the plain
    # version
    launches = mel_cuda.log_mel_cuda.launches
    want = n_val + min(4, n_val) + 1
    check(launches == want,
          f"log-mel launches on the diagnostics path: {launches} == {want}")
    worst, n_mels = 0.0, 0
    for d in mel_caches:
        for f in sorted(d.glob("*.npy")):
            audio = load_audio(Path(stage_dirs["data_root"]) / "wavs"
                               / f"{f.stem}.wav")
            plain = log_mel_spectrogram_plain(
                torch.from_numpy(audio).to(dev), stage_dirs["audio"])
            cached = np.load(f)
            check(bool(np.isfinite(cached).all()), f"finite mel {f}")
            worst = max(worst, max_abs(cached, plain))
            n_mels += 1
    check(n_mels == want, f"a cached mel a launch ({n_mels})")
    check(worst <= 2e-3, f"diagnostics path mels vs plain max-abs {worst}")
    total = time.perf_counter() - t_phase
    print(f"phase 14 log-mel kernel on the diagnostics path: {launches} "
          f"launches ({n_val} val utterance(s) x validate_vae_checkpoint, "
          f"{min(4, n_val)} x analyze_vae, 1 x test_synthesis); every "
          f"cached mel within {worst:.3e} of the plain version", flush=True)
    print(f"phase 14 done in {total:.1f} s (tools: "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
          + f" s; {card})", flush=True)
    return launches


# -- phase 15: the speed-of-light, memory and vocoder-profile tools -----------

# The JAX tools' default dispatch: batch, phonemes, frames.
ANALYSIS_SHAPE = (8, 256, 1024)
# Frames of the f32 vocoder count held equal on the card and the CPU (the
# shape at which the CPU tests hold it to XLA's count, batch 1).
COUNT_CHECK_FRAMES = 32
MEM_ROWS = {"vae": [("vae", False), ("vae", True)],
            "gan": [("gan_gen", False), ("gan_disc", False),
                    ("gan_gen", True)]}


def phase15_analysis(dev, card: str, pipe, handoff):
    """The analysis path on the card (see the module docstring):
    ``roofline``, ``mem_analysis`` and ``profile_vocoder`` through their
    ``main(argv)`` on the card by default, beside the measured device time
    of the dispatch the roofline bounds and the tracker's memory rows.
    ``pipe`` is phase 3's pipeline (``IrisConfig()``, seed 0: the
    roofline's weights). Returns the kernel's launches on this path
    (checked to be 0) and (frames, budget, (FLOPs, bytes)) of phase 3's
    sentence, for the line after the profile."""
    import copy

    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.scripts import (
        mem_analysis,
        profile_vocoder,
        roofline,
    )

    t_phase = time.perf_counter()
    mel_cuda.log_mel_cuda.launches = 0
    B, P, T = ANALYSIS_SHAPE
    hop = pipe.config.hifigan.total_upsample

    # (a) the roofline of one fused dispatch, and the dispatch timed
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        report = roofline.main(["--batch", str(B), "--phonemes", str(P),
                                "--frames", str(T), "--dtype", dtype])
        count_s = time.perf_counter() - t0
        for r in report["stages"]:
            check(r["gflops"] > 0 and r["gbytes"] > 0,
                  f"roofline {dtype} {r['stage']}: work counted")
            print(f"phase 15 roofline {dtype} {r['stage']}: "
                  f"{r['gflops']:.3f} GFLOP, {r['gbytes']:.4f} GB, "
                  f"{r['arith_intensity']:.1f} FLOP/B -> t_fl "
                  f"{r['t_flops_ms']:.4f} ms, t_hbm {r['t_hbm_ms']:.4f} ms, "
                  f"{r['bound']}-bound, SoL {r['sol_rt_factor']:.0f}x "
                  f"realtime (B={B}, P={P}, T={T}; data-sheet peaks "
                  f"{report['peak_tflops']} TFLOP/s, "
                  f"{report['peak_hbm_gbps']} GB/s; {card})", flush=True)
        view = pipe if dtype == "float32" else replace(
            pipe, dtype=torch.bfloat16)
        fused = roofline.stage_fns(view, B, P, T)["fused end-to-end"]
        with torch.inference_mode():
            audio = fused()[0]
            check(audio.shape == (B, T * hop) and audio.dtype == torch.int16,
                  f"fused dispatch {dtype}: PCM16 [{B}, {T * hop}]")
            ms = time_cuda_ms(fused, reps=3, warmup=1, graph=False)
        e2e = report["stages"][-1]
        t_sol = max(e2e["t_flops_ms"], e2e["t_hbm_ms"])
        print(f"phase 15 fused dispatch {dtype} measured: {ms:.3f} ms of "
              f"device time (CUDA events around 3 eager calls after a "
              f"warm-up), {report['audio_s_per_dispatch'] * 1e3 / ms:.0f}x "
              f"realtime; t_sol {t_sol:.3f} ms ({e2e['bound']}), t_sol / "
              f"measured {t_sol / ms:.4f}; counted in {count_s:.1f} s "
              f"({card})", flush=True)

    mel = torch.zeros((1, COUNT_CHECK_FRAMES,
                       pipe.config.hifigan.in_channels))
    on_cpu = roofline.count_cost(copy.deepcopy(pipe.model.hifigan).cpu(),
                                 mel)
    on_card = roofline.count_cost(pipe.model.hifigan, mel.to(dev))
    check(on_card == on_cpu, f"f32 vocoder count, card {on_card} == CPU "
                             f"{on_cpu}")
    print(f"phase 15 f32 vocoder count at B=1, T={COUNT_CHECK_FRAMES}: "
          f"{on_card[0]} FLOPs, {on_card[1]} bytes on the card, equal to the "
          f"CPU's", flush=True)
    frames = len(pipe.synthesize(SENTENCE, seed=1)) // hop
    budget = pipe._fused_frame_budget(pipe._encode_texts([SENTENCE])[1])
    sentence = roofline.count_cost(lambda: pipe.synthesize(SENTENCE, seed=1))

    # (b) memory of the training steps: the allocator's rows (the CLI) and
    # the tracker's for the same steps on the card
    peaks = handoff.get("gan_round_peak_mib", {})
    for stage in ("vae", "gan"):
        for bf16 in (False, True):
            torch.cuda.empty_cache()
            rows = mem_analysis.main(["--stage", stage]
                                     + (["--bf16"] if bf16 else []))
            tracked = mem_analysis.analysis_rows(stage, 8, 1024, 64, bf16,
                                                 dev, method="tracker")
            for got in (rows, tracked):
                check([(r["stage"], r["remat"]) for r in got]
                      == MEM_ROWS[stage], f"mem_analysis {stage} rows")
                check(all(r["temp_mib"] > 0 for r in got),
                      f"mem_analysis {stage}: positive temp")
            for a, t in zip(rows, tracked):
                print(f"phase 15 mem_analysis {a['stage']} {a['dtype']} "
                      f"remat={a['remat']} B={a['B']} T={a['T']}: allocator "
                      f"temp {a['temp_mib']} / args {a['args_mib']} / out "
                      f"{a['out_mib']} MiB; tracker {t['temp_mib']} / "
                      f"{t['args_mib']} / {t['out_mib']} MiB; temp "
                      f"allocator/tracker "
                      f"{a['temp_mib'] / t['temp_mib']:.3f} ({card})",
                      flush=True)
    if peaks:
        print("phase 15 phase 9's GAN round peak (16 x 8192 samples, both "
              "steps): " + " / ".join(f"{k} {v:.1f}" for k, v in
                                      peaks.items())
              + f" MiB, beside the rows above (8 x 1024 frames, a step) "
              f"({card})", flush=True)

    # (c) the vocoder stage by stage at onchip_evidence.sh's shape, each
    # part's time beside its own bound at the data-sheet peaks
    for dtype in ("bf16", "f32"):
        prof = profile_vocoder.main(["--seconds", "12", "--batch", "8",
                                     "--dtype", dtype])
        check(all(v > 0 for v in prof["parts_ms"].values()),
              f"profile_vocoder {dtype}: every part timed")
        gen, x = profile_vocoder.build_generator(12, 8, dtype, dev)
        costs = {}
        with torch.no_grad():
            for name, call in profile_vocoder.stage_calls(gen):
                costs[name] = roofline.count_cost(call, x)
                x = call(x)
        del gen, x
        parts = []
        for r in roofline.roofline_rows(
                costs, 0.0, roofline.PEAK_TFLOPS[
                    "bfloat16" if dtype == "bf16" else "float32"],
                roofline.PEAK_HBM_GBPS):
            ms = prof["parts_ms"][r["stage"]]
            t_sol = max(r["t_flops_ms"], r["t_hbm_ms"])
            parts.append(f"{r['stage']} {ms:.3f} ms, {r['gflops']:.1f} "
                         f"GFLOP {r['gbytes']:.3f} GB, bound {t_sol:.3f} ms "
                         f"({r['bound']}), {t_sol / ms:.3f} of it")
        print(f"phase 15 profile_vocoder {dtype} (12 s x 8): full "
              f"{prof['full_ms']:.3f} ms, parts {prof['sum_ms']:.3f} ms; "
              + "; ".join(parts) + f" ({card})", flush=True)

    launches = mel_cuda.log_mel_cuda.launches
    check(launches == 0, f"log-mel launches on the analysis path: "
                         f"{launches} == 0")
    # The profile line after this phase times a warm call: this phase
    # emptied the allocator's cache, so one call refills its pools first.
    t0 = time.perf_counter()
    pipe.synthesize(SENTENCE, seed=1)
    print(f"phase 15 done in {time.perf_counter() - t_phase:.1f} s (the "
          f"sentence once more to refill the pools: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; {card})", flush=True)
    return launches, (frames, budget, sentence)


def phase15_sentence_line(card: str, sentence, busy_rows) -> None:
    """Phase 3's sentence: its counted work at the f32 data-sheet peaks
    beside the device busy time of the profile line just printed."""
    from iris_tts_tpu_torch.scripts import roofline

    frames, budget, cost = sentence
    r, = roofline.roofline_rows({"sentence": cost}, 0.0,
                                roofline.PEAK_TFLOPS["float32"],
                                roofline.PEAK_HBM_GBPS)
    t_sol = max(r["t_flops_ms"], r["t_hbm_ms"])
    busy_ms = sum(t for _, t in busy_rows) / 1e3
    busy = (f"device busy {busy_ms:.2f} ms in the profile line above, "
            f"{busy_ms / t_sol:.2f}x the bound" if busy_ms > 0
            else "device busy not measured")
    print(f"phase 15 the sentence ({frames} frames, a {budget}-frame fused "
          f"budget), f32: {r['gflops']:.3f} GFLOP, {r['gbytes']:.4f} GB -> "
          f"t_fl {r['t_flops_ms']:.3f} ms, t_hbm {r['t_hbm_ms']:.3f} ms "
          f"({r['bound']}-bound); {busy} ({card})", flush=True)



# -- phase 16: the benchmark drivers --------------------------------------------

# bench_serve on phase 7's cut ladders: the closed loop at the script's
# default depth (16 clients x 8 requests) in-process and over HTTP, then the
# fixed/adaptive A/B at one open-loop rate, 300 requests a configuration.
BENCH_SERVE_LADDERS = [
    "--phoneme_buckets", ",".join(map(str, SERVE_PHONEME_BUCKETS)),
    "--frame_buckets", ",".join(map(str, SERVE_FRAME_BUCKETS))]
BENCH_SERVE_RUNS = (
    ["--clients", "16", "--requests", "8"],
    ["--http", "--clients", "16", "--requests", "8"],
    ["--ab_max_batch_limit", "16", "--offered_qps", "20", "--requests",
     "300"],
)
# bench_mel at its defaults: two cases, each the kernel once for the
# max-abs, then avg_ms's warm-up call and 30 timed calls.
BENCH_MEL_LAUNCHES = 2 * (1 + 1 + 30)
# Values that may be 0: seconds JAX's rounding can leave at 0 on a fast
# card (the second trivial op's, a first call's to 0.1 s) and a count.
NON_NEGATIVE = {"cold_start_marginal_jit_s", "compile_s", "rejected_503"}


def _check_positive(row: dict, what: str) -> None:
    """Every number in a driver's JSON line (nested ones too) is positive,
    those of ``NON_NEGATIVE`` non-negative; the marginal scaling
    efficiency, a ratio of gains, may take either sign."""
    for k, v in row.items():
        if isinstance(v, dict):
            _check_positive(v, f"{what} {k}")
        elif (isinstance(v, (int, float)) and not isinstance(v, bool)
              and k != "marginal_scaling_eff"):
            check(v >= 0 if k in NON_NEGATIVE else v > 0,
                  f"{what}: {k} = {v} positive")


def phase16_serve_tail(card: str) -> None:
    """What ``bench_serve``'s slowest requests wait for. Each run builds a
    fresh pipeline, whose neural G2P loads its checkpoint on the first
    out-of-lexicon word, inside ``submit()`` on the client's thread: the
    script's closed loop (16 × 8), twice on one batcher built as the script
    builds it, the frontend cold and then warm, each request's text kept;
    then that text through a fresh frontend alone, cold and warm."""
    import numpy as np

    from iris_tts_tpu_torch import IrisConfig
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.scripts import bench_serve
    from iris_tts_tpu_torch.serve import DynamicBatcher
    from iris_tts_tpu_torch.text import PhonemeVocab, create_text_processor

    texts = bench_serve.TEXTS
    pipe = TTSPipeline.initialize(IrisConfig(), seed=0)
    pipe.phoneme_buckets = SERVE_PHONEME_BUCKETS
    pipe.frame_buckets = SERVE_FRAME_BUCKETS
    sr = pipe.config.audio.sample_rate
    g2p = pipe.text_processor.neural_g2p
    check(g2p is not None, "the pipeline's frontend has the neural G2P")
    batcher = DynamicBatcher(pipe, max_batch=8, max_wait_ms=5.0).start()
    try:
        for label in ("cold", "warm"):
            reqs = []

            def submit(text, timeout):
                t0 = time.perf_counter()
                audio = batcher.synthesize(text, timeout=timeout)
                reqs.append((time.perf_counter() - t0, texts.index(text)))
                return audio.shape[0] / sr

            lats, _, _, wall = bench_serve.closed_loop(submit, 16, 8, 600)
            check(len(lats) == 128, f"serve tail {label}: 128 requests")
            ms = np.sort(np.asarray(lats)) * 1e3
            top = sorted(reqs, reverse=True)[:7]  # the slowest 5%
            print(f"phase 16 bench_serve tail, frontend {label}: 16 x 8 "
                  f"closed loop on one batcher {128 / wall:.2f} req/s, "
                  f"p50 / p95 / max {ms[64]:.2f} / {ms[121]:.2f} / "
                  f"{ms[-1]:.2f} ms; the 7 slowest "
                  + ", ".join(f"{t * 1e3:.0f} ms (TEXTS[{i}])"
                              for t, i in top)
                  + f"; neural G2P loaded {g2p._loaded} ({card})",
                  flush=True)
    finally:
        batcher.stop()
    # each text once through a fresh frontend alone, noting which reach the
    # neural G2P (the first of them pays its checkpoint load), then again
    tp, vocab = create_text_processor(), PhonemeVocab.default_arpabet()
    calls = []
    predict = tp.neural_g2p.predict_batch
    tp.neural_g2p.predict_batch = lambda words: (calls.append(words),
                                                 predict(words))[1]
    rows = []
    for when in ("first", "again"):
        for i, text in enumerate(texts):
            n, t0 = len(calls), time.perf_counter()
            tp.text_to_ids(text, vocab)
            rows.append(f"TEXTS[{i}] {when} "
                        f"{(time.perf_counter() - t0) * 1e3:.2f} ms"
                        + (" (G2P)" if len(calls) > n else ""))
    print("phase 16 bench_serve tail, a fresh frontend alone: "
          + "; ".join(rows) + f" (host clock; {card})", flush=True)


def phase16_bench(card: str):
    """The benchmark drivers on the card (see the module docstring), each
    through its ``main(argv)`` as a user runs it, on its default device.
    Returns the log-mel launches on this path (checked: ``bench_mel``'s
    exactly) and the worst kernel-vs-plain max-abs of its outputs."""
    from iris_tts_tpu_torch import bench
    from iris_tts_tpu_torch.config import AudioConfig
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram_plain
    from iris_tts_tpu_torch.scripts import (
        bench_batch_sweep,
        bench_mel,
        bench_serve,
        bench_stream,
        bench_train,
    )

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the cold-start children share the card
    mel_cuda.log_mel_cuda.launches = 0
    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t0
        return out

    # (a) the headline bench, its cold-start children first
    line = timed("bench", lambda: bench.main([]))
    check(line["metric"] == "synthesis_rtf_per_chip", "bench metric")
    check(line["bulk_batch"] == bench.BULK_BATCH, "bench bulk batch")
    check("cold_start_to_first_audio_s" in line, "bench ran its cold start")
    check(line["sol_fraction"] <= 1.0,
          f"bench sol_fraction {line['sol_fraction']} <= 1.0")
    _check_positive(line, "bench")
    print(f"phase 16 bench: {line['value']}x realtime at B="
          f"{line['bulk_batch']} (rtf_b8 {line['rtf_b8']}x), "
          f"{line['mel_frames_per_sec']} mel frames/s; p50 fused "
          f"{line['p50_fused_dispatch_ms']} ms, public API "
          f"{line['p50_public_api_ms']} ms (PCM16 "
          f"{line['p50_public_api_pcm16_ms']} ms); speed of light "
          f"{line['sol_rt_factor']}x ({line['sol_bound']}), sol_fraction "
          f"{line['sol_fraction']}; cold start to first audio "
          f"{line['cold_start_to_first_audio_s']} s (export "
          f"{line['aot_export_s']} s) in {walls['bench']:.1f} s ({card})",
          flush=True)

    # (b) throughput against batch size
    rows = timed("bench_batch_sweep",
                 lambda: bench_batch_sweep.main(["--batches", "1,8,32"]))
    check([r["batch"] for r in rows] == [1, 8, 32], "sweep batches")
    check(rows[0]["marginal_scaling_eff"] is None
          and all(r["marginal_scaling_eff"] is not None for r in rows[1:]),
          "sweep efficiency from the second point on")
    for r in rows:
        _check_positive(r, f"sweep B={r['batch']}")
    print("phase 16 bench_batch_sweep (bf16, 1024 frames): " + "; ".join(
        f"B={r['batch']} {r['rtf']}x, {r['step_ms']} ms, eff "
        f"{r['marginal_scaling_eff']}" for r in rows)
        + f" in {walls['bench_batch_sweep']:.1f} s ({card})", flush=True)

    # (c) serving under load
    for i, argv in enumerate(BENCH_SERVE_RUNS):
        payloads = timed(f"bench_serve {i}",
                         lambda: bench_serve.main(argv + BENCH_SERVE_LADDERS))
        check(len(payloads) == (2 if "--ab_max_batch_limit" in argv else 1),
              f"bench_serve {argv}: one line a configuration")
        for p in payloads:
            check(p["requests_completed"] == p["requests_sent"],
                  f"bench_serve {argv}: {p['requests_completed']} of "
                  f"{p['requests_sent']} requests completed")
            _check_positive(p, f"bench_serve {argv}")
            print(f"phase 16 bench_serve {p['mode']} {p['transport']} "
                  f"batcher={p['batcher']} limit={p['max_batch_limit']} "
                  f"rate={p['offered_qps']}: {p['value']} req/s, p50/p95/max "
                  f"{p['latency_ms']['p50']} / {p['latency_ms']['p95']} / "
                  f"{p['latency_ms']['max']} ms, {p['audio_rt_factor']}x "
                  f"realtime, mean batch {p['mean_batch_size']} "
                  f"{p['batch_size_hist']} ({card})", flush=True)
        print(f"phase 16 bench_serve run {i} in "
              f"{walls[f'bench_serve {i}']:.1f} s", flush=True)
    timed("bench_serve tail", lambda: phase16_serve_tail(card))

    # (d) the streaming vocoder against the full pass
    for argv in ([], ["--pcm16"]):
        res = timed(f"bench_stream {argv}", lambda: bench_stream.main(argv))
        check(res["ok"], f"bench_stream {argv}: stream equals the full pass")
        _check_positive({k: v for k, v in res.items() if k != "err"},
                        f"bench_stream {argv}")
        print(f"phase 16 bench_stream {argv}: full {res['full_ms']:.2f} ms, "
              f"TTFA {res['ttfa_ms']:.2f} ms, total {res['total_ms']:.2f} "
              f"ms, {res['chunks']} chunks, err {res['err']} ({card})",
              flush=True)

    # (e) training throughput
    for stage in ("vae", "gan"):
        for extra in ([], ["--bf16"]):
            argv = ["--stage", stage] + extra
            out = timed(f"bench_train {argv}",
                        lambda: bench_train.main(argv))
            _check_positive(out, f"bench_train {argv}")
            print(f"phase 16 bench_train {argv}: {out['metric']} "
                  f"{out['value']} {out['unit']}, {out['step_ms']} ms a "
                  f"step, batch {out['batch']} ({card})", flush=True)

    # (f) the log-mel kernel against the differentiable composition
    mel = timed("bench_mel", lambda: bench_mel.main([]))
    launches = mel_cuda.log_mel_cuda.launches
    check(launches == BENCH_MEL_LAUNCHES,
          f"log-mel launches on the bench path: {launches} == "
          f"{BENCH_MEL_LAUNCHES}")
    cfg = AudioConfig()
    # bench_mel's inputs at its defaults, on the card
    d = bench_mel.build_parser().parse_args([])
    inputs = dict(zip(("single", "batch"), bench_mel.make_inputs(
        d.seconds, d.batch, cfg, torch.device("cuda"))))
    worst = 0.0
    for case in ("single", "batch"):
        res = mel[case]
        check(res is not None, f"bench_mel {case} ran the kernel")
        check(res["maxabs"] <= 2e-3, f"bench_mel {case}: kernel vs xla "
                                     f"{res['maxabs']} <= 2e-3")
        errs = [max_abs(mel_cuda.log_mel_cuda(a, cfg),
                        log_mel_spectrogram_plain(a, cfg))
                for a in inputs[case]]
        check(max(errs) <= 2e-3, f"bench_mel {case}: kernel vs plain "
                                 f"{max(errs)} <= 2e-3")
        worst = max(worst, max(errs))
        print(f"phase 16 bench_mel {case}: xla {res['xla_ms']:.4f} ms, "
              f"kernel {res['kernel_ms']:.4f} ms (avg_ms: eager, host "
              f"clock), {res['speedup']:.2f}x; kernel vs xla "
              f"{res['maxabs']:.3e}, vs plain {max(errs):.3e} ({card})",
              flush=True)
    print(f"phase 16 done in {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f"; {launches} log-mel launches, all from bench_mel ({card})",
          flush=True)
    return launches, worst

# -- phase 11: multi-device on one card ----------------------------------------

# Eight sentences for the data-parallel batch (four a rank at world size 2).
MESH_TEXTS = SERVE_TEXTS[:7] + [SENTENCE]
PP_BATCHES = [BATCH[:2], MESH_TEXTS[:4], [SHORT]]
# A rank's rows or window against the whole: cuDNN picks algorithms per
# shape, so cross-shape results are held to this share of the peak; same
# shapes (world size 1) are bitwise.
MESH_SHAPE_LIMIT = 1e-5
# Mesh SGD steps against single-process ones at full width: the params'
# (and separately the buffers') max-abs difference, as a share of the
# largest change the single-process steps made to them (the gradients
# differ by cross-rank summation order and per-shape algorithms only). Each
# run also holds the check's power: the same mesh steps with the gradient
# all-reduce left out (a fault planted for that one run) must read above
# the limit. Float32 rounding lies under the share: an element within
# MESH_TRAIN_ULPS float spacings of its single-process value counts as
# equal, so one flipped ulp of a BatchNorm scale near 1.0 (1.2e-7, which
# the share alone allows only 1.4e-7 in PostNet) cannot fail the run; the
# limit is then held by the elements past that floor. PERF.md (phase 11)
# gives each stage's readings of both, sound and planted, against it.
MESH_TRAIN_SHARE = 3e-3
MESH_TRAIN_ULPS = 4
MESH_DEADLINE_S = {"11a": 360, "11b": 600, "11c": 600}
MESH_TRAIN_STEPS = 3


def _mesh_train_cases(dev):
    """Full-width (``IrisConfig()``) seeded modules and random batches of 16
    for one case per stage: (stage, trained module, frozen modules, batches,
    lr, extras). The PostNet batch's second half has other statistics."""
    import torch.nn as nn

    from iris_tts_tpu_torch import IrisConfig
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
    from iris_tts_tpu_torch.runtime import seeded_generator

    cfg = IrisConfig()
    g = torch.Generator().manual_seed(11)
    b, p, t = 16, 64, 256

    def init(m, seed):
        init_params(m, seeded_generator(seed, "cpu"))
        return m.to(dev)

    def batch(shift=False):
        lengths = torch.randint(16, p + 1, (b,), generator=g)
        mask = (torch.arange(p)[None] < lengths[:, None]).float()
        mel = torch.randn(b, t, cfg.vae.n_mels, generator=g)
        if shift:
            mel[b // 2:] = 3.0 * mel[b // 2:] + 1.0
        return {"phoneme_ids": (torch.randint(
                    2, cfg.encoder.vocab_size, (b, p), generator=g)
                    * mask).long(),
                "durations": torch.randint(1, 5, (b, p), generator=g)
                * mask, "phoneme_mask": mask, "mel": mel}

    def enc_dur():
        return init(nn.ModuleDict({
            "encoder": PhonemeEncoder(cfg.encoder),
            "duration": DurationPredictor(cfg.encoder.embed_dim,
                                          cfg.duration)}), 1)

    def frozen_vae():
        return init(TextConditionedVAE(cfg.vae), 2)

    seg = 32
    hop = cfg.hifigan.total_upsample
    steps = range(MESH_TRAIN_STEPS)
    batches = {
        "duration": [batch() for _ in steps],
        "vae": [batch() for _ in steps],
        "postnet": [batch(shift=True) for _ in steps],
        "gan": [{"mel": torch.randn(b, seg, cfg.vae.n_mels, generator=g),
                 "audio": 0.3 * torch.randn(b, seg * hop, generator=g)}
                for _ in steps],
    }
    # name → (stage, fresh (module, frozen), batches, lr, extras)
    return cfg, {
        "duration": ("duration", lambda: (enc_dur(), None),
                     batches["duration"], 1e-3, ()),
        "vae": ("vae", lambda: (frozen_vae(),
                                {"encoder": enc_dur()["encoder"]}),
                batches["vae"], 1e-3, (0.5,)),
        "postnet": ("postnet", lambda: (
            init(PostNet(cfg.postnet), 3),
            {"encoder": enc_dur()["encoder"], "vae": frozen_vae()}),
            batches["postnet"], 1e-3, ()),
        "gan": ("gan", lambda: ((init(HiFiGANGenerator(cfg.hifigan), 4),
                                 init(HiFiGANDiscriminators(), 5)), None),
                batches["gan"], 1e-4, ()),
    }


@contextlib.contextmanager
def _without_gradient_sum():
    """A planted fault, for the training check's power only: the train
    state's gradient all-reduce does nothing within the block."""
    from iris_tts_tpu_torch.train import state as tstate

    real = tstate.all_reduce_flat_
    tstate.all_reduce_flat_ = lambda *a, **k: 0
    try:
        yield
    finally:
        tstate.all_reduce_flat_ = real


@contextlib.contextmanager
def _without_input_gradient_sum():
    """A planted fault, for the model axis' training check's power only:
    the sum of a column-parallel layer's input gradient over the model
    group does nothing within the block."""
    from iris_tts_tpu_torch.parallel import tp

    real = tp.input_grad_sum_
    tp.input_grad_sum_ = lambda grad, axis: grad
    try:
        yield
    finally:
        tp.input_grad_sum_ = real


def _mesh_train_run(cfg, case, dev, mesh, steps: int, fault=None):
    """Run one case's steps with SGD (clip 1.0), in one process (``mesh``
    None) or as one rank of ``mesh`` (``mesh_training_placement``; within
    the ``fault`` context, a planted fault) → (whole state dict(s) after,
    per-step metrics, median step ms of steps 2+, state dict(s) before,
    the buffers' names)."""
    from iris_tts_tpu_torch.parallel.sharding import full_state_dict
    from iris_tts_tpu_torch.scripts.common import mesh_training_placement
    from iris_tts_tpu_torch.train import steps as tsteps
    from iris_tts_tpu_torch.train.gan import GANState, make_gan_train_step
    from iris_tts_tpu_torch.train.state import TrainState, Tx

    stage, make, batches, lr, extras = case
    module, frozen = make()

    def sgd(m, seed, frozen=None):
        st = TrainState.create(m, Tx(lr, clip_norm=1.0), seed,
                               frozen=frozen)
        st.optimizer = torch.optim.SGD(m.parameters(), lr=lr)
        return st

    if stage == "gan":
        state = GANState(sgd(module[0], 5), sgd(module[1], 6))
        step = make_gan_train_step(cfg)
    else:
        state = sgd(module, 5, frozen)
        step = {"duration": tsteps.make_duration_train_step,
                "vae": tsteps.make_vae_train_step,
                "postnet": lambda c: tsteps.make_postnet_train_step(c)
                }[stage](cfg)
    place = lambda b: {k: v.to(dev) for k, v in b.items()}  # noqa: E731
    if mesh is not None:
        state, place = mesh_training_placement(state, mesh=mesh)

    def snapshot():
        if stage == "gan":
            return {**{f"gen.{k}": v.detach().cpu().clone() for k, v in
                       full_state_dict(state.gen.params).items()},
                    **{f"disc.{k}": v.detach().cpu().clone() for k, v in
                       full_state_dict(state.disc.params).items()}}
        return {k: v.detach().cpu().clone()
                for k, v in full_state_dict(state.params).items()}

    if stage == "gan":
        buffers = {f"{side}.{k}" for side, st in (("gen", state.gen),
                                                  ("disc", state.disc))
                   for k, _ in st.params.named_buffers()}
    else:
        buffers = {k for k, _ in state.params.named_buffers()}
    before = snapshot()
    metrics, times = [], []
    for b in batches[:steps]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (fault() if fault else contextlib.nullcontext()):
            state, m = step(state, place(b), *extras)
        metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return (snapshot(), metrics, statistics.median(times[1:] or times),
            before, buffers)


def _train_errs(got, single, ulps: int = 0) -> dict:
    """Max-abs of ``got``'s state against the single-process run's, for
    the params and the buffers apart (float tensors); with ``ulps``, over
    the elements more than that many float spacings of the single-process
    value away from it."""
    out = {"params": 0.0, "buffers": 0.0}
    for k, v in single[0].items():
        if not v.is_floating_point():
            continue
        kind = "buffers" if k in single[4] else "params"
        w = v.detach().cpu()
        g = got[0][k].detach().cpu()
        check(g.shape == w.shape, f"{k}: {tuple(g.shape)} vs {tuple(w.shape)}")
        if not w.numel():
            continue
        d = (g.double() - w.double()).abs()
        if ulps:
            a = w.abs()
            gap = (torch.nextafter(a, torch.full_like(a, math.inf)) - a)
            d = torch.where(d <= ulps * gap.double(), 0.0, d)
        out[kind] = max(out[kind], float(d.max()))
    return out


def _metric_err(got, single) -> float:
    return max(abs(a[k] - w[k]) / max(1.0, abs(w[k]))
               for a, w in zip(got[1], single[1]) for k in w)


def _mesh_train_compare(cfg, cases, dev, mesh, steps, label, card,
                        share: float, metric_tol: float,
                        fault=_without_gradient_sum,
                        fault_name: str = "the gradient all-reduce") -> dict:
    """Each stage in one process, then as a rank of ``mesh``, from the same
    initial weights on the same batches; params and buffers (BatchNorm
    statistics) compared, each within ``share`` of the largest change the
    single-process steps made to them (0: bitwise), and metrics compared.
    With ``share`` > 0 the elements within ``MESH_TRAIN_ULPS`` float
    spacings count as equal, and the mesh steps run again with a planted
    ``fault`` (by default without the gradient all-reduce), whose reading
    must lie above the limit → per-stage numbers."""
    ulps = MESH_TRAIN_ULPS if share > 0 else 0
    out = {}
    for name, case in cases.items():
        single = _mesh_train_run(cfg, case, dev, None, steps)
        meshed = _mesh_train_run(cfg, case, dev, mesh, steps)
        moved = _train_errs((single[3],), single)
        limit = {k: share * v for k, v in moved.items()}
        err = _train_errs(meshed, single)
        past = _train_errs(meshed, single, ulps)
        metric_err = _metric_err(meshed, single)
        check(single[1] and single[1][0], f"{label} {name} metrics")
        for kind in err:
            check(past[kind] <= limit[kind],
                  f"{label} {name} {kind} max-abs {past[kind]} past "
                  f"{ulps} float spacings <= {limit[kind]} ({share} of "
                  f"{moved[kind]})")
        check(metric_err <= metric_tol,
              f"{label} {name} metrics {metric_err} <= {metric_tol}")
        row = {"params_max_abs": err["params"],
               "buffers_max_abs": err["buffers"],
               "params_past_ulps": past["params"],
               "buffers_past_ulps": past["buffers"],
               "params_moved": moved["params"],
               "buffers_moved": moved["buffers"],
               "metrics_rel": metric_err,
               "single_ms": single[2], "mesh_ms": meshed[2]}
        planted = ""
        if share > 0:
            faulty = _mesh_train_run(cfg, case, dev, mesh, steps,
                                     fault=fault)
            bad = _train_errs(faulty, single, ulps)
            check(max(bad[k] - limit[k] for k in bad) > 0,
                  f"{label} {name}: without {fault_name} ({bad}, past "
                  f"{ulps} float spacings) reads above the limit {limit}")
            row.update(fault_params_past_ulps=bad["params"],
                       fault_buffers_past_ulps=bad["buffers"],
                       fault_metrics_rel=_metric_err(faulty, single))
            planted = (f"; without {fault_name} (planted) params "
                       f"{bad['params']:.3e}, buffers "
                       f"{bad['buffers']:.3e} past {ulps} float spacings, "
                       f"metrics {row['fault_metrics_rel']:.1e}")
        out[name] = row
        print(f"{label} {name}: {steps} SGD step(s) at batch 16 "
              f"({16 // mesh.data_size} a rank, mesh {mesh.shape}) vs one "
              f"process: params "
              f"max-abs {err['params']:.3e}, {past['params']:.3e} past "
              f"{ulps} float spacings (limit {limit['params']:.3e} = "
              f"{share} of the steps' largest change {moved['params']:.3e})"
              f", buffers {err['buffers']:.3e}, {past['buffers']:.3e} past "
              f"(limit {limit['buffers']:.3e}), metrics "
              f"{metric_err:.1e}{planted}; "
              f"step {single[2]:.2f} ms in one process, {meshed[2]:.2f} ms "
              f"as a rank of {mesh.size} (median; {card})", flush=True)
    return out


def _stop_flag_ms(mesh) -> float:
    """Median host ms of the train loop's per-step stop-flag agreement
    (``parallel.mesh.any_rank``), 50 calls after 5 warm ones."""
    from iris_tts_tpu_torch.parallel.mesh import any_rank

    times = []
    for i in range(55):
        t0 = time.perf_counter()
        any_rank(False, mesh, "stop_flag")
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[5:])


def _rank_11a(dev, rank: int, workdir: Path) -> dict:
    """NCCL at world size 1: the 1×1 mesh of a process group calls every
    collective of its paths on NCCL (a one-rank all-reduce is exact), and
    every mesh path is bitwise the off-mesh one; then the NCCL all-reduce
    of the full model's gradient bucket, timed."""
    import numpy as np
    import torch.distributed as dist

    from iris_tts_tpu_torch.parallel import build_mesh
    from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES

    card = card_line()
    pipe = _serving_pipeline(dev, "phase 11a")
    mel = np.random.default_rng(7).standard_normal((700, 80)).astype(
        np.float32)
    want = (pipe.synthesize(MESH_TEXTS, seed=5, temperature=0.667),
            pipe.synthesize(MESH_TEXTS, seed=6, temperature=0.667,
                            fused=True), pipe.vocode(mel))
    mesh = build_mesh()
    check(mesh.size == 1 and mesh.backend == "nccl"
          and mesh.group is not None, "a 1x1 mesh on NCCL")
    pipe.use_mesh(mesh)
    got = (pipe.synthesize(MESH_TEXTS, seed=5, temperature=0.667),
           pipe.synthesize(MESH_TEXTS, seed=6, temperature=0.667,
                           fused=True), pipe.vocode_sharded(mel))
    for g_rows, w_rows in zip(got[:2], want[:2]):
        for g, w in zip(g_rows, w_rows):
            check(np.array_equal(g, w), "use_mesh bitwise at world size 1")
    check(np.array_equal(got[2], want[2]),
          "vocode_sharded bitwise vocode at world size 1")
    print(f"phase 11a NCCL world size 1: use_mesh synthesize of "
          f"{len(MESH_TEXTS)} sentences at temperature 0.667 (two-stage and "
          f"fused) and vocode_sharded of 700 frames bitwise the off-mesh "
          f"calls", flush=True)
    # Bitwise needs deterministic kernels: the embedding's and some
    # convolutions' backward passes otherwise add with atomics, in an order
    # that differs from run to run (7.5e-9 between two one-process steps).
    torch.use_deterministic_algorithms(True)
    cfg, cases = _mesh_train_cases(dev)
    train = _mesh_train_compare(cfg, cases, dev, mesh, 1, "phase 11a", card,
                                share=0.0, metric_tol=0.0)
    torch.use_deterministic_algorithms(False)
    stop_ms = _stop_flag_ms(mesh)
    print(f"phase 11a stop flag agreed on the host (gloo side group, CPU "
          f"tensor) once a train step: {stop_ms:.4f} ms (median of 50; "
          f"{card})", flush=True)
    n = sum(p.numel() for p in pipe.model.parameters())
    flat = torch.ones(n, device=dev)
    ms = time_cuda_ms(lambda: dist.all_reduce(flat), reps=20, graph=False)
    print(f"phase 11a NCCL all-reduce of the full model's gradient bucket "
          f"({n / 1e6:.2f} M f32, {4 * n / 1e6:.1f} MB) at world size 1: "
          f"{ms:.4f} ms (events around 20 calls; {card})", flush=True)
    return {"train": train, "grad_bucket_bytes": 4 * n,
            "nccl_all_reduce_ms": ms, "stop_flag_ms": stop_ms,
            "collectives": {f"{p} {op} ({b})": c
                            for (p, op, b), c in COLLECTIVES.items()}}


def _rank_11b(dev, rank: int, workdir: Path) -> dict:
    """gloo at world size 2, both ranks on this card (NCCL refuses two
    ranks on one GPU): use_mesh, vocode_sharded, the pipeline split, the
    four stages' mesh steps and ``train_full_pipeline --mesh``."""
    import numpy as np
    import torch.distributed as dist

    from iris_tts_tpu_torch.models.pipeline import host_pcm16
    from iris_tts_tpu_torch.ops import mel_cuda
    from iris_tts_tpu_torch.parallel import (
        PipelineParallelSynthesizer,
        build_mesh,
    )
    from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES
    from iris_tts_tpu_torch.scripts import train_full_pipeline

    card = card_line()
    label = f"phase 11b rank {rank}"
    pipe = _serving_pipeline(dev, label)
    mel = np.random.default_rng(7).standard_normal((700, 80)).astype(
        np.float32)
    want_b = pipe.synthesize(MESH_TEXTS, seed=5, temperature=0.667)
    want_f = pipe.synthesize(MESH_TEXTS, seed=6, temperature=0.667,
                             fused=True)
    want_v = pipe.vocode(mel)
    want_pp = [pipe.synthesize(b, seed=3, fused=True) for b in PP_BATCHES]
    mesh = build_mesh(devices=[dev] * 2)
    check(mesh.size == 2 and mesh.backend == "gloo", "a 2x1 gloo mesh")
    pipe.use_mesh(mesh)
    worst = {}

    def rows(name, got, want):
        check(len(got) == len(want), f"{name} rows")
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"{name} lengths {g.shape} {w.shape}")
            err = max(err, max_abs(g, w) / float(np.abs(w).max()))
        check(err <= MESH_SHAPE_LIMIT,
              f"{name} {err} of the peak <= {MESH_SHAPE_LIMIT}")
        worst[name] = err

    t0 = time.perf_counter()
    rows("use_mesh two-stage", pipe.synthesize(
        MESH_TEXTS, seed=5, temperature=0.667), want_b)
    staged_ms = 1e3 * (time.perf_counter() - t0)
    rows("use_mesh fused", pipe.synthesize(
        MESH_TEXTS, seed=6, temperature=0.667, fused=True), want_f)
    rows("vocode_sharded", [pipe.vocode_sharded(mel)], [want_v])
    got16 = pipe.vocode_sharded(mel, pcm16=True)
    lsb = int(np.abs(got16.astype(np.int32)
                     - host_pcm16(want_v).astype(np.int32)).max())
    check(got16.dtype == np.int16 and lsb <= 1, f"PCM16 within 1 LSB ({lsb})")
    pp = PipelineParallelSynthesizer(pipe, split=1)
    got_pp = list(pp.synthesize_batches(PP_BATCHES, seed=3))
    for i, (g, w) in enumerate(zip(got_pp, want_pp)):
        rows(f"pipeline split batch {i}", g, w)
    print(f"{label}: use_mesh of {len(MESH_TEXTS)} sentences ("
          f"{len(MESH_TEXTS) // 2} a rank, temperature 0.667), "
          f"vocode_sharded of 700 frames (and PCM16 within {lsb} LSB), "
          f"pipeline split (split=1, 3 batches) vs one process: worst "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" of the peak; two-stage call {staged_ms:.1f} ms wall ({card})",
          flush=True)

    cfg, cases = _mesh_train_cases(dev)
    train = _mesh_train_compare(cfg, cases, dev, mesh, MESH_TRAIN_STEPS,
                                label, card, share=MESH_TRAIN_SHARE,
                                metric_tol=1e-5)
    stop_ms = _stop_flag_ms(mesh)
    print(f"{label}: stop flag agreed on the host (the gloo world group, "
          f"CPU tensor) once a train step: {stop_ms:.4f} ms (median of 50; "
          f"{card})", flush=True)
    n = sum(p.numel() for p in pipe.model.parameters())
    flat = torch.ones(n, device=dev)
    for _ in range(2):
        dist.all_reduce(flat)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    gloo_ms = statistics.median(times)
    print(f"{label}: gloo all-reduce of the full model's gradient bucket "
          f"({n / 1e6:.2f} M f32, {4 * n / 1e6:.1f} MB, CUDA tensors, two "
          f"ranks on one card): {gloo_ms:.2f} ms (median of 5, host wall "
          f"to a synchronize; {card})", flush=True)

    # train_full_pipeline --mesh with phase 10's flags
    data_root = workdir / "corpus" / "LJSpeech-1.1"
    cache, out = workdir / "cache", workdir / "run"
    mel_cuda.log_mel_cuda.launches = 0
    seen = {}
    evaluate = train_full_pipeline.evaluate

    def counted(*a, **k):
        seen["train_launches"] = mel_cuda.log_mel_cuda.launches
        return evaluate(*a, **k)

    train_full_pipeline.evaluate = counted
    t0 = time.perf_counter()
    summary = train_full_pipeline.main([
        "--data_root", str(data_root),
        "--alignment_dir", str(workdir / "corpus" / "aligned"),
        "--cache_dir", str(cache), "--output_dir", str(out),
        "--batch_size", "16", "--encoder_epochs", "1",
        "--vae_epochs", "1", "--postnet_epochs", "1",
        "--gan_epochs", "1", "--gan_batch", "16",
        "--segment_frames", "32", "--eval_samples", "4",
        "--artifact_half", "--mesh", "--device", str(dev)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = mel_cuda.log_mel_cuda.launches
    train_launches = seen.get("train_launches", launches)
    print(f"{label}: train_full_pipeline --mesh (phase 10's flags) in "
          f"{run_s:.1f} s; log-mel launches {train_launches} in the stages, "
          f"{launches} in all ({card})", flush=True)
    return {"worst": worst, "pcm16_lsb": lsb, "train": train,
            "grad_bucket_bytes": 4 * n, "gloo_all_reduce_ms": gloo_ms,
            "staged_ms": staged_ms, "cli_s": run_s, "stop_flag_ms": stop_ms,
            "launches": launches, "train_launches": train_launches,
            "summary": summary,
            "collectives": {f"{p} {op} ({b})": c
                            for (p, op, b), c in COLLECTIVES.items()}}


def _param_bytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _rank_11c(dev, rank: int, workdir: Path) -> dict:
    """gloo at world size 2 as a 1×2 (data, model) mesh on this card: the
    model axis (tensor parallelism). ``use_mesh`` fused and two-stage and
    ``vocode_sharded`` against one process, parameter bytes a rank, peak
    memory, tensor-parallel vs one-process ms, and three SGD steps of each
    stage with the planted input-gradient fault."""
    import numpy as np

    from iris_tts_tpu_torch.config import MeshConfig
    from iris_tts_tpu_torch.parallel import build_mesh
    from iris_tts_tpu_torch.parallel.mesh import COLLECTIVES
    from iris_tts_tpu_torch.parallel.sharding import sharded_params

    card = card_line()
    label = f"phase 11c rank {rank}"
    pipe = _serving_pipeline(dev, label)
    mel = np.random.default_rng(7).standard_normal((700, 80)).astype(
        np.float32)

    def timed(fn, reps=3, warm=True):
        if warm:
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return out, statistics.median(times)

    def staged():
        return pipe.synthesize(MESH_TEXTS, seed=5, temperature=0.667)

    def fused():
        return pipe.synthesize(MESH_TEXTS, seed=6, temperature=0.667,
                               fused=True)

    def sentence():
        return pipe.synthesize(SENTENCE, seed=1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    want_b, one_b_ms = timed(staged)
    want_f, one_f_ms = timed(fused)
    want_s, one_s_ms = timed(sentence)
    want_v = pipe.vocode(mel)
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated(dev)
    sizes = {k: v.numel() * v.element_size()
             for k, v in pipe.model.state_dict().items()}
    one_bytes = _param_bytes(pipe.model)
    mesh = build_mesh(MeshConfig(model_parallel=2), [dev] * 2)
    check(mesh.shape == {"data": 1, "model": 2} and mesh.backend == "gloo"
          and mesh.model_rank == rank, "a 1x2 (data, model) gloo mesh")
    pipe.use_mesh(mesh, MeshConfig(model_parallel=2))  # a sharded copy
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    split = sharded_params(pipe.model)
    tp_bytes = _param_bytes(pipe.model)
    half = sum(sizes[k] for k in split) // 2
    check(split and tp_bytes == one_bytes - half,
          f"a rank holds half of each of the {len(split)} sharded leaves: "
          f"{tp_bytes} = {one_bytes} - {half} bytes")
    worst = {}

    def rows(name, got, want):
        check(len(got) == len(want), f"{name} rows")
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"{name} lengths {g.shape} {w.shape}")
            err = max(err, max_abs(g, w) / float(np.abs(w).max()))
        check(err <= MESH_SHAPE_LIMIT,
              f"{name} {err} of the peak <= {MESH_SHAPE_LIMIT}")
        worst[name] = err

    # a batch of 8 takes seconds on the model axis here (each gather crosses
    # the host): one timed call, with no warm one before it (the script's
    # time limit), so it carries the sharded shapes' first-call set-up
    got_b, tp_b_ms = timed(staged, reps=1, warm=False)
    rows("use_mesh two-stage", got_b, want_b)
    got_f, tp_f_ms = timed(fused, reps=1, warm=False)
    rows("use_mesh fused", got_f, want_f)
    got_s, tp_s_ms = timed(sentence)
    rows("use_mesh fused sentence", [got_s], [want_s])
    rows("vocode_sharded", [pipe.vocode_sharded(mel)], [want_v])
    torch.cuda.synchronize()
    tp_peak = torch.cuda.max_memory_allocated(dev)
    print(f"{label}: 1x2 (data, model) mesh, {len(split)} sharded leaves; "
          f"params {tp_bytes / 1e6:.3f} MB a rank vs {one_bytes / 1e6:.3f} "
          f"MB in one process (sharded leaves exactly half: "
          f"{half / 1e6:.3f} MB less); peak memory "
          f"{tp_peak / 2**20:.1f} MiB a rank on the model axis, "
          f"{one_peak / 2**20:.1f} MiB in one process; use_mesh of "
          f"{len(MESH_TEXTS)} sentences (temperature 0.667) and "
          f"vocode_sharded of 700 frames vs one process: worst "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" of the peak; ms (host walls: one process median of 3 after "
          f"a warm call; the model axis one first call for a batch, median "
          f"of 3 after a warm call for the sentence), one process / "
          f"tensor-parallel rank: "
          f"two-stage batch of 8 {one_b_ms:.1f} / "
          f"{tp_b_ms:.1f}, fused batch of 8 {one_f_ms:.1f} / {tp_f_ms:.1f},"
          f" fused sentence {one_s_ms:.1f} / {tp_s_ms:.1f} ({card})",
          flush=True)
    synth_calls = dict(COLLECTIVES)

    cfg, cases = _mesh_train_cases(dev)
    train = _mesh_train_compare(
        cfg, cases, dev, mesh, MESH_TRAIN_STEPS, label, card,
        share=MESH_TRAIN_SHARE, metric_tol=1e-5,
        fault=_without_input_gradient_sum,
        fault_name="the model axis' input-gradient sum")
    from iris_tts_tpu_torch.ops import mel_cuda

    return {"worst": worst, "train": train, "sharded_leaves": len(split),
            "launches": mel_cuda.log_mel_cuda.launches,
            "param_bytes": tp_bytes, "one_param_bytes": one_bytes,
            "peak_bytes": tp_peak, "one_peak_bytes": one_peak,
            "ms": {"staged": [one_b_ms, tp_b_ms], "fused": [one_f_ms,
                                                           tp_f_ms],
                   "sentence": [one_s_ms, tp_s_ms]},
            "synth_collectives": {f"{p} {op} ({b})": c
                                  for (p, op, b), c in synth_calls.items()},
            "collectives": {f"{p} {op} ({b})": c
                            for (p, op, b), c in COLLECTIVES.items()}}


def _get(port: int, path: str):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# Phase 11d's burst: eight seeded requests, each dispatched alone on the
# fused path (a seeded request is never co-batched).
MESH_SERVE_JOBS = [(SERVE_TEXTS[i % 7], 100 + i) for i in range(8)]
MESH_SERVE_DEADLINE_S = 420


def _seeded_burst(port: int) -> list:
    """MESH_SERVE_JOBS from 8 client threads at once → (status, headers,
    body, seconds) each."""
    import threading

    out = [None] * len(MESH_SERVE_JOBS)

    def client(k):
        text, seed = MESH_SERVE_JOBS[k]
        out[k] = _post("127.0.0.1", port, "/synthesize",
                       {"text": text, "seed": seed})

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(len(out))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def phase11d_serve(dev, card: str, root: Path) -> dict:
    """``python -m iris_tts_tpu_torch.serve --mesh --backend gloo`` as two
    rank processes on this card (a 2x1 data mesh; rank 0 serves, rank 1
    follows its device calls) against a one-process ``TTSServer`` on the
    same weights: the burst's WAVs within ``MESH_SHAPE_LIMIT`` of the peak,
    the follower's device calls equal to rank 0's, p50 of both."""
    import re

    import numpy as np

    from iris_tts_tpu_torch.serve import TTSServer

    pipe = _serving_pipeline(dev, "phase 11d")
    pipe_dir = root / "serve_pipe"
    pipe.save(pipe_dir)
    server = TTSServer(pipe, host="127.0.0.1", port=0, max_batch=1,
                       pcm16_transfer=True).start()
    try:
        want = _seeded_burst(server.address[1])
    finally:
        server.stop()
    del server, pipe
    torch.cuda.empty_cache()

    port = _free_port()
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    cmd = [sys.executable, "-m", "iris_tts_tpu_torch.serve", "--mesh",
           "--backend", "gloo", "--device",
           "cuda:0" if dev.type == "cuda" else str(dev), "--pipeline",
           str(pipe_dir), "--host", "127.0.0.1", "--port", str(port),
           "--max_batch", "1"]
    logs = [open(root / f"11d_rank{r}.log", "w") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              cwd=Path(__file__).resolve().parent)
             for r in range(2)]
    try:
        while True:
            for r, p in enumerate(procs):
                check(p.poll() is None, f"phase 11d rank {r} exited "
                                        f"{p.returncode} before serving")
            try:
                if _get(port, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < MESH_SERVE_DEADLINE_S,
                  "phase 11d server up within its deadline")
            time.sleep(0.25)
        boot_s = time.perf_counter() - t0
        got = _seeded_burst(port)
        stats = json.loads(_get(port, "/stats")[1])
        procs[0].send_signal(signal.SIGINT)
        for r, p in enumerate(procs):
            p.wait(timeout=120)
            check(p.returncode == 0, f"phase 11d rank {r} exited "
                                     f"{p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [(root / f"11d_rank{r}.log").read_text() for r in range(2)]
    calls, launches = [], 0
    for r, role in enumerate(("leader", "follower")):
        m = re.search(rf"mesh {role}: (\d+) device calls, (\d+) log-mel "
                      rf"launches", texts[r])
        check(m is not None, f"phase 11d rank {r} logged its calls")
        calls.append(int(m.group(1)))
        launches += int(m.group(2))
    check(calls[0] == calls[1] >= 2 + len(MESH_SERVE_JOBS),
          f"the follower made rank 0's device calls: {calls}")
    worst = 0.0
    for (ws, _, wb, _), (gs, _, gb, _) in zip(want, got):
        check(ws == gs == 200, f"phase 11d status {ws} / {gs}")
        w, g = _wav_pcm(wb)[1], _wav_pcm(gb)[1]
        check(w.shape == g.shape and w.size > 0, "phase 11d lengths")
        peak = float(np.abs(w.astype(np.float64)).max())
        check(peak > 0, "phase 11d audio not silent")
        worst = max(worst, max_abs(g, w) / peak)
    check(worst <= MESH_SHAPE_LIMIT,
          f"phase 11d vs one process {worst} of the peak")
    p50 = 1e3 * _pct([r[3] for r in got], 0.5)
    one_p50 = 1e3 * _pct([r[3] for r in want], 0.5)
    print(f"phase 11d serve --mesh (2 gloo ranks on this card, data axis): "
          f"up in {boot_s:.1f} s (process start, load, use_mesh and the "
          f"warmup); a burst of {len(got)} seeded requests from 8 threads "
          f"within {worst:.2e} of the peak of the one-process server's "
          f"WAVs; p50 {p50:.1f} ms, max {1e3 * max(r[3] for r in got):.1f}"
          f" ms (one-process server: p50 {one_p50:.1f} ms, max "
          f"{1e3 * max(r[3] for r in want):.1f} ms); device calls rank 0 "
          f"{calls[0]} = rank 1 {calls[1]}; /stats requests "
          f"{stats['requests']} ({card})", flush=True)
    return {"worst": worst, "p50_ms": p50, "one_p50_ms": one_p50,
            "calls": calls, "boot_s": boot_s, "launches": launches}


def mesh_rank(sub: str, workdir: Path) -> int:
    """One rank of phase 11 (a child process; see :func:`phase11_mesh`)."""
    import torch.distributed as dist

    from iris_tts_tpu_torch.parallel import initialize_multihost

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda", 0)
    initialize_multihost(os.environ["MESH_INIT"], world, rank,
                         backend="nccl" if sub == "11a" else "gloo",
                         device=dev, timeout_s=240)
    try:
        out = {"11a": _rank_11a, "11b": _rank_11b,
               "11c": _rank_11c}[sub](dev, rank, workdir)
        (workdir / f"{sub}_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _run_ranks(sub: str, world: int, workdir: Path, card: str) -> list:
    """Start ``world`` rank processes of sub-phase ``sub``, wait for them
    (at most its deadline) and return their results; a failed or late rank
    fails the phase, and every rank still running is killed."""
    env = dict(os.environ, WORLD_SIZE=str(world),
               MESH_INIT=f"file://{workdir}/store_{sub}",
               # cuBLAS's deterministic mode (11a's bitwise steps)
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", sub,
         str(workdir)], env=dict(env, RANK=str(r), LOCAL_RANK="0"))
        for r in range(world)]
    t0 = time.perf_counter()
    walls = [None] * world
    try:
        while None in walls:
            for r, p in enumerate(procs):
                if walls[r] is None and p.poll() is not None:
                    check(p.returncode == 0,
                          f"phase {sub} rank {r} exited {p.returncode}")
                    walls[r] = time.perf_counter() - t0
            check(time.perf_counter() - t0 < MESH_DEADLINE_S[sub],
                  f"phase {sub} ranks past {MESH_DEADLINE_S[sub]} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"phase {sub}: {world} rank process(es), wall "
          + ", ".join(f"rank {r} {w:.1f} s" for r, w in enumerate(walls))
          + f" (process start and the card's first use included; {card})",
          flush=True)
    return [json.loads((workdir / f"{sub}_rank{r}.json").read_text())
            for r in range(world)]


def phase11_mesh(dev, card: str, cli_summary=None):
    """Multi-device on one card (see the module docstring): 11a, NCCL at
    world size 1; 11b, gloo at world size 2 on this card; 11c, the model
    axis as a 1x2 gloo mesh; 11d, ``serve --mesh``. Returns the log-mel
    kernel's launches on the data-axis mesh path (11a and 11b, both
    ranks), on the model-axis path (11c's ranks) and on the ``serve
    --mesh`` path (11d's two rank processes, from their logs). Phase 10's
    eval summary (``cli_summary``) is printed beside the mesh run's."""
    import numpy as np

    from iris_tts_tpu_torch.data.audio_io import load_audio
    from iris_tts_tpu_torch import AudioConfig
    from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram_plain
    from iris_tts_tpu_torch.scripts import make_synthetic_corpus

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    root = Path(tmp.name)
    try:
        a = _run_ranks("11a", 1, root, card)[0]
        want_a = {"use_mesh all_reduce (nccl)",
                  "frame_bucket all_reduce (nccl)",
                  "gradients all_reduce (nccl)",
                  "loss_denominator all_reduce (nccl)",
                  "batch_norm_stats all_reduce (nccl)",
                  "metrics all_reduce (nccl)", "replicate broadcast (nccl)",
                  "stop_flag all_reduce (gloo)"}
        check(want_a <= set(a["collectives"]),
              f"11a called every collective: {sorted(a['collectives'])}")
        print("phase 11a collectives by path (NCCL world size 1; the stop "
              "flag on a gloo side group): " + json.dumps(a["collectives"]),
              flush=True)
        make_synthetic_corpus.main(["--root", str(root / "corpus"),
                                    "--n", str(CLI_CORPUS)])
        b = _run_ranks("11b", 2, root, card)
        for r in b:
            check(r["collectives"] and all(
                "all_reduce" in k or "broadcast" in k
                for k in r["collectives"]), "only all-reduce and broadcast")
        print("phase 11b collectives by path (rank 0; every path: "
              "all-reduce into a zero-filled buffer or broadcast, on gloo "
              "with CUDA tensors as NCCL would take them): "
              + json.dumps(b[0]["collectives"]), flush=True)
        for name in a["train"]:
            print(f"phase 11 {name} step: one process "
                  f"{b[0]['train'][name]['single_ms']:.2f} ms, a rank of "
                  f"two (gloo, one card) {b[0]['train'][name]['mesh_ms']:.2f}"
                  f" ms / {b[1]['train'][name]['mesh_ms']:.2f} ms; NCCL "
                  f"world size 1 {a['train'][name]['mesh_ms']:.2f} ms "
                  f"({card})", flush=True)
        # the mesh CLI run: the cache on rank 0 only, through the kernel
        data_root = root / "corpus" / "LJSpeech-1.1"
        mel_files = sorted((root / "cache" / "mels").glob("*.npy"))
        check(len(mel_files) == CLI_CORPUS,
              f"a cached mel per clip ({len(mel_files)})")
        check(b[0]["train_launches"] == CLI_CORPUS,
              f"rank 0 built the cache: {b[0]['train_launches']} launches")
        check(b[1]["launches"] == 0,
              f"rank 1 launched the kernel {b[1]['launches']} times")
        s0, s1 = b[0]["summary"], b[1]["summary"]
        check(s1 is None and s0 is not None, "rank 0 alone evaluates")
        n_resynth = min(4, s0["eval_samples"])
        check(b[0]["launches"] == CLI_CORPUS + n_resynth,
              f"rank 0 launches {b[0]['launches']}")
        check((root / "run" / "pipeline_artifact").is_dir()
              and s0["artifact_smoke"]["ok"], "the artifact, smoke-checked")
        audio_cfg = AudioConfig()
        worst = 0.0
        for f in mel_files:
            audio = load_audio(data_root / "wavs" / f"{f.stem}.wav")
            want = log_mel_spectrogram_plain(
                torch.from_numpy(audio).to(dev), audio_cfg)
            cached = np.load(f)
            check(bool(np.isfinite(cached).all()), f"finite mel {f.stem}")
            worst = max(worst, max_abs(cached, want))
        check(worst <= 2e-3, f"mesh cache vs plain max-abs {worst}")
        ref = cli_summary or {"mcd_db": math.nan, "lsd_db": math.nan,
                              "control_mcd_db": math.nan}
        print(f"phase 11b train_full_pipeline --mesh: log-mel launches "
              f"{b[0]['train_launches']} on rank 0 for the cache (+"
              f"{n_resynth} scored resynthesis in its eval), "
              f"{b[1]['launches']} on rank 1; every cached mel within "
              f"{worst:.3e} of the plain version; held-out MCD "
              f"{s0['mcd_db']:.3f} dB (phase 10 {ref['mcd_db']:.3f}),"
              f" LSD {s0['lsd_db']:.3f} dB (phase 10 "
              f"{ref['lsd_db']:.3f}), control MCD "
              f"{s0['control_mcd_db']:.3f} (phase 10 "
              f"{ref['control_mcd_db']:.3f}); run "
              f"{b[0]['cli_s']:.1f} s ({card})", flush=True)
        launches = b[0]["launches"] + b[1]["launches"]

        c = _run_ranks("11c", 2, root, card)
        tp_launches = sum(r["launches"] for r in c)
        check(tp_launches == 0, "no log-mel on the model-axis path")
        print("phase 11c collectives by path, rank 0 (synthesis, then "
              "with the training steps; gloo, CUDA tensors): "
              + json.dumps(c[0]["synth_collectives"]) + " / "
              + json.dumps(c[0]["collectives"]), flush=True)
        for name in c[0]["train"]:
            print(f"phase 11c {name} step: one process "
                  f"{c[0]['train'][name]['single_ms']:.2f} ms, a "
                  f"tensor-parallel rank of two (gloo, one card) "
                  f"{c[0]['train'][name]['mesh_ms']:.2f} ms / "
                  f"{c[1]['train'][name]['mesh_ms']:.2f} ms ({card})",
                  flush=True)
        serve_launches = phase11d_serve(dev, card, root)["launches"]
        check(serve_launches == 0, "no log-mel on the serve --mesh path")
    finally:
        tmp.cleanup()
    print(f"phase 11 done in {time.perf_counter() - t_phase:.1f} s ({card})",
          flush=True)
    return launches, tp_launches, serve_launches


RELEASE_ARTIFACT = Path(__file__).resolve().parent / "release" / \
    "pipeline_artifact"
# SHA-256 of the artifact's decoded params tree (convert/orbax.tree_sha256);
# tests/test_torch_orbax.py computes it from orbax's own restore.
RELEASE_PARAMS_SHA256 = (
    "417ba99febd91218c2a59942699a28c0ba5156c426569c887cd22c010ea28272")
# tests/test_torch_release.py's FRAME_TOTALS: (text, f32 frames).
RELEASE_FRAMES = (("The quick brown fox.", 99), ("Hello world.", 65),
                  ("Good morning to you.", 111),
                  ("The old gardener found a basket of apples.", 216))
RELEASE_SERVE_REQUESTS = 8


def phase17_release(dev, card: str, control):
    """The shipped trained model, read from the JAX package's orbax
    artifact without JAX (see the module docstring). ``control`` is phase
    3's random-weight pipeline. Returns the log-mel launches on this path
    (the trained and the control copy analyses, counted exactly) and the
    worst kernel-vs-plain max-abs on its audio."""
    import dataclasses
    import threading

    import numpy as np

    from iris_tts_tpu_torch.convert import orbax, zstd
    from iris_tts_tpu_torch.data.audio_io import read_wav
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.ops import mel_cuda, mrf_cuda
    from iris_tts_tpu_torch.ops.stft import (
        log_mel_spectrogram,
        log_mel_spectrogram_plain,
    )
    from iris_tts_tpu_torch.serve import DynamicBatcher
    from iris_tts_tpu_torch.utils import cxx

    t_phase = time.perf_counter()
    mel_cuda.log_mel_cuda.launches = 0
    # 1. the zstd decoder, the tree, its digest, the load onto the card
    prebuilt = sorted(cxx.BUILD_DIR.glob("libiriszstd_*.so"))
    t0 = time.perf_counter()
    lib = zstd.build_library()
    zstd.get_lib()
    build_s = time.perf_counter() - t0
    how = (f"found already built ({len(prebuilt)} in {cxx.BUILD_DIR})"
           if lib in prebuilt else f"built with g++ in {build_s:.2f} s")
    t0 = time.perf_counter()
    tree = orbax.read_tree(RELEASE_ARTIFACT / "params")
    decode_s = time.perf_counter() - t0
    leaves = list(orbax.flat_leaves(tree))
    n_bytes = sum(np.asarray(a).nbytes for _, a in leaves)
    digest = orbax.tree_sha256(tree)
    check(digest == RELEASE_PARAMS_SHA256,
          f"release params SHA-256 {digest} == {RELEASE_PARAMS_SHA256}")
    t0 = time.perf_counter()
    pipe = TTSPipeline.load(RELEASE_ARTIFACT)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(pipe.device.type == "cuda", "the artifact loads onto the card")
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"phase 17 release artifact: zstd decoder {lib.name} {how}; "
          f"{len(leaves)} leaves, {n_bytes / 1e6:.2f} MB "
          f"decoded and assembled in {decode_s:.3f} s "
          f"({n_bytes / 1e6 / decode_s:.1f} MB/s, host); SHA-256 "
          f"{digest[:16]}... matches; TTSPipeline.load onto the card in "
          f"{load_s:.2f} s ({n_params / 1e6:.2f} M params; {card})",
          flush=True)

    # 2. frame totals: f32 exactly; bf16 per phoneme away from a rounding
    # boundary (phase 9's rule)
    texts = [t for t, _ in RELEASE_FRAMES]
    got32 = [pipe.synthesize(t, temperature=0.0, return_mel=True)
             for t in texts]
    frames32 = [m.shape[0] for _, m in got32]
    check(frames32 == [n for _, n in RELEASE_FRAMES],
          f"f32 frame totals {frames32} == {[n for _, n in RELEASE_FRAMES]}")
    pipe16 = dataclasses.replace(pipe, dtype=torch.bfloat16)
    frames16 = [pipe16.synthesize(t, temperature=0.0, return_mel=True)[1]
                .shape[0] for t in texts]

    _, fr32, x32, lengths = stage_a_frames(pipe, texts)
    _, fr16, _, _ = stage_a_frames(pipe16, texts)
    moved = bf16_frames_moved(texts, lengths, x32, fr32, fr16)
    for i, t in enumerate(texts):
        check(int(fr32[i, :int(lengths[i])].sum()) == frames32[i],
              f"stage A frames of {t!r}")
    print(f"phase 17 frame totals at temperature 0: f32 {frames32} "
          f"(exact), bf16 {frames16}; bf16 moved "
          + ("; ".join(f"{t!r} {frames32[i]} -> {frames16[i]} (f32 "
                       + ", ".join(f"{float(v):.3f}" for v in moved[i])
                       + ")" for i, t in enumerate(texts)
                       if frames16[i] != frames32[i]) or "none")
          + f", each at a rounding boundary ({card})", flush=True)

    # 3. the card's f32 audio against the port's CPU run of the same load
    cpu = TTSPipeline.load(RELEASE_ARTIFACT, device="cpu")
    errs = []
    for t, (a_gpu, m_gpu) in zip(texts, got32):
        a_cpu, m_cpu = cpu.synthesize(t, temperature=0.0, return_mel=True)
        check(m_cpu.shape == m_gpu.shape, f"card and CPU frames of {t!r}")
        err = max_abs(a_gpu, a_cpu)
        check(float(np.abs(a_cpu).max()) > 0.05, f"a real signal ({t!r})")
        check(err <= 1e-3, f"card vs CPU audio of {t!r}: {err} <= 1e-3")
        errs.append(err)
    del cpu
    print(f"phase 17 card vs CPU, the same load at temperature 0: audio "
          f"max-abs {max(errs):.3e} over {len(texts)} sentences (limit "
          f"1e-3), peaks "
          + ", ".join(f"{float(np.abs(a).max()):.3f}" for a, _ in got32)
          + f" ({card})", flush=True)

    # 4. the log-mel kernel on the trained audio: how far the model's mel
    # lies from the log-mel of its own audio, beside phase 3's random
    # weights
    cfg = pipe.config.audio
    worst, l1 = 0.0, {}
    for label, p in (("trained", pipe), ("random", control)):
        dists = []
        for i, t in enumerate(texts):
            audio, mel = (got32[i] if p is pipe else
                          p.synthesize(t, temperature=0.0, return_mel=True))
            a = torch.from_numpy(audio).to(dev)
            feats = log_mel_spectrogram(a, cfg)
            want = log_mel_spectrogram_plain(a, cfg)
            worst = max(worst, max_abs(feats, want))
            n = min(feats.shape[0], mel.shape[0])
            dists.append(float((feats[:n].cpu()
                                - torch.from_numpy(mel[:n])).abs().mean()))
        l1[label] = float(np.mean(dists))
    launches = mel_cuda.log_mel_cuda.launches
    check(launches == 2 * len(texts),
          f"log-mel launches on the release path: {launches} == "
          f"{2 * len(texts)}")
    check(worst <= 2e-3, f"kernel vs plain on the release audio: {worst}")
    print(f"phase 17 log-mel of the synthesized audio vs the model's mel, "
          f"mean L1 over {len(texts)} sentences: trained {l1['trained']:.4f}"
          f", phase 3's random weights {l1['random']:.4f}; kernel vs plain "
          f"max-abs {worst:.3e}; {launches} launches ({card})", flush=True)

    # 5. synthesize --artifact in a child process, from cold
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "release.wav"
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "iris_tts_tpu_torch.scripts.synthesize",
             "--artifact", str(RELEASE_ARTIFACT), "--text", texts[-1],
             "--temperature", "0", "--output_wav", str(wav)],
            capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        check(r.returncode == 0, f"synthesize child: {r.stderr[-1500:]}")
        samples, sr = read_wav(wav)
    check(sr == cfg.sample_rate and len(samples) == len(got32[-1][0]),
          "the child's wav has the in-process length")

    # 6. eight requests through the live batcher over the trained pipeline,
    # on phase 7's cut ladders: they hold every shape of the four texts,
    # and warming the artifact's own ladders would double the phase
    pipe.phoneme_buckets = SERVE_PHONEME_BUCKETS
    pipe.frame_buckets = SERVE_FRAME_BUCKETS
    batcher = DynamicBatcher(pipe, max_batch=8, max_wait_ms=5.0).start()
    try:
        batcher.synthesize(texts[0], timeout=300)  # first-call set-up
        lats, outs = [], []

        def one(text):
            t0 = time.perf_counter()
            out = batcher.synthesize(text, timeout=300)
            lats.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)

        threads = [threading.Thread(target=one, args=(texts[i % 4],))
                   for i in range(RELEASE_SERVE_REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        check(not any(th.is_alive() for th in threads)
              and len(outs) == RELEASE_SERVE_REQUESTS,
              "every served request answered")
        check(all(np.isfinite(o).all() and len(o) > 0 for o in outs),
              "served audio finite")
    finally:
        batcher.stop()
    print(f"phase 17 synthesize --artifact in a child process: "
          f"{child_s:.2f} s from cold to the wav ({len(samples)} samples); "
          f"{RELEASE_SERVE_REQUESTS} concurrent requests through the "
          f"DynamicBatcher over the trained pipeline ({batcher.n_warmed} "
          f"shapes of phase 7's cut ladders warmed in "
          f"{batcher.warmup_s:.1f} s): p50 "
          f"{_pct(lats, 0.5):.1f} ms, max {max(lats):.1f} ms; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return launches, worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    import iris_tts_tpu_torch
    from iris_tts_tpu_torch import AudioConfig, IrisConfig
    from iris_tts_tpu_torch.models.pipeline import TTSPipeline
    from iris_tts_tpu_torch.ops import mel_cuda, mrf_cuda
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
    ptxas = lib_path.with_suffix(".build.txt")
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

    # -- 2b. the MRF kernel vs plain at the main path's shapes ----------------
    mrf = phase2b_mrf(dev, card)
    mrf_by_path = {}

    # -- 2c. the activation kernel vs plain, and BigVGAN's synthesis path ------
    amp = phase2c_amp(dev, card)

    # -- main path: phases 3 and 4 ------------------------------------------
    mel_cuda.log_mel_cuda.launches = 0
    mrf_cuda.mrf_cuda.launches = 0

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
    mrf_by_path["synthesis"] = mrf_cuda.mrf_cuda.launches
    check(mrf_by_path["synthesis"] >= V1_MRF_LAUNCHES
          and mrf_by_path["synthesis"] % V1_MRF_LAUNCHES == 0,
          f"the main path launched the MRF kernel {V1_MRF_LAUNCHES} times a "
          f"vocoder call ({mrf_by_path['synthesis']})")

    # -- 6. training at full width (the training path) ----------------------
    with mrf_launches(mrf_by_path, "training"):
        train_launches, handoff = phase6_training(dev, card)

    # -- 7. serving at full width (the serving path) ------------------------
    with mrf_launches(mrf_by_path, "serving"):
        serve_launches, served_7 = phase7_serving(dev, card)

    # -- 8. ahead-of-time serving at full width (the AOT path) ---------------
    with mrf_launches(mrf_by_path, "aot_serving"):
        aot_launches = phase8_aot(dev, card, served_7)

    # -- 9. bf16 and remat (the bf16 path) -----------------------------------
    with mrf_launches(mrf_by_path, "bf16"):
        bf16_launches = phase9_bf16(dev, card, pipe, handoff)
    check(bf16_launches >= 1, "the bf16 path launched the log-mel kernel")

    # -- 10. the command-line drivers (the CLI path) --------------------------
    with mrf_launches(mrf_by_path, "cli"):
        cli_launches, cli_summary, stage_dirs = phase10_cli(dev, card)
    # phase 13's AOTInductor compile runs in a child beside phases 11-12
    native_job = start_native_export()
    try:
        check(cli_launches >= 1, "the CLI path launched the log-mel kernel")

        # -- 11. multi-device on one card (the mesh path) ---------------------
        with mrf_launches(mrf_by_path, "mesh"):
            mesh_launches, tp_launches, serve_mesh_launches = phase11_mesh(
                dev, card, cli_summary)
        check(mesh_launches >= 1,
              "the mesh path launched the log-mel kernel")

        # -- 12. G2P training, the converters and native IO (the demo
        # vocoder's path) ------------------------------------------------------
        with mrf_launches(mrf_by_path, "vocoder_demo"):
            demo_launches = phase12(dev, card, stage_dirs)

        # -- 13. the C++ serving host (the native host path) ------------------
        with mrf_launches(mrf_by_path, "native_host"):
            native_launches = phase13_native(dev, card, native_job)

        # -- 14. the diagnostics and pre-flight tools (the diagnostics path) --
        with mrf_launches(mrf_by_path, "diagnostics"):
            diag_launches = phase14_diagnostics(dev, card, stage_dirs)
    finally:
        stage_dirs["tmp"].cleanup()
        stop_native_export(native_job)

    # -- 15. the speed-of-light, memory and vocoder-profile tools (the
    # analysis path) -------------------------------------------------------
    with mrf_launches(mrf_by_path, "analysis"):
        analysis_launches, sentence = phase15_analysis(dev, card, pipe,
                                                       handoff)

    # -- where the time goes: one fused synthesize under the profiler --------
    busy_rows = profile_line("fused synthesize",
                             lambda: pipe.synthesize(SENTENCE, seed=1), card)
    phase15_sentence_line(card, sentence, busy_rows)

    # -- 16. the benchmark drivers (the bench path) ---------------------------
    with mrf_launches(mrf_by_path, "bench"):
        bench_launches, bench_err = phase16_bench(card)

    # -- 17. the shipped trained model through the port (the release path) --
    with mrf_launches(mrf_by_path, "release"):
        release_launches, release_err = phase17_release(dev, card, pipe)
    # The paths that vocode in f32 on the card in this process: synthesis
    # (checked above), serving, the analysis tools and the trained model.
    for path in ("serving", "analysis", "release"):
        check(mrf_by_path[path] >= V1_MRF_LAUNCHES,
              f"the {path} path launched the MRF kernel "
              f"({mrf_by_path[path]})")
    print("MRF kernel launches by path: " + json.dumps(mrf_by_path),
          flush=True)

    jax_pkg = iris_tts_tpu_torch.__name__.removesuffix("_torch")
    kernels = [{
        "name": "log_mel",
        "route": "cuda",
        "source": "iris_tts_tpu_torch/ops/csrc/log_mel.cu",
        "replaces": f"{jax_pkg}/ops/mel_pallas.py:110",
        "launches": launches + train_launches + serve_launches
        + aot_launches + bf16_launches + cli_launches + mesh_launches
        + tp_launches + serve_mesh_launches + demo_launches
        + native_launches + diag_launches + analysis_launches
        + bench_launches + release_launches,
        "launches_by_path": {"synthesis": launches,
                             "training": train_launches,
                             "serving": serve_launches,
                             "aot_serving": aot_launches,
                             "bf16": bf16_launches,
                             "cli": cli_launches,
                             "mesh": mesh_launches,
                             "model_axis": tp_launches,
                             "serve_mesh": serve_mesh_launches,
                             "vocoder_demo": demo_launches,
                             "native_host": native_launches,
                             "diagnostics": diag_launches,
                             "analysis": analysis_launches,
                             "bench": bench_launches,
                             "release": release_launches},
        "max_abs_err": max(worst, bench_err, release_err),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": l_ms,
    }, {
        "name": "mrf_resblock",
        "route": "cuda",
        "source": "iris_tts_tpu_torch/ops/csrc/mrf_resblock.cu",
        # The JAX package leaves HiFiGAN's convolutions to XLA.
        "replaces": None,
        "launches": sum(mrf_by_path.values()),
        "launches_by_path": mrf_by_path,
        "max_abs_err": mrf["worst"],
        # At V2's 32-channel stage; each stage under "stages". The plain
        # version is the library composition the kernel replaces.
        **{key: mrf["stages"]["v2_32ch"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": mrf["stages"]["v2_32ch"]["plain_ms"],
        "stages": mrf["stages"],
    }, {
        "name": "amp_act",
        "route": "cuda",
        "source": "iris_tts_tpu_torch/ops/csrc/amp_activation.cu",
        # The JAX package has no BigVGAN.
        "replaces": None,
        "launches": sum(amp["launches_by_path"].values()),
        "launches_by_path": amp["launches_by_path"],
        "max_abs_err": amp["worst"],
        # At the 384-channel stage; each stage under "stages". The plain
        # version is the library composition the kernel replaces.
        **{key: amp["stages"]["384ch"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": amp["stages"]["384ch"]["plain_ms"],
        "stages": amp["stages"],
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
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank(sys.argv[2], Path(sys.argv[3])))
    if len(sys.argv) == 3 and sys.argv[1] == "--native-export":
        sys.exit(native_export(Path(sys.argv[2])))
    sys.exit(main())
