"""Offline training-convergence proof of the port: overfit the three
stages (+ GAN steps) on a tiny harmonic corpus and check that the port's
training actually *learns*, mirroring the JAX package's
``tests/test_convergence.py::test_three_stage_overfit_converges`` with its
corpus builder, step counts, KL anneal, learning rates and rubric, on the
port's ``TrainLoop``, ``TrainState``, ``CheckpointManager`` and
``TTSPipeline.from_checkpoints``, on the CPU.

24 synthetic utterances over a 6-"phoneme" tone alphabet: phoneme i is a
sine at a distinct frequency with a distinct duration distribution. Real
audio → real log-mels, real durations, so every stage trains on the
feature contract the LJSpeech path produces.

Asserts, as JAX's test does:
  * duration head: linear-frame MAE < 5 (the reference rubric) and below
    half the untrained predictor's,
  * VAE: masked recon L1 below 0.8 and below a third of its first epoch,
  * PostNet: refinement L1 finite and falling,
  * GAN: six MPD+MSD steps keep every loss finite and move the
    discriminator below its first-step loss,
  * end to end: pipeline mel → Griffin-Lim audio → log-mel correlates
    with the utterance's ground-truth mel (Pearson r) far above a
    shuffled-utterance control, and the DTW-aligned MCD beats the
    control's by more than 1 dB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

from iris_tts_tpu_torch.config import (
    DurationConfig,
    EncoderConfig,
    HiFiGANConfig,
    IrisConfig,
    PostNetConfig,
    TrainConfig,
    VAEConfig,
)
from iris_tts_tpu_torch.data.batching import BucketedBatcher, to_device
from iris_tts_tpu_torch.data.ljspeech import Sample
from iris_tts_tpu_torch.models import (
    DurationPredictor,
    HiFiGANGenerator,
    PhonemeEncoder,
    PostNet,
    TextConditionedVAE,
    TTSPipeline,
)
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.ops.griffin_lim import griffin_lim_from_log_mel
from iris_tts_tpu_torch.ops.stft import log_mel_spectrogram
from iris_tts_tpu_torch.runtime import seeded_generator
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab
from iris_tts_tpu_torch.train import (
    TrainLoop,
    TrainState,
    adam_clipped,
    make_duration_eval_step,
    make_duration_train_step,
    make_gan_steps,
    make_postnet_train_step,
    make_vae_train_step,
)
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
from iris_tts_tpu_torch.utils.metrics import MetricsWriter, quality_report

torch.set_num_threads(2)

SR = 22050
HOP = 256
N_TONES = 6
TONE_FREQS = [220.0 * (1.5 ** i) for i in range(N_TONES)]
TONE_MEAN_FRAMES = [4 + 2 * i for i in range(N_TONES)]

CFG = IrisConfig(
    encoder=EncoderConfig(
        vocab_size=8, embed_dim=64, num_blocks=2, num_heads=2, dropout=0.0
    ),
    duration=DurationConfig(hidden_dim=64, num_layers=2, dropout=0.0),
    vae=VAEConfig(
        n_mels=80, cond_dim=64, model_channels=48, latent_dim=8,
        num_wavenet_blocks=3, decoder_blocks=2, flow_layers=2,
        flow_hidden=32, dropout=0.0, flow_prior=True,
    ),
    postnet=PostNetConfig(n_mels=80, num_layers=3, channels=48, dropout=0.0),
    hifigan=HiFiGANConfig(
        in_channels=80,
        upsample_rates=(4, 2),
        upsample_kernel_sizes=(8, 4),
        upsample_initial_channel=32,
        resblock_kernel_sizes=(3,),
        resblock_dilations=((1, 3),),
    ),
    train=TrainConfig(duration_huber_delta=10.0),
)


def _build_corpus(n: int = 24, seed: int = 7):
    """n harmonic utterances: token sequence → sine audio → real log-mel."""
    rng = np.random.default_rng(seed)
    samples, texts, audios = [], [], []
    for i in range(n):
        p = int(rng.integers(4, 8))
        tones = rng.integers(0, N_TONES, p)
        durs = np.array(
            [TONE_MEAN_FRAMES[t] + int(rng.integers(-1, 2)) for t in tones],
            np.float32,
        )
        total = int(durs.sum())
        freq = np.repeat(
            np.array([TONE_FREQS[t] for t in tones], np.float32),
            (durs * HOP).astype(np.int64),
        )
        audio = (0.25 * np.sin(2 * np.pi * np.cumsum(freq) / SR)).astype(
            np.float32
        )
        assert len(audio) == total * HOP
        mel = log_mel_spectrogram(torch.from_numpy(audio),
                                  CFG.audio).numpy()[:total]
        # ids: specials occupy 0/1 (PhonemeVocab.build), tones at 2..7
        samples.append(
            Sample(
                file_id=f"tone{i:02d}",
                text=" ".join(f"T{t}" for t in tones),
                phoneme_ids=(tones + 2).astype(np.int32),
                durations=durs,
                mel=mel.astype(np.float32),
            )
        )
        texts.append(samples[-1].text)
        audios.append(audio)
    return samples, texts, audios


class _TokenProcessor:
    """Pipeline text frontend for the tone alphabet ("T0".."T5")."""

    def text_to_ids(self, text: str, vocab: PhonemeVocab) -> np.ndarray:
        return vocab.encode(text.split())


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a.ravel() - a.mean()
    b = b.ravel() - b.mean()
    return float((a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _init(module: nn.Module) -> nn.Module:
    init_params(module, seeded_generator(0, "cpu"))
    return module


@pytest.mark.integration
def test_three_stage_overfit_converges(tmp_path):
    data, texts, audios = _build_corpus()
    csv_dir = tmp_path / "metrics"
    csv_dir.mkdir()

    dur_batcher = BucketedBatcher(
        data, 8, phoneme_buckets=(8,), with_mel=False
    )
    mel_batcher = BucketedBatcher(
        data, 8, phoneme_buckets=(8,), frame_buckets=(48, 64, 96),
        with_mel=True
    )

    # ---- Stage 1: encoder + duration head --------------------------------
    params0 = nn.ModuleDict({
        "encoder": _init(PhonemeEncoder(CFG.encoder)),
        "duration": _init(DurationPredictor(CFG.encoder.embed_dim,
                                            CFG.duration)),
    })
    eval_step = make_duration_eval_step(CFG)

    def dur_mae(params) -> float:
        tot, n = 0.0, 0
        for batch in dur_batcher.epoch(0):
            b = to_device(batch, "cpu")
            tot += float(eval_step(params, b)["duration_mae_frames"])
            n += 1
        return tot / n

    mae_untrained = dur_mae(params0)
    loop = TrainLoop(
        state=TrainState.create(params0, adam_clipped(2e-3), 0),
        train_step=make_duration_train_step(CFG),
        batcher=dur_batcher,
        num_epochs=60,
        checkpoints=CheckpointManager(tmp_path / "enc", CFG),
        checkpoint_every=60,
        metrics=MetricsWriter(csv_dir / "duration.csv"),
        val_metric_key="duration_loss",
    )
    enc_state = loop.run()

    mae = dur_mae(enc_state.params)
    print(f"duration MAE: untrained={mae_untrained:.2f} trained={mae:.2f}")
    assert mae < 5.0, f"duration MAE {mae:.2f} fails the <5-frame rubric"
    assert mae < mae_untrained / 2

    # ---- Stage 2: VAE with frozen encoder --------------------------------
    encoder = enc_state.params["encoder"]
    loop = TrainLoop(
        state=TrainState.create(
            _init(TextConditionedVAE(CFG.vae)), adam_clipped(3e-3), 0,
            frozen={"encoder": encoder},
        ),
        train_step=make_vae_train_step(CFG),
        batcher=mel_batcher,
        num_epochs=300,  # ~900 steps
        checkpoints=CheckpointManager(tmp_path / "vae", CFG),
        checkpoint_every=300,
        metrics=MetricsWriter(csv_dir / "vae.csv"),
        # KL anneal toward 0.05 (the flow_prior recipe): the inference path
        # samples the flow prior, so the KL term must pull the prior and
        # the posterior together.
        epoch_extras=lambda e: (min(0.05, 0.001 + 2.5e-4 * e),),
    )
    vae_state = loop.run()

    recon_first = loop.history[0]["recon_l1"]
    recon_last = loop.history[-1]["recon_l1"]
    print(f"VAE recon L1: first-epoch={recon_first:.3f} last={recon_last:.3f}")
    assert recon_last < 0.8, f"VAE recon L1 {recon_last:.3f} did not overfit"
    assert recon_last < recon_first / 3

    # ---- Stage 3: PostNet over frozen encoder+VAE ------------------------
    loop = TrainLoop(
        state=TrainState.create(
            _init(PostNet(CFG.postnet)), adam_clipped(1e-3), 0,
            frozen={"encoder": encoder, "vae": vae_state.params},
        ),
        train_step=make_postnet_train_step(CFG),
        batcher=mel_batcher,
        num_epochs=10,
        checkpoints=CheckpointManager(tmp_path / "pn", CFG),
        checkpoint_every=10,
        metrics=MetricsWriter(csv_dir / "postnet.csv"),
        val_metric_key="postnet_l1",
    )
    loop.run()
    pn_first = loop.history[0]["postnet_l1"]
    pn_last = loop.history[-1]["postnet_l1"]
    print(f"PostNet L1: first-epoch={pn_first:.3f} last={pn_last:.3f}")
    assert np.isfinite(pn_last) and pn_last < pn_first

    # ---- GAN stage: a few MPD+MSD steps on the same audio ----------------
    hop = CFG.hifigan.total_upsample
    seg_frames, b = 32, 4
    long_enough = [
        i for i, s in enumerate(data) if s.mel.shape[0] >= seg_frames
    ][:b]
    assert len(long_enough) == b
    gan_batch = to_device({
        "mel": np.stack([data[i].mel[:seg_frames] for i in long_enough]),
        # (tiny 8x topology: audio is any [B, T*hop] aligned signal)
        "audio": np.stack([audios[i][: seg_frames * hop]
                           for i in long_enough]),
    }, "cpu")
    disc_step, gen_step = make_gan_steps(
        CFG, periods=(2, 3), num_scales=2, disc_width=0.25
    )
    g_state = TrainState.create(_init(HiFiGANGenerator(CFG.hifigan)),
                                adam_clipped(2e-4), 0)
    d_state = TrainState.create(
        _init(HiFiGANDiscriminators(periods=(2, 3), num_scales=2,
                                    width=0.25)),
        adam_clipped(2e-4), 0)
    gan_csv = MetricsWriter(csv_dir / "gan.csv")
    disc_losses = []
    for step in range(6):
        d_state, dm = disc_step(g_state, d_state, gan_batch)
        g_state, gm = gen_step(g_state, d_state, gan_batch)
        scalars = {k: float(v) for k, v in {**dm, **gm}.items()}
        gan_csv.write(step, scalars)
        assert all(np.isfinite(v) for v in scalars.values()), scalars
        disc_losses.append(scalars["disc_loss"])
    gan_csv.close()
    print(f"GAN disc loss: first={disc_losses[0]:.3f} "
          f"last={disc_losses[-1]:.3f}")
    assert disc_losses[-1] < disc_losses[0]

    # ---- End-to-end: pipeline mel → Griffin-Lim audio --------------------
    vocab = PhonemeVocab.build([f"T{i}" for i in range(N_TONES)])
    pipe = TTSPipeline.from_checkpoints(
        tmp_path / "enc", tmp_path / "vae",
        postnet_checkpoint=tmp_path / "pn",
        config=CFG, vocab=vocab, device="cpu",
    )
    pipe = dataclasses.replace(pipe, text_processor=_TokenProcessor(),
                               phoneme_buckets=(8,),
                               frame_buckets=(48, 64, 96, 128))

    gt = data[0]
    synth_mel = pipe.synthesize_mel(texts[0], seed=0, temperature=0.0)
    audio = griffin_lim_from_log_mel(torch.from_numpy(synth_mel),
                                     cfg=CFG.audio).numpy()
    assert np.isfinite(audio).all() and len(audio) > 0
    mel_of_audio = log_mel_spectrogram(torch.from_numpy(audio),
                                       CFG.audio).numpy()
    n = min(len(mel_of_audio), len(gt.mel))
    r = _pearson(mel_of_audio[:n], gt.mel[:n])
    # Control: the same synthesized audio against an unrelated utterance.
    other = data[5]
    n2 = min(len(mel_of_audio), len(other.mel))
    r_control = _pearson(mel_of_audio[:n2], other.mel[:n2])
    print(f"audio↔mel correlation: match r={r:.3f} control "
          f"r={r_control:.3f}")
    assert r > 0.35, f"synthesized audio does not correlate (r={r:.3f})"
    assert r > 1.8 * max(r_control, 0.05), (r, r_control)

    # ---- Audio-quality gate: MCD + LSD -----------------------------------
    # Predicted durations give another frame count than the ground truth,
    # so frames are DTW-aligned; the generated-vs-target MCD must beat the
    # shuffled-utterance control by a clear margin.
    q_match = quality_report(synth_mel, gt.mel, align="dtw")
    q_control = quality_report(synth_mel, other.mel, align="dtw")
    print(
        f"quality: match MCD={q_match['mcd_db']:.2f} dB "
        f"LSD={q_match['lsd_db']:.2f} dB | control "
        f"MCD={q_control['mcd_db']:.2f} dB LSD={q_control['lsd_db']:.2f} dB"
    )
    qual_csv = MetricsWriter(csv_dir / "quality.csv")
    qual_csv.write(0, {f"match_{k}": v for k, v in q_match.items()})
    qual_csv.write(0, {f"control_{k}": v for k, v in q_control.items()})
    qual_csv.close()
    assert q_match["mcd_db"] < q_control["mcd_db"] - 1.0, (
        f"generated mel is not meaningfully closer to its target "
        f"(MCD {q_match['mcd_db']:.2f} vs control "
        f"{q_control['mcd_db']:.2f})"
    )
    # LSD is reported, not gated (as in JAX's test: on this tone corpus
    # near-floor bins dominate it for match and control alike).
    assert np.isfinite(q_match["lsd_db"])

    for name in ("duration", "vae", "postnet", "gan", "quality"):
        p = csv_dir / f"{name}.csv"
        assert p.exists() and p.stat().st_size > 0
