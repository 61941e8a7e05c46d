"""The port's command-line drivers (``iris_tts_tpu_torch.scripts``), run
in-process through ``main(argv)`` with ``--device cpu``: their options
against the JAX scripts', the corpus against JAX's, the one-command
training run end to end (evidence, resume, preemption), its held-out
evaluation against the JAX package's on the same weights and split,
synthesis, batch synthesis and checkpoint averaging."""

import argparse
import importlib
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iris_tts_tpu.config as jcfg
from iris_tts_tpu.data.batching import BucketedBatcher as JBatcher
from iris_tts_tpu.data.ljspeech import LJSpeechVAEDataset as JVAEDataset
from iris_tts_tpu.data.synthetic_speech import CorpusSpec as JCorpusSpec
from iris_tts_tpu.data.synthetic_speech import generate_corpus as jgen
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from iris_tts_tpu.train import make_duration_eval_step as jdur_eval
from iris_tts_tpu.utils.metrics import quality_report as jquality
from iris_tts_tpu_torch.data.audio_io import read_wav, wav_bytes
from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.scripts import (
    average_checkpoints,
    batch_synthesize,
    common,
    make_synthetic_corpus,
    plot_training_curves,
    synthesize,
    train_encoder,
    train_full_pipeline,
    train_hifigan,
    train_postnet,
    train_vae,
)
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager, load_params
from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
from tests.corpus_utils import build_mini_corpus
from tests.torch_port_utils import numpy_tree, port_config, small_config

torch.set_num_threads(2)

DRIVERS = {
    "make_synthetic_corpus": make_synthetic_corpus,
    "train_encoder": train_encoder,
    "train_vae": train_vae,
    "train_postnet": train_postnet,
    "train_hifigan": train_hifigan,
    "plot_training_curves": plot_training_curves,
    "train_full_pipeline": train_full_pipeline,
    "synthesize": synthesize,
    "batch_synthesize": batch_synthesize,
    "average_checkpoints": average_checkpoints,
}
# JAX flags the port does not accept yet, each with the ROADMAP item that
# brings it.
WAITING = {
    "train_hifigan": {"--init_from_torch": "§A.8 (torch checkpoint "
                                           "converter)"},
    "synthesize": {"--hifigan_checkpoint": "§A.8 (torch checkpoint "
                                           "converter)"},
    "batch_synthesize": {"--hifigan_checkpoint": "§A.8"},
}
# Flags the port has and the JAX script lacks. JAX runs a mesh of all the
# devices one process sees and fakes N CPU devices with an XLA flag; the
# port runs one process per device, so its mesh drivers take --mesh and
# --force_cpu_devices (N gloo ranks on the CPU) alike.
EXTRA = {
    **{name: {"--force_cpu_devices"} for name in (
        "train_encoder", "train_vae", "train_postnet", "train_hifigan",
        "train_full_pipeline")},
    "batch_synthesize": {"--mesh"},
}

# The drivers' small config: hop equals the tiny generator's total
# upsample (4 * 2), as in the JAX package's integration test.
SMALL_CFG = {
    "encoder": {"vocab_size": 41, "embed_dim": 16, "num_blocks": 1,
                "num_heads": 2},
    "duration": {"hidden_dim": 8, "num_layers": 1},
    "vae": {"n_mels": 16, "cond_dim": 16, "model_channels": 8,
            "latent_dim": 4, "num_wavenet_blocks": 1, "decoder_blocks": 1,
            "flow_layers": 1, "flow_hidden": 8, "flow_prior": True},
    "postnet": {"n_mels": 16, "num_layers": 2, "channels": 8},
    "hifigan": {"in_channels": 16, "upsample_rates": [4, 2],
                "upsample_kernel_sizes": [8, 4],
                "upsample_initial_channel": 16,
                "resblock_kernel_sizes": [3],
                "resblock_dilations": [[1]]},
    "audio": {"n_fft": 64, "hop_length": 8, "win_length": 64, "n_mels": 16},
    "train": {"checkpoint_every_epochs": 1},
}


class _Parsed(Exception):
    pass


def _jax_options(name, monkeypatch):
    """The option strings of the JAX script ``scripts/<name>.py``: its
    ``main()`` runs up to ``parse_args``, which hands over the parser
    (what ``--help`` prints, without a subprocess)."""
    mod = importlib.import_module(f"scripts.{name}")
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        mod.main()
    monkeypatch.undo()
    return {s for a in seen["parser"]._actions for s in a.option_strings}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_options_match_jax(name, monkeypatch):
    jax_opts = _jax_options(name, monkeypatch)
    port_opts = {s for a in DRIVERS[name].build_parser()._actions
                 for s in a.option_strings}
    waiting = set(WAITING.get(name, {}))
    assert waiting <= jax_opts, sorted(waiting - jax_opts)
    # the port adds --device (the JAX scripts pick their platform in JAX)
    want = (jax_opts - waiting) | {"--device"} | EXTRA.get(name, set())
    assert not EXTRA.get(name, set()) & jax_opts
    assert port_opts == want, (sorted(port_opts - want),
                               sorted(want - port_opts))


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_without_cuda_raises(name, monkeypatch, tmp_path):
    """No CUDA and no --device: the driver stops with resolve_device's
    error before it does any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "make_synthetic_corpus": ["--root", str(tmp_path / "c"), "--n", "1"],
        "plot_training_curves": ["--run", str(tmp_path), "--out",
                                 str(tmp_path / "p")],
        "average_checkpoints": ["--stage_dir", str(tmp_path / "s"),
                                "--output", str(tmp_path / "o.pt")],
    }.get(name, ["--output_dir", str(tmp_path / "o")]
          if name != "synthesize" else ["--random_weights"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DRIVERS[name].main(argv)
    assert not (tmp_path / "c").exists() and not (tmp_path / "p").exists()


def test_make_synthetic_corpus_byte_identical_to_jax(tmp_path):
    make_synthetic_corpus.main(["--root", str(tmp_path / "port"), "--n", "3",
                                "--seed", "11", "--device", "cpu"])
    jgen(tmp_path / "jax", JCorpusSpec(n_utterances=3, seed=11),
         progress_every=0)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*")
                        if p.is_file())
    assert files == port_files and len(files) == 2 * 3 + 2  # + spec, meta
    for rel in files:
        port, ref = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.name == "corpus_spec.json":  # names its generator module
            spec, jspec = (json.loads(f.read_text()) for f in (port, ref))
            assert spec.pop("generator").startswith("iris_tts_tpu_torch.")
            jspec.pop("generator")
            assert spec == jspec
            continue
        assert port.read_bytes() == ref.read_bytes(), rel


def test_checked_step_raises_at_a_non_finite_metric():
    class State:
        step = 3

    ok = common.checked_step(lambda s, b: (s, {"loss": torch.tensor(1.0)}))
    assert ok(State(), None)[1]["loss"] == 1.0
    bad = common.checked_step(
        lambda s, b: (s, {"loss": torch.tensor(float("nan"))}))
    with pytest.raises(FloatingPointError, match="loss"):
        bad(State(), None)


# ---------------------------------------------------------------------------
# train_full_pipeline end to end (one run shared by the tests below)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """The mini corpus (24 utterances), one epoch of each stage, the
    evaluation and an fp16 artifact, in-process on the CPU."""
    tmp = tmp_path_factory.mktemp("full_run")
    cfg_file = tmp / "cfg.json"
    cfg_file.write_text(json.dumps(SMALL_CFG))
    root, align = build_mini_corpus(tmp, n=24)
    argv = [
        "--config", str(cfg_file),
        "--data_root", str(root),
        "--alignment_dir", str(align),
        "--cache_dir", str(tmp / "cache"),
        "--output_dir", str(tmp / "run"),
        "--batch_size", "4",
        "--encoder_epochs", "1", "--vae_epochs", "1",
        "--postnet_epochs", "1", "--gan_epochs", "1",
        "--gan_batch", "2", "--segment_frames", "16",
        "--disc_width", "0.05", "--ema_decay", "0.9",
        "--eval_samples", "1",
        "--artifact_half",
        "--evidence_dir", str(tmp / "evidence"),
        "--release_dir", str(tmp / "release" / "pipeline_artifact"),
        "--device", "cpu",
    ]
    summary = train_full_pipeline.main(argv)
    return {"tmp": tmp, "argv": argv, "summary": summary, "cfg": cfg_file}


def test_train_full_pipeline_end_to_end(full_run):
    tmp, summary = full_run["tmp"], full_run["summary"]
    evidence = tmp / "evidence"
    for key in ("mcd_db", "lsd_db", "control_mcd_db", "control_lsd_db",
                "duration_mae_frames", "resynth_mcd_db"):
        assert math.isfinite(summary[key]), (key, summary[key])
    assert summary["mcd_margin_db"] is not None
    smoke = summary["artifact_smoke"]
    assert smoke["ok"] and smoke["params_dtype"] == "float16", smoke
    assert len(smoke["samples"]) >= 1
    on_disk = json.loads((evidence / "eval" / "summary.json").read_text())
    assert on_disk["artifact_smoke"]["ok"]
    assert set(on_disk["stage_timings_s"]) == {
        "encoder_s", "vae_s", "postnet_s", "gan_s", "eval_s"}
    for stage in ("encoder", "vae", "postnet", "hifigan_gan"):
        sdir = evidence / "stages" / stage
        assert (sdir / "metrics.csv").exists(), stage
        snap = json.loads((sdir / "snapshot.json").read_text())
        assert snap["stage"] == stage and not snap["partial"]
        assert snap["seconds"] >= 0 and snap["final_metrics"]
    assert (evidence / "stages" / "encoder" / "config_encoder.json").exists()
    assert (evidence / "stages" / "vae" / "config_vae.json").exists()
    timings = json.loads((evidence / "timings.json").read_text())
    assert set(timings) == set(on_disk["stage_timings_s"])
    assert (tmp / "run" / "timings.json").exists()
    wavs = {p.name.split("_")[0]
            for p in (evidence / "eval" / "wavs").glob("*.wav")}
    assert wavs == {"resynth", "ref", "e2e"}
    # the released artifact loads and synthesizes through the public API
    pipe = TTSPipeline.load(tmp / "release" / "pipeline_artifact",
                            device="cpu")
    audio = pipe.synthesize("hello world", seed=0)
    assert audio.ndim == 1 and len(audio) > 0
    assert len(audio) % pipe.config.hifigan.total_upsample == 0


def _stage_marks(run: Path):
    return {stage: (CheckpointManager(run / stage / "checkpoints")
                    .all_steps(),
                    len((run / stage / "metrics.csv").read_text()
                        .splitlines()))
            for stage in ("encoder", "vae", "postnet", "hifigan_gan")}


def test_train_full_pipeline_resumes_then_stops_on_preemption(
        full_run, monkeypatch):
    """A second run with the same --output_dir trains nothing (every stage
    resumes at its last epoch); a preempted stage stops the driver with
    exit code 75 and leaves partial evidence."""
    run = full_run["tmp"] / "run"
    before = _stage_marks(run)
    assert all(steps for steps, _ in before.values())
    assert train_full_pipeline.main(full_run["argv"] + ["--skip_eval"]) is None
    assert _stage_marks(run) == before

    from iris_tts_tpu_torch.train import loop as train_loop

    monkeypatch.setattr(train_loop, "was_preempted", lambda: True)
    with pytest.raises(SystemExit) as exc:
        train_full_pipeline.main(full_run["argv"])
    assert exc.value.code == 75
    snap = json.loads((full_run["tmp"] / "evidence" / "stages" / "encoder"
                       / "snapshot.json").read_text())
    assert snap["partial"] is True


def test_synthesize_from_the_artifact(full_run, tmp_path):
    art = full_run["tmp"] / "run" / "pipeline_artifact"
    out = tmp_path / "a.wav"
    audio = synthesize.main(["--artifact", str(art), "--text", "hello world",
                             "--output_wav", str(out), "--seed", "3",
                             "--device", "cpu"])
    want = TTSPipeline.load(art, device="cpu").synthesize("hello world",
                                                          seed=3)
    np.testing.assert_array_equal(audio, want)
    samples, sr = read_wav(out)
    assert sr == 22050 and len(samples) == len(want) > 0


def test_synthesize_griffin_lim(full_run, tmp_path):
    art = full_run["tmp"] / "run" / "pipeline_artifact"
    out = tmp_path / "gl.wav"
    audio = synthesize.main(["--artifact", str(art), "--text", "hello",
                             "--use_griffin_lim", "--temperature", "0",
                             "--output_wav", str(out), "--device", "cpu"])
    pipe = TTSPipeline.load(art, device="cpu")
    mel = pipe.synthesize_mel("hello", seed=1337, temperature=0.0)
    assert audio.dtype == np.float32 and bool(np.isfinite(audio).all())
    assert len(audio) == (len(mel) - 1) * pipe.config.audio.hop_length
    assert float(np.abs(audio).max()) > 0
    assert out.stat().st_size == 44 + 2 * len(audio)


def test_synthesize_random_weights_equals_pipeline(tmp_path):
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(jcfg.config_to_json(small_config()))
    out = tmp_path / "r.wav"
    text = "Hello world, this is a test."
    audio = synthesize.main(["--random_weights", "--config", str(cfg_file),
                             "--seed", "5", "--text", text,
                             "--output_wav", str(out), "--device", "cpu"])
    want = TTSPipeline.initialize(port_config(small_config()), device="cpu",
                                  seed=5).synthesize(text, seed=5)
    np.testing.assert_array_equal(audio, want)
    assert out.read_bytes() == wav_bytes(want, 22050)


# ---------------------------------------------------------------------------
# the slice against JAX: the held-out evaluation on the same weights
# ---------------------------------------------------------------------------


def test_evaluate_pipeline_matches_jax(tmp_path):
    """``evaluate_pipeline`` on a pipeline carried over from JAX, against
    the numbers JAX's building blocks give on the same weights and the same
    val split, in the order ``scripts/train_full_pipeline.py`` runs them
    (duration MAE, DTW-aligned MCD/LSD and control, resynthesis MCD)."""
    root, align = build_mini_corpus(tmp_path, n=60)
    cache = tmp_path / "cache"
    cfg = small_config()
    JVAEDataset(root, align, split="train", cache_dir=cache, audio=cfg.audio)
    jval = JVAEDataset(root, align, split="val", cache_dir=cache,
                       audio=cfg.audio)
    n_eval = len(jval)
    assert n_eval == 3  # the control row is another utterance
    jpipe = JPipeline.initialize(cfg, seed=0)

    # JAX, as scripts/train_full_pipeline.py:177-246 computes it
    step = jdur_eval(jpipe.config)
    maes, weights = [], []
    for batch in JBatcher(jval, 8, with_mel=False, seed=0).epoch(0):
        m = step({"encoder": jpipe.params["encoder"],
                  "duration": jpipe.params["duration"]},
                 {k: jnp.asarray(v) for k, v in batch.items()})
        maes.append(float(m["duration_mae_frames"]))
        weights.append(int(np.asarray(batch["phoneme_mask"]).sum()))
    rows = []
    for i in range(n_eval):
        gt, other = jval[i], jval[(i + n_eval // 2 + 1) % len(jval)]
        mel = jpipe.synthesize_mel(gt.text, seed=0, temperature=0.0)
        q, qc = jquality(mel, gt.mel, "dtw"), jquality(mel, other.mel, "dtw")
        rows.append((q["mcd_db"], q["lsd_db"], qc["mcd_db"], qc["lsd_db"]))
    resynth = []
    for i in range(min(4, n_eval)):
        gt = jval[i]
        mel_r = np.asarray(jax_log_mel(jnp.asarray(jpipe.vocode(gt.mel)),
                                       cfg.audio))[: gt.mel.shape[0]]
        resynth.append(jquality(mel_r, gt.mel[: mel_r.shape[0]],
                                "trim")["mcd_db"])
    want = dict(zip(("mcd_db", "lsd_db", "control_mcd_db", "control_lsd_db"),
                    np.mean(rows, axis=0)))
    want["resynth_mcd_db"] = float(np.mean(resynth))

    # the port, on the same weights and the same cached split
    pipe = TTSPipeline.from_jax_params(numpy_tree(jpipe.params),
                                       port_config(jpipe.config),
                                       device="cpu", seed=jpipe.seed)
    val = LJSpeechVAEDataset(root, align, split="val", cache_dir=cache,
                             audio=pipe.config.audio, device="cpu")
    assert val.sample_ids == jval.sample_ids
    summary, port_rows = train_full_pipeline.evaluate_pipeline(
        pipe, val, tmp_path / "eval", root, eval_samples=8)
    assert summary["eval_samples"] == n_eval == len(port_rows)
    assert abs(summary["duration_mae_frames"]
               - float(np.average(maes, weights=weights))) <= 1e-4
    for key, value in want.items():
        assert abs(summary[key] - value) <= 0.05, (key, summary[key], value)
    assert summary["control_mcd_db"] != summary["mcd_db"]


# ---------------------------------------------------------------------------
# batch synthesis and checkpoint averaging
# ---------------------------------------------------------------------------

BATCH_TEXTS = ["Hello world.", "The quick brown fox jumps.", "A test.",
               "Speech synthesis is fast.", "Good morning to you all."]


def test_batch_synthesize_rows_equal_two_stage_synthesis(tmp_path, capsys,
                                                        monkeypatch):
    cfg = port_config(small_config())
    pipe = TTSPipeline.initialize(cfg, seed=7, device="cpu")
    audio, plan = batch_synthesize.synthesize_batches(pipe, BATCH_TEXTS, 2, 7)
    assert sorted(audio) == list(range(len(BATCH_TEXTS)))
    assert sum(len(set(idxs)) for idxs, _ in plan) == len(BATCH_TEXTS)
    assert any(len(set(idxs)) < len(idxs) for idxs, _ in plan)  # padded
    for idxs, seed in plan:
        want = pipe.synthesize([BATCH_TEXTS[i] for i in idxs], seed=seed,
                               fused=False)
        for r, i in enumerate(idxs):
            if r and i == idxs[r - 1]:
                continue  # a padding repeat: its own noise, not returned
            peak = float(np.abs(want[r]).max())
            assert audio[i].shape == want[r].shape
            assert float(np.abs(audio[i] - want[r]).max()) <= 1e-6 * peak

    text_file = tmp_path / "texts.txt"
    text_file.write_text("\n".join(BATCH_TEXTS) + "\n\n")
    # --random_weights builds IrisConfig(), as JAX's does: small here
    monkeypatch.setattr(batch_synthesize, "IrisConfig", lambda: cfg)
    summary = batch_synthesize.main([
        "--text_file", str(text_file), "--random_weights",
        "--batch_size", "2", "--seed", "7", "--write_wavs",
        "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert set(summary) == {"rtf", "mel_frames_per_sec", "p50_latency_s",
                            "p90_latency_s", "audio_seconds", "wall_seconds"}
    total = sum(len(a) for a in audio.values())
    assert summary["audio_seconds"] == pytest.approx(total / 22050)
    assert summary["rtf"] > 0
    logged = capsys.readouterr().err
    assert "batched synthesis summary" in logged and "rtf:" in logged
    assert len(list((tmp_path / "out").glob("utt_*.wav"))) == len(BATCH_TEXTS)


def _save_states(directory, n):
    ckpt = CheckpointManager(directory, keep_every_n=0)
    rng = np.random.default_rng(9)
    params = []
    for step in range(1, n + 1):
        m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(
                    rng.standard_normal(tuple(p.shape)).astype(np.float32)))
        state = TrainState.create(m, adam_clipped(1e-3), 0)
        state.step = step
        ckpt.save(step, state)
        params.append({k: v.double() for k, v in m.state_dict().items()})
    return params


def test_average_checkpoints_is_the_float64_mean(tmp_path):
    params = _save_states(tmp_path / "stage", 4)
    out = tmp_path / "avg.pt"
    used = average_checkpoints.main(["--stage_dir", str(tmp_path / "stage"),
                                     "--last", "3", "--output", str(out),
                                     "--device", "cpu"])
    assert used == [2, 3, 4]
    avg = load_params(out)
    assert set(avg) == set(params[0])
    for k, v in avg.items():
        want = sum(p[k] for p in params[1:]) / 3
        assert v.dtype == torch.float32
        assert float((v.double() - want).abs().max()) <= 1e-7

    used = average_checkpoints.main(["--stage_dir", str(tmp_path / "stage"),
                                     "--steps", "1", "4", "--output",
                                     str(out), "--device", "cpu"])
    assert used == [1, 4]
    avg = load_params(out)
    for k, v in avg.items():
        want = (params[0][k] + params[3][k]) / 2
        assert float((v.double() - want).abs().max()) <= 1e-7
    with pytest.raises(ValueError, match="not retained"):
        average_checkpoints.main(["--stage_dir", str(tmp_path / "stage"),
                                  "--steps", "9", "--output", str(out),
                                  "--device", "cpu"])
