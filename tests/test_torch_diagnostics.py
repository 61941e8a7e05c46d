"""The port's diagnostics and pre-flight tools
(``iris_tts_tpu_torch.scripts``), run in-process through ``main(argv)``
with ``--device cpu``: the checkpoint tools against the numbers JAX's
building blocks give on the same weights and the same validation split
(computed in the order the JAX scripts compute them), the host tools'
output against the JAX scripts' own, and the JAX package's command-line
tests of the tools mirrored."""

import argparse
import dataclasses
import hashlib
import importlib
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import iris_tts_tpu.config as jcfg
from iris_tts_tpu.data.batching import BucketedBatcher as JBatcher
from iris_tts_tpu.data.ljspeech import LJSpeechDurationDataset as JDurDataset
from iris_tts_tpu.data.ljspeech import LJSpeechVAEDataset as JVAEDataset
from iris_tts_tpu.models import DurationPredictor as JDuration
from iris_tts_tpu.models import PhonemeEncoder as JEncoder
from iris_tts_tpu.models import TextConditionedVAE as JVAE
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.ops.length import length_regulate as jlength_regulate
from iris_tts_tpu.ops.length import round_up_to_multiple
from iris_tts_tpu.train import make_vae_eval_step as jvae_eval
from iris_tts_tpu.train import make_vae_recon_step as jvae_recon
from iris_tts_tpu.utils.metrics import RunningMean as JRunningMean
from iris_tts_tpu.utils.metrics import quality_report as jquality
from iris_tts_tpu_torch.convert.torch_oracle import TorchGenerator
from iris_tts_tpu_torch.data.audio_io import read_wav
from iris_tts_tpu_torch.data.ljspeech import LJSpeechVAEDataset
from iris_tts_tpu_torch.models import (
    DurationPredictor,
    PhonemeEncoder,
    TextConditionedVAE,
)
from iris_tts_tpu_torch.scripts import (
    analyze_vae,
    debug_vae_loss,
    demo_text_processing,
    example,
    gen_normalize_corpus,
    investigate_durations,
    test_encoder_setup,
    test_synthesis,
    test_trained_encoder,
    test_vae_setup,
    validate_vae_checkpoint,
)
from iris_tts_tpu_torch.scripts.synthesize import build_parser
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
from iris_tts_tpu_torch.train.stages import load_frozen_encoder, load_frozen_vae
from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
from iris_tts_tpu_torch.utils.metrics import quality_report
from tests.corpus_utils import build_mini_corpus
from tests.torch_port_utils import load_port_module, port_config, small_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TOOLS = ["demo_text_processing", "gen_normalize_corpus",
         "investigate_durations", "test_encoder_setup", "test_vae_setup",
         "debug_vae_loss", "test_trained_encoder", "validate_vae_checkpoint",
         "analyze_vae", "test_synthesis", "example"]
DEVICE_TOOLS = TOOLS[3:]
REL = 1e-4  # deterministic numbers, relative
PEAK = 1e-4  # numbers from a shared prior draw, of the peak


def _close(got, want, rel=REL):
    assert abs(got - want) <= rel * max(abs(want), 1e-6), (got, want)


# ---------------------------------------------------------------------------
# a corpus, JAX weights, and the same weights as the port's stage checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The mini corpus of 60 (a val split of 3), its cache built by the
    JAX datasets (vocab, alignments and val mels: the port's tools read
    the same cached mels), JAX weights at ``small_config()`` with the
    corpus's vocab, and the same weights saved as the port's duration
    and VAE stage checkpoints."""
    tmp = tmp_path_factory.mktemp("diag")
    root, align = build_mini_corpus(tmp, n=60)
    cache = tmp / "cache"
    cfg = small_config()
    jtrain = JDurDataset(root, align, split="train", cache_dir=cache,
                         audio=cfg.audio)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, vocab_size=len(jtrain.vocab)))
    jval = JVAEDataset(root, align, split="val", cache_dir=cache,
                       audio=cfg.audio)
    jval.precompute_mels()
    assert len(jval) == 3
    jparams = JPipeline.initialize(cfg, vocab=jtrain.vocab, seed=0).params

    pcfg = port_config(cfg)
    dur = nn.ModuleDict({
        "encoder": load_port_module(PhonemeEncoder(pcfg.encoder), "encoder",
                                    jparams["encoder"]),
        "duration": load_port_module(
            DurationPredictor(pcfg.encoder.embed_dim, pcfg.duration),
            "duration", jparams["duration"]),
    })
    vae = load_port_module(TextConditionedVAE(pcfg.vae), "vae",
                           jparams["vae"])
    stages = {}
    for name, module in (("encoder", dur), ("vae", vae)):
        stages[name] = tmp / name / "checkpoints"
        CheckpointManager(stages[name], pcfg).save(
            1, TrainState.create(module, adam_clipped(1e-3), 0))
    return dict(root=root, align=align, cache=cache, cfg=cfg, pcfg=pcfg,
                jparams=jparams, jval=jval, stages=stages, tmp=tmp)


def _args(w, *extra):
    return ["--data_root", str(w["root"]), "--alignment_dir",
            str(w["align"]), "--cache_dir", str(w["cache"]),
            "--encoder_checkpoint", str(w["stages"]["encoder"]),
            *extra, "--device", "cpu"]


def _vae_args(w, *extra):
    return _args(w, "--vae_checkpoint", str(w["stages"]["vae"]), *extra)


def _port_stages(w):
    return (load_frozen_encoder(w["pcfg"], w["stages"]["encoder"], "cpu"),
            load_frozen_vae(w["pcfg"], w["stages"]["vae"], "cpu"))


def _jax_cond(w, sample, T):
    """JAX's frame conditioning of one utterance, as the scripts build it
    (no padding mask)."""
    cfg, p = w["cfg"], w["jparams"]
    enc = JEncoder(config=cfg.encoder).apply(
        {"params": p["encoder"]}, jnp.asarray(sample.phoneme_ids)[None])
    return jlength_regulate(
        enc, jnp.asarray(sample.durations.astype(np.int32))[None], T)


def _jax_generate(w, cond, z_prior):
    return np.asarray(JVAE(config=w["cfg"].vae).apply(
        {"params": w["jparams"]["vae"]}, cond, jnp.asarray(z_prior),
        method=JVAE.generate)[0])


# ---------------------------------------------------------------------------
# the checkpoint tools against JAX's building blocks
# ---------------------------------------------------------------------------


def test_trained_encoder_matches_jax(world):
    """``test_trained_encoder``: per-utterance duration MAE / RMSE /
    correlation and the verdict, against JAX's encoder and duration head
    on the same weights and split (``scripts/test_trained_encoder.py``'s
    order)."""
    w = world
    got = test_trained_encoder.main(_args(w))
    cfg, p = w["cfg"], w["jparams"]
    jval = JDurDataset(w["root"], w["align"], split="val",
                       cache_dir=w["cache"], audio=cfg.audio)
    enc, head = JEncoder(config=cfg.encoder), JDuration(config=cfg.duration)
    maes, rmses, corrs = [], [], []
    for batch in JBatcher(jval, 16, with_mel=False, seed=0).epoch(0):
        e = enc.apply({"params": p["encoder"]},
                      jnp.asarray(batch["phoneme_ids"]),
                      padding_mask=jnp.asarray(batch["phoneme_mask"]))
        pred = np.asarray(jnp.exp(head.apply({"params": p["duration"]}, e))
                          - 1.0)
        for b in range(pred.shape[0]):
            m = batch["phoneme_mask"][b] > 0
            if m.sum() < 2 or len(maes) >= 100:
                continue
            pp, t = pred[b][m], batch["durations"][b][m]
            maes.append(np.abs(pp - t).mean())
            rmses.append(np.sqrt(((pp - t) ** 2).mean()))
            if np.std(pp) > 1e-6 and np.std(t) > 1e-6:
                corrs.append(np.corrcoef(pp, t)[0, 1])
    assert got["n_samples"] == len(maes) == 3
    _close(got["mae_frames"], float(np.mean(maes)))
    _close(got["rmse_frames"], float(np.mean(rmses)))
    # the mini corpus gives every phone of an utterance one duration, so
    # neither side has a correlation to average
    assert not corrs and np.isnan(got["corr"])
    mae = float(np.mean(maes))
    assert got["verdict"] == next(
        v for t, v in test_trained_encoder.VERDICTS if mae < t)


def test_validate_vae_checkpoint_matches_jax(world):
    """``validate_vae_checkpoint``: eval metrics and posterior-mean
    MCD / LSD over the split and the recon-L1 verdict against JAX's eval
    and recon steps; the generation smoke check on a shared prior draw
    within 1e-4 of the peak."""
    w = world
    got = validate_vae_checkpoint.main(_vae_args(w, "--num_batches", "2"))
    cfg, p = w["cfg"], w["jparams"]
    eval_step, recon_step = jax.jit(jvae_eval(cfg)), jax.jit(jvae_recon(cfg))
    rm, n_batches = JRunningMean(), 0
    for batch in JBatcher(w["jval"], cfg.train.batch_size, with_mel=True,
                          down_factor=cfg.vae.down_factor, seed=0).epoch(0):
        if n_batches >= 2:
            break
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        frozen = {"encoder": p["encoder"]}
        m = eval_step(p["vae"], frozen, batch, jnp.asarray(0.01))
        rm.update({k: float(v) for k, v in m.items()})
        recon, mask = recon_step(p["vae"], frozen, batch)
        recon, mask = np.asarray(recon), np.asarray(mask)
        gt = np.asarray(batch["mel"])
        for i in range(recon.shape[0]):
            n = int((mask[i] > 0).sum())
            if n >= 4:
                rm.update(jquality(recon[i, :n], gt[i, :n]))
        n_batches += 1
    want = rm.means()
    assert got["n_batches"] == n_batches >= 1
    assert set(got["means"]) == set(want)
    assert {"mcd_db", "lsd_db", "recon_l1", "kl", "total"} <= set(want)
    for key, value in want.items():
        _close(got["means"][key], value)
    recon = want["recon_l1"]
    assert got["verdict"] == ("not trained well" if recon > 5 else
                              "could be better" if recon > 1 else
                              "reasonable")
    assert got["generate"]["finite"]
    assert got["generate"]["shape"] == (
        1, validate_vae_checkpoint.GENERATE_FRAMES, cfg.vae.n_mels)

    _, vae = _port_stages(w)
    frames = validate_vae_checkpoint.GENERATE_FRAMES
    z = np.random.default_rng(3).standard_normal(
        (1, frames // cfg.vae.down_factor, cfg.vae.latent_dim)).astype(
            np.float32)
    with torch.no_grad():
        ours = validate_vae_checkpoint.generation_smoke(vae, w["pcfg"],
                                                        "cpu", z_prior=z)
    theirs = _jax_generate(w, jnp.zeros((1, frames, cfg.vae.cond_dim)), z)
    peak = float(np.abs(theirs).max())
    assert np.abs(ours["mel"] - theirs).max() <= PEAK * peak
    assert abs(ours["std"] - theirs.std()) <= PEAK * peak
    assert abs(ours["mean"] - theirs.mean()) <= PEAK * peak


def test_analyze_vae_matches_jax(world, capsys):
    """``analyze_vae``: per utterance the posterior-mean reconstruction's
    MSE, rubric and statistics against JAX's on the same weights; the
    prior generation and the random-conditioning control on shared draws
    within 1e-4 of the peak."""
    w = world
    rows = analyze_vae.main(_vae_args(w))
    printed = capsys.readouterr().out
    cfg, p = w["cfg"], w["jparams"]
    jvae = JVAE(config=cfg.vae)
    encoder, vae = _port_stages(w)
    pval = LJSpeechVAEDataset(w["root"], w["align"], split="val",
                              cache_dir=w["cache"], audio=w["pcfg"].audio,
                              device="cpu")
    rng = np.random.default_rng(4)
    assert len(rows) == len(w["jval"]) == 3
    for i, row in enumerate(rows):
        s = w["jval"][i]
        assert row["file_id"] == s.file_id and f"[{s.file_id}]" in printed
        T = round_up_to_multiple(s.mel.shape[0], cfg.vae.down_factor)
        mel = jnp.asarray(np.pad(s.mel, ((0, T - s.mel.shape[0]),
                                         (0, 0))))[None]
        cond, _ = _jax_cond(w, s, T)
        recon, (mean, logvar), _ = jvae.apply({"params": p["vae"]}, mel,
                                              cond)
        r = np.asarray(recon[0, : s.mel.shape[0]])
        mse = float(np.mean((r - s.mel) ** 2))
        _close(row["mse"], mse)
        assert row["rubric"] == analyze_vae.rubric(mse)
        _close(row["recon_std"], float(r.std()))
        _close(row["target_std"], float(s.mel.std()))
        _close(row["posterior_abs_mean"], float(jnp.abs(mean).mean()))
        assert row["logvar_mean"] == float(logvar.mean()) == 0.0

        tp = T // cfg.vae.down_factor
        draws = {
            "z_prior": rng.standard_normal((1, tp, cfg.vae.latent_dim)),
            "rand_cond": rng.standard_normal(tuple(cond.shape)),
            "z_control": rng.standard_normal((1, tp, cfg.vae.latent_dim)),
        }
        draws = {k: v.astype(np.float32) for k, v in draws.items()}
        ours = analyze_vae.analyze_sample(encoder, vae, pval[i], w["pcfg"],
                                          "cpu", draws=draws)
        g = _jax_generate(w, cond, draws["z_prior"])[0]
        g_r = _jax_generate(w, jnp.asarray(draws["rand_cond"]),
                            draws["z_control"])
        peak = float(np.abs(g).max())
        delta = float(np.abs(g_r - g).mean())
        for key, want in (("gen_std", g.std()), ("gen_min", g.min()),
                          ("gen_max", g.max()), ("delta", delta)):
            assert abs(ours[key] - float(want)) <= PEAK * peak, key
        assert ours["live"] == (delta > analyze_vae.LIVE_DELTA)


def test_synthesis_matches_jax(world):
    """``test_synthesis``: the ground-truth-duration generation on a
    shared prior draw within 1e-4 of the peak of JAX's, with its MSE /
    MAE and trimmed quality report; the command line writes the
    reference and the Griffin-Lim wavs."""
    w = world
    out_dir = w["tmp"] / "synth"
    got = test_synthesis.main(_vae_args(w, "--output_dir", str(out_dir)))
    cfg = w["cfg"]
    s = w["jval"][0]
    assert got["file_id"] == s.file_id
    for name in ("reference", "generated"):
        audio, sr = read_wav(got[name])
        assert sr == cfg.audio.sample_rate and len(audio) > 0
        assert got[name] == out_dir / "test_synthesis" / f"{name}.wav"
    assert np.isfinite([got[k] for k in ("mse", "mae", "mcd_db", "lsd_db",
                                         "mel_l1")]).all()

    encoder, vae = _port_stages(w)
    pval = LJSpeechVAEDataset(w["root"], w["align"], split="val",
                              cache_dir=w["cache"], audio=w["pcfg"].audio,
                              device="cpu")
    T = round_up_to_multiple(int(s.durations.astype(np.int32).sum()),
                             cfg.vae.down_factor)
    z = np.random.default_rng(5).standard_normal(
        (1, T // cfg.vae.down_factor, cfg.vae.latent_dim)).astype(np.float32)
    ours = test_synthesis.generate_with_gt_durations(
        encoder, vae, pval[0], w["pcfg"], "cpu", z_prior=z)
    cond, mask = _jax_cond(w, s, T)
    n = int(np.asarray(mask).sum())
    theirs = _jax_generate(w, cond, z)[0, :n]
    peak = float(np.abs(theirs).max())
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= PEAK * peak
    gt = s.mel[:n]
    # |(d + e)^2 - d^2| <= |e| (2 |d| + |e|) for a mel error e <= PEAK peak
    err, d = PEAK * peak, np.abs(theirs - gt).max()
    assert abs(np.mean((ours - gt) ** 2)
               - np.mean((theirs - gt) ** 2)) <= err * (2 * d + err)
    assert abs(np.mean(np.abs(ours - gt))
               - np.mean(np.abs(theirs - gt))) <= err
    q_ours = quality_report(ours, gt, align="trim")
    q_theirs = jquality(theirs, gt, align="trim")
    for key in ("mcd_db", "lsd_db", "mel_l1"):
        assert abs(q_ours[key] - q_theirs[key]) <= 1e-3 * abs(
            q_theirs[key]), key


def test_synthesis_vocodes_with_a_converted_hifigan(world):
    """``--hifigan_checkpoint``: a torch ``generator.ckpt`` (the oracle
    generator at the small width) is converted on load and vocodes the
    generated mel; the wav holds the oracle's own waveform."""
    w = world
    torch.manual_seed(7)
    hcfg = w["pcfg"].hifigan
    oracle = TorchGenerator(hcfg).eval()
    with torch.no_grad():  # a waveform PCM16 resolves
        for name, prm in oracle.named_parameters():
            if name.endswith("weight_g"):
                prm.mul_(20.0)
    ckpt = w["tmp"] / "generator.ckpt"
    torch.save({"generator": oracle.state_dict()}, ckpt)
    out_dir = w["tmp"] / "synth_hifigan"
    got = test_synthesis.main(_vae_args(
        w, "--output_dir", str(out_dir), "--hifigan_checkpoint", str(ckpt)))

    encoder, vae = _port_stages(w)
    pval = LJSpeechVAEDataset(w["root"], w["align"], split="val",
                              cache_dir=w["cache"], audio=w["pcfg"].audio,
                              device="cpu")
    gen = torch.Generator().manual_seed(0)  # the command line's draw
    mel = test_synthesis.generate_with_gt_durations(
        encoder, vae, pval[0], w["pcfg"], "cpu", generator=gen)
    with torch.no_grad():
        want = oracle(torch.from_numpy(mel).T[None])[0, 0].numpy()
    audio, sr = read_wav(got["generated"])
    assert len(audio) == len(want) == len(mel) * hcfg.total_upsample
    assert np.abs(want).max() > 1e-2
    assert np.abs(audio - np.clip(want, -1, 1)).max() <= 2.0 / 32767


# ---------------------------------------------------------------------------
# pre-flight tools, mirrored from the JAX package's command-line tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_cfg_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "small.json"
    path.write_text(jcfg.config_to_json(small_config()))
    return path


def test_encoder_setup_cli(small_cfg_file, capsys):
    got = test_encoder_setup.main(["--config", str(small_cfg_file),
                                   "--data_root", "no/corpus/here",
                                   "--device", "cpu"])
    assert got["failures"] == 0 and np.isfinite(got["loss"])
    assert "SETUP OK" in capsys.readouterr().out


def test_encoder_setup_reads_a_corpus(world, capsys):
    w = world
    got = test_encoder_setup.main([
        "--config", str(w["stages"]["encoder"] / "config.json"),
        "--data_root", str(w["root"]), "--alignment_dir", str(w["align"]),
        "--cache_dir", str(w["tmp"] / "setup_cache"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert got["failures"] == 0 and got["samples"] == 4
    assert got["vocab_size"] == w["cfg"].encoder.vocab_size
    assert "✓ dataset: 57 samples" in out and "SETUP OK" in out


def test_vae_setup_cli(small_cfg_file, capsys):
    got = test_vae_setup.main(["--config", str(small_cfg_file),
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert got["failures"] == 0
    assert "SETUP OK" in out and "flow invertibility" in out
    assert got["flow_err"] < test_vae_setup.FLOW_LIMIT


def test_debug_vae_loss_derivations_agree(monkeypatch, capsys):
    """At the test width: the train step, the recompute on the replayed
    random stream and the raw NumPy arithmetic agree."""
    cfg = port_config(small_config())
    monkeypatch.setattr(debug_vae_loss, "IrisConfig", lambda: cfg)
    got = debug_vae_loss.main(["--device", "cpu"])
    assert got["agree"] and "all three derivations agree" in (
        capsys.readouterr().out)
    assert got["step"] == got["manual"]
    for key in ("recon_l1", "kl", "total"):
        assert abs(got["raw"][key] - got["step"][key]) <= 1e-4


def test_example_writes_a_wav(tmp_path, monkeypatch):
    cfg = port_config(small_config())
    monkeypatch.setattr(example, "IrisConfig", lambda: cfg)
    out = tmp_path / "nested" / "example.wav"
    got = example.main(["--output_wav", str(out), "--device", "cpu"])
    audio, sr = read_wav(out)
    assert sr == 22050 and len(audio) == got["file_samples"] > 0
    assert got["samples"] > 0 and got["samples"] % 256 == 0


def test_example_hifigan_synthesis_script():
    """The shell example parses, and every flag it passes to the port's
    ``synthesize`` exists in that driver's parser."""
    script = REPO / "iris_tts_tpu_torch" / "scripts" / (
        "example_hifigan_synthesis.sh")
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    text = script.read_text()
    assert "python -m iris_tts_tpu_torch.scripts.synthesize" in text
    flags = set(re.findall(r"(--[a-z_]+)", text))
    known = {o for a in build_parser()._actions for o in a.option_strings}
    assert flags and flags <= known, flags - known


# ---------------------------------------------------------------------------
# host tools: the JAX scripts' own output
# ---------------------------------------------------------------------------


def _jax_stdout(module: str, argv, monkeypatch, capsys) -> str:
    """A JAX root script's ``main()`` in-process, its stdout."""
    mod = importlib.import_module(module)
    monkeypatch.setattr(sys, "argv", [module, *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--text", "Dr. Who saw 3 cats."]])
def test_demo_text_processing_prints_jaxs_lines(argv, monkeypatch, capsys):
    want = _jax_stdout("demo_text_processing", argv, monkeypatch, capsys)
    got = demo_text_processing.main(argv)
    assert capsys.readouterr().out.splitlines() == want.splitlines()
    if argv:  # JAX's own CLI check
        assert "doctor who saw three cats." in want
        assert got["normalized"] == ["doctor who saw three cats."]


def test_investigate_durations_prints_jaxs_lines(world, monkeypatch,
                                                 capsys):
    argv = ["--alignment_dir", str(world["align"])]
    want = _jax_stdout("investigate_durations", argv, monkeypatch, capsys)
    got = investigate_durations.main(argv)
    assert capsys.readouterr().out.splitlines() == want.splitlines()
    assert got["utterances"] == 60 and sum(got["histogram"]) == got["phones"]


def test_gen_normalize_corpus_cli(capsys):
    got = gen_normalize_corpus.main(["--audit", "1"])
    assert "== cardinal" in capsys.readouterr().out
    assert got["classes"] == 18 and got["frozen"] is None


def _digest(directory: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(directory.rglob("*")):
        if p.is_file():
            h.update(str(p.relative_to(directory)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_gen_normalize_corpus_freeze_equals_the_golden(tmp_path):
    data = REPO / "tests" / "data"
    before = _digest(data)
    dest = tmp_path / "golden.txt"
    got = gen_normalize_corpus.main(["--freeze", "--output", str(dest)])
    assert got["frozen"] == dest and got["cases"] == 514
    assert dest.read_bytes() == (data / "normalize_corpus_golden.txt"
                                 ).read_bytes()
    assert _digest(data) == before


def test_gen_normalize_corpus_aborts_on_a_property_failure(monkeypatch):
    monkeypatch.setattr(gen_normalize_corpus, "normalize_text",
                        lambda s: s.lower())  # digits survive
    with pytest.raises(SystemExit) as e:
        gen_normalize_corpus.main([])
    assert e.value.code == 1


# ---------------------------------------------------------------------------
# the tools' options against the JAX scripts'
# ---------------------------------------------------------------------------

# Where each JAX tool lives (the root-level ones are modules of the repo
# root; JAX's example.py has no parser).
JAX_TOOLS = {t: (t if t in ("demo_text_processing", "investigate_durations",
                            "debug_vae_loss", "analyze_vae")
                 else f"scripts.{t}")
             for t in TOOLS if t != "example"}
# Options the port has and the JAX tool lacks: the device, and where the
# generator's --freeze writes (JAX writes into its tests/data).
EXTRA_OPTIONS = {**{t: {"--device"} for t in DEVICE_TOOLS},
                 "gen_normalize_corpus": {"--output"}}


class _Parsed(Exception):
    pass


def _options(main, monkeypatch, *args) -> set:
    """The option strings of the parser ``main`` builds: its
    ``parse_args`` hands the parser over instead of parsing."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        main(*args)
    return {o for a in seen["parser"]._actions for o in a.option_strings}


@pytest.mark.parametrize("tool", sorted(JAX_TOOLS))
def test_tool_options_are_jaxs(tool, monkeypatch):
    theirs = _options(importlib.import_module(JAX_TOOLS[tool]).main,
                      monkeypatch)
    ours = _options(importlib.import_module(
        f"iris_tts_tpu_torch.scripts.{tool}").main, monkeypatch, [])
    assert ours == theirs | EXTRA_OPTIONS.get(tool, set()), (
        ours ^ theirs)


# ---------------------------------------------------------------------------
# the tools' contract: the card by default, and no JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool", DEVICE_TOOLS)
def test_device_tool_raises_without_a_card(tool):
    """Without ``--device`` a device tool takes the card, and raises
    before any work on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    mod = importlib.import_module(f"iris_tts_tpu_torch.scripts.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_tools_import_no_jax():
    """Every tool module imports, and nothing it pulls in is JAX or the
    JAX package (a fresh interpreter, its module table read)."""
    code = (
        "import importlib, sys\n"
        f"for t in {TOOLS!r}:\n"
        "    importlib.import_module('iris_tts_tpu_torch.scripts.' + t)\n"
        "roots = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'iris_tts_tpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    shell = (REPO / "iris_tts_tpu_torch" / "scripts"
             / "example_hifigan_synthesis.sh").read_text()
    assert "iris_tts_tpu." not in shell and "scripts/synthesize.py" not in (
        shell)
