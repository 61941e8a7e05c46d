"""The port's checkpoints, metrics writer and training loop, and the whole
training slice: the four stages through ``TrainLoop`` on a 4-utterance
synthetic corpus, assembled by ``TTSPipeline.from_checkpoints`` and held
against the JAX pipeline built from the same params.
"""

import csv
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch
import torch.nn as nn

import iris_tts_tpu.config as jcfg
import iris_tts_tpu_torch.config as tcfg
from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu.text.phonemes import PhonemeVocab as JVocab
from iris_tts_tpu.utils.metrics import MetricsWriter as JMetricsWriter
from iris_tts_tpu_torch.data.synthetic_speech import (
    CorpusSpec,
    generate_corpus,
)
from iris_tts_tpu_torch.models.discriminators import HiFiGANDiscriminators
from iris_tts_tpu_torch.models.encoder import DurationPredictor, PhonemeEncoder
from iris_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.train import stages
from iris_tts_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from iris_tts_tpu_torch.train.gan import GANState, make_gan_train_step
from iris_tts_tpu_torch.train.loop import (
    TrainLoop,
    resume_if_available,
    was_preempted,
)
from iris_tts_tpu_torch.train.state import TrainState, adam_clipped
from iris_tts_tpu_torch.train.steps import make_duration_train_step
from iris_tts_tpu_torch.utils.metrics import MetricsWriter
from tests.torch_port_utils import (
    jax_params_from_port,
    max_abs,
    numpy_tree,
    small_config,
)

torch.set_num_threads(2)
CFG = small_config(tcfg)  # dropout on: the generator must round-trip
P = 8


def _duration_state(seed=0, ema=None):
    module = nn.ModuleDict({
        "encoder": PhonemeEncoder(CFG.encoder),
        "duration": DurationPredictor(CFG.encoder.embed_dim, CFG.duration)})
    init_params(module, torch.Generator().manual_seed(seed))
    return TrainState.create(module, adam_clipped(1e-3, 1.0), seed,
                             ema_decay=ema)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "phoneme_ids": torch.from_numpy(
            rng.integers(2, 40, (2, P)).astype(np.int32)),
        "durations": torch.from_numpy(
            rng.integers(1, 4, (2, P)).astype(np.float32)),
        "phoneme_mask": torch.ones(2, P),
    }


def _snapshot(state):
    """Everything a step reads or writes, as tensors."""
    sd = state.state_dict()
    out = {f"p.{k}": v.clone() for k, v in sd["params"].items()}
    if sd["ema_params"] is not None:
        out.update({f"e.{k}": v.clone() for k, v in sd["ema_params"].items()})
    for i, st in sd["opt_state"]["state"].items():
        out.update({f"o.{i}.{k}": torch.as_tensor(v).clone()
                    for k, v in st.items()})
    out["rng"] = sd["rng"].clone()
    return out


def _assert_bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("ema", [None, 0.99])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, ema):
    """Save after two steps; the restored state, and two more steps from
    it, equal the uninterrupted run bit for bit (params, optimizer,
    generator — dropout is on — EMA, step, epoch)."""
    step = make_duration_train_step(CFG)
    state = _duration_state(ema=ema)
    for i in range(2):
        state, _ = step(state, _batch(i))
    state.epoch = 1
    ckpt = CheckpointManager(tmp_path / "ckpt", CFG)
    ckpt.save(state.step, state, epoch=1)
    saved = _snapshot(state)
    for i in range(2, 4):
        state, m = step(state, _batch(i))
    final = _snapshot(state)

    restored, start_epoch = resume_if_available(
        ckpt, _duration_state(seed=5, ema=ema))
    assert (restored.step, restored.epoch, start_epoch) == (2, 1, 1)
    _assert_bit_equal(_snapshot(restored), saved)
    for i in range(2, 4):
        restored, m2 = step(restored, _batch(i))
    _assert_bit_equal(_snapshot(restored), final)
    assert torch.equal(m["duration_loss"], m2["duration_loss"])
    with pytest.raises(ValueError, match="ema_decay"):
        ckpt.restore(_duration_state(ema=None if ema else 0.9))


def test_gan_state_round_trip(tmp_path):
    gen = HiFiGANGenerator(CFG.hifigan)
    disc = HiFiGANDiscriminators(width=0.125)
    for m in (gen, disc):
        init_params(m, torch.Generator().manual_seed(0))
    tx = adam_clipped(1e-3, 1.0, b1=0.8, b2=0.99)
    state = GANState(TrainState.create(gen, tx, 0, ema_decay=0.9),
                     TrainState.create(disc, tx, 1))
    batch = {"mel": torch.randn(2, 8, 80), "audio": 0.1 * torch.randn(2, 2048)}
    state, m = make_gan_train_step(CFG)(state, batch)
    assert state.step == state.disc.step == 1
    state.epoch = 1
    assert state.disc.epoch == 1
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(state.step, state, val_metric=float(m["gen_mel_l1"]))
    raw = ckpt.restore_best_raw()
    assert set(raw) == {"gen", "disc"}
    fresh = GANState(TrainState.create(HiFiGANGenerator(CFG.hifigan), tx, 0,
                                       ema_decay=0.9),
                     TrainState.create(HiFiGANDiscriminators(width=0.125),
                                       tx, 1))
    ckpt.restore(fresh)
    for a, b in [(fresh.gen, state.gen), (fresh.disc, state.disc)]:
        _assert_bit_equal(_snapshot(a), _snapshot(b))
    assert fresh.serving_params is fresh.gen.ema_params


def test_checkpoint_manager_retention_best_and_config(tmp_path, caplog):
    state = _duration_state()
    ckpt = CheckpointManager(tmp_path, CFG, keep_every_n=2, max_to_keep=2)
    bests = [ckpt.save(s, state, val_metric=v, epoch=s)
             for s, v in [(1, 3.0), (2, 2.0), (3, 2.5), (4, 1.0), (5, None),
                          (6, 4.0)]]
    assert bests == [True, True, False, True, False, False]
    # latest two + every 2nd epoch pinned for good
    assert ckpt.all_steps() == [2, 4, 5, 6]
    assert ckpt.latest_step() == 6
    assert json.loads((tmp_path / "best_metric.json").read_text()) == {
        "best_metric": 1.0, "step": 4}
    assert CheckpointManager(tmp_path).best_metric == 1.0
    assert ckpt.load_config() == CFG
    other = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, seed=1))
    CheckpointManager(tmp_path, other)
    assert "keeping the original record" in caplog.text
    assert ckpt.load_config() == CFG
    assert not list(tmp_path.glob("*.tmp"))
    save_params(tmp_path / "p.pt", state.params)
    loaded = load_params(tmp_path / "p.pt", _duration_state(seed=3).params)
    for k, v in state.params.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore_raw()


def test_metrics_writer_matches_jax(tmp_path):
    for cls, name in [(MetricsWriter, "t.csv"), (JMetricsWriter, "j.csv")]:
        w = cls(tmp_path / name)
        w.write(3, {"loss": 0.5, "kl": 1})
        w.close()
    rows = [list(csv.reader(open(tmp_path / n))) for n in ("t.csv", "j.csv")]
    assert [r[:3] for r in rows[0]] == [r[:3] for r in rows[1]]


class _Batcher:
    def __init__(self, n):
        self.n = n

    def epoch(self, i):
        for j in range(self.n):
            yield {k: v.numpy() for k, v in _batch(10 * i + j).items()}

    def num_batches(self):
        return self.n


def test_train_loop_epochs_eval_extras_and_checkpoints(tmp_path):
    seen = []
    base = make_duration_train_step(CFG)

    def step(state, batch, scale):
        seen.append(scale)
        return base(state, batch)

    def eval_step(params, batch, scale):
        return {"duration_loss": torch.tensor(scale)}

    ckpt = CheckpointManager(tmp_path)
    loop = TrainLoop(state=_duration_state(), train_step=step,
                     batcher=_Batcher(3), num_epochs=3,
                     device=torch.device("cpu"), checkpoints=ckpt,
                     metrics=MetricsWriter(tmp_path / "m.csv"),
                     eval_step=eval_step, val_batcher=_Batcher(1),
                     epoch_extras=lambda e: (float(3 - e),),
                     val_metric_key="duration_loss", checkpoint_every=2,
                     uses_frozen_in_eval=False, log_every_steps=2)
    state = loop.run()
    assert (state.step, state.epoch) == (9, 3)
    assert seen == [3.0] * 3 + [2.0] * 3 + [1.0] * 3
    assert [h["val_duration_loss"] for h in loop.history] == [3.0, 2.0, 1.0]
    assert ckpt.all_steps() == [3, 6, 9]  # every epoch a new best
    assert ckpt.best_metric == 1.0
    assert not loop.preempted and not was_preempted()
    names = {r[1] for r in csv.reader(open(tmp_path / "m.csv"))}
    assert {"duration_loss", "val_duration_loss"} <= names


def test_train_loop_checkpoints_and_stops_on_sigterm(tmp_path):
    base = make_duration_train_step(CFG)

    def step(state, batch):
        out = base(state, batch)
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    ckpt = CheckpointManager(tmp_path)
    loop = TrainLoop(state=_duration_state(), train_step=step,
                     batcher=_Batcher(4), num_epochs=2,
                     device=torch.device("cpu"), checkpoints=ckpt,
                     prefetch=0)
    state = loop.run()
    assert loop.preempted and was_preempted()
    assert state.step == 2 and ckpt.latest_step() == 2
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    restored, start_epoch = resume_if_available(ckpt, _duration_state(1))
    assert (restored.step, start_epoch) == (2, 0)


# -- the whole slice -----------------------------------------------------------


def test_four_stages_then_from_checkpoints_match_jax(tmp_path):
    """Duration, VAE (frozen encoder, annealed KL), PostNet (frozen encoder
    and VAE) and GAN, two steps each through the TrainLoop on a 4-utterance
    corpus; the assembled pipeline's synthesize_mel equals the JAX
    pipeline's with the same params."""
    corpus, aligned = generate_corpus(tmp_path / "corpus",
                                      CorpusSpec(n_utterances=4, seed=11),
                                      progress_every=0)
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, batch_size=2, num_epochs=1, warmup_epochs=0))
    out = tmp_path / "run"
    kw = dict(device="cpu", cache_dir=tmp_path / "cache")
    steps = {}
    for name, build, extra in [
            ("duration", stages.duration_stage, {}),
            ("vae", stages.vae_stage, {}),
            ("postnet", stages.postnet_stage, {}),
            ("gan", stages.gan_stage, dict(disc_width=0.125,
                                           ema_decay=0.9))]:
        loop = build(cfg, corpus, aligned, out, **kw, **extra)
        loop.prefetch = 1
        state = loop.run()
        steps[name] = state.step
        assert state.epoch == 1
        assert all(np.isfinite(v) for v in loop.history[0].values())
    assert steps["gan"] == 2 and all(n >= 2 for n in steps.values()), steps
    vocab_path = tmp_path / "cache" / "phoneme_vocab.json"
    pipe = TTSPipeline.from_checkpoints(
        out / "encoder" / "checkpoints", out / "vae" / "checkpoints",
        out / "postnet" / "checkpoints",
        hifigan_gan_checkpoint=out / "hifigan_gan" / "checkpoints",
        vocab_path=vocab_path, device="cpu")
    vae_sd = CheckpointManager(out / "vae" / "checkpoints"
                               ).restore_best_params()
    for k, v in vae_sd.items():
        assert torch.equal(pipe.model.state_dict()[f"vae.{k}"], v)
    gan = CheckpointManager(out / "hifigan_gan" / "checkpoints"
                            ).restore_best_raw()["gen"]
    for k, v in gan["ema_params"].items():
        assert torch.equal(pipe.model.state_dict()[f"hifigan.{k}"], v)

    jconfig = jcfg.config_from_json(tcfg.config_to_json(pipe.config))
    jpipe = JPipeline.initialize(jconfig, vocab=JVocab.load(vocab_path))
    jpipe.params = jax_params_from_port(numpy_tree(jpipe.params),
                                        pipe.model.state_dict())
    text = "The teacher found an ancient map."
    want = jpipe.synthesize_mel(text, temperature=0.0)
    got = pipe.synthesize_mel(text, temperature=0.0)
    assert got.shape == want.shape and got.shape[0] > 0
    assert max_abs(got, want) <= 1e-4
