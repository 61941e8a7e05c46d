"""The drivers' ``--mesh`` on two gloo ranks on the CPU
(``--force_cpu_devices 2``): the ranks' results against one process.

Each two-rank launch runs on a thread here while the one-process run
computes, so the two overlap.
"""

import json
import threading
from dataclasses import replace

import numpy as np
import pytest
import torch

from iris_tts_tpu_torch.config import config_to_json
from iris_tts_tpu_torch.data.audio_io import read_wav
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.models.pipeline import SynthesisModel
from iris_tts_tpu_torch.runtime import seeded_generator
from iris_tts_tpu_torch.scripts import batch_synthesize, train_encoder
from iris_tts_tpu_torch.text.phonemes import PhonemeVocab
from iris_tts_tpu_torch.train.checkpoint import CheckpointManager
from tests.corpus_utils import build_mini_corpus
from tests.test_torch_scripts import SMALL_CFG
from tests.torch_port_utils import max_abs, port_config, small_config

torch.set_num_threads(2)


def _beside(fn, *args):
    """Run ``fn(*args)`` on a thread; returns a join that re-raises."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised in join
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]
        return box.get("out")

    return join


@pytest.fixture(scope="module")
def encoder_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    cfg_file = tmp / "cfg.json"
    cfg_file.write_text(json.dumps(SMALL_CFG))
    root, align = build_mini_corpus(tmp, n=12)
    argv = ["--config", str(cfg_file), "--data_root", str(root),
            "--alignment_dir", str(align), "--batch_size", "4",
            "--num_epochs", "2"]
    mesh = _beside(train_encoder.main, argv + [
        "--cache_dir", str(tmp / "cache2"), "--output_dir",
        str(tmp / "mesh"), "--mesh", "--force_cpu_devices", "2"])
    train_encoder.main(argv + ["--cache_dir", str(tmp / "cache1"),
                               "--output_dir", str(tmp / "single"),
                               "--device", "cpu"])
    mesh()
    return tmp


def test_train_encoder_mesh_checkpoint_matches_one_process(encoder_runs):
    """Two epochs of ``train_encoder --mesh --force_cpu_devices 2`` (batch
    4, two rows a rank, dropout on) end in the one-process run's
    checkpoint: same steps, params within 1e-5, except where Adam turns a
    rounding-level gradient into a step of up to lr (the attention key
    biases, whose true gradient is zero): those within 2 × the summed
    learning rates."""
    ck = {r: CheckpointManager(encoder_runs / r / "encoder" / "checkpoints")
          for r in ("single", "mesh")}
    assert ck["mesh"].all_steps() == ck["single"].all_steps()
    want = ck["single"].restore_raw()
    got = ck["mesh"].restore_raw()
    assert got["step"] == want["step"] > 0
    moved = 0
    for k, v in want["params"].items():
        if not v.is_floating_point():
            continue
        tol = 2e-2 if k.endswith("attention.key.bias") else 1e-5
        assert max_abs(got["params"][k], v) <= tol, k
        moved += 1
    assert moved
    # rank 0 alone wrote the metrics and the config record
    lines = [(encoder_runs / r / "encoder" / "metrics.csv").read_text()
             .splitlines() for r in ("single", "mesh")]
    assert len(lines[0]) == len(lines[1]) > 1
    assert (encoder_runs / "mesh" / "encoder" / "config_encoder.json").exists()


class _Params:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return {"params": self.sd}


def test_batch_synthesize_on_two_ranks_writes_the_same_wavs(tmp_path):
    """``batch_synthesize --force_cpu_devices 2`` writes the WAVs one
    process writes (rank 0 writes them; the batch of 4 splits two a
    rank)."""
    base = port_config(small_config())
    cfg = replace(base, encoder=replace(
        base.encoder, vocab_size=len(PhonemeVocab.default_arpabet())))
    model = SynthesisModel(cfg)
    init_params(model, seeded_generator(3, "cpu"))
    with torch.no_grad():  # a mel loud enough for the random vocoder to
        model.vae.out_proj.weight.mul_(2e6)  # reach PCM16's steps
    sd = model.state_dict()
    CheckpointManager(tmp_path / "enc").save(0, _Params(
        {k: v for k, v in sd.items()
         if k.startswith(("encoder.", "duration."))}))
    vae = CheckpointManager(tmp_path / "vae", cfg)
    vae.save(0, _Params({k[len("vae."):]: v for k, v in sd.items()
                         if k.startswith("vae.")}))
    assert json.loads(config_to_json(vae.load_config()))
    argv = ["--encoder_checkpoint", str(tmp_path / "enc"),
            "--vae_checkpoint", str(tmp_path / "vae"),
            "--num_utterances", "6", "--batch_size", "4", "--seed", "7",
            "--write_wavs"]
    mesh = _beside(batch_synthesize.main, argv + [
        "--output_dir", str(tmp_path / "mesh"), "--force_cpu_devices", "2"])
    batch_synthesize.main(argv + ["--output_dir", str(tmp_path / "single"),
                                  "--device", "cpu"])
    mesh()
    names = sorted(p.name for p in (tmp_path / "single").glob("*.wav"))
    assert len(names) == 6
    assert names == sorted(p.name for p in (tmp_path / "mesh").glob("*.wav"))
    heard = 0
    for name in names:
        want, _ = read_wav(tmp_path / "single" / name)
        got, _ = read_wav(tmp_path / "mesh" / name)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1.0 / 32767  # one PCM16 step
        heard += int(np.abs(want).max() > 0.01)
    assert heard == len(names)
