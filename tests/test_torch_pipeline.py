"""Port parity end to end: the PyTorch TTSPipeline against the JAX one with
the same weights, at temperature 0 (the prior sample is exactly zero in
both, so their different random generators do not matter)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu_torch import config as port_cfg
from iris_tts_tpu_torch.models.pipeline import TTSPipeline, host_pcm16
from tests.torch_port_utils import max_abs, numpy_tree, port_config, small_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SENTENCE = "Hello world, this is a test."
BATCH = ["Hello world.", "The quick brown fox jumps over the lazy dog.",
         "Speech!"]
BUCKETS = dict(phoneme_buckets=(16, 32, 64),
               frame_buckets=(16, 32, 64, 128, 256, 512))


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline.initialize(small_config(), seed=3)
    # HiFiGAN's normal(0.01) init gives near-silent audio at this width;
    # scale its kernels so the waveform comparison sees order-one signal.
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    jpipe = dataclasses.replace(jpipe, **BUCKETS)
    pipe = TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu")
    pipe = dataclasses.replace(pipe, **BUCKETS)
    return jpipe, pipe


def _assert_clear_of_half(jpipe, texts):
    """Frame counts come from round(exp(p) − 1): a value within float noise
    of .5 could round differently in the two packages. The chosen seed and
    sentences keep every prediction clear of a .5 boundary."""
    ids, lengths = jpipe._encode_texts(texts)
    mask = np.arange(ids.shape[1])[None] < lengths[:, None]
    enc = jpipe._encoder.apply({"params": jpipe.params["encoder"]},
                               jnp.asarray(ids), padding_mask=jnp.asarray(mask))
    log_dur = jpipe._duration.apply({"params": jpipe.params["duration"]}, enc)
    x = np.exp(np.asarray(log_dur, np.float64)) - 1.0
    frac = np.abs((x - np.floor(x)) - 0.5)[mask]
    assert frac.min() > 1e-3, frac.min()


def _assert_same_audio(got, want):
    assert len(got) == len(want)
    assert np.isfinite(got).all()
    assert float(np.abs(want).max()) > 0.05  # a real signal is compared
    assert max_abs(got, want) <= 1e-3


def test_fused_synthesize_matches_jax(pipes):
    jpipe, pipe = pipes
    _assert_clear_of_half(jpipe, [SENTENCE])
    want = jpipe.synthesize(SENTENCE, temperature=0.0)
    got = pipe.synthesize(SENTENCE, temperature=0.0)
    assert got.dtype == np.float32 and len(got) % 256 == 0
    _assert_same_audio(got, want)


def test_two_stage_batch_matches_jax(pipes):
    jpipe, pipe = pipes
    _assert_clear_of_half(jpipe, BATCH)
    want = jpipe.synthesize(BATCH, temperature=0.0)
    got = pipe.synthesize(BATCH, temperature=0.0)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_same_audio(g, w)


@pytest.mark.parametrize("tolerance", [None, 0.1])
def test_fused_overflow_compression_and_redo_match_jax(pipes, tolerance):
    """A budget of 2 frames per phoneme overflows (8 phonemes, 29 predicted
    frames, budget 16): tolerance None ships the largest-remainder-compressed
    row, 0.1 redoes it two-stage."""
    jpipe, pipe = pipes
    over = dict(fused_frames_per_phoneme=2,
                fused_overflow_tolerance=tolerance)
    jp = dataclasses.replace(jpipe, **over)
    tp = dataclasses.replace(pipe, **over)
    text = BATCH[0]
    _assert_clear_of_half(jpipe, [text])
    want = jp.synthesize(text, temperature=0.0)
    got = tp.synthesize(text, temperature=0.0)
    _assert_same_audio(got, want)
    assert tp.fused_overflow_count == 1
    assert tp.fused_fallback_count == (0 if tolerance is None else 1)


@pytest.mark.parametrize("fused", [True, False])
def test_gaussian_upsampling_matches_jax(pipes, fused):
    """upsample="gaussian" (soft length regulation) on the fused path (one
    sentence) and the two-stage path (a batch) against JAX's."""
    jpipe, pipe = pipes
    jp = dataclasses.replace(jpipe, upsample="gaussian")
    tp = dataclasses.replace(pipe, upsample="gaussian")
    texts = [SENTENCE] if fused else BATCH
    _assert_clear_of_half(jpipe, texts)
    want = jp.synthesize(texts, temperature=0.0, fused=fused)
    got = tp.synthesize(texts, temperature=0.0, fused=fused)
    hard = pipe.synthesize(texts, temperature=0.0, fused=fused)
    assert len(got) == len(want) == len(texts)
    for g, w in zip(got, want):
        _assert_same_audio(g, w)
    # the option is in force: soft regulation moves the audio off the hard
    # path's (a short row's nearly hard)
    assert max(max_abs(g, h) for g, h in zip(got, hard)) > 1e-2


def test_pcm16_is_the_host_quantization(pipes):
    _, pipe = pipes
    f32 = pipe.synthesize(SENTENCE, temperature=0.0)
    pcm = pipe.synthesize(SENTENCE, temperature=0.0, pcm16=True)
    assert pcm.dtype == np.int16
    np.testing.assert_array_equal(pcm, host_pcm16(f32))


def test_synthesize_mel_and_vocode_match_jax(pipes):
    jpipe, pipe = pipes
    want = jpipe.synthesize_mel(SENTENCE, temperature=0.0)
    got = pipe.synthesize_mel(SENTENCE, temperature=0.0)
    assert got.shape == want.shape
    assert max_abs(got, want) <= 1e-4
    # vocode takes the reference layout [n_mels, T] as well.
    want_audio = jpipe.vocode(want)
    got_audio = pipe.vocode(torch.from_numpy(np.ascontiguousarray(want.T)))
    _assert_same_audio(got_audio, want_audio)


def test_vocoder_upsampling_apart_from_the_hop_matches_jax():
    """A HiFiGAN whose total upsampling (8) is not the audio hop (256):
    the JAX pipeline takes it (its convergence test trains one), and so
    does the port, with JAX's audio (samples a frame = the upsampling)."""
    import iris_tts_tpu.config as jcfg

    cfg = small_config()
    cfg = dataclasses.replace(cfg, hifigan=dataclasses.replace(
        cfg.hifigan, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4)))
    assert cfg.hifigan.total_upsample != cfg.audio.hop_length
    assert isinstance(cfg, jcfg.IrisConfig)
    jpipe = JPipeline.initialize(cfg, seed=3)
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    jpipe = dataclasses.replace(jpipe, **BUCKETS)
    pipe = dataclasses.replace(TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu"),
        **BUCKETS)
    _assert_clear_of_half(jpipe, [SENTENCE])
    mel = pipe.synthesize_mel(SENTENCE, temperature=0.0)
    want = jpipe.synthesize(SENTENCE, temperature=0.0)
    got = pipe.synthesize(SENTENCE, temperature=0.0)
    assert len(got) == 8 * len(mel)
    _assert_same_audio(got, want)


def test_seeded_prior_is_reproducible(pipes):
    _, pipe = pipes
    a = pipe.synthesize(SENTENCE, seed=5)
    b = pipe.synthesize(SENTENCE, seed=5 + 2**32)  # same int32 seed
    c = pipe.synthesize(SENTENCE, seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, load without jax, flax,
    optax, orbax, tensorstore, zstandard or the JAX package; the orbax
    reader (``convert.zstd``, ``convert.ocdbt``, ``convert.orbax``) among
    them."""
    code = (
        "import sys, runpy, importlib, pkgutil\n"
        "import iris_tts_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "iris_tts_tpu_torch.__path__, 'iris_tts_tpu_torch.')]\n"
        "assert 'iris_tts_tpu_torch.train.stages' in mods, mods\n"
        "assert 'iris_tts_tpu_torch.text.neural_g2p' in mods, mods\n"
        "assert 'iris_tts_tpu_torch.scripts.train_full_pipeline' in mods, "
        "mods\n"
        "new = ['models.g2p', 'convert.to_jax', 'convert.hifigan_torch', "
        "'convert.keras_h5', 'convert.torch_oracle', 'data.native', "
        "'scripts.train_g2p', 'scripts.import_keras_checkpoint', "
        "'scripts.verify_reference_artifacts', "
        "'scripts.hifigan_integration', 'scripts.demo_vocoder', "
        "'convert.zstd', 'convert.ocdbt', 'convert.orbax']\n"
        "assert all('iris_tts_tpu_torch.' + m in mods for m in new), mods\n"
        "[importlib.import_module(m) for m in mods]\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        # bf16 and remat run without JAX too: a tiny bf16 pipeline
        # synthesizes, and a bf16 + remat VAE step trains.
        "import torch\n"
        "from iris_tts_tpu_torch import config as C\n"
        "from iris_tts_tpu_torch.models import TTSPipeline\n"
        "from iris_tts_tpu_torch.models.vae import TextConditionedVAE\n"
        "from iris_tts_tpu_torch.models.encoder import PhonemeEncoder\n"
        "from iris_tts_tpu_torch.train import TrainState, adam_clipped\n"
        "from iris_tts_tpu_torch.train import make_vae_train_step\n"
        "cfg = C.IrisConfig(encoder=C.EncoderConfig(embed_dim=16, "
        "num_blocks=1, num_heads=2), duration=C.DurationConfig(hidden_dim=8,"
        " num_layers=1), vae=C.VAEConfig(cond_dim=16, model_channels=8, "
        "latent_dim=4, num_wavenet_blocks=1, decoder_blocks=1, "
        "flow_layers=1, flow_hidden=8, dropout=0.1), "
        "postnet=C.PostNetConfig(num_layers=2, channels=8), "
        "hifigan=C.HiFiGANConfig(upsample_initial_channel=16, "
        "resblock_kernel_sizes=(3,), resblock_dilations=((1,),)))\n"
        "p = TTSPipeline.initialize(cfg, device='cpu', dtype='bf16')\n"
        "a = p.synthesize('hello world', seed=1)\n"
        "assert a.dtype.name == 'float32' and a.size, a.dtype\n"
        "cfg = p.config\n"
        "from iris_tts_tpu_torch.models.layers import init_params\n"
        "vae, enc = TextConditionedVAE(cfg.vae), PhonemeEncoder(cfg.encoder)\n"
        "[init_params(m, torch.Generator().manual_seed(0)) "
        "for m in (vae, enc)]\n"
        "st = TrainState.create(vae, adam_clipped(1e-3), 0, "
        "frozen={'encoder': enc})\n"
        "b = {'phoneme_ids': torch.ones(2, 5, dtype=torch.long), "
        "'durations': torch.full((2, 5), 3.0), 'phoneme_mask': "
        "torch.ones(2, 5), 'mel': torch.randn(2, 16, cfg.vae.n_mels)}\n"
        "st, m = make_vae_train_step(cfg, compute_dtype=torch.bfloat16, "
        "remat=True)(st, b, torch.tensor(0.01))\n"
        "assert torch.isfinite(m['total']), m\n"
        "roots = ('jax', 'flax', 'optax', 'orbax', 'iris_tts_tpu', "
        "'tensorstore', 'zstandard')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_initialize_without_device_raises_on_a_cuda_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSPipeline.initialize(small_config(port_cfg))
