"""The port's pipeline directory: ``TTSPipeline.save`` → ``load`` round
trips, the tuned serving knobs, half precision, shape checks, and JAX
weights carried through ``from_jax_params`` → ``save`` → ``load``."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from iris_tts_tpu.models.pipeline import TTSPipeline as JPipeline
from iris_tts_tpu_torch import config as C
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.train.checkpoint import load_params, save_params
from tests.test_torch_pipeline import _assert_clear_of_half
from tests.torch_port_utils import max_abs, numpy_tree, port_config, small_config

torch.set_num_threads(2)

LADDERS = dict(phoneme_buckets=(16,), frame_buckets=(32, 64))


def _tiny():
    """The JAX save/load test's config, in the port's dataclasses (the port
    requires the hop to equal the vocoder's upsampling)."""
    return C.IrisConfig(
        audio=C.AudioConfig(hop_length=8),
        encoder=C.EncoderConfig(vocab_size=41, embed_dim=16, num_blocks=1,
                                num_heads=2),
        duration=C.DurationConfig(hidden_dim=8, num_layers=1),
        vae=C.VAEConfig(n_mels=8, cond_dim=16, model_channels=8,
                        latent_dim=4, num_wavenet_blocks=1, decoder_blocks=1,
                        flow_layers=1, flow_hidden=8),
        postnet=C.PostNetConfig(n_mels=8, num_layers=2, channels=8),
        hifigan=C.HiFiGANConfig(in_channels=8, upsample_rates=(4, 2),
                                upsample_kernel_sizes=(8, 4),
                                upsample_initial_channel=16,
                                resblock_kernel_sizes=(3,),
                                resblock_dilations=((1,),)),
    )


@pytest.fixture
def pipe():
    p = TTSPipeline.initialize(_tiny(), seed=7, device="cpu")
    # Scale the vocoder's output conv so half-precision rounding is compared
    # on order-one audio, and give the PostNet's BatchNorm non-trivial
    # running statistics so their round trip shows.
    with torch.no_grad():
        p.model.hifigan.conv_post.weight.mul_(2e4)
        for name, buf in p.model.postnet.named_buffers():
            if buf.is_floating_point():
                buf.copy_(torch.rand(buf.shape, generator=torch.Generator()
                                     .manual_seed(len(name))) + 0.5)
    return dataclasses.replace(p, **LADDERS)


def test_save_load_roundtrip(pipe, tmp_path):
    want = pipe.synthesize("hello world", seed=3)
    assert float(np.abs(want).max()) > 0.05
    pipe.save(tmp_path / "deploy")
    again = TTSPipeline.load(tmp_path / "deploy", device="cpu")
    np.testing.assert_array_equal(again.synthesize("hello world", seed=3),
                                  want)
    assert again.config == pipe.config
    assert again.vocab.phoneme_to_id == pipe.vocab.phoneme_to_id
    assert again.use_postnet == pipe.use_postnet and again.seed == pipe.seed
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    meta = json.loads((tmp_path / "deploy" / "meta.json").read_text())
    assert set(meta) == {"use_postnet", "seed", "upsample", "params_dtype",
                         "fused_frames_per_phoneme",
                         "fused_overflow_tolerance", "phoneme_buckets",
                         "frame_buckets"}
    assert meta["params_dtype"] == "float32" and meta["upsample"] == "hard"


def test_save_load_keeps_gaussian_upsampling(pipe, tmp_path):
    gauss = dataclasses.replace(pipe, upsample="gaussian")
    want = gauss.synthesize("hello world", seed=3)
    assert not np.array_equal(want, pipe.synthesize("hello world", seed=3))
    gauss.save(tmp_path / "deploy")
    meta = json.loads((tmp_path / "deploy" / "meta.json").read_text())
    assert meta["upsample"] == "gaussian"
    again = TTSPipeline.load(tmp_path / "deploy", device="cpu")
    assert again.upsample == "gaussian"
    np.testing.assert_array_equal(again.synthesize("hello world", seed=3),
                                  want)
    with pytest.raises(ValueError, match="upsample='nearest'"):
        dataclasses.replace(pipe, upsample="nearest")


def test_save_load_persists_tuned_serving_knobs(tmp_path):
    p = TTSPipeline.initialize(small_config(C), seed=0, device="cpu")
    p = dataclasses.replace(p, phoneme_buckets=(16, 32), frame_buckets=(32, 64),
                            fused_frames_per_phoneme=21,
                            fused_overflow_tolerance=None, use_postnet=False)
    p.save(tmp_path / "exp")
    loaded = TTSPipeline.load(tmp_path / "exp", device="cpu")
    assert loaded.fused_frames_per_phoneme == 21
    assert loaded.fused_overflow_tolerance is None
    assert loaded.phoneme_buckets == (16, 32)
    assert loaded.frame_buckets == (32, 64)
    assert loaded.use_postnet is False


def test_save_load_half_precision(pipe, tmp_path):
    """half=True stores float16 (BatchNorm statistics included), loads back
    as float32, and synthesizes within float16 rounding of the original."""
    want = pipe.synthesize("hello world", seed=3)
    pipe.save(tmp_path / "full")
    pipe.save(tmp_path / "half", half=True)

    def tree_bytes(d):
        return sum(p.stat().st_size for p in d.rglob("*") if p.is_file())

    assert tree_bytes(tmp_path / "half") < 0.7 * tree_bytes(tmp_path / "full")
    stored = load_params(tmp_path / "half" / "params")
    assert stored["postnet.bn_0.running_var"].dtype == torch.float16
    assert stored["postnet.bn_0.num_batches_tracked"].dtype == torch.int64

    again = TTSPipeline.load(tmp_path / "half", device="cpu")
    sd = again.model.state_dict()
    assert all(v.dtype == torch.float32 for k, v in sd.items()
               if "num_batches_tracked" not in k)
    want_var = pipe.model.state_dict()["postnet.bn_0.running_var"]
    assert torch.equal(sd["postnet.bn_0.running_var"],
                       want_var.half().float())
    got = again.synthesize("hello world", seed=3)
    assert got.shape == want.shape
    assert max_abs(got, want) < 1e-2 * float(np.abs(want).max())


def test_half_save_rejects_a_tensor_outside_float16(pipe, tmp_path):
    with torch.no_grad():
        pipe.model.hifigan.conv_post.weight[0, 0, 0] = 1e5
    with pytest.raises(ValueError, match="hifigan.conv_post.weight"):
        pipe.save(tmp_path / "half", half=True)
    pipe.save(tmp_path / "full")  # float32 holds it


def test_load_rejects_a_tensor_of_another_shape(pipe, tmp_path):
    pipe.save(tmp_path / "bad")
    sd = load_params(tmp_path / "bad" / "params")
    sd["hifigan.conv_post.weight"] = torch.zeros(1, 5, 7)
    save_params(tmp_path / "bad" / "params", sd)
    with pytest.raises(ValueError, match="hifigan.conv_post.weight"):
        TTSPipeline.load(tmp_path / "bad", device="cpu")
    del sd["hifigan.conv_post.weight"]
    save_params(tmp_path / "bad" / "params", sd)
    with pytest.raises(ValueError, match="hifigan.conv_post.weight"):
        TTSPipeline.load(tmp_path / "bad", device="cpu")


def test_load_without_device_raises_on_a_cuda_less_host(pipe, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    pipe.save(tmp_path / "p")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTSPipeline.load(tmp_path / "p")


def test_jax_weights_through_save_and_load_match_jax(tmp_path):
    """JAX params → from_jax_params → save → load synthesizes what the JAX
    pipeline does, at temperature 0."""
    jpipe = JPipeline.initialize(small_config(), seed=3)
    jpipe.params["hifigan"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a * (15.0 if p[-1].key == "kernel" else 1.0),
        jpipe.params["hifigan"])
    ladders = dict(phoneme_buckets=(16, 32, 64),
                   frame_buckets=(16, 32, 64, 128, 256, 512))
    jpipe = dataclasses.replace(jpipe, **ladders)
    text = "Hello world, this is a test."
    _assert_clear_of_half(jpipe, [text])
    pipe = dataclasses.replace(TTSPipeline.from_jax_params(
        numpy_tree(jpipe.params), port_config(jpipe.config), device="cpu"),
        **ladders)
    pipe.save(tmp_path / "from_jax")
    loaded = TTSPipeline.load(tmp_path / "from_jax", device="cpu")
    assert loaded.phoneme_buckets == ladders["phoneme_buckets"]
    got = loaded.synthesize(text, temperature=0.0)
    want = jpipe.synthesize(text, temperature=0.0)
    assert len(got) == len(want) and float(np.abs(want).max()) > 0.05
    assert max_abs(got, want) <= 1e-3
    np.testing.assert_array_equal(got, pipe.synthesize(text, temperature=0.0))
