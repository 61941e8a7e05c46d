"""Port parity: conv, length and log-mel ops against the JAX package, and
the CUDA log-mel kernel against its plain version (on a card only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_tts_tpu.config import AudioConfig as JaxAudioConfig
from iris_tts_tpu.models.layers import Conv1d as JConv1d
from iris_tts_tpu.ops import length as jlength
from iris_tts_tpu.ops.conv import conv1d_mm, conv_transpose1d_mm
from iris_tts_tpu.ops.mel_pallas import log_mel_spectrogram_pallas
from iris_tts_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.models.layers import Conv1d
from iris_tts_tpu_torch.ops import length
from iris_tts_tpu_torch.ops.conv import conv1d, conv_transpose1d
from iris_tts_tpu_torch.ops.mel_cuda import log_mel_cuda
from iris_tts_tpu_torch.ops.stft import (
    log_mel_spectrogram,
    log_mel_spectrogram_plain,
)
from tests.torch_port_utils import load_port_module, max_abs

torch.set_num_threads(2)


def _ct(x):
    """[B, T, C] numpy → [B, C, T] tensor."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
def test_conv1d_dilated_matches_jax(k, dilation):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 40, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    want = np.asarray(conv1d_mm(jnp.asarray(x), jnp.asarray(w),
                                dilation=dilation))
    got = conv1d(_ct(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                 dilation=dilation)
    assert max_abs(got.transpose(1, 2), want) <= 1e-5


@pytest.mark.parametrize("t", [15, 16])
def test_stride2_same_conv_matches_jax(t):
    """XLA 'SAME' puts the odd pad on the right (T=16, k=5: (1, 2))."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 8)).astype(np.float32)
    jconv = JConv1d(6, 5, stride=2)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))
    conv = load_port_module(Conv1d(8, 6, 5, stride=2), "conv", params)
    with torch.no_grad():
        got = conv(_ct(x)).transpose(1, 2)
    assert got.shape[1] == -(-t // 2)
    assert max_abs(got, want) <= 1e-5


@pytest.mark.parametrize("k,u", [(16, 8), (4, 2)])
def test_conv_transpose1d_matches_jax(k, u):
    """Every HiFiGAN (kernel, rate) pair: transpose, no flip, crop
    (k − u) // 2, so T_out = T·u."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 4)).astype(np.float32)
    want = np.asarray(conv_transpose1d_mm(jnp.asarray(x), jnp.asarray(w),
                                          stride=u))
    got = conv_transpose1d(_ct(x),
                           torch.from_numpy(w.transpose(1, 2, 0).copy()),
                           stride=u)
    assert got.shape[-1] == 9 * u
    assert max_abs(got.transpose(1, 2), want) <= 1e-5


def test_length_regulate_matches_jax():
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, 5, 3)).astype(np.float32)
    dur = np.array([[2, 3, 1, 0, 0], [1, 1, 4, 2, 3]], np.int32)
    for total in (8, 11, 16):  # under, exactly, and over the sums
        want_f, want_m = jlength.length_regulate(jnp.asarray(enc),
                                                 jnp.asarray(dur), total)
        got_f, got_m = length.length_regulate(torch.from_numpy(enc),
                                              torch.from_numpy(dur), total)
        assert max_abs(got_f, want_f) == 0.0
        assert max_abs(got_m, want_m) == 0.0


def test_gaussian_upsample_and_masks_match_jax():
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, 4, 3)).astype(np.float32)
    dur = np.array([[2.0, 3.0, 1.0, 0.0], [1.0, 2.0, 2.0, 3.0]], np.float32)
    want_f, want_m = jlength.gaussian_upsample(jnp.asarray(enc),
                                               jnp.asarray(dur), 10)
    got_f, got_m = length.gaussian_upsample(torch.from_numpy(enc),
                                            torch.from_numpy(dur), 10)
    assert max_abs(got_f, want_f) <= 1e-5
    assert max_abs(got_m, want_m) == 0.0
    lengths = np.array([3, 0, 7])
    np.testing.assert_array_equal(
        length.padding_mask(torch.from_numpy(lengths), 7).numpy(),
        np.asarray(jlength.padding_mask(jnp.asarray(lengths), 7)))
    assert length.round_up_to_multiple(10, 4) == 12


def test_durations_from_log_rounds_half_to_even_like_jax():
    # exp(p) − 1 exactly at .5 values (and around them): half to even.
    targets = np.array([0.5, 1.5, 2.5, 3.5, 4.5, 2.49, 2.51, 7.0, 0.0],
                       np.float64)
    p = np.log(targets + 1.0).astype(np.float32)
    want = np.asarray(jlength.durations_from_log(jnp.asarray(p)))
    got = length.durations_from_log(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    # Exact halves (exp of a float32 log may land a ULP off): the rounding
    # rule itself.
    halves = torch.tensor([0.5, 1.5, 2.5, 3.5])
    np.testing.assert_array_equal(torch.round(halves).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(
                                      halves.numpy()))))


def _audio(n, seed=1337):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


_MEL_INPUTS = {
    "single": lambda: _audio(22050),
    "short": lambda: _audio(4000),  # one group of the kernel's frames
    "batched": lambda: np.stack([_audio(8000, 1), _audio(8000, 2)]),
    "tiny_300": lambda: _audio(300),  # 2 frames, both in the padding
    "odd_batch": lambda: np.stack([_audio(70001, s) for s in (3, 4, 5)]),
}


@pytest.mark.parametrize("case", sorted(_MEL_INPUTS))
def test_plain_log_mel_matches_jax_xla_and_pallas(case):
    audio = _MEL_INPUTS[case]()
    got = log_mel_spectrogram_plain(torch.from_numpy(audio), AudioConfig())
    want_xla = np.asarray(jax_log_mel(jnp.asarray(audio), JaxAudioConfig(),
                                      impl="xla"))
    want_pallas = np.asarray(log_mel_spectrogram_pallas(
        jnp.asarray(audio), JaxAudioConfig(), interpret=True))
    assert got.shape == want_xla.shape
    assert max_abs(got, want_xla) <= 2e-3
    assert max_abs(got, want_pallas) <= 2e-3
    # The entry point takes the plain version for a CPU tensor.
    routed = log_mel_spectrogram(torch.from_numpy(audio))
    assert max_abs(routed, got) == 0.0


@pytest.mark.cuda
def test_log_mel_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfg = AudioConfig()
    for make in _MEL_INPUTS.values():
        audio = torch.from_numpy(make()).cuda()
        before = log_mel_cuda.launches
        got = log_mel_cuda(audio, cfg)
        torch.cuda.synchronize()
        assert log_mel_cuda.launches == before + 1
        want = log_mel_spectrogram_plain(audio, cfg)
        assert max_abs(got, want) <= 2e-3
