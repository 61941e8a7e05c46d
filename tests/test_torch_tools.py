"""Port parity: the eval and tool modules the drivers need — the FFT
magnitude, layout, normalisation and padding helpers, Griffin-Lim, the
profiling and finite-check utilities and the HiFiGAN vocoder wrapper —
against the JAX package on the same seeded inputs."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iris_tts_tpu.config as jcfg
import iris_tts_tpu.ops.griffin_lim as jgl
import iris_tts_tpu.utils.prof as jprof
from iris_tts_tpu.models.hifigan import HiFiGANGenerator as JHiFi
from iris_tts_tpu.models.hifigan import HiFiGANVocoder as JVocoder
from iris_tts_tpu.ops import length as jlength
from iris_tts_tpu.ops import stft as jstft
from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.convert.from_jax import state_dict_from_jax
from iris_tts_tpu_torch.models.hifigan import HiFiGANVocoder, create_vocoder
from iris_tts_tpu_torch.ops import griffin_lim as tgl
from iris_tts_tpu_torch.ops import length as tlength
from iris_tts_tpu_torch.ops import stft as tstft
from iris_tts_tpu_torch.utils import prof as tprof
from tests.torch_port_utils import (
    max_abs,
    numpy_tree,
    port_config,
    small_config,
)

torch.set_num_threads(2)

# A small audio config: n_fft 128 keeps Griffin-Lim's FFTs cheap.
GL_KW = dict(sample_rate=22050, n_fft=128, hop_length=32, win_length=128,
             n_mels=20)


def _audio(seed, n=4000, batch=()):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    tone = 0.4 * np.sin(2 * np.pi * 440 * t)
    return (tone + 0.05 * rng.standard_normal(batch + (n,))).astype(
        np.float32)


@pytest.mark.parametrize("kw", [
    dict(n_fft=256, hop_length=64, win_length=200),
    dict(n_fft=64, hop_length=8, win_length=64, pad_mode="reflect"),
])
def test_stft_magnitude_matches_jax(kw):
    x = _audio(0, batch=(2,))
    want = np.asarray(jstft.stft_magnitude(jnp.asarray(x), **kw))
    got = tstft.stft_magnitude(torch.from_numpy(x), **kw)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert max_abs(got, want) <= 1e-4 * float(np.abs(want).max())


def test_layout_normalize_and_pad_exact():
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 13, 16)).astype(np.float32)
    tm = torch.from_numpy(mel)
    ref = np.asarray(jstft.to_reference_layout(jnp.asarray(mel)))
    np.testing.assert_array_equal(tstft.to_reference_layout(tm).numpy(), ref)
    back = tstft.from_reference_layout(torch.from_numpy(ref.copy()))
    np.testing.assert_array_equal(back.numpy(), mel)

    got, g_mean, g_std = tstft.normalize_mel(tm)
    want, w_mean, w_std = jstft.normalize_mel(jnp.asarray(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert abs(float(g_mean) - float(w_mean)) <= 1e-7
    assert abs(float(g_std) - float(w_std)) <= 1e-6
    given = tstft.normalize_mel(tm, torch.tensor(0.5), torch.tensor(2.0))
    np.testing.assert_array_equal(
        given[0].numpy(), np.asarray(jstft.normalize_mel(
            jnp.asarray(mel), jnp.float32(0.5), jnp.float32(2.0))[0]))

    for axis, multiple in ((1, 4), (1, 13), (2, 5), (0, 3)):
        got = tlength.pad_time_to_multiple(tm, multiple, axis)
        want = np.asarray(jlength.pad_time_to_multiple(
            jnp.asarray(mel), multiple, axis))
        np.testing.assert_array_equal(got.numpy(), want)
    assert tlength.pad_time_to_multiple(tm, 13) is tm


@pytest.mark.parametrize("method", ["nnls", "pinv"])
def test_mel_to_linear_matches_jax(method):
    jc, tc = jcfg.AudioConfig(**GL_KW), AudioConfig(**GL_KW)
    log_mel = np.asarray(jstft.log_mel_spectrogram(
        jnp.asarray(_audio(2)), jc))
    want = np.asarray(jgl.mel_to_linear(jnp.asarray(log_mel), jc, method))
    got = tgl.mel_to_linear(torch.from_numpy(log_mel), tc, method)
    assert tuple(got.shape) == want.shape == (log_mel.shape[0],
                                              tc.n_freqs)
    assert max_abs(got, want) <= 1e-4 * float(np.abs(want).max())
    with pytest.raises(ValueError):
        tgl.mel_to_linear(torch.from_numpy(log_mel), tc, "lstsq")


def test_griffin_lim_from_jax_phase_matches_jax():
    """Both packages from JAX's own initial phase (PRNGKey(seed) uniform in
    [-pi, pi)), 8 iterations."""
    jc, tc = jcfg.AudioConfig(**GL_KW), AudioConfig(**GL_KW)
    log_mel = jstft.log_mel_spectrogram(jnp.asarray(_audio(3)), jc)
    mag = np.asarray(jgl.mel_to_linear(log_mel, jc))
    want = np.asarray(jgl.griffin_lim(jnp.asarray(mag), jc, n_iter=8,
                                      seed=5))
    angles = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(5), mag.shape, minval=-np.pi, maxval=np.pi))
    got = tgl.griffin_lim_from_phase(torch.from_numpy(mag),
                                     torch.from_numpy(angles), tc, n_iter=8)
    assert tuple(got.shape) == want.shape == (
        (mag.shape[0] - 1) * tc.hop_length,)
    assert max_abs(got, want) <= 1e-3 * float(np.abs(want).max())


def test_griffin_lim_from_log_mel_seeded():
    tc = AudioConfig(**GL_KW)
    log_mel = tstft.log_mel_spectrogram_plain(torch.from_numpy(_audio(4)),
                                              tc)
    a = tgl.griffin_lim_from_log_mel(log_mel, n_iter=4, cfg=tc, seed=1)
    b = tgl.griffin_lim_from_log_mel(log_mel, n_iter=4, cfg=tc, seed=1)
    c = tgl.griffin_lim_from_log_mel(log_mel, n_iter=4, cfg=tc, seed=2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == ((log_mel.shape[0] - 1) * tc.hop_length,)
    assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0


def test_grad_norm_and_tree_finite_match_jax():
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    want = jprof.grad_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    assert abs(tprof.grad_norm(ttree) - want) <= 1e-6 * want
    assert tprof.tree_finite(ttree) is jprof.tree_finite(tree) is True
    bad = dict(tree, a=np.where(tree["a"] > 1, np.nan, tree["a"]))
    tbad = dict(ttree, a=torch.from_numpy(bad["a"]))
    assert tprof.tree_finite(tbad) is jprof.tree_finite(bad) is False

    # a module: tree_finite reads its state dict, grad_norm its .grad
    lin = torch.nn.Linear(5, 4)
    with torch.no_grad():
        lin.weight.copy_(ttree["a"])
    lin.weight.grad = ttree["a"].clone()
    assert tprof.tree_finite(lin)
    assert tprof.tree_finite(lin.state_dict())
    want_w = jprof.grad_norm({"w": jnp.asarray(tree["a"])})
    assert abs(tprof.grad_norm(lin) - want_w) <= 1e-6 * want_w
    with torch.no_grad():
        lin.bias[0] = float("inf")
    assert not tprof.tree_finite(lin)


def test_guard_finite_prints_and_returns_input(capsys):
    x = torch.tensor([1.0, float("nan"), 2.0])
    assert tprof.guard_finite("mel", x) is x
    assert "[guard_finite] mel: non-finite values!" in capsys.readouterr().out
    y = torch.ones(3)
    assert tprof.guard_finite("ok", y) is y
    assert capsys.readouterr().out == ""
    # JAX's tripwire prints the same line
    jprof.guard_finite("mel", jnp.asarray(x.numpy()))
    jax.effects_barrier()
    assert "[guard_finite] mel: non-finite values!" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "tr"):
        torch.ones(64, 64) @ torch.ones(64, 64)
        time.sleep(0.001)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def _scaled_hifigan(cfg):
    """JAX HiFiGAN params with the kernels scaled ×15, so the output is of
    order 0.5 (as the HiFiGAN parity test does)."""
    mel0 = jnp.zeros((1, 8, cfg.hifigan.in_channels))
    params = JHiFi(config=cfg.hifigan).init(jax.random.PRNGKey(8),
                                            mel0)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) * (15.0 if p[-1].key == "kernel" else 1.0),
        params)


def test_hifigan_vocoder_matches_jax_in_both_layouts():
    cfg = small_config()
    params = _scaled_hifigan(cfg)
    sd = state_dict_from_jax({"hifigan": numpy_tree(params)})
    sd = {k[len("hifigan."):]: v for k, v in sd.items()}
    voc = HiFiGANVocoder(sd, port_config(cfg).hifigan, device="cpu")
    jvoc = JVocoder(params, cfg.hifigan)
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((2, cfg.hifigan.in_channels, 12)).astype(
        np.float32)
    hop = cfg.hifigan.total_upsample
    for x in (mel, mel[0]):  # [B, n_mels, T] and [n_mels, T]
        want = np.asarray(jvoc(jnp.asarray(x)))
        got = voc(x)
        assert got.device.type == "cpu" and tuple(got.shape) == want.shape
        assert want.shape[-1] == 12 * hop
        assert float(np.abs(want).max()) > 0.05
        assert max_abs(got, want) <= 1e-4
    assert torch.equal(voc.infer(torch.from_numpy(mel[0])), voc(mel[0]))


def test_create_vocoder_seeded_and_device_explicit(monkeypatch):
    cfg = port_config(small_config()).hifigan
    a = create_vocoder(cfg, seed=3, device="cpu")
    b = create_vocoder(cfg, seed=3, device="cpu")
    c = create_vocoder(cfg, seed=4, device="cpu")
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert not all(torch.equal(a.params[k], c.params[k]) for k in a.params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_vocoder(cfg)
