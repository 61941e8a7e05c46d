"""What surrounds the CUDA log-mel kernel, on the CPU: the tables its wrapper
uploads, a torch emulation of the kernel's own schedule built on exactly
those tables, and the wrapper's checks. The kernel itself runs only on a
card (tests/test_torch_ops.py, ``cuda`` marker)."""

import dataclasses

import numpy as np
import pytest
import torch

from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.ops.mel_cuda import kernel_tables, log_mel_cuda
from iris_tts_tpu_torch.ops.stft import (
    log_mel_spectrogram_plain,
    mel_filterbank,
    padded_window,
)
torch.set_num_threads(2)

CONFIGS = {
    1024: AudioConfig(),
    # The JAX package's small test configs (tests/test_gan.py).
    64: AudioConfig(n_fft=64, hop_length=8, win_length=64, n_mels=16),
}


def max_abs(a, b) -> float:
    """This file's own (tests/torch_port_utils.py imports JAX, and the
    card tests here run where JAX is not installed)."""
    a = torch.as_tensor(a).detach().cpu().double()
    b = torch.as_tensor(b).detach().cpu().double()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max()) if a.numel() else 0.0


def _audio(shape, seed):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / 22050.0
    return (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(shape)).astype(np.float32)


INPUTS = {
    "single": lambda: _audio((22050,), 0),
    "tiny_300": lambda: _audio((300,), 1),  # both frames in the padding
    "odd_batch": lambda: _audio((3, 7001), 2),
}


# -- the kernel's schedule, emulated --------------------------------------


def _dft4(v):
    """The kernel's radix-4 butterfly along dim -2 (forward sign)."""
    a0, a1 = v[..., 0, :] + v[..., 2, :], v[..., 0, :] - v[..., 2, :]
    a2, a3 = v[..., 1, :] + v[..., 3, :], (v[..., 1, :] - v[..., 3, :]) * -1j
    return torch.stack([a0 + a2, a1 + a3, a0 - a2, a1 - a3], dim=-2)


def _dft2(v):
    return torch.stack([v[..., 0, :] + v[..., 1, :],
                        v[..., 0, :] - v[..., 1, :]], dim=-2)


def stockham_fft(z, twiddles):
    """Complex FFT along the last dim, stage by stage as the kernel runs it:
    one radix-2 stage first when log2 n is odd, then radix-4 stages.
    Butterfly j reads z[j + r·n/R], multiplies input r by w^r where
    w = W_n^((j % Ns)·n/(Ns·R)) comes from the table and w², w³ are products
    (w·w, w·w²), and writes z[(j // Ns)·Ns·R + j % Ns + r·Ns]."""
    n = z.shape[-1]
    tw = torch.complex(*torch.from_numpy(np.array(twiddles)).unbind(-1))
    radices = ([2] if int(np.log2(n)) % 2 else []) + [4] * (
        int(np.log2(n)) // 2)
    ns = 1
    for radix in radices:
        j = torch.arange(n // radix)
        r = torch.arange(radix)[:, None]
        v = z[..., j[None, :] + r * (n // radix)]  # [..., R, n/R]
        if ns > 1:  # the first stage's twiddles are all 1
            w1 = tw[(j % ns) * (n // (ns * radix))]
            w2 = w1 * w1
            v = v * torch.stack([torch.ones_like(w1), w1, w2, w1 * w2])
        v = _dft4(v) if radix == 4 else _dft2(v)
        d = (j // ns) * ns * radix + j % ns
        out = torch.empty_like(z)
        out[..., d[None, :] + r * ns] = v
        z, ns = out, ns * radix
    return z


def _frames(audio, cfg, count):
    """``count`` centre-padded frames [..., count, n_fft], zeros outside the
    signal as the kernel's staged span has them."""
    pad = cfg.n_fft // 2
    x = torch.from_numpy(audio)
    right = max(0, (count - 1) * cfg.hop_length + cfg.n_fft
                - pad - x.shape[-1])
    padded = torch.nn.functional.pad(x, (pad, right))
    return padded.unfold(-1, cfg.n_fft, cfg.hop_length)[..., :count, :]


def emulate_kernel(audio, cfg):
    """(spectra [..., T, n_freqs] complex, log-mel [..., T, n_mels]) by the
    kernel's schedule: frames in pairs packed as one complex FFT, split,
    magnitude, sparse mel, log."""
    tables = kernel_tables(cfg)
    n = cfg.n_fft
    t = 1 + audio.shape[-1] // cfg.hop_length
    frames = _frames(audio, cfg, t + t % 2) * torch.from_numpy(
        np.array(tables.window))
    z = stockham_fft(torch.complex(frames[..., 0::2, :],
                                   frames[..., 1::2, :]), tables.twiddles)
    k = torch.arange(n // 2 + 1)
    zk, zc = z[..., k], z[..., (n - k) % n].conj()
    xa, xb = (zk + zc) / 2, (zk - zc) / 2j
    spec = torch.stack([xa, xb], dim=-2).flatten(-3, -2)[..., :t, :]
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)
    mel = torch.zeros(*mag.shape[:-1], cfg.n_mels)
    for m in range(cfg.n_mels):
        o0, o1 = int(tables.fb_offset[m]), int(tables.fb_offset[m + 1])
        f0 = int(tables.fb_first[m])
        w = torch.from_numpy(np.array(tables.fb_weights[o0:o1]))
        mel[..., m] = mag[..., f0: f0 + o1 - o0] @ w
    return spec, torch.log(torch.clamp(mel, min=cfg.log_clip_min))


# -- tables ---------------------------------------------------------------


@pytest.mark.parametrize("n_fft", sorted(CONFIGS))
def test_window_and_twiddle_tables(n_fft):
    cfg = CONFIGS[n_fft]
    tables = kernel_tables(cfg)
    np.testing.assert_array_equal(tables.window,
                                  padded_window(n_fft, cfg.win_length))
    assert tables.twiddles.shape == (n_fft, 2)
    assert tables.twiddles.dtype == np.float32
    want = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    # Rounded once from float64: within half an f32 ulp of the exact value.
    assert np.max(np.abs(tables.twiddles[:, 0] - want.real)) <= 6e-8
    assert np.max(np.abs(tables.twiddles[:, 1] - want.imag)) <= 6e-8
    assert not tables.twiddles.flags.writeable


@pytest.mark.parametrize("n_fft", sorted(CONFIGS))
def test_sparse_filterbank_rebuilds_the_dense_one(n_fft):
    cfg = CONFIGS[n_fft]
    tables = kernel_tables(cfg)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                        cfg.fmax)
    dense = np.zeros_like(fb)
    for m in range(cfg.n_mels):
        o0, o1 = tables.fb_offset[m], tables.fb_offset[m + 1]
        f0 = tables.fb_first[m]
        dense[f0: f0 + o1 - o0, m] = tables.fb_weights[o0:o1]
    np.testing.assert_array_equal(dense, fb)
    assert tables.fb_offset[0] == 0
    assert tables.fb_offset[-1] == tables.fb_weights.size
    # Only the triangles' interiors are kept: nnz counts what the mel
    # projection must multiply.
    assert tables.fb_weights.size == np.count_nonzero(fb)
    assert tables.fb_first.dtype == tables.fb_offset.dtype == np.int32


# -- the schedule against torch.fft and the plain version -----------------


@pytest.mark.parametrize("n_fft", sorted(CONFIGS))
def test_stockham_schedule_matches_torch_fft(n_fft):
    rng = np.random.default_rng(n_fft)
    z = torch.complex(*torch.from_numpy(
        rng.standard_normal((2, 5, n_fft)).astype(np.float32)))
    got = stockham_fft(z, kernel_tables(CONFIGS[n_fft]).twiddles)
    want = torch.fft.fft(z)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("case", sorted(INPUTS))
@pytest.mark.parametrize("n_fft", sorted(CONFIGS))
def test_kernel_schedule_matches_rfft_and_plain(n_fft, case):
    cfg = CONFIGS[n_fft]
    audio = INPUTS[case]()
    spec, got = emulate_kernel(audio, cfg)
    t = 1 + audio.shape[-1] // cfg.hop_length
    frames = _frames(audio, cfg, t) * torch.from_numpy(
        padded_window(n_fft, cfg.win_length))
    want = torch.fft.rfft(frames)
    assert spec.shape == want.shape
    assert float((spec - want).abs().max() / want.abs().max()) <= 1e-5
    plain = log_mel_spectrogram_plain(torch.from_numpy(audio), cfg)
    assert got.shape == plain.shape == (*audio.shape[:-1], t, cfg.n_mels)
    assert max_abs(got, plain) <= 2e-3


# -- the wrapper's checks -------------------------------------------------


@pytest.mark.parametrize("n_fft", [48, 96, 1000, 32, 4096])
def test_kernel_rejects_unsupported_n_fft(n_fft):
    cfg = AudioConfig(n_fft=n_fft, win_length=n_fft)
    with pytest.raises(ValueError, match="power of two"):
        kernel_tables(cfg)


def test_kernel_rejects_reflect_padding():
    cfg = dataclasses.replace(AudioConfig(), pad_mode="reflect")
    with pytest.raises(ValueError, match="pads with zeros"):
        kernel_tables(cfg)
    # The plain version, which a CPU tensor takes, does reflect padding.
    audio = torch.from_numpy(_audio((4000,), 3))
    assert log_mel_cuda(audio, cfg).shape == (16, cfg.n_mels)


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="no log-mel kernel for device"):
        log_mel_cuda(torch.zeros(4000, device="meta"))


# -- on a card: the kernel against its emulation --------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(INPUTS))
@pytest.mark.parametrize("n_fft", sorted(CONFIGS))
def test_kernel_matches_its_emulation_on_card(n_fft, case):
    """This file imports no JAX, so on a host without it the card tests run
    with ``python -m pytest --noconftest -m cuda
    tests/test_torch_mel_kernel.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfg = CONFIGS[n_fft]
    audio = INPUTS[case]()
    before = log_mel_cuda.launches
    got = log_mel_cuda(torch.from_numpy(audio).cuda(), cfg)
    torch.cuda.synchronize()
    assert log_mel_cuda.launches == before + 1
    _, want = emulate_kernel(audio, cfg)
    # The same arithmetic in another order of rounding: f32 ulps of the
    # magnitudes, seen through the log.
    assert max_abs(got, want) <= 1e-4
    plain = log_mel_spectrogram_plain(torch.from_numpy(audio), cfg)
    assert max_abs(got, plain) <= 2e-3
