"""The benchmark's plain reference of BigVGAN-v2's generator, in float32.

NVIDIA/BigVGAN as its source writes it (``bigvgan.py``: ``AMPBlock1`` and
the generator; ``activations.py``: ``SnakeBeta``;
``alias_free_activation/torch/{filter,resample,act}.py``:
``kaiser_sinc_filter1d``, ``LowPassFilter1d``, ``UpSample1d``,
``DownSample1d``, ``Activation1d``), for ``resblock "1"`` and
``activation "snakebeta"``, with the module names of the source, so a
state dict of the published layout (weight norm folded) loads as it is.
Departures, none of which changes the function:

- weight norm is folded: each conv holds its plain ``weight``;
- the generator takes the mel time-major ``[B, T, n_mels]`` and returns
  ``[B, T · prod(upsample_rates)]`` (the source: ``[B, n_mels, T]`` →
  ``[B, 1, samples]``), as the benchmark's HiFiGAN reference does;
- the configuration is a dict with the port's key for the dilations
  (``resblock_dilations``; the source: ``resblock_dilation_sizes``) and
  ``in_channels`` for ``num_mels``;
- only v2's variant is written out, which ``activation "snakebeta"``
  states: α and β stored as logarithms, ``conv_post`` without a bias and
  the waveform clamped, not tanh'd (the source's ``snake_logscale`` true,
  ``use_bias_at_final`` and ``use_tanh_at_final`` false).

It imports ``torch`` and ``math`` only, nothing of the port. The caller
pins the arithmetic (:func:`pin_f32`).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def pin_f32() -> None:
    """float32 means float32: TF32 off in cuDNN and cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def kaiser_sinc_filter1d(cutoff, half_width, kernel_size):
    """[1, 1, kernel_size]."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    if even:
        time = torch.arange(-half_size, half_size) + 0.5
    else:
        time = torch.arange(kernel_size) - half_size
    if cutoff == 0:
        filter_ = torch.zeros_like(time)
    else:
        filter_ = 2 * cutoff * window * torch.sinc(2 * cutoff * time)
        filter_ /= filter_.sum()
    return filter_.view(1, 1, kernel_size)


class LowPassFilter1d(nn.Module):
    def __init__(self, cutoff=0.5, half_width=0.6, stride=1, padding=True,
                 padding_mode="replicate", kernel_size=12):
        super().__init__()
        self.kernel_size = kernel_size
        self.even = kernel_size % 2 == 0
        self.pad_left = kernel_size // 2 - int(self.even)
        self.pad_right = kernel_size // 2
        self.stride = stride
        self.padding = padding
        self.padding_mode = padding_mode
        self.register_buffer("filter", kaiser_sinc_filter1d(
            cutoff, half_width, kernel_size))

    def forward(self, x):
        _, C, _ = x.shape
        if self.padding:
            x = F.pad(x, (self.pad_left, self.pad_right),
                      mode=self.padding_mode)
        return F.conv1d(x, self.filter.expand(C, -1, -1),
                        stride=self.stride, groups=C)


class UpSample1d(nn.Module):
    def __init__(self, ratio=2, kernel_size=None):
        super().__init__()
        self.ratio = ratio
        self.kernel_size = (int(6 * ratio // 2) * 2 if kernel_size is None
                            else kernel_size)
        self.stride = ratio
        self.pad = self.kernel_size // ratio - 1
        self.pad_left = (self.pad * self.stride
                         + (self.kernel_size - self.stride) // 2)
        self.pad_right = (self.pad * self.stride
                          + (self.kernel_size - self.stride + 1) // 2)
        self.register_buffer("filter", kaiser_sinc_filter1d(
            cutoff=0.5 / ratio, half_width=0.6 / ratio,
            kernel_size=self.kernel_size))

    def forward(self, x):
        _, C, _ = x.shape
        x = F.pad(x, (self.pad, self.pad), mode="replicate")
        x = self.ratio * F.conv_transpose1d(
            x, self.filter.expand(C, -1, -1), stride=self.stride, groups=C)
        return x[..., self.pad_left:-self.pad_right]


class DownSample1d(nn.Module):
    def __init__(self, ratio=2, kernel_size=None):
        super().__init__()
        self.ratio = ratio
        self.kernel_size = (int(6 * ratio // 2) * 2 if kernel_size is None
                            else kernel_size)
        self.lowpass = LowPassFilter1d(
            cutoff=0.5 / ratio, half_width=0.6 / ratio, stride=ratio,
            kernel_size=self.kernel_size)

    def forward(self, x):
        return self.lowpass(x)


class Activation1d(nn.Module):
    def __init__(self, activation, up_ratio=2, down_ratio=2,
                 up_kernel_size=12, down_kernel_size=12):
        super().__init__()
        self.act = activation
        self.upsample = UpSample1d(up_ratio, up_kernel_size)
        self.downsample = DownSample1d(down_ratio, down_kernel_size)

    def forward(self, x):
        return self.downsample(self.act(self.upsample(x)))


class SnakeBeta(nn.Module):
    """The source's ``SnakeBeta`` with ``alpha_logscale=True``."""

    def __init__(self, in_features, alpha=1.0):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(in_features) * alpha)
        self.beta = nn.Parameter(torch.zeros(in_features) * alpha)
        self.no_div_by_zero = 0.000000001

    def forward(self, x):
        alpha = self.alpha.unsqueeze(0).unsqueeze(-1)
        beta = self.beta.unsqueeze(0).unsqueeze(-1)
        alpha = torch.exp(alpha)
        beta = torch.exp(beta)
        return x + (1.0 / (beta + self.no_div_by_zero)) * pow(
            torch.sin(x * alpha), 2)


def get_padding(kernel_size, dilation=1):
    return int((kernel_size * dilation - dilation) / 2)


class AMPBlock1(nn.Module):
    def __init__(self, channels, kernel_size=3, dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, stride=1, dilation=d,
                      padding=get_padding(kernel_size, d))
            for d in dilation])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, stride=1, dilation=1,
                      padding=get_padding(kernel_size, 1))
            for _ in range(len(dilation))])
        self.num_layers = len(self.convs1) + len(self.convs2)
        self.activations = nn.ModuleList([
            Activation1d(activation=SnakeBeta(channels))
            for _ in range(self.num_layers)])

    def forward(self, x):
        acts1, acts2 = self.activations[::2], self.activations[1::2]
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts1, acts2):
            xt = a1(x)
            xt = c1(xt)
            xt = a2(xt)
            xt = c2(xt)
            x = xt + x
        return x


class BigVGAN(nn.Module):
    """mel [B, T, n_mels] → waveform [B, T · prod(upsample_rates)]."""

    def __init__(self, cfg):
        super().__init__()
        if cfg["activation"] != "snakebeta":
            raise ValueError("the reference is BigVGAN's snakebeta generator")
        self.cfg = cfg
        self.num_kernels = len(cfg["resblock_kernel_sizes"])
        self.num_upsamples = len(cfg["upsample_rates"])
        c0 = cfg["upsample_initial_channel"]
        self.conv_pre = nn.Conv1d(cfg["in_channels"], c0, 7, 1, padding=3)
        self.ups = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                       cfg["upsample_kernel_sizes"])):
            self.ups.append(nn.ModuleList([nn.ConvTranspose1d(
                c0 // (2 ** i), c0 // (2 ** (i + 1)), k, u,
                padding=(k - u) // 2)]))
        self.resblocks = nn.ModuleList()
        for i in range(len(self.ups)):
            ch = c0 // (2 ** (i + 1))
            for k, d in zip(cfg["resblock_kernel_sizes"],
                            cfg["resblock_dilations"]):
                self.resblocks.append(AMPBlock1(ch, k, d))
        self.activation_post = Activation1d(activation=SnakeBeta(ch))
        self.conv_post = nn.Conv1d(ch, 1, 7, 1, padding=3, bias=False)

    def forward(self, mel):
        x = self.conv_pre(mel.transpose(1, 2))
        for i in range(self.num_upsamples):
            for i_up in range(len(self.ups[i])):
                x = self.ups[i][i_up](x)
            xs = None
            for j in range(self.num_kernels):
                if xs is None:
                    xs = self.resblocks[i * self.num_kernels + j](x)
                else:
                    xs += self.resblocks[i * self.num_kernels + j](x)
            x = xs / self.num_kernels
        x = self.activation_post(x)
        x = self.conv_post(x)
        x = torch.clamp(x, min=-1.0, max=1.0)
        return x[:, 0]
