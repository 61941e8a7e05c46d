"""BigVGAN's anti-aliased SnakeBeta activation: the plain composition, the
hand-written CUDA kernel and its operator.

BigVGAN (NVIDIA/BigVGAN, ``alias_free_activation/torch``) wraps each
activation of its AMP blocks as ``Activation1d``: upsample 2× by a
low-pass filter, apply SnakeBeta at the doubled rate, low-pass and
downsample 2× back. :func:`amp_plain` is that composition as the source
writes it (replicate pad 5, ``2 · conv_transpose1d`` of the 12-tap filter
with stride 2, crop 15 a side; ``x + sin²(αx) / (β + 1e-9)``; replicate pad
(5, 6) of the activated signal, strided ``conv1d`` of the same filter).
:func:`kaiser_sinc_filter` gives the filter by BigVGAN's formula; its
constants (ratio 2, 12 taps, cutoff 0.25, half width 0.3) are fixed, as in
the source.

The kernel (``csrc/amp_activation.cu``) computes the same function in one
launch a call: a read of the input with a halo of a few samples, Up's two
polyphase branches of 6 taps and SnakeBeta in shared memory, Down's 12
taps, one write. Its header comment gives the design and what bounds it
(device memory). It is f32 throughout with the accurate ``sinf``.

α and β are stored as logarithms (BigVGAN-v2's ``snake_logscale``).

The generator runs :func:`amp_plain` on a CPU tensor and :func:`amp_cuda`
on any other. :func:`amp_cuda` goes through the operator
``iris_tts::amp_act``, so the launch is tied to the profiler range open
around it, and has no fallback: BigVGAN runs f32 inference on the card,
and it raises for anything else (:func:`amp_refusal`: another dtype,
gradients on, ``torch.export`` / ``torch.compile`` tracing). A meta tensor
passes, so the counters run the operator.

Counting: the operator has a FLOP formula for ``FlopCounterMode`` and a
byte count for ``scripts/roofline.ByteCounter``, whatever implements it:
the FIR multiply-adds, ``48 · B · C · T`` FLOPs (Up's 12 taps at 2T and
Down's 12 at T, two FLOPs each; the composition's count adds only its
padded edges), and ``4 · (2 · B · C · T + 2 · C)`` bytes (the input read
and the output written once, α and β) (:func:`amp_cost`).

Build: at first use, ``nvcc`` compiles the source into a shared library
with a plain C interface under ``build/iris_tts_tpu_torch/`` (once per
source hash, ``utils/cxx.py``), loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from iris_tts_tpu_torch.utils.cxx import build_cuda_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "amp_activation.cu"
RATIO = 2
TAPS = 12
CUTOFF = 0.5 / RATIO
HALF_WIDTH = 0.6 / RATIO
UP_PAD = TAPS // RATIO - 1                            # 5
UP_CROP = UP_PAD * RATIO + (TAPS - RATIO) // 2        # 15, each side
DOWN_PAD = (TAPS // 2 - 1, TAPS // 2)                 # (5, 6)
# Input samples on each side that one output reads: the activation's
# receptive radius at its own rate.
HALO = 5
SNAKE_EPS = 1e-9  # SnakeBeta's no_div_by_zero


def kaiser_sinc_filter(cutoff: float = CUTOFF, half_width: float = HALF_WIDTH,
                       taps: int = TAPS) -> torch.Tensor:
    """BigVGAN's ``kaiser_sinc_filter1d`` for an even number of taps, as a
    float32 vector ``[taps]``: a Kaiser window (β by Kaiser's rule from the
    attenuation ``A``, ``periodic=False``) times ``2·cutoff·sinc(2·cutoff·
    t)`` at ``t = −taps/2 + 0.5 … taps/2 − 0.5``, normalised to sum to 1."""
    half = taps // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(taps, beta=beta, periodic=False)
    t = torch.arange(-half, half) + 0.5
    h = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return h / h.sum()


# The filter, once: 12 floats the kernel takes by value.
FILTER = kaiser_sinc_filter()
_TAPS = [float(v) for v in FILTER]


def snake_beta(x: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """``x + sin²(α·x) / (β + 1e-9)`` per channel of ``x`` [B, C, T],
    α = exp(alpha), β = exp(beta)."""
    a = torch.exp(alpha[None, :, None])
    b = torch.exp(beta[None, :, None])
    return x + (1.0 / (b + SNAKE_EPS)) * torch.pow(torch.sin(x * a), 2)


def amp_plain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """``Down(SnakeBeta(Up(x)))`` on ``x`` [B, C, T] with the filter ``h``
    [TAPS], as BigVGAN's ``Activation1d`` composes it, in ``x``'s dtype."""
    c = x.shape[1]
    w = h.to(x.dtype).expand(c, 1, TAPS)
    u = F.pad(x, (UP_PAD, UP_PAD), mode="replicate")
    u = RATIO * F.conv_transpose1d(u, w, stride=RATIO, groups=c)
    u = u[..., UP_CROP:-UP_CROP]
    v = snake_beta(u, alpha.to(x.dtype), beta.to(x.dtype))
    v = F.pad(v, DOWN_PAD, mode="replicate")
    return F.conv1d(v, w, stride=RATIO, groups=c)


def build_library() -> Path:
    """Compile ``csrc/amp_activation.cu`` (once per source hash) and return
    the path of the shared library."""
    return build_cuda_library(SOURCE, "amp_activation")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.iris_amp_act.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2
        + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p])
    lib.iris_amp_act.restype = ctypes.c_int
    lib.iris_amp_error_string.argtypes = [ctypes.c_int]
    lib.iris_amp_error_string.restype = ctypes.c_char_p
    return lib


def amp_refusal(x: torch.Tensor, alpha: torch.Tensor,
                beta: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take this call, or None: it runs float32
    inference on a CUDA device (or on meta tensors, for the counters)."""
    if x.device.type not in ("cuda", "meta"):
        return f"no anti-aliased activation kernel for device {x.device}"
    dtypes = (x.dtype, alpha.dtype, beta.dtype)
    if any(d != torch.float32 for d in dtypes):
        return f"the kernel takes float32, got {dtypes}"
    if torch.is_grad_enabled():
        return "the kernel has no backward: run it with gradients off"
    if torch.compiler.is_compiling():
        return "the kernel does not run under export or compile tracing"
    return None


def amp_cuda(x: torch.Tensor, alpha: torch.Tensor,
             beta: torch.Tensor) -> torch.Tensor:
    """:func:`amp_plain` with BigVGAN's filter by the kernel, through the
    operator ``iris_tts::amp_act``; raises ``ValueError`` for a call that
    :func:`amp_refusal` refuses."""
    why = amp_refusal(x, alpha, beta)
    if why is not None:
        raise ValueError(f"BigVGAN runs f32 inference on the card: {why}")
    return torch.ops.iris_tts.amp_act(x.contiguous(), alpha, beta, _TAPS)


amp_cuda.launches = 0


def amp_cost(x_shape: Sequence[int], itemsize: int = 4) -> Tuple[int, int]:
    """(FLOPs, bytes) of one activation on ``x`` [B, C, T]: the FIR
    multiply-adds (Up's 12 taps at 2T, Down's 12 at T), and the input read
    and the output written once with α and β."""
    b, c, t = x_shape
    return 48 * b * c * t, itemsize * (2 * b * c * t + 2 * c)


def _amp_act(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
             taps: List[float]) -> torch.Tensor:
    if any(t.dtype != torch.float32 for t in (x, alpha, beta)):
        raise TypeError(f"the activation kernel takes float32, got "
                        f"{x.dtype}, {alpha.dtype}, {beta.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("the activation kernel takes a contiguous "
                         "[B, C, T] tensor")
    batch, channels, t = x.shape
    if (alpha.shape != (channels,) or beta.shape != (channels,)
            or not alpha.is_contiguous() or not beta.is_contiguous()):
        raise ValueError(f"alpha and beta must be contiguous [{channels}]")
    if len(taps) != TAPS:
        raise ValueError(f"the activation kernel takes {TAPS} taps")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.iris_amp_act(
            x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(),
            batch * channels, channels, t, (ctypes.c_float * TAPS)(*taps),
            stream)
    if code != 0:
        raise RuntimeError("activation kernel launch failed: "
                           + lib.iris_amp_error_string(code).decode())
    amp_cuda.launches += 1
    return out


# As ``iris_tts::mrf_stage`` (ops/mrf_cuda.py): the launch runs inside an
# operator, so the profiler ties it to the range open around the call; a
# ``torch.library.Library`` registration costs nothing at the first call;
# the Meta kernel lets the counters run the operator on meta tensors.
_LIB = torch.library.Library("iris_tts", "FRAGMENT")
_LIB.define("amp_act(Tensor x, Tensor alpha, Tensor beta, float[] taps) "
            "-> Tensor")
_LIB.impl("amp_act", _amp_act, "CUDA")
_LIB.impl("amp_act", lambda x, *args: torch.empty_like(x), "Meta")


@register_flop_formula(torch.ops.iris_tts.amp_act)
def _amp_act_flops(x_shape, alpha_shape, beta_shape, taps, out_val=None,
                   **kwargs) -> int:
    return amp_cost(x_shape)[0]


def amp_act_bytes(x: torch.Tensor, alpha, beta, taps) -> int:
    """The operator's bytes for ``scripts/roofline.ByteCounter``
    (:func:`amp_cost`)."""
    return amp_cost(tuple(x.shape), x.element_size())[1]
