"""HiFiGAN's multi-receptive-field (MRF) resblocks: the hand-written CUDA
kernels and their wrapper.

The kernels (``csrc/mrf_resblock.cu``) replace no TPU kernel: the JAX
package leaves HiFiGAN to XLA's convolutions. They compute a ResBlock
layer, ``x + conv2(lrelu(conv1(lrelu(x))))``, and on a block's last layer
one step of the MRF average; the last block's epilogue writes the leaky
ReLU of the average, which is all the next upsampler or ``conv_post``
reads. There is a tile plan per range of widths, picked by the stage's
channel count: at 8 and 16 channels (:data:`NARROW_CHANNELS`) one launch a
layer; at 32-256 (:data:`WIDE_CHANNELS`) an f32 implicit GEMM a conv, two
launches a layer, the leaky ReLUs, bias, residual and MRF step in their
prologues and epilogues. The source's header comment gives the designs and
what bounds them (FFMA). They are f32 throughout and ignore PyTorch's TF32
switches.

:func:`mrf_cuda` runs a stage's whole MRF through the operator
``iris_tts::mrf_stage`` (every layer of every block, after one launch that
packs the stage's weights);
:func:`mrf_plain` is the same function in plain PyTorch: the blocks'
forward passes, their sum in order, the division and the leaky ReLU.
:func:`fused_mrf_applies` is the generator's dispatch rule, read off the
input and the blocks: a CUDA float32 tensor, gradients off, not under
``torch.export`` / ``torch.compile`` tracing, and unsharded convs that
compute in float32. Such a call on blocks the kernel has no plan for (a
width outside :data:`KERNEL_CHANNELS`, a kernel size outside
:data:`KERNEL_SIZES`, a dilation it was not built for: read once, when a
``ResBlock`` is built, :func:`block_refusal`) raises rather than leave the
kernel. Everything else (the GAN step, bf16, export, sharded convs, the
CPU) runs :func:`mrf_plain`.

Counting: the operator has a FLOP formula for ``FlopCounterMode`` and a
byte count for ``scripts/roofline.ByteCounter``, both those of the
composition it replaces (:func:`composition_cost`), so a count of the
vocoder's work reads the same on the card as on the CPU.

Build: at first use, ``nvcc`` compiles the source into a shared library
with a plain C interface under ``build/iris_tts_tpu_torch/``, keyed by a
hash of the source and flags (``utils/cxx.py``): one translation unit for
the narrow plan, the pack and the error strings, and one a wide width,
side by side; ``ctypes`` loads it.
The launches go on PyTorch's current stream; each error code is checked
and a failure raises. :func:`mrf_cuda` has no fallback: on a tensor or
blocks it does not take, it raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from iris_tts_tpu_torch.utils.cxx import build_cuda_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "mrf_resblock.cu"
LRELU_SLOPE = 0.1  # HiFiGAN's; the kernel's kSlope
# The widths the kernel has a tile plan for. At 8 and 16 channels a block
# stages one conv's whole weights and runs a layer in one launch; from 32 on
# a block stages a slice of input channels at a time, a launch a conv (the
# source's header gives the times that drew the line).
NARROW_CHANNELS = (8, 16)
WIDE_CHANNELS = (32, 64, 128, 256)
KERNEL_CHANNELS = NARROW_CHANNELS + WIDE_CHANNELS
KERNEL_SIZES = (3, 7, 11)
WIDE_DILATIONS = (1, 3, 5)  # the wide plan's, built per (C, K, dilation)
MAX_SPAN = 50  # (K - 1) * dilation: conv1's reach over both sides
MAX_CONVS = 64  # convs one pack launch takes
# The epilogue's mode bits; FIRST marks a wide layer's conv1 launch.
ADD_SUM, FINISH, FIRST = 1, 2, 4


def build_library() -> Path:
    """Compile ``csrc/mrf_resblock.cu`` (once per source hash) and return
    the path of the shared library: one translation unit for the narrow
    plan and one a wide width (``IRIS_MRF_WIDE``), compiled side by side."""
    return build_cuda_library(SOURCE, "mrf_resblock", [()] + [
        (f"-DIRIS_MRF_WIDE={c}",) for c in WIDE_CHANNELS])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.iris_mrf_pack.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    lib.iris_mrf_pack.restype = ctypes.c_int
    lib.iris_mrf_layer.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.iris_mrf_layer.restype = ctypes.c_int
    for c in WIDE_CHANNELS:
        wide = getattr(lib, f"iris_mrf_wide_{c}")
        wide.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        wide.restype = ctypes.c_int
    lib.iris_mrf_error_string.argtypes = [ctypes.c_int]
    lib.iris_mrf_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"MRF kernel {what} failed: "
                           + lib.iris_mrf_error_string(code).decode())


def block_refusal(channels: int, kernel_size: int,
                  dilations: Sequence[int]) -> Optional[str]:
    """Why the kernel cannot run a ResBlock of this shape, or None. A
    ResBlock reads it once, when it is built: its convs' shapes, strides
    and paddings follow from these three and change only when a conv is
    sharded, which :func:`fused_mrf_applies` checks on every call."""
    if channels not in KERNEL_CHANNELS:
        return f"no tile plan for {channels} channels"
    if kernel_size not in KERNEL_SIZES:
        return f"kernel size {kernel_size}"
    if any((kernel_size - 1) * d > MAX_SPAN for d in dilations):
        return f"dilations {tuple(dilations)} at kernel size {kernel_size}"
    if channels in WIDE_CHANNELS and not set(dilations) <= set(
            WIDE_DILATIONS):
        return f"dilations {tuple(dilations)} at {channels} channels"
    return None


def _shape_refusal(blocks: Sequence) -> Optional[str]:
    """Why the kernel has no plan for ``blocks``' shapes, or None."""
    for block in blocks:
        if block.kernel_refusal is not None:
            return block.kernel_refusal
    n = sum(2 * block.n for block in blocks)
    return f"{n} convs in a stage" if n > MAX_CONVS else None


def _conv_refusal(blocks: Sequence) -> Optional[str]:
    """Why the kernel cannot take ``blocks``' convs as they stand, or None:
    each conv unsharded and in float32 (its compute dtype and its
    weights)."""
    for block in blocks:
        for pair in block.layers():
            for conv in pair:
                if conv.tp is not None:
                    return "a conv sharded over the model axis"
                if (conv.dtype != torch.float32
                        or conv.weight.dtype != torch.float32):
                    return f"a conv computing in {conv.dtype}"
    return None


def _refusal(blocks: Sequence) -> Optional[str]:
    """Why the kernel cannot run ``blocks`` as they stand, or None."""
    return _shape_refusal(blocks) or _conv_refusal(blocks)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def fused_mrf_applies(x: torch.Tensor, blocks: Sequence) -> bool:
    """The generator's dispatch rule for a stage's MRF on ``x`` [B, C, T]:
    True where :func:`mrf_stage` runs it. HiFiGAN's float32 inference on
    the card runs on the kernel: for such a call on blocks of a shape the
    kernel has no plan for, it raises ``ValueError``."""
    if not (_on_card(x) and x.dtype == torch.float32
            and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()):
        return False
    why = _shape_refusal(blocks)
    if why is not None:
        raise ValueError(f"HiFiGAN runs its f32 inference on the card on "
                         f"the MRF kernel: {why}")
    return _conv_refusal(blocks) is None


def mrf_plain(x: torch.Tensor, blocks: Sequence) -> torch.Tensor:
    """lrelu(mean of ``block(x)``): each block (a callable) on ``x``, the
    outputs summed in order, divided by their number, and the leaky ReLU
    the next upsampler or ``conv_post`` reads."""
    acc = None
    for block in blocks:
        out = block(x)
        acc = out if acc is None else acc + out
    return F.leaky_relu(acc / len(blocks), LRELU_SLOPE)


def mrf_stage(x: torch.Tensor, blocks: Sequence) -> torch.Tensor:
    """:func:`mrf_plain` of ResBlocks ``blocks`` on a CUDA float32 ``x``
    [B, C, T], contiguous, by the kernel, through the operator
    ``iris_tts::mrf_stage``: one launch packs the stage's weights, then one
    launch a layer at 8 and 16 channels, two at 32-256 (each counted in
    ``mrf_cuda.launches``), the last layer of each block stepping the
    average in place in the output. For blocks
    :func:`fused_mrf_applies` has passed (the generator's call); the
    operator raises for another dtype or layout of ``x``."""
    pairs = [pair for block in blocks for pair in block.layers()]
    return torch.ops.iris_tts.mrf_stage(
        x, [conv.weight for pair in pairs for conv in pair],
        [conv.bias for pair in pairs for conv in pair],
        [conv1.dilation for conv1, _ in pairs],
        [block.n for block in blocks])


def mrf_cuda(x: torch.Tensor, blocks: Sequence) -> torch.Tensor:
    """:func:`mrf_stage` after checking ``x``'s device and the blocks:
    raises for another device, dtype, layout or block shape."""
    if not _on_card(x):
        raise ValueError(f"no MRF kernel for device {x.device}")
    why = _refusal(blocks)
    if why is not None:
        raise ValueError(f"the MRF kernel does not take {why}")
    return mrf_stage(x, blocks)


mrf_cuda.launches = 0


def composition_cost(x_shape: Sequence[int], weight_shapes: Sequence,
                     n_blocks: int, itemsize: int = 4) -> Tuple[int, int]:
    """(FLOPs, bytes) of the composition the operator replaces, on ``x``
    [B, C, T] with convs of ``weight_shapes`` [C, C, K] (each with a bias of
    C), as ``FlopCounterMode`` and ``scripts/roofline.ByteCounter`` count
    :func:`mrf_plain`: two FLOPs a multiply-add of each conv; each aten op's
    input and output bytes. A layer is two leaky ReLUs (2 passes each), two
    convs (input, output, weight, bias) and the residual add (3 passes);
    the stage adds ``n_blocks - 1`` sums (3 passes), the division and the
    last leaky ReLU (2 passes each)."""
    b, c, t = x_shape
    flops = sum(2 * b * t * co * ci * k for co, ci, k in weight_shapes)
    layers = len(weight_shapes) // 2
    passes = 11 * layers + 3 * (n_blocks - 1) + 4
    params = sum(co * ci * k + co for co, ci, k in weight_shapes)
    return flops, itemsize * (passes * b * c * t + params)


def _mrf_stage(x: torch.Tensor, weights: List[torch.Tensor],
               biases: List[torch.Tensor], dilations: List[int],
               layers: List[int]) -> torch.Tensor:
    """``weights`` and ``biases`` of each layer's (conv1, conv2), block by
    block; ``dilations`` each layer's conv1's; ``layers`` each block's
    number of layers."""
    if x.dtype != torch.float32 or any(
            w.dtype != torch.float32 for w in weights + biases):
        raise TypeError(f"the MRF kernel takes float32, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("the MRF kernel takes a contiguous [B, C, T] tensor")
    batch, channels, t = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ks = [w.shape[-1] for w in weights]
    offs: List[int] = [0]
    for k in ks:
        offs.append(offs[-1] + channels * k * channels + channels)
    packed = torch.empty(offs[-1], device=x.device, dtype=torch.float32)
    lib = _library()
    wide = (getattr(lib, f"iris_mrf_wide_{channels}")
            if channels in WIDE_CHANNELS else None)
    if wide is not None:
        # conv1's output, and the layers between a block's first and last:
        # each overwrites its own residual, element by element
        hidden = torch.empty_like(x)
        between = torch.empty_like(x) if max(layers) > 1 else None
    else:
        tmp = [torch.empty_like(x) for _ in range(min(2, max(layers) - 1))]
    n = len(weights)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(lib, lib.iris_mrf_pack(
            (ctypes.c_void_p * n)(*(w.data_ptr() for w in weights)),
            (ctypes.c_void_p * n)(*(b.data_ptr() for b in biases)),
            (ctypes.c_int * n)(*ks), (ctypes.c_int * n)(*offs[:-1]), n,
            channels, packed.data_ptr(), stream), "pack")
        base, i = packed.data_ptr(), 0
        for j, n_layers in enumerate(layers):
            h = x
            for step in range(n_layers):
                last = step == n_layers - 1
                mode = ((ADD_SUM if last and j > 0 else 0)
                        | (FINISH if last and j == len(layers) - 1 else 0))
                w1, w2 = (base + 4 * offs[i], base + 4 * offs[i + 1])
                k, d = ks[i], dilations[i // 2]
                bias = 4 * channels * k * channels  # a bias after its weights
                if wide is not None:
                    dst = out if last else between
                    _raise_on(lib, wide(
                        h.data_ptr(), w1, w1 + bias, None, None,
                        hidden.data_ptr(), batch, t, k, d, FIRST,
                        len(layers), stream), "launch")
                    _raise_on(lib, wide(
                        hidden.data_ptr(), w2, w2 + bias, h.data_ptr(),
                        out.data_ptr() if mode & ADD_SUM else None,
                        dst.data_ptr(), batch, t, k, 1, mode,
                        len(layers), stream), "launch")
                    mrf_cuda.launches += 2
                else:
                    dst = out if last else tmp[step % 2]
                    _raise_on(lib, lib.iris_mrf_layer(
                        h.data_ptr(), w1, w1 + bias, w2, w2 + bias,
                        out.data_ptr() if mode & ADD_SUM else None,
                        dst.data_ptr(), batch, channels, t, k, d, mode,
                        len(layers), stream), "launch")
                    mrf_cuda.launches += 1
                h, i = dst, i + 2
    return out


# The launches run inside an operator, so that the profiler ties them to it,
# and through it to the ``record_function`` range open around the call (a
# launch made outside any operator reaches a trace as a kernel of no
# range). Registered with ``torch.library.Library``: a ``custom_op``'s first
# call takes seconds of imports. The Meta kernel gives the output's shape,
# so the counters can run the operator on meta tensors.
_LIB = torch.library.Library("iris_tts", "DEF")
_LIB.define("mrf_stage(Tensor x, Tensor[] weights, Tensor[] biases, "
            "int[] dilations, int[] layers) -> Tensor")
_LIB.impl("mrf_stage", _mrf_stage, "CUDA")
_LIB.impl("mrf_stage", lambda x, *args: torch.empty_like(x), "Meta")


@register_flop_formula(torch.ops.iris_tts.mrf_stage)
def _mrf_stage_flops(x_shape, weight_shapes, bias_shapes, dilations, layers,
                     out_val=None, **kwargs) -> int:
    return composition_cost(x_shape, weight_shapes, len(layers))[0]


def mrf_stage_bytes(x: torch.Tensor, weights: List[torch.Tensor],
                    biases, dilations, layers) -> int:
    """The operator's bytes for ``scripts/roofline.ByteCounter``: those of
    the composition it replaces (:func:`composition_cost`)."""
    return composition_cost(tuple(x.shape), [tuple(w.shape) for w in weights],
                            len(layers), x.element_size())[1]
