"""1-D convolutions with the JAX package's padding and kernel conventions.

Counterpart of the JAX package's ``ops/conv.py`` (``conv1d_mm`` and
``conv_transpose1d_mm`` in their native formulation). The matmul/pair
formulations there work around TPU backends and have no counterpart here.

Tensors are channels-first ``[B, C, T]`` and kernels are in PyTorch's own
layouts: ``[C_out, C_in/groups, K]`` for a convolution and
``[C_in, C_out, K]`` for a transposed one. The weight converter
(``convert/from_jax.py``) reorders the JAX kernels ``[K, C_in, C_out]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    dilation: int = 1,
    padding: Optional[Tuple[int, int]] = None,
    groups: int = 1,
) -> torch.Tensor:
    """Cross-correlation. ``padding`` is (left, right); the default is
    torch same-padding ``((K·d − d) // 2,) * 2``. Output length
    ``(T + pl + pr − (K−1)·d − 1) // stride + 1``."""
    k = weight.shape[-1]
    if padding is None:
        p = (k * dilation - dilation) // 2
        padding = (p, p)
    pl, pr = padding
    if pl == pr:
        return F.conv1d(x, weight, bias, stride=stride, padding=pl,
                        dilation=dilation, groups=groups)
    # Asymmetric ('SAME' with an odd total pad): torch's padding= is
    # symmetric only, so pad explicitly.
    return F.conv1d(F.pad(x, (pl, pr)), weight, bias, stride=stride,
                    dilation=dilation, groups=groups)


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int,
    crop: Optional[int] = None,
) -> torch.Tensor:
    """Transposed convolution with torch ConvTranspose1d semantics.

    ``weight`` is ``[C_in, C_out, K]`` in true-convolution orientation:
    the JAX kernel ``[K, C_in, C_out]`` transposed, NOT flipped. ``crop``
    defaults to ``(K − u) // 2`` so that T_out == T·u when K − u is even
    (the HiFiGAN upsampler contract)."""
    k = weight.shape[-1]
    if crop is None:
        crop = (k - stride) // 2
    return F.conv_transpose1d(x, weight, bias, stride=stride, padding=crop)
