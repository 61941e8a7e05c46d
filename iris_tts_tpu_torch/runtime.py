"""Device resolution and the f32 numerics contract of the port.

Every entry point takes an explicit ``device``. ``None`` means the CUDA
device; where there is none the entry point raises instead of carrying on
on the CPU. The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no CUDA device exists); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def pin_f32_math() -> None:
    """Make f32 mean f32 on the card: cuDNN convolutions default to TF32
    (about three decimal digits), which breaks the ≤1e-3 vocoder contract.
    The JAX package pins HIGHEST precision for f32 for the same reason.
    This sets process-wide PyTorch flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def wrap_int32(seed: int) -> int:
    """Two's-complement wrap of any Python int into the int32 range: the
    one place a synthesis seed is normalised."""
    return ((int(seed) + 2**31) % 2**32) - 2**31


def seeded_generator(seed: int, device: DeviceLike) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
