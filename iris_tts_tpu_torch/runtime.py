"""Device and compute-dtype resolution, and the numerics contract of the
port.

Every entry point takes an explicit ``device``. ``None`` means the CUDA
device; where there is none the entry point raises instead of carrying on
on the CPU. The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do.

Compute dtypes are float32 (the default) and bfloat16. As in the JAX
package (flax's per-module ``dtype``), bf16 is a compute dtype only:
parameters stay float32, and each layer casts its input and its weight to
the compute dtype at the op (``models/layers.py``).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]
DtypeLike = Union[str, torch.dtype, None]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_ALIASES = {"f32": "float32", "bf16": "bfloat16"}


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


def resolve_dtype(dtype: DtypeLike = None) -> torch.dtype:
    """``None`` → float32; a compute dtype as a ``torch.dtype`` or by name
    (``"float32"``/``"f32"``, ``"bfloat16"``/``"bf16"``). Anything else
    raises."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        name = _DTYPE_ALIASES.get(dtype, dtype)
        if name not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute dtype {dtype!r}; use one of "
                             f"{sorted(COMPUTE_DTYPES)}")
        return COMPUTE_DTYPES[name]
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"unsupported compute dtype {dtype}; use one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return dtype


def dtype_name(dtype: torch.dtype) -> str:
    """The name :func:`resolve_dtype` takes back (``"bfloat16"``)."""
    return str(dtype).rsplit(".", 1)[-1]


def pin_math_precision() -> None:
    """Make the card's arithmetic that of the JAX package. This sets
    process-wide PyTorch flags:

    * f32 means f32: cuDNN convolutions and cuBLAS matmuls default to TF32
      (about three decimal digits), which breaks the ≤1e-3 vocoder
      contract; the JAX package pins HIGHEST precision for f32 for the
      same reason.
    * bf16 GEMMs accumulate in f32, as XLA's do: cuBLAS may otherwise
      reduce a bf16 product's partial sums in reduced precision."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def wrap_int32(seed: int) -> int:
    """Two's-complement wrap of any Python int into the int32 range: the
    one place a synthesis seed is normalised."""
    return ((int(seed) + 2**31) % 2**32) - 2**31


def seeded_generator(seed: int, device: DeviceLike) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
