"""Static-shape length regulation, padding masks, and padding helpers.

Counterpart of the JAX package's ``ops/length.py``. Length regulation is a
fixed-frame-budget searchsorted gather: static output shapes, and the
durations never leave the device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def length_regulate(
    encoder_output: torch.Tensor,
    durations: torch.Tensor,
    total_frames: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand phoneme-level features to frame level with a static budget.

    Args:
        encoder_output: [B, P, E] phoneme-level features.
        durations: [B, P] integer frames per phoneme (0 for padding).
        total_frames: static output length T. Frames beyond
            ``sum(durations)`` gather the last valid phoneme and are masked.

    Returns:
        frames [B, T, E] and frame_mask [B, T] (1.0 where the frame is real),
        both in ``encoder_output``'s dtype. Count frames from the mask in an
        integer dtype: a bf16 sum of 701 ones is 700.
    """
    b, p, e = encoder_output.shape
    ends = torch.cumsum(durations.to(torch.int64), dim=-1)  # [B, P]
    total = ends[:, -1:]  # [B, 1]
    frame_idx = torch.arange(total_frames, device=ends.device)
    # Phoneme index owning each frame: number of ends <= frame index.
    seg_ids = torch.searchsorted(
        ends, frame_idx.expand(b, total_frames).contiguous(), right=True
    ).clamp_(max=p - 1)
    frames = torch.gather(
        encoder_output, 1, seg_ids[..., None].expand(b, total_frames, e)
    )
    frame_mask = (frame_idx[None, :] < total).to(encoder_output.dtype)
    return frames * frame_mask[..., None], frame_mask


def gaussian_upsample(
    encoder_output: torch.Tensor,
    durations: torch.Tensor,
    total_frames: int,
    temperature: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft length regulation (Gaussian upsampling): frames [B, T, E] and
    frame_mask [B, T]. Attention energy is −temperature·(t + 0.5 − c_p)²
    against each phoneme centre; padding phonemes (duration 0) are masked
    out of the softmax. The attention is f32, so the frames come out in f32
    (as JAX's einsum promotes a bf16 ``encoder_output``); the mask is in
    ``encoder_output``'s dtype."""
    durations = durations.to(torch.float32)
    ends = torch.cumsum(durations, dim=-1)
    centers = ends - durations / 2.0
    total = ends[:, -1:]
    t = torch.arange(total_frames, dtype=torch.float32,
                     device=ends.device)[None, :, None] + 0.5
    energy = -temperature * torch.square(t - centers[:, None, :])
    energy = torch.where(durations[:, None, :] > 0, energy,
                         torch.full_like(energy, -1e9))
    attn = torch.softmax(energy, dim=-1)
    frames = torch.einsum("btp,bpe->bte", attn,
                          encoder_output.to(torch.promote_types(
                              attn.dtype, encoder_output.dtype)))
    frame_mask = (t[..., 0] < total).to(encoder_output.dtype)
    return frames * frame_mask[..., None], frame_mask


def frame_counts(frame_mask: torch.Tensor) -> torch.Tensor:
    """Real frames per row of a [B, T] frame mask, as int32: summed in an
    integer dtype, never in the mask's own (bf16 rounds counts above 256)."""
    return (frame_mask > 0).sum(dim=1, dtype=torch.int32)


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean mask [B, max_len], True where position < length."""
    positions = torch.arange(max_len, device=lengths.device)[None, :]
    return positions < lengths[:, None]


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (clamps to the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def round_up_to_multiple(n: int, multiple: int) -> int:
    """Host-side shape arithmetic used by bucketing."""
    return ((n + multiple - 1) // multiple) * multiple


def pad_time_to_multiple(x: torch.Tensor, multiple: int,
                         axis: int = 1) -> torch.Tensor:
    """Zero-pad ``x`` at the end of ``axis`` so that its size is a multiple
    of ``multiple`` (returned as is when it already is)."""
    t = x.shape[axis]
    target = round_up_to_multiple(t, multiple)
    if target == t:
        return x
    shape = list(x.shape)
    shape[axis] = target - t
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def durations_from_log(pred_log_durations: torch.Tensor) -> torch.Tensor:
    """Duration head output → integer frames: ``clip(round(exp(p) − 1), 1,
    1e6)``. ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    frames = torch.clamp(
        torch.round(torch.exp(pred_log_durations) - 1.0), 1.0, 1e6
    )
    return frames.to(torch.int32)
