"""The benchmark's plain reference of the synthesis model, in float32.

A frozen copy of the inference math of ``iris_tts_tpu_torch``'s
``models/{encoder,vae,postnet,hifigan,layers}.py``, ``ops/length.py`` and
``convert/from_jax.py``, cut to what synthesis runs: no compute dtype, no
dropout, no tensor parallelism, no training path. Submodules keep the
port's names, which are the flax parameter paths joined with dots, so the
JAX package's parameter tree maps onto it leaf by leaf
(:func:`state_dict_from_flax`). It imports nothing of the port and takes
nothing the port built: weights come from the parameter tree the
benchmark reads itself.

The caller pins the arithmetic (float32 with TF32 off,
:func:`pin_f32`), as the port's ``runtime.pin_math_precision`` does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1
_LN_EPS = 1e-6


def pin_f32() -> None:
    """float32 means float32: TF32 off in cuDNN and cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def same_padding(t: int, k: int, stride: int, dilation: int
                 ) -> Tuple[int, int]:
    """XLA 'SAME': output ceil(T/s); the extra pad goes on the right."""
    out = -(-t // stride)
    eff_k = (k - 1) * dilation + 1
    pad_total = max((out - 1) * stride + eff_k - t, 0)
    return pad_total // 2, pad_total - pad_total // 2


class Conv1d(nn.Module):
    """1-D conv on ``[B, C, T]``: 'SAME' padding, or explicit
    (left, right). Weight ``[C_out, C_in, K]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dilation: int = 1, padding=None):
        super().__init__()
        self.stride, self.dilation, self.padding = stride, dilation, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        pl, pr = self.padding or same_padding(x.shape[-1], k, self.stride,
                                              self.dilation)
        if pl != pr:
            x, pl = F.pad(x, (pl, pr)), 0
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        padding=pl, dilation=self.dilation)


class TorchConv1d(Conv1d):
    """HiFiGAN's conv: ``(k·d − d) // 2`` on each side."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        p = (k * dilation - dilation) // 2
        super().__init__(cin, cout, k, dilation=dilation, padding=(p, p))


class ConvTranspose1d(nn.Module):
    """Transposed conv, torch semantics with crop ``(K − u) // 2`` (T·u
    out); weight ``[C_in, C_out, K]``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cin, cout, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        return F.conv_transpose1d(x, self.weight, self.bias,
                                  stride=self.stride,
                                  padding=(k - self.stride) // 2)


class Dense(nn.Module):
    """``flax.linen.Dense`` on the last axis; weight ``[out, in]``."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def forward_ct(self, x: torch.Tensor) -> torch.Tensor:
        return self(x.transpose(1, 2)).transpose(1, 2)


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = _LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias,
                            self.eps)


# --------------------------------------------------------------------------
# encoder and duration head (models/encoder.py)
# --------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key = Dense(dim, dim), Dense(dim, dim)
        self.value, self.out = Dense(dim, dim), Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, p, e = x.shape
        h = self.heads
        d = e // h
        q = self.query(x).view(b, p, h, d) / math.sqrt(d)
        k = self.key(x).view(b, p, h, d)
        v = self.value(x).view(b, p, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, p, e))


class TransformerBlock(nn.Module):
    """Post-LN: attention + residual + LN, then ReLU FFN + residual + LN."""

    def __init__(self, dim: int, heads: int, ffn: int):
        super().__init__()
        self.attention = MultiHeadAttention(dim, heads)
        self.attn_norm = LayerNorm(dim)
        self.ffn_in, self.ffn_out = Dense(dim, ffn), Dense(ffn, dim)
        self.ffn_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attn_norm(x + self.attention(x, mask))
        return self.ffn_norm(x + self.ffn_out(F.relu(self.ffn_in(x))))


class PhonemeEncoder(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        e = cfg["embed_dim"]
        ffn = cfg["ffn_dim"] if cfg["ffn_dim"] > 0 else 4 * e
        self.num_blocks = cfg["num_blocks"]
        self.phoneme_embedding = Embedding(cfg["vocab_size"], e)
        self.position_embedding = Embedding(cfg["max_length"], e)
        for i in range(self.num_blocks):
            self.add_module(f"block_{i}",
                            TransformerBlock(e, cfg["num_heads"], ffn))
        self.output_norm = LayerNorm(e)

    def forward(self, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = self.phoneme_embedding(ids) + self.position_embedding(pos)[None]
        mask = valid[:, None, :, None] & valid[:, None, None, :]
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, mask)
        return self.output_norm(x) * valid.to(x.dtype)[..., None]


class DurationPredictor(nn.Module):
    """[B, P, E] → log-durations [B, P]: conv + ReLU + LN stack, 1×1 conv,
    softplus."""

    def __init__(self, in_dim: int, cfg: Dict[str, Any]):
        super().__init__()
        self.num_layers = cfg["num_layers"]
        c = in_dim
        for i in range(self.num_layers):
            self.add_module(f"conv_{i}", Conv1d(c, cfg["hidden_dim"],
                                                cfg["kernel_size"]))
            self.add_module(f"norm_{i}", LayerNorm(cfg["hidden_dim"]))
            c = cfg["hidden_dim"]
        self.output_proj = Conv1d(c, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = getattr(self, f"norm_{i}")(F.relu(x))
        return F.softplus(self.output_proj(x.transpose(1, 2))[:, 0])


# --------------------------------------------------------------------------
# VAE, prior path (models/vae.py)
# --------------------------------------------------------------------------


class FiLM(nn.Module):
    def __init__(self, cond_dim: int, channels: int):
        super().__init__()
        self.proj = Dense(cond_dim, 2 * channels)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.proj.forward_ct(cond).chunk(2, dim=1)
        return gamma * x + beta


class WaveNetResBlock(nn.Module):
    def __init__(self, c: int, cond_dim: int, k: int, dilation: int):
        super().__init__()
        self.conv = Conv1d(c, c, k, dilation=dilation)
        self.film = FiLM(cond_dim, c)
        self.res_proj = Conv1d(c, c, 1)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return x + self.res_proj(self.film(_gelu(self.conv(x)), cond))


class TemporalDownsample(nn.Module):
    def __init__(self, cin: int, c: int, stages: int):
        super().__init__()
        self.stages = stages
        for i in range(stages):
            self.add_module(f"conv_{i}",
                            Conv1d(cin if i == 0 else c, c, 5, stride=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.stages):
            x = _gelu(getattr(self, f"conv_{i}")(x))
        return x


class TemporalUpsample(nn.Module):
    def __init__(self, c: int, stages: int):
        super().__init__()
        self.stages = stages
        for i in range(stages):
            self.add_module(f"conv_{i}", Conv1d(c, c, 5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.stages):
            x = _gelu(getattr(self, f"conv_{i}")(
                torch.repeat_interleave(x, 2, dim=2)))
        return x


class APCoupling(nn.Module):
    def __init__(self, channels: int, hidden: int, cond_dim: int):
        super().__init__()
        half = channels // 2
        self.cond_proj = Dense(cond_dim, half)
        self.net_pre = Conv1d(half, hidden, 3)
        self.net_post = Conv1d(hidden, half, 1)
        self.film = FiLM(half, half)

    def inverse(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=1)
        ce = _gelu(self.cond_proj.forward_ct(cond))
        t = self.film(self.net_post(_gelu(self.net_pre(x1 + ce))), ce)
        return torch.cat([x1, x2 - t], dim=1)


class VolumePreservingFlow(nn.Module):
    def __init__(self, channels: int, layers: int, hidden: int, cond: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"ap_{i}", APCoupling(channels, hidden, cond))

    def inverse(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        for i in reversed(range(self.layers)):
            x = getattr(self, f"ap_{i}").inverse(x, cond)
        return x


class TextConditionedVAE(nn.Module):
    """The posterior encoder's modules are built so that the parameter tree
    maps whole; synthesis runs :meth:`generate` only."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        c, k = cfg["model_channels"], cfg["wavenet_kernel_size"]
        cond, lat = cfg["cond_dim"], cfg["latent_dim"]
        self.in_proj = Conv1d(cfg["n_mels"], c, 1)
        for i in range(cfg["num_wavenet_blocks"]):
            self.add_module(f"enc_block_{i}",
                            WaveNetResBlock(c, cond, k, 2 ** (i % 4)))
        self.downsample = TemporalDownsample(c, c, cfg["down_stages"])
        self.down_cond_proj = Conv1d(cond, c, 1)
        self.latent_mean_proj = Dense(c, lat)
        self.latent_logvar_proj = Dense(c, lat)
        self.vpflow = VolumePreservingFlow(lat, cfg["flow_layers"],
                                           cfg["flow_hidden"], c)
        self.latent_dec_proj = Dense(lat, c)
        for i in range(cfg["decoder_blocks"]):
            self.add_module(f"dec_block_{i}",
                            WaveNetResBlock(c, c, k, 2 ** (i % 4)))
        self.upsample = TemporalUpsample(c, cfg["down_stages"])
        self.out_proj = Conv1d(c, cfg["n_mels"], 1)
        self.residual_proj = Dense(c, cond)

    def generate(self, frame_cond: torch.Tensor, z: torch.Tensor
                 ) -> torch.Tensor:
        """frame_cond [B, T, cond], prior latent z [B, latent, T/down] →
        mel [B, T, n_mels]."""
        lat_cond = self.downsample(self.down_cond_proj(
            frame_cond.transpose(1, 2)))
        d = self.latent_dec_proj.forward_ct(self.vpflow.inverse(z, lat_cond))
        for i in range(self.cfg["decoder_blocks"]):
            d = getattr(self, f"dec_block_{i}")(d, lat_cond)
        return self.out_proj(self.upsample(d)).transpose(1, 2)


# --------------------------------------------------------------------------
# PostNet (models/postnet.py) and HiFiGAN (models/hifigan.py)
# --------------------------------------------------------------------------


class BatchNorm(nn.Module):
    """Inference BatchNorm over the running statistics, eps 1e-3."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + 1e-3)[None, :, None]
        y = (x - self.running_mean[None, :, None]) * inv
        return y * self.weight[None, :, None] + self.bias[None, :, None]


class PostNet(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.hidden = cfg["num_layers"] - 1
        c, k = cfg["n_mels"], cfg["kernel_size"]
        for i in range(self.hidden):
            self.add_module(f"conv_{i}", Conv1d(c, cfg["channels"], k))
            self.add_module(f"bn_{i}", BatchNorm(cfg["channels"]))
            c = cfg["channels"]
        self.conv_out = Conv1d(c, cfg["n_mels"], k)
        self.bn_out = BatchNorm(cfg["n_mels"])

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = mel.transpose(1, 2)
        for i in range(self.hidden):
            h = torch.tanh(getattr(self, f"bn_{i}")(
                getattr(self, f"conv_{i}")(h)))
        return mel + self.bn_out(self.conv_out(h)).transpose(1, 2)


class ResBlock(nn.Module):
    def __init__(self, c: int, k: int, dilations: Sequence[int]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}", TorchConv1d(c, c, k, d))
            self.add_module(f"convs2_{i}", TorchConv1d(c, c, k, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            x = x + getattr(self, f"convs2_{i}")(F.leaky_relu(h, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    """mel [B, T, n_mels] → waveform [B, T · prod(upsample_rates)]."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        c0 = cfg["upsample_initial_channel"]
        self.nk = len(cfg["resblock_kernel_sizes"])
        self.nu = len(cfg["upsample_rates"])
        self.conv_pre = TorchConv1d(cfg["in_channels"], c0, 7)
        for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                       cfg["upsample_kernel_sizes"])):
            ch = c0 // 2 ** (i + 1)
            self.add_module(f"ups_{i}", ConvTranspose1d(2 * ch, ch, k, u))
            for j, (rk, rd) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                             cfg["resblock_dilations"])):
                self.add_module(f"resblocks_{i * self.nk + j}",
                                ResBlock(ch, rk, rd))
        self.conv_post = TorchConv1d(c0 // 2 ** self.nu, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        for i in range(self.nu):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(self.nk):
                out = getattr(self, f"resblocks_{i * self.nk + j}")(x)
                acc = out if acc is None else acc + out
            x = acc / self.nk
        return torch.tanh(self.conv_post(F.leaky_relu(x, LRELU_SLOPE)))[:, 0]


class SynthesisModel(nn.Module):
    def __init__(self, model_cfg: Dict[str, Dict[str, Any]]):
        super().__init__()
        self.cfg = model_cfg
        self.encoder = PhonemeEncoder(model_cfg["encoder"])
        self.duration = DurationPredictor(model_cfg["encoder"]["embed_dim"],
                                          model_cfg["duration"])
        self.vae = TextConditionedVAE(model_cfg["vae"])
        self.postnet = PostNet(model_cfg["postnet"])
        self.hifigan = HiFiGANGenerator(model_cfg["hifigan"])


# --------------------------------------------------------------------------
# length regulation and buckets (ops/length.py)
# --------------------------------------------------------------------------


def durations_from_log(log_dur: torch.Tensor) -> torch.Tensor:
    """``clip(round(exp(p) − 1), 1, 1e6)`` as int64 (round half to even)."""
    return torch.clamp(torch.round(torch.exp(log_dur) - 1.0), 1.0,
                       1e6).to(torch.int64)


def length_regulate(enc: torch.Tensor, durations: torch.Tensor,
                    total_frames: int) -> torch.Tensor:
    """[B, P, E] phoneme features → [B, T, E] frames, zero past each row's
    total."""
    b, p, e = enc.shape
    ends = torch.cumsum(durations, dim=-1)
    frame_idx = torch.arange(total_frames, device=enc.device)
    seg = torch.searchsorted(ends, frame_idx.expand(b, total_frames)
                             .contiguous(), right=True).clamp_(max=p - 1)
    frames = torch.gather(enc, 1, seg[..., None].expand(b, total_frames, e))
    return frames * (frame_idx[None, :] < ends[:, -1:]).to(enc.dtype)[..., None]


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n (the largest when none is)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


# --------------------------------------------------------------------------
# the JAX package's parameter tree (convert/from_jax.py)
# --------------------------------------------------------------------------

_QKV = ("query", "key", "value")


def flat_leaves(tree: Any, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, path + (str(k),))
    else:
        yield path, tree


def _leaf_to_torch(path: Tuple[str, ...], a: np.ndarray
                   ) -> Tuple[str, np.ndarray]:
    *mod, leaf = path
    parent = mod[-1] if mod else ""
    in_attn = len(mod) >= 2 and mod[-2] == "attention"
    if leaf == "kernel":
        name = "weight"
        if in_attn and parent in _QKV and a.ndim == 3:
            a = a.reshape(a.shape[0], -1).T
        elif in_attn and parent == "out" and a.ndim == 3:
            a = a.reshape(-1, a.shape[-1]).T
        elif a.ndim == 2:
            a = a.T
        elif a.ndim == 3 and parent.startswith("ups_"):
            a = a.transpose(1, 2, 0)
        elif a.ndim == 3:
            a = a.transpose(2, 1, 0)
        else:
            raise ValueError(f"unexpected kernel {'/'.join(path)} {a.shape}")
    elif leaf == "bias":
        name = "bias"
        a = a.reshape(-1)
    elif leaf in ("scale", "embedding"):
        name = "weight"
    elif leaf in ("mean", "var"):
        name = "running_" + leaf
    else:
        raise ValueError(f"unplaced leaf {'/'.join(path)}")
    return ".".join(mod + [name]), a


def state_dict_from_flax(params: Dict[str, Any], model: SynthesisModel
                         ) -> Dict[str, torch.Tensor]:
    """The JAX ``TTSPipeline.params`` tree (numpy leaves; the PostNet under
    ``params`` and ``batch_stats``) → ``model``'s state dict in float32.
    Raises on a leaf it cannot place, a key left unset, or a shape that
    differs."""
    out: Dict[str, torch.Tensor] = {}
    for top, sub in params.items():
        subtrees = ([sub["params"], sub["batch_stats"]] if top == "postnet"
                    else [sub])
        for tree in subtrees:
            for path, leaf in flat_leaves(tree, (top,)):
                key, a = _leaf_to_torch(path, np.asarray(leaf))
                out[key] = torch.from_numpy(
                    np.ascontiguousarray(a, dtype=np.float32))
    want = model.state_dict()
    if set(out) != set(want):
        raise ValueError(f"parameter tree does not fit the model: missing "
                         f"{sorted(set(want) - set(out))[:5]}, unknown "
                         f"{sorted(set(out) - set(want))[:5]}")
    for k, v in want.items():
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: tree {tuple(out[k].shape)}, model "
                             f"{tuple(v.shape)}")
    return out


def flax_shapes(model: nn.Module, prefix: str, heads: int = 1
                ) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """The flax leaf paths and shapes of ``model``'s parameters (the inverse
    of :func:`_leaf_to_torch`), for drawing a parameter tree from a seed.
    ``heads`` splits the attention projections as flax stores them."""
    out = {}
    for key, v in model.state_dict().items():
        *mod, name = (prefix + "." + key).split(".")
        shape = tuple(v.shape)
        parent = mod[-1]
        in_attn = len(mod) >= 2 and mod[-2] == "attention"
        if name == "weight":
            if isinstance(_module_at(model, key), (LayerNorm, BatchNorm)):
                leaf = "scale"
            elif isinstance(_module_at(model, key), Embedding):
                leaf = "embedding"
            else:
                leaf = "kernel"
                if in_attn and parent in _QKV:
                    shape = (shape[1], heads, shape[0] // heads)
                elif in_attn and parent == "out":
                    shape = (heads, shape[1] // heads, shape[0])
                elif len(shape) == 2:
                    shape = shape[::-1]
                elif parent.startswith("ups_"):
                    shape = (shape[2], shape[0], shape[1])
                else:
                    shape = (shape[2], shape[1], shape[0])
        elif name == "bias":
            leaf = "bias"
            if in_attn and parent in _QKV:
                shape = (heads, shape[0] // heads)
        elif name.startswith("running_"):
            leaf = name[len("running_"):]
        else:
            raise ValueError(f"no flax leaf for {key}")
        out[tuple(mod) + (leaf,)] = shape
    return out


def _module_at(model: nn.Module, key: str) -> nn.Module:
    return model.get_submodule(key.rsplit(".", 1)[0])
