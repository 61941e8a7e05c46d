"""Transformer phoneme encoder + convolutional duration predictor.

Counterpart of the JAX package's ``models/encoder.py``: learned positional
embeddings, post-LN transformer blocks (LayerNorm eps 1e-6, ReLU FFN), and
a softplus conv duration head. Submodule names follow the flax parameter
tree (``block_0.attention.query``, ``norm_1``, ...). With
``deterministic=False`` (training) dropout acts at the JAX sites: attention
weights, attention output, FFN hidden and output, the embedding sum, and
after each duration-head LayerNorm; its masks come from the ``generator``
passed in (``layers.dropout``).

``dtype`` is the compute dtype (``models/layers.py``). In bf16, as flax's
modules with ``dtype=bfloat16`` compute (flax 0.12): the embeddings are
cast, Q/K/V and the attention logits are bf16, the mask fills with bf16's
``finfo.min``, the softmax runs in the logits' dtype
(``force_fp32_for_softmax`` is off by default), and each LayerNorm takes
its statistics in f32 and returns bf16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from iris_tts_tpu_torch.config import DurationConfig, EncoderConfig
from iris_tts_tpu_torch.models.layers import (
    Conv1d,
    Dense,
    Embedding,
    LayerNorm,
    dropout,
    set_dtype,
)

_LN_EPS = 1e-6


class MultiHeadAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` (biases on every
    projection): self-attention, or attention over ``kv`` (the G2P
    decoder's cross-attention). The flax kernels ``[E, H, D]`` / ``[H, D, E]``
    flatten to plain ``[E, E]`` Dense weights; on the model axis the query,
    key and value split ``D`` within each head, as JAX's rule splits their
    trailing dim, and the output projection splits ``E``."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(embed_dim, embed_dim, heads=num_heads)
        self.key = Dense(embed_dim, embed_dim, heads=num_heads)
        self.value = Dense(embed_dim, embed_dim, heads=num_heads)
        self.out = Dense(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                dropout_rate: float = 0.0, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, P, E] (the queries); kv [B, S, E] (keys and values; ``x``
        when None); mask [B, 1, P, S] bool (True = attend). Dropout on the
        attention weights shares one mask over batch and heads, as flax's
        ``broadcast_dropout``."""
        kv = x if kv is None else kv
        b, p, e = x.shape
        s = kv.shape[1]
        h = self.num_heads
        d = e // h
        q = self.query(x).view(b, p, h, d) / math.sqrt(d)
        k = self.key(kv).view(b, s, h, d)
        v = self.value(kv).view(b, s, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            # finfo.min, not -inf (as flax does): a fully padded query row
            # then softmaxes to a uniform row instead of NaN, and NaN would
            # survive the output padding mask (NaN·0 = NaN).
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        weights = dropout(weights, dropout_rate, deterministic, generator,
                          broadcast_dims=(0, 1))
        y = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, p, e)
        return self.out(y)


class TransformerBlock(nn.Module):
    """Post-LN encoder block: self-attention + residual + LN, then ReLU FFN
    + residual + LN."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.attention = MultiHeadAttention(embed_dim, num_heads)
        self.attn_norm = LayerNorm(embed_dim, eps=_LN_EPS)
        self.ffn_in = Dense(embed_dim, ffn_dim)
        self.ffn_out = Dense(ffn_dim, embed_dim)
        self.ffn_norm = LayerNorm(embed_dim, eps=_LN_EPS)
        set_dtype(self, dtype)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, det, g = self.dropout, deterministic, generator
        attn = self.attention(x, attn_mask, p, det, g)
        x = self.attn_norm(x + dropout(attn, p, det, g))
        h = dropout(F.relu(self.ffn_in(x)), p, det, g)
        h = dropout(self.ffn_out(h), p, det, g)
        return self.ffn_norm(x + h)


class PhonemeEncoder(nn.Module):
    """Phoneme IDs [B, P] → contextual representations [B, P, E]."""

    def __init__(self, config: EncoderConfig = EncoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.phoneme_embedding = Embedding(config.vocab_size,
                                           config.embed_dim)
        self.position_embedding = Embedding(config.max_length,
                                            config.embed_dim)
        self.num_blocks = config.num_blocks
        for i in range(config.num_blocks):
            self.add_module(f"block_{i}", TransformerBlock(
                config.embed_dim, config.num_heads, config.ffn_hidden,
                config.dropout))
        self.output_norm = LayerNorm(config.embed_dim, eps=_LN_EPS)
        set_dtype(self, dtype)

    def forward(self, phoneme_ids: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """phoneme_ids [B, P] int; padding_mask [B, P] bool/float, True (1)
        = valid; ``deterministic=False`` turns dropout on."""
        seq_len = phoneme_ids.shape[1]
        positions = torch.arange(seq_len, device=phoneme_ids.device)
        x = (self.phoneme_embedding(phoneme_ids).to(self.dtype)
             + self.position_embedding(positions)[None].to(self.dtype))
        x = dropout(x, self.config.dropout, deterministic, generator)
        attn_mask = None
        if padding_mask is not None:
            valid = padding_mask.bool()
            attn_mask = valid[:, None, :, None] & valid[:, None, None, :]
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, attn_mask, deterministic,
                                            generator)
        x = self.output_norm(x)
        if padding_mask is not None:
            x = x * padding_mask.to(x.dtype)[..., None]
        return x


class DurationPredictor(nn.Module):
    """Encoder output [B, P, E] → per-phoneme log-durations [B, P]:
    conv stack (ReLU + LN eps 1e-6) → 1×1 conv → softplus."""

    def __init__(self, in_dim: int, config: DurationConfig = DurationConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = config.num_layers
        self.dropout = config.dropout
        c = in_dim
        for i in range(config.num_layers):
            self.add_module(f"conv_{i}", Conv1d(c, config.hidden_dim,
                                                config.kernel_size))
            self.add_module(f"norm_{i}", LayerNorm(config.hidden_dim,
                                                   eps=_LN_EPS))
            c = config.hidden_dim
        self.output_proj = Conv1d(c, 1, 1)
        set_dtype(self, dtype)

    def forward(self, encoder_output: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = encoder_output
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = getattr(self, f"norm_{i}")(F.relu(x))
            x = dropout(x, self.dropout, deterministic, generator)
        x = self.output_proj(x.transpose(1, 2))  # [B, 1, P]
        return F.softplus(x[:, 0])
