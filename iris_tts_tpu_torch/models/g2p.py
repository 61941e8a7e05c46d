"""Neural grapheme-to-phoneme model (transformer encoder-decoder), the
training side of the shipped G2P checkpoint.

Counterpart of the JAX package's ``models/g2p.py``: characters are
encoded by post-LN :class:`~iris_tts_tpu_torch.models.encoder.TransformerBlock`
s, and a post-LN decoder (causal self-attention, cross-attention over the
character encoding, ReLU FFN; LayerNorm eps 1e-6) predicts phonemes. The
submodules carry the flax names (``char_embedding``, ``enc_0``,
``dec_0.self_attention``, ``out_proj``, ...), so ``convert/from_jax.py``
carries a JAX tree across and ``convert/to_jax.py`` carries one back
(``text.neural_g2p.save_g2p``). The inference side of the same checkpoint
is ``text.neural_g2p`` (NumPy, on the host).

The vocabularies and :class:`~iris_tts_tpu_torch.text.neural_g2p.G2PConfig`
are defined once, in ``text/neural_g2p.py``. Dropout acts at the JAX sites
(attention weights with one mask over batch and heads, attention outputs,
FFN hidden and output) and draws from the ``generator`` passed in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from iris_tts_tpu_torch.models.encoder import (
    MultiHeadAttention,
    TransformerBlock,
)
from iris_tts_tpu_torch.models.layers import (
    Dense,
    Embedding,
    LayerNorm,
    dropout,
    set_dtype,
)
from iris_tts_tpu_torch.text.neural_g2p import (
    CHAR_PAD,
    PHONE_BOS,
    PHONE_EOS,
    PHONE_PAD,
    G2PConfig,
)

_LN_EPS = 1e-6


class DecoderBlock(nn.Module):
    """Post-LN decoder block: causal self-attention, cross-attention over
    the character encoding, ReLU FFN, each with a residual and LayerNorm."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.self_attention = MultiHeadAttention(embed_dim, num_heads)
        self.self_norm = LayerNorm(embed_dim, eps=_LN_EPS)
        self.cross_attention = MultiHeadAttention(embed_dim, num_heads)
        self.cross_norm = LayerNorm(embed_dim, eps=_LN_EPS)
        self.ffn_in = Dense(embed_dim, ffn_dim)
        self.ffn_out = Dense(ffn_dim, embed_dim)
        self.ffn_norm = LayerNorm(embed_dim, eps=_LN_EPS)
        set_dtype(self, dtype)

    def forward(self, y: torch.Tensor, enc: torch.Tensor,
                self_mask: torch.Tensor, cross_mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, det, g = self.dropout, deterministic, generator
        attn = self.self_attention(y, self_mask, p, det, g)
        y = self.self_norm(y + dropout(attn, p, det, g))
        cross = self.cross_attention(y, cross_mask, p, det, g, kv=enc)
        y = self.cross_norm(y + dropout(cross, p, det, g))
        h = dropout(F.relu(self.ffn_in(y)), p, det, g)
        h = dropout(self.ffn_out(h), p, det, g)
        return self.ffn_norm(y + h)


class G2PTransformer(nn.Module):
    """Characters → phoneme logits (teacher-forced decoder).

    ``forward(char_ids [B, W], phone_in [B, T])`` returns logits
    ``[B, T, V]``. Padding is read from the PAD ids; the decoder's
    self-attention is causal.
    """

    def __init__(self, config: G2PConfig = G2PConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        ffn = cfg.ffn_mult * cfg.embed_dim
        self.char_embedding = Embedding(cfg.char_vocab, cfg.embed_dim)
        self.char_position = Embedding(cfg.max_word_len, cfg.embed_dim)
        self.phone_embedding = Embedding(cfg.phone_vocab, cfg.embed_dim)
        self.phone_position = Embedding(cfg.max_phone_len, cfg.embed_dim)
        for i in range(cfg.enc_blocks):
            self.add_module(f"enc_{i}", TransformerBlock(
                cfg.embed_dim, cfg.num_heads, ffn, cfg.dropout))
        for i in range(cfg.dec_blocks):
            self.add_module(f"dec_{i}", DecoderBlock(
                cfg.embed_dim, cfg.num_heads, ffn, cfg.dropout))
        self.enc_norm = LayerNorm(cfg.embed_dim, eps=_LN_EPS)
        self.out_proj = Dense(cfg.embed_dim, cfg.phone_vocab)
        self.dtype = dtype
        set_dtype(self, dtype)

    def encode(self, char_ids: torch.Tensor, deterministic: bool = True,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, W] int → (encoding [B, W, E], character validity [B, W]);
        the encoding is zero at PAD characters."""
        valid = char_ids != CHAR_PAD
        w = char_ids.shape[1]
        pos = torch.arange(w, device=char_ids.device)
        x = (self.char_embedding(char_ids).to(self.dtype)
             + self.char_position(pos)[None].to(self.dtype))
        mask = valid[:, None, :, None] & valid[:, None, None, :]
        for i in range(self.config.enc_blocks):
            x = getattr(self, f"enc_{i}")(x, mask, deterministic, generator)
        x = self.enc_norm(x)
        return x * valid[..., None].to(x.dtype), valid

    def decode(self, phone_in: torch.Tensor, enc: torch.Tensor,
               char_valid: torch.Tensor, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced decode: [B, T] tokens → [B, T, V] logits."""
        b, t = phone_in.shape
        pos = torch.arange(t, device=phone_in.device)
        y = (self.phone_embedding(phone_in).to(self.dtype)
             + self.phone_position(pos)[None].to(self.dtype))
        # Causal mask only: PAD positions attend causally too; their logits
        # are masked out of the loss and never read by the greedy decoder.
        self_mask = torch.ones(t, t, dtype=torch.bool,
                               device=phone_in.device).tril()[None, None]
        cross_mask = char_valid[:, None, None, :].expand(b, 1, t, -1)
        for i in range(self.config.dec_blocks):
            y = getattr(self, f"dec_{i}")(y, enc, self_mask, cross_mask,
                                          deterministic, generator)
        return self.out_proj(y)

    def forward(self, char_ids: torch.Tensor, phone_in: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        enc, valid = self.encode(char_ids, deterministic, generator)
        return self.decode(phone_in, enc, valid, deterministic, generator)


@torch.no_grad()
def greedy_decode(model: G2PTransformer,
                  char_ids: torch.Tensor) -> torch.Tensor:
    """Batched greedy decoding with a fixed token buffer, as JAX's
    ``lax.scan``: each of ``max_phone_len - 1`` steps re-runs the decoder
    on the whole buffer and writes position ``t + 1``; a row that has
    emitted EOS gets PAD from then on; ties in the argmax go to the first
    index. Returns ``[B, max_phone_len]`` int32 tokens (BOS, phones, EOS,
    then PAD) on ``char_ids``' device."""
    t_max = model.config.max_phone_len
    b = char_ids.shape[0]
    enc, valid = model.encode(char_ids)
    tokens = torch.full((b, t_max), PHONE_PAD, dtype=torch.long,
                        device=char_ids.device)
    tokens[:, 0] = PHONE_BOS
    done = torch.zeros(b, dtype=torch.bool, device=char_ids.device)
    for t in range(t_max - 1):
        logits = model.decode(tokens, enc, valid)
        nxt = logits[:, t].argmax(-1)
        nxt = torch.where(done, torch.full_like(nxt, PHONE_PAD), nxt)
        tokens[:, t + 1] = nxt
        done = done | (nxt == PHONE_EOS)
    return tokens.to(torch.int32)
