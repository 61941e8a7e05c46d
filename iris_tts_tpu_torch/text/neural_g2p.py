"""Lazy-loading neural G2P for out-of-lexicon words (inference side).

A copy of the JAX package's ``text/neural_g2p.py`` without jax or flax: the
shipped transformer checkpoint (``data/g2p_transformer.npz``, fp16 params
plus a ``__manifest__`` JSON) is read with ``np.load`` and decoded by a
pure-NumPy forward pass (:class:`_NumpyG2P`). Importing this module, or
constructing :class:`NeuralG2P`, loads nothing; the first out-of-lexicon
word pays the one-time checkpoint load, and per-word results are memoized.
The training side is ``models/g2p.py`` and ``scripts/train_g2p.py``;
:func:`save_g2p` writes the JAX package's checkpoint format.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from iris_tts_tpu_torch.text.lexicon import ARPABET

logger = logging.getLogger(__name__)

DEFAULT_CHECKPOINT = (
    Path(__file__).resolve().parent / "data" / "g2p_transformer.npz"
)

# Character inventory: PAD + a-z + apostrophe (CMUdict headwords).
G2P_CHARS = "abcdefghijklmnopqrstuvwxyz'"
CHAR_PAD = 0
CHAR_VOCAB = 1 + len(G2P_CHARS)  # 28
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(G2P_CHARS)}

# Phone inventory: PAD/BOS/EOS + the 39 stress-stripped ARPABET symbols
# (``lexicon.ARPABET`` order is the contract).
PHONE_PAD, PHONE_BOS, PHONE_EOS = 0, 1, 2
N_SPECIAL = 3


def encode_word(word: str, max_len: int) -> Optional[list]:
    """Word → padded char-ID list, or None if it doesn't fit/clean."""
    ids = [_CHAR_TO_ID.get(c) for c in word]
    if not ids or any(i is None for i in ids) or len(ids) > max_len:
        return None
    return ids + [CHAR_PAD] * (max_len - len(ids))


@dataclass(frozen=True)
class G2PConfig:
    """Self-contained config (persisted inside the checkpoint manifest)."""

    char_vocab: int = CHAR_VOCAB
    phone_vocab: int = N_SPECIAL + 39
    embed_dim: int = 192
    num_heads: int = 4
    enc_blocks: int = 3
    dec_blocks: int = 3
    ffn_mult: int = 4
    dropout: float = 0.1
    max_word_len: int = 32   # characters
    max_phone_len: int = 36  # phonemes incl. BOS/EOS


def _flatten(tree, prefix: str = ""):
    """flax ``traverse_util.flatten_dict(tree, sep="/")`` as (key, leaf)
    pairs, in the tree's order."""
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _flatten(v, key)
        else:
            yield key, v


def save_g2p(path: str | Path, params, cfg, meta: Optional[dict] = None):
    """Serialize params (fp16) + config + metadata into one npz, in the
    JAX package's ``save_g2p`` format: ``params`` is the nested variables
    tree (``{"params": {...}}``, numpy leaves; ``convert.to_jax``
    lays a port module out so), flattened to ``/`` names, floats stored as
    fp16 and other leaves as they are, beside a ``__manifest__`` JSON of
    ``config`` and ``meta``."""
    arrays = {}
    for key, value in _flatten(params):
        a = np.asarray(value)
        arrays[key] = (a.astype(np.float16)
                       if np.issubdtype(a.dtype, np.floating) else a)
    manifest = {"config": vars(cfg) if not hasattr(cfg, "__dataclass_fields__")
                else {f: getattr(cfg, f) for f in cfg.__dataclass_fields__},
                "meta": meta or {}}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, __manifest__=json.dumps(manifest), **arrays)


def _read_checkpoint(path: str | Path):
    """npz → (flat ``{"params/...": fp32 array}``, G2PConfig, meta)."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        flat = {
            k: np.asarray(z[k], np.float32)
            if z[k].dtype == np.float16 else z[k]
            for k in z.files if k != "__manifest__"
        }
    return flat, G2PConfig(**manifest["config"]), manifest.get("meta", {})


def load_g2p(path: str | Path):
    """Checkpoint → (nested params fp32, G2PConfig, meta), the tree the JAX
    package's ``load_g2p`` returns, as numpy arrays."""
    flat, cfg, meta = _read_checkpoint(path)
    params: Dict = {}
    for key, value in flat.items():
        node = params
        *parents, leaf = key.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return params, cfg, meta


class _NumpyG2P:
    """Pure-NumPy forward pass over the checkpoint's flat param dict.

    A 3M-param seq2seq decodes a word in single-digit ms on the host, which
    keeps the text frontend host-side and leaves the card to synthesis. A
    copy of the JAX package's ``_NumpyG2P`` (flax
    MultiHeadDotProductAttention conventions: kernels [E,H,D], out [H,D,E]);
    parity with it is pinned by ``tests/test_torch_g2p.py``.
    """

    def __init__(self, flat: Dict[str, np.ndarray], cfg):
        self.p = flat
        self.cfg = cfg
        self.head_dim = cfg.embed_dim // cfg.num_heads

    @staticmethod
    def _ln(x, scale, bias, eps=1e-6):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + eps) * scale + bias

    def _dense(self, x, prefix):
        return x @ self.p[f"{prefix}/kernel"] + self.p[f"{prefix}/bias"]

    def _mha(self, q_in, kv_in, prefix, mask):
        """Flax MultiHeadDotProductAttention: kernels [E,H,D], out [H,D,E];
        mask [B,Tq,Tk] boolean (True = attend)."""
        p = self.p

        def proj(x, name):
            return (
                np.einsum("bte,ehd->bthd", x, p[f"{prefix}/{name}/kernel"])
                + p[f"{prefix}/{name}/bias"]
            )

        q = proj(q_in, "query") / np.sqrt(self.head_dim).astype(np.float32)
        k = proj(kv_in, "key")
        v = proj(kv_in, "value")
        logits = np.einsum("bqhd,bkhd->bhqk", q, k)
        logits = np.where(mask[:, None, :, :], logits, np.float32(-1e10))
        w = np.exp(logits - logits.max(-1, keepdims=True))
        w = w / w.sum(-1, keepdims=True)
        out = np.einsum("bhqk,bkhd->bqhd", w, v)
        return (
            np.einsum("bqhd,hde->bqe", out, p[f"{prefix}/out/kernel"])
            + p[f"{prefix}/out/bias"]
        )

    def _ffn(self, x, prefix):
        h = np.maximum(self._dense(x, f"{prefix}/ffn_in"), 0.0)
        return self._dense(h, f"{prefix}/ffn_out")

    def _block_ln(self, x, prefix):
        return self._ln(
            x, self.p[f"{prefix}/scale"], self.p[f"{prefix}/bias"]
        )

    def encode(self, char_ids: np.ndarray):
        p, cfg = self.p, self.cfg
        valid = char_ids != 0
        x = (
            p["params/char_embedding/embedding"][char_ids]
            + p["params/char_position/embedding"][None, : char_ids.shape[1]]
        )
        mask = valid[:, :, None] & valid[:, None, :]
        for i in range(cfg.enc_blocks):
            pre = f"params/enc_{i}"
            x = self._block_ln(
                x + self._mha(x, x, f"{pre}/attention", mask),
                f"{pre}/attn_norm",
            )
            x = self._block_ln(x + self._ffn(x, pre), f"{pre}/ffn_norm")
        x = self._block_ln(x, "params/enc_norm")
        return x * valid[..., None], valid

    def decode_step(self, tokens: np.ndarray, enc, char_valid):
        """Teacher-forced logits for the full buffer (numpy mirror of
        G2PTransformer.decode)."""
        p, cfg = self.p, self.cfg
        t = tokens.shape[1]
        y = (
            p["params/phone_embedding/embedding"][tokens]
            + p["params/phone_position/embedding"][None, :t]
        )
        causal = np.tril(np.ones((t, t), bool))[None]
        causal = np.broadcast_to(causal, (tokens.shape[0], t, t))
        cross = np.broadcast_to(
            char_valid[:, None, :],
            (tokens.shape[0], t, char_valid.shape[1]),
        )
        for i in range(cfg.dec_blocks):
            pre = f"params/dec_{i}"
            y = self._block_ln(
                y + self._mha(y, y, f"{pre}/self_attention", causal),
                f"{pre}/self_norm",
            )
            y = self._block_ln(
                y + self._mha(y, enc, f"{pre}/cross_attention", cross),
                f"{pre}/cross_norm",
            )
            y = self._block_ln(y + self._ffn(y, pre), f"{pre}/ffn_norm")
        return self._dense(y, "params/out_proj")

    def _proj_heads(self, x, prefix):
        """[B, E] (or [B, T, E]) → per-head projection via [E,H,D] kernel."""
        p = self.p
        return (
            np.einsum("...e,ehd->...hd", x, p[f"{prefix}/kernel"])
            + p[f"{prefix}/bias"]
        )

    def greedy_decode(self, char_ids: np.ndarray) -> np.ndarray:
        """[B, W] int → [B, max_phone_len] tokens (BOS, phones, EOS, PAD).

        Incremental K/V-cache decode: each step projects only the NEW
        position (post-LN causality guarantees earlier positions' activations
        never change), so the whole
        word costs O(T) small matmuls instead of O(T²) full-buffer passes.
        Early-exits once every row has emitted EOS."""
        p, cfg = self.p, self.cfg
        b = char_ids.shape[0]
        t_max = cfg.max_phone_len
        enc, valid = self.encode(char_ids)
        scale = np.sqrt(self.head_dim).astype(np.float32)

        # Cross-attention K/V depend only on the encoder output.
        cross_kv = [
            (
                self._proj_heads(enc, f"params/dec_{i}/cross_attention/key"),
                self._proj_heads(enc, f"params/dec_{i}/cross_attention/value"),
            )
            for i in range(cfg.dec_blocks)
        ]
        neg = np.float32(-1e10)
        self_k = [
            np.zeros((b, t_max, cfg.num_heads, self.head_dim), np.float32)
            for _ in range(cfg.dec_blocks)
        ]
        self_v = [np.zeros_like(k) for k in self_k]

        tokens = np.zeros((b, t_max), np.int64)
        tokens[:, 0] = 1  # PHONE_BOS
        done = np.zeros((b,), bool)
        for t in range(t_max - 1):
            y = (
                p["params/phone_embedding/embedding"][tokens[:, t]]
                + p["params/phone_position/embedding"][t]
            )  # [B, E]
            for i in range(cfg.dec_blocks):
                pre = f"params/dec_{i}"
                # Causal self-attention over cached positions 0..t.
                self_k[i][:, t] = self._proj_heads(
                    y, f"{pre}/self_attention/key"
                )
                self_v[i][:, t] = self._proj_heads(
                    y, f"{pre}/self_attention/value"
                )
                q = self._proj_heads(y, f"{pre}/self_attention/query") / scale
                att = np.einsum("bhd,bkhd->bhk", q, self_k[i][:, : t + 1])
                att = att - att.max(-1, keepdims=True)
                w = np.exp(att)
                w /= w.sum(-1, keepdims=True)
                o = np.einsum("bhk,bkhd->bhd", w, self_v[i][:, : t + 1])
                o = (
                    np.einsum(
                        "bhd,hde->be", o,
                        p[f"{pre}/self_attention/out/kernel"],
                    )
                    + p[f"{pre}/self_attention/out/bias"]
                )
                y = self._ln(
                    y + o, p[f"{pre}/self_norm/scale"],
                    p[f"{pre}/self_norm/bias"],
                )
                # Cross-attention over the (fixed) character encoding.
                ck, cv = cross_kv[i]
                q = (
                    self._proj_heads(y, f"{pre}/cross_attention/query")
                    / scale
                )
                att = np.einsum("bhd,bkhd->bhk", q, ck)
                att = np.where(valid[:, None, :], att, neg)
                att = att - att.max(-1, keepdims=True)
                w = np.exp(att)
                w /= w.sum(-1, keepdims=True)
                o = np.einsum("bhk,bkhd->bhd", w, cv)
                o = (
                    np.einsum(
                        "bhd,hde->be", o,
                        p[f"{pre}/cross_attention/out/kernel"],
                    )
                    + p[f"{pre}/cross_attention/out/bias"]
                )
                y = self._ln(
                    y + o, p[f"{pre}/cross_norm/scale"],
                    p[f"{pre}/cross_norm/bias"],
                )
                h = np.maximum(self._dense(y, f"{pre}/ffn_in"), 0.0)
                y = self._ln(
                    y + self._dense(h, f"{pre}/ffn_out"),
                    p[f"{pre}/ffn_norm/scale"], p[f"{pre}/ffn_norm/bias"],
                )
            nxt = self._dense(y, "params/out_proj").argmax(-1)
            nxt = np.where(done, 0, nxt)
            tokens[:, t + 1] = nxt
            done |= nxt == 2  # PHONE_EOS
            if done.all():
                break
        return tokens


class NeuralG2P:
    """Word → ARPABET phonemes via the shipped transformer checkpoint.

    ``NeuralG2P()(word)`` returns a phone list, or ``[]`` when the model is
    unavailable (no checkpoint / load failure) or produces nothing — the
    caller falls back to the rule engine either way, so this class can never
    make the frontend worse than rules-only.
    """

    # Bounded memo (FIFO): the serving path feeds every OOV token from
    # request traffic through here, so a hostile stream of distinct words
    # must not grow memory unboundedly (same cap policy as
    # the pipeline's id cache).
    _CACHE_MAX = 4096

    def __init__(self, checkpoint: str | Path = DEFAULT_CHECKPOINT):
        self.checkpoint = Path(checkpoint)
        self._lock = threading.Lock()
        self._loaded = False
        self._failed = False
        self._cache: Dict[str, List[str]] = {}

    @staticmethod
    def available(checkpoint: str | Path = DEFAULT_CHECKPOINT) -> bool:
        return (
            os.environ.get("IRIS_NEURAL_G2P", "1") != "0"
            and Path(checkpoint).exists()
        )

    # -- lazy init -----------------------------------------------------------

    def _load(self) -> bool:
        if self._loaded:
            return True
        if self._failed:
            return False
        with self._lock:
            if self._loaded or self._failed:
                return self._loaded
            try:
                flat, cfg, meta = _read_checkpoint(self.checkpoint)
                self._net = _NumpyG2P(flat, cfg)
                self._cfg = cfg
                self._id_to_phone = {
                    i + N_SPECIAL: p for i, p in enumerate(ARPABET)
                }
                self._loaded = True
                logger.info(
                    "neural G2P loaded (%s, val PER %s)", self.checkpoint,
                    meta.get("val_per", "?"),
                )
            except Exception as e:  # noqa: BLE001 — frontend must survive
                logger.warning("neural G2P unavailable (%s); falling back "
                               "to rule G2P", e)
                self._failed = True
        return self._loaded

    # -- inference -----------------------------------------------------------

    def predict_batch(self, words: Sequence[str]) -> List[List[str]]:
        """Batched decode; unknown-character or over-long words → []."""
        out: List[List[str]] = [[] for _ in words]
        if not words or not self._load():
            return out
        todo = []  # (position, char-ids)
        for i, w in enumerate(words):
            w = w.lower()
            if w in self._cache:
                out[i] = list(self._cache[w])
                continue
            cid = encode_word(w, self._cfg.max_word_len)
            if cid is not None:
                todo.append((i, w, cid))
        if not todo:
            return out
        arr = np.asarray([cid for (_, _, cid) in todo], np.int32)
        toks = self._net.greedy_decode(arr)
        for row, (i, w, _) in enumerate(todo):
            phones = []
            for t in toks[row, 1:]:
                if t == PHONE_EOS or t < N_SPECIAL:
                    break
                phones.append(self._id_to_phone[int(t)])
            if len(self._cache) >= self._CACHE_MAX:
                self._cache.pop(next(iter(self._cache)))
            self._cache[w] = phones
            out[i] = list(phones)
        return out

    def __call__(self, word: str) -> List[str]:
        return self.predict_batch([word])[0]
