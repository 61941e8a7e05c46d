"""Train the neural G2P transformer on the shipped CMUdict.

The port of the JAX package's ``scripts/train_g2p.py``: a deterministic 2%
validation split by word CRC, AdamW (decay on every parameter, no
clipping) under optax's warmup-cosine schedule, masked cross-entropy, and
greedy-decoded PER / word exact-match every ``--eval_every`` epochs. The
whole dataset lives on the device; each epoch takes one host permutation
from ``np.random.default_rng(seed)`` (the JAX script's batch order) and
reads its mean loss back once, at the epoch's end.

The checkpoint is the JAX package's format (``text.neural_g2p.save_g2p``:
fp16 params and a JSON manifest), read by both packages' ``load_g2p`` and
``NeuralG2P``. The default ``--output`` is the port's shipped checkpoint,
``iris_tts_tpu_torch/text/data/g2p_transformer.npz``.

Usage:
    python -m iris_tts_tpu_torch.scripts.train_g2p --output g2p.npz
"""

from __future__ import annotations

import argparse
import logging
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from iris_tts_tpu_torch.convert.to_jax import jax_params_from_module
from iris_tts_tpu_torch.models.g2p import G2PTransformer, greedy_decode
from iris_tts_tpu_torch.models.layers import init_params
from iris_tts_tpu_torch.runtime import (
    pin_math_precision,
    resolve_device,
    seeded_generator,
)
from iris_tts_tpu_torch.scripts.common import add_device_arg, setup_logging
from iris_tts_tpu_torch.text.lexicon import ARPABET, Lexicon
from iris_tts_tpu_torch.text.neural_g2p import (
    DEFAULT_CHECKPOINT,
    N_SPECIAL,
    PHONE_BOS,
    PHONE_EOS,
    PHONE_PAD,
    G2PConfig,
    encode_word,
    save_g2p,
)
from iris_tts_tpu_torch.train.schedules import warmup_cosine_decay_schedule
from iris_tts_tpu_torch.train.state import TrainState, Tx

logger = logging.getLogger(__name__)


def build_dataset(cfg: G2PConfig, max_entries: int = 0):
    """CMUdict table → (chars [N,W], phone_in [N,T], phone_out [N,T],
    is_val [N]) int32/bool numpy arrays.

    Deterministic 2% validation split by word CRC, so the held-out set is
    stable across runs and packages."""
    phone_to_id = {p: N_SPECIAL + i for i, p in enumerate(ARPABET)}
    table = Lexicon()._table
    words = sorted(table)
    if max_entries:
        words = words[:: max(1, len(words) // max_entries)]

    chars, pin, pout, is_val = [], [], [], []
    w_max, t_max = cfg.max_word_len, cfg.max_phone_len
    for word in words:
        cid = encode_word(word, w_max)
        phones = table[word]
        if cid is None or len(phones) + 2 > t_max:
            continue
        pid = [phone_to_id.get(p) for p in phones]
        if any(p is None for p in pid):
            continue
        seq_in = [PHONE_BOS] + pid
        seq_out = pid + [PHONE_EOS]
        pad = t_max - len(seq_in)
        chars.append(cid)
        pin.append(seq_in + [PHONE_PAD] * pad)
        pout.append(seq_out + [PHONE_PAD] * pad)
        is_val.append(zlib.crc32(word.encode()) % 50 == 0)
    return (
        np.asarray(chars, np.int32),
        np.asarray(pin, np.int32),
        np.asarray(pout, np.int32),
        np.asarray(is_val, bool),
    )


def phone_error_rate(pred: list, ref: list) -> int:
    """Levenshtein distance between two phone sequences."""
    m, n = len(pred), len(ref)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev, dp[0] = dp[0], i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(
                dp[j] + 1, dp[j - 1] + 1,
                prev + (pred[i - 1] != ref[j - 1]),
            )
            prev = cur
    return dp[n]


def decode_tokens(model: G2PTransformer, chars: np.ndarray,
                  batch: int = 512) -> np.ndarray:
    """Greedy-decode ``chars`` [N, W] in batches on the model's device →
    [N, max_phone_len] int32 tokens on the host."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        out = [greedy_decode(model, torch.from_numpy(
            np.ascontiguousarray(chars[i:i + batch], np.int64)).to(device)
        ).cpu().numpy() for i in range(0, chars.shape[0], batch)]
    finally:
        model.train(was_training)
    if not out:
        return np.zeros((0, model.config.max_phone_len), np.int32)
    return np.concatenate(out)


def score_tokens(toks: np.ndarray, pout: np.ndarray):
    """(PER, word exact-match) of decoded tokens against the targets."""
    err = tot = exact = 0
    for row, ref_row in zip(toks, pout):
        pred = []
        for t in row[1:]:
            if t == PHONE_EOS or t < N_SPECIAL:
                break
            pred.append(int(t))
        ref = [int(t) for t in ref_row if t >= N_SPECIAL]
        err += phone_error_rate(pred, ref)
        tot += len(ref)
        exact += pred == ref
    return err / max(tot, 1), exact / max(len(toks), 1)


def evaluate(model: G2PTransformer, chars_val: np.ndarray,
             pout_val: np.ndarray, batch: int = 512):
    """Greedy-decode the validation split; return (PER, word
    exact-match)."""
    return score_tokens(decode_tokens(model, chars_val, batch), pout_val)


def loss_fn(model: G2PTransformer, chars: torch.Tensor,
            phone_in: torch.Tensor, phone_out: torch.Tensor,
            deterministic: bool = False,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean cross-entropy over the positions whose target is not PAD."""
    logits = model(chars, phone_in, deterministic, generator)
    mask = (phone_out != PHONE_PAD).float()
    ce = F.cross_entropy(logits.flatten(0, 1).float(),
                         phone_out.flatten().long(), reduction="none")
    return (ce * mask.flatten()).sum() / mask.sum().clamp_min(1.0)


def make_state(cfg: G2PConfig, seed: int, device, lr: float,
               weight_decay: float, warmup_steps: int,
               total_steps: int) -> TrainState:
    """A seeded model on ``device`` under AdamW (decay on every parameter,
    no clipping) with optax's warmup-cosine schedule from 0 to ``lr`` and
    down to ``lr / 100``."""
    model = G2PTransformer(cfg)
    init_params(model, seeded_generator(seed, "cpu"))
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup_steps, total_steps,
                                         end_value=lr * 1e-2)
    return TrainState.create(model.to(device),
                             Tx(sched, clip_norm=None,
                                weight_decay=weight_decay), seed + 1)


def train_step(state: TrainState, chars, phone_in, phone_out,
               deterministic: bool = False) -> torch.Tensor:
    """One AdamW update; returns the loss as a device tensor (no host
    sync)."""
    state.params.train()
    loss = loss_fn(state.params, chars, phone_in, phone_out, deterministic,
                   state.generator)
    loss.backward()
    state.apply_gradients()
    return loss.detach()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output", type=Path, default=DEFAULT_CHECKPOINT)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--embed_dim", type=int, default=192)
    parser.add_argument("--enc_blocks", type=int, default=3)
    parser.add_argument("--dec_blocks", type=int, default=3)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--warmup_frac", type=float, default=0.05)
    parser.add_argument("--label_smoothing", type=float, default=0.0,
                        help="accepted and not applied, as by the JAX "
                        "package's script")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval_every", type=int, default=10)
    parser.add_argument("--max_entries", type=int, default=0,
                        help="subsample the dict (smoke tests)")
    add_device_arg(parser)
    return parser


def main(argv=None) -> dict:
    """Trains, writes ``--output`` and returns a summary: the epochs' mean
    losses and seconds, steps a epoch, the final val PER and exact match,
    and the train state."""
    args = build_parser().parse_args(argv)
    setup_logging()
    device = resolve_device(args.device)
    pin_math_precision()

    cfg = G2PConfig(embed_dim=args.embed_dim, enc_blocks=args.enc_blocks,
                    dec_blocks=args.dec_blocks)
    chars, pin, pout, is_val = build_dataset(cfg, args.max_entries)
    tr = ~is_val
    chars_val, pout_val = chars[is_val], pout[is_val]
    n_train = int(tr.sum())
    logger.info("dataset: %d train / %d val entries", n_train,
                chars_val.shape[0])

    b = min(args.batch_size, n_train)
    steps_per_epoch = n_train // b
    total_steps = steps_per_epoch * args.epochs
    state = make_state(cfg, args.seed, device, args.lr, args.weight_decay,
                       int(total_steps * args.warmup_frac), total_steps)
    model = state.params
    logger.info("model: %.2fM params",
                sum(p.numel() for p in model.parameters()) / 1e6)

    # The dataset stays on the device; a step gathers its rows there.
    dc, dpi, dpo = (torch.from_numpy(a[tr].astype(np.int64)).to(device)
                    for a in (chars, pin, pout))
    shuffle_rng = np.random.default_rng(args.seed)
    losses, epoch_s = [], []
    t_start = time.perf_counter()
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        perm = torch.from_numpy(
            shuffle_rng.permutation(n_train).astype(np.int64)).to(device)
        step_losses = []
        for i in range(steps_per_epoch):
            idx = perm[i * b:(i + 1) * b]
            step_losses.append(train_step(state, dc[idx], dpi[idx],
                                          dpo[idx]))
        loss = float(torch.stack(step_losses).mean())  # one fetch an epoch
        epoch_s.append(time.perf_counter() - t0)
        losses.append(loss)
        logger.info("epoch %3d/%d  loss %.4f  (%.1fs)", epoch + 1,
                    args.epochs, loss, time.perf_counter() - t_start)
        if (epoch + 1) % args.eval_every == 0 or epoch + 1 == args.epochs:
            per, exact = evaluate(model, chars_val, pout_val)
            logger.info("  val PER %.4f  word exact-match %.3f", per, exact)
    if not losses:  # the last epoch evaluated already
        per, exact = evaluate(model, chars_val, pout_val)
    save_g2p(args.output, {"params": jax_params_from_module(model)}, cfg,
             meta={"val_per": round(per, 4),
                   "val_exact": round(exact, 4),
                   "train_entries": n_train,
                   "epochs": args.epochs})
    logger.info("saved %s  (val PER %.4f, exact %.3f)", args.output, per,
                exact)
    return {"losses": losses, "epoch_s": epoch_s,
            "steps_per_epoch": steps_per_epoch, "val_per": per,
            "val_exact": exact, "train_entries": n_train, "state": state}


if __name__ == "__main__":
    main()
