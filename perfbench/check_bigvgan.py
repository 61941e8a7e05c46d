"""Whether what the timed path produced is correct, for a configuration
whose vocoder is BigVGAN-v2: ``check.py``'s comparison, number for number
and rule for rule, with the plain BigVGAN reference
(``reference/bigvgan.py``) in place of the reference HiFiGAN.

The acoustic model is the frozen reference of ``reference/model.py``
(encoder, duration head, VAE, PostNet) on the parameter tree's acoustic
modules; the vocoder is the reference BigVGAN on the vocoder's state dict
(weight norm folded, the names NVIDIA's). See ``check.py`` for what each
number is: ``ids_bad_rows``, ``bucket_bad``, ``frames_bad_rows``
(counts), ``dur_gap``, ``mel_gap`` and ``wave_gap`` (:func:`wave_gap`: the
widest gap over a row's real samples as a share of the batch's reference
peak).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn

from perfbench.check import COUNTS, GAPS, _gap
from perfbench.reference.bigvgan import BigVGAN
from perfbench.reference.frontend import Frontend, read_lexicon
from perfbench.reference.model import (
    DurationPredictor,
    PhonemeEncoder,
    PostNet,
    TextConditionedVAE,
    durations_from_log,
    length_regulate,
    pick_bucket,
    pin_f32,
    round_up,
    state_dict_from_flax,
)


class Acoustic(nn.Module):
    """The reference's encoder, duration head, VAE and PostNet, under the
    parameter tree's names."""

    def __init__(self, model_cfg: Dict[str, Dict[str, Any]]):
        super().__init__()
        self.encoder = PhonemeEncoder(model_cfg["encoder"])
        self.duration = DurationPredictor(model_cfg["encoder"]["embed_dim"],
                                          model_cfg["duration"])
        self.vae = TextConditionedVAE(model_cfg["vae"])
        self.postnet = PostNet(model_cfg["postnet"])


def reference_models(cfg: Dict[str, Any], tree: Dict[str, Any],
                     vocoder: Dict[str, torch.Tensor], device: torch.device):
    """(acoustic model, BigVGAN) of the reference on ``tree`` (no
    ``hifigan``) and ``vocoder``, on ``device``, in eval mode."""
    acoustic = Acoustic(cfg["model"])
    acoustic.load_state_dict(state_dict_from_flax(tree, acoustic),
                             strict=True)
    bigvgan = BigVGAN(cfg["model"]["hifigan"])
    sd = dict(bigvgan.state_dict())  # the filter buffers
    sd.update(vocoder)
    bigvgan.load_state_dict(sd, strict=True)
    return acoustic.to(device).eval(), bigvgan.to(device).eval()


def wave_gap(program: Sequence, reference: np.ndarray,
             n_frames: Sequence[int], hop: int) -> float:
    """The widest gap between each row's program waveform and the
    reference's over its ``n * hop`` real samples, as a share of the
    largest reference sample over those; a row with no program audio is
    skipped (``frames_bad_rows`` counts it)."""
    peak = max(float(np.abs(a[: n * hop]).max(initial=0.0))
               for a, n in zip(reference, n_frames))
    out = 0.0
    for r, n in enumerate(n_frames):
        a_prog = program[r]
        if a_prog is None:
            continue
        m = min(len(a_prog), n * hop)
        gap = np.abs(a_prog[:m] - reference[r, :m]).max(initial=0.0)
        out = max(out, _gap(gap / max(peak, 1e-12)))
    return out


@torch.inference_mode()
def compare(cfg: Dict[str, Any], tree: Dict[str, Any],
            vocoder: Dict[str, torch.Tensor], vocab: Dict[str, int],
            batches: List[Dict[str, Any]], device: torch.device
            ) -> Dict[str, float]:
    """The numbers compared, over every batch of ``batches`` (the keys of
    ``check.compare``'s batches)."""
    pin_f32()
    model, bigvgan = reference_models(cfg, tree, vocoder, device)
    frontend = Frontend(read_lexicon(), vocab)
    vae = cfg["model"]["vae"]
    down, latent = 2 ** vae["down_stages"], vae["latent_dim"]
    hop = int(np.prod(cfg["model"]["hifigan"]["upsample_rates"]))
    p_buckets, t_buckets = cfg["buckets"]["phoneme"], cfg["buckets"]["frame"]
    out = {k: 0 for k in COUNTS}
    out.update({k: 0.0 for k in GAPS})
    for b in batches:
        rows = [frontend.ids(t) for t in b["texts"]]
        p = pick_bucket(max(len(r) for r in rows), p_buckets)
        ids = np.full((len(rows), p), frontend.pad, np.int64)
        lengths = np.array([min(len(r), p) for r in rows])
        for i, r in enumerate(rows):
            ids[i, :lengths[i]] = r[:p]
        same = [(int((c_ids == ids).all(axis=1).sum()), c_log)
                for c_ids, c_log in b["candidates"]
                if c_ids.shape == ids.shape]
        if not same:
            out["ids_bad_rows"] += len(rows)
            continue
        matched, prog_log = max(same, key=lambda m: m[0])
        out["ids_bad_rows"] += len(rows) - matched
        ids_t = torch.from_numpy(ids).to(device)
        valid = (torch.arange(p, device=device)[None]
                 < torch.from_numpy(lengths).to(device)[:, None])
        enc = model.encoder(ids_t, valid)
        log_dur = model.duration(enc)
        prog_log = torch.from_numpy(prog_log).to(device)
        out["dur_gap"] = max(out["dur_gap"], _gap(
            torch.where(valid, (prog_log - log_dur).abs(), 0.0).max()))

        dur = durations_from_log(prog_log) * valid
        totals = dur.sum(dim=1).cpu().numpy()
        mel_prog = np.asarray(b["mel"])
        t = mel_prog.shape[1]
        want_t = pick_bucket(round_up(max(int(totals.max()), down), down),
                             t_buckets)
        out["bucket_bad"] += int(t != want_t)
        n_frames = np.minimum(totals, t)
        audio_prog = b["audio"]
        out["frames_bad_rows"] += int(sum(
            a is None or len(a) != n * hop
            for a, n in zip(audio_prog, n_frames)))

        gen = torch.Generator(device=device)
        gen.manual_seed(int(b["seed"]))
        z = torch.randn((len(rows), latent, t // down), generator=gen,
                        device=device, dtype=torch.float32)
        mel = model.postnet(model.vae.generate(
            length_regulate(enc, dur, t), z))
        audio = bigvgan(mel).cpu().numpy()
        mel = mel.cpu().numpy()
        for r, n in enumerate(n_frames):
            out["mel_gap"] = max(out["mel_gap"], _gap(
                np.abs(mel_prog[r, :n] - mel[r, :n]).max(initial=0.0)))
        out["wave_gap"] = max(out["wave_gap"],
                              wave_gap(audio_prog, audio, n_frames, hop))
    return out
