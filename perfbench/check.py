"""Whether what the timed path produced is correct: the program's batches
against the plain reference, after the window.

For each sampled batch the harness hands over what the program made at
the timed sizes: the padded phoneme ids and the duration head's
log-durations of each stage-A call of its job (``candidates``), the mel after the VAE's prior sample and the
PostNet, each row's trimmed waveform, and the batch's seed. The
reference (float32, TF32 off, its own frontend, model and weights) then:

1. phonemizes the batch's texts and pads them to its own phoneme bucket,
   and takes the stage-A call whose ids match the most rows:
   ``ids_bad_rows`` counts the rows whose ids differ (limit 0);
2. runs its encoder and duration head on those ids: ``dur_gap`` is the
   widest gap between the two log-durations;
3. follows the program's durations from here, rounded by the model's
   rule, since a log-duration within rounding of a half frame may round
   either way (PERF.md says so): the frame bucket must be the one those
   durations pick (``bucket_bad``, limit 0) and each row's waveform
   must be there and hold exactly its frames (``frames_bad_rows``, limit
   0);
4. regulates its own encoder output by those durations, draws the prior
   noise from the batch's seed as the program's two-stage path does, and
   runs the VAE, PostNet and HiFiGAN: ``mel_gap`` is the widest gap over
   real frames, ``wave_gap`` the widest gap over each row's samples as a
   share of the batch's reference peak.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.reference.frontend import Frontend, read_lexicon
from perfbench.reference.model import (
    SynthesisModel,
    durations_from_log,
    length_regulate,
    pick_bucket,
    pin_f32,
    round_up,
    state_dict_from_flax,
)

COUNTS = ("ids_bad_rows", "bucket_bad", "frames_bad_rows")
GAPS = ("dur_gap", "mel_gap", "wave_gap")


def _gap(x) -> float:
    """A gap that is not a finite number (a NaN) counts as infinite."""
    x = float(x)
    return x if np.isfinite(x) else float("inf")


def reference_model(cfg: Dict[str, Any], tree: Dict[str, Any],
                    device: torch.device) -> SynthesisModel:
    model = SynthesisModel(cfg["model"])
    model.load_state_dict(state_dict_from_flax(tree, model), strict=True)
    return model.to(device).eval()


@torch.inference_mode()
def compare(cfg: Dict[str, Any], tree: Dict[str, Any], vocab: Dict[str, int],
            batches: List[Dict[str, Any]], device: torch.device
            ) -> Dict[str, float]:
    """The numbers compared, over every batch of ``batches`` (see the
    module docstring for each batch's keys)."""
    pin_f32()
    model = reference_model(cfg, tree, device)
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
        # the job's stage-A call whose ids match the most rows
        same = [(int((c_ids == ids).all(axis=1).sum()), c_log)
                for c_ids, c_log in b["candidates"] if c_ids.shape == ids.shape]
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
        audio = model.hifigan(mel).cpu().numpy()
        mel = mel.cpu().numpy()
        peak = max(float(np.abs(a[: n * hop]).max(initial=0.0))
                   for a, n in zip(audio, n_frames))
        for r, n in enumerate(n_frames):
            out["mel_gap"] = max(out["mel_gap"], _gap(
                np.abs(mel_prog[r, :n] - mel[r, :n]).max(initial=0.0)))
            a_prog = audio_prog[r]
            if a_prog is None:  # counted in frames_bad_rows
                continue
            m = min(len(a_prog), n * hop)
            gap = np.abs(a_prog[:m] - audio[r, :m]).max(initial=0.0)
            out["wave_gap"] = max(out["wave_gap"],
                                  _gap(gap / max(peak, 1e-12)))
    return out
