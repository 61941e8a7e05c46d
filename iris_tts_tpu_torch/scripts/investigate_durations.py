"""Duration data analysis: per-phoneme statistics and variability.

The port's counterpart of the JAX package's root
``investigate_durations.py``: per-phoneme duration mean / std / CV in
frames over the MFA alignments, the global statistics and a text
histogram (no display dependency), printed as JAX prints them.

Usage:
    python -m iris_tts_tpu_torch.scripts.investigate_durations \
        [--alignment_dir data/aligned] [--top_k 20]
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np

from iris_tts_tpu_torch.config import AudioConfig
from iris_tts_tpu_torch.data.textgrid import durations_to_frames, load_alignments


def main(argv=None) -> dict:
    """Returns ``{"utterances", "phones", "phone_types", "mean_frames",
    "median_frames", "p95_frames", "per_phone": [(phone, n, mean, std,
    cv), ...] (the printed rows), "histogram": counts of 0..30 frames}``;
    an empty dict when no TextGrid is found."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--alignment_dir", type=str, default="data/aligned")
    parser.add_argument("--top_k", type=int, default=20)
    args = parser.parse_args(argv)

    audio = AudioConfig()
    alignments = load_alignments(args.alignment_dir)
    if not alignments:
        print(f"no TextGrids found under {args.alignment_dir}")
        return {}

    per_phone = defaultdict(list)
    all_frames = []
    for phones in alignments.values():
        frames = durations_to_frames(
            phones, audio.sample_rate, audio.hop_length
        )
        for p, f in zip(phones, frames):
            per_phone[p["phone"]].append(int(f))
            all_frames.append(int(f))

    all_frames = np.array(all_frames)
    out = {"utterances": len(alignments), "phones": len(all_frames),
           "phone_types": len(per_phone),
           "mean_frames": float(all_frames.mean()),
           "median_frames": float(np.median(all_frames)),
           "p95_frames": float(np.percentile(all_frames, 95))}
    print(f"{len(alignments)} utterances, {len(all_frames)} phones, "
          f"{len(per_phone)} phone types")
    print(f"global: mean {all_frames.mean():.2f} frames "
          f"({all_frames.mean() * audio.hop_length / audio.sample_rate * 1000:.1f} ms), "
          f"median {np.median(all_frames):.0f}, "
          f"p95 {np.percentile(all_frames, 95):.0f}")

    print(f"\n{'phone':>8} {'n':>7} {'mean':>6} {'std':>6} {'CV':>5}")
    stats = []
    for phone, frames in per_phone.items():
        f = np.array(frames)
        stats.append((phone, len(f), float(f.mean()), float(f.std()),
                      float(f.std() / max(f.mean(), 1e-9))))
    out["per_phone"] = sorted(stats, key=lambda s: -s[1])[: args.top_k]
    for phone, n, mean, std, cv in out["per_phone"]:
        print(f"{phone:>8} {n:>7} {mean:>6.2f} {std:>6.2f} {cv:>5.2f}")

    # Text histogram of global durations.
    print("\nduration histogram (frames):")
    hist, edges = np.histogram(all_frames, bins=range(0, 32))
    out["histogram"] = [int(c) for c in hist]
    peak = hist.max() or 1
    for count, lo in zip(hist, edges[:-1]):
        bar = "#" * int(50 * count / peak)
        print(f"{lo:>4} | {bar} {count}")
    return out


if __name__ == "__main__":
    main()
