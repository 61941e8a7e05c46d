"""Generate the formant-synthesized training corpus (LJSpeech layout):
real English sentences rendered by a Klatt-style formant synthesizer with
exact ground-truth alignments (``data/synthetic_speech.py``), the corpus
the training drivers run on when LJSpeech itself is not at hand.

Usage:
    python -m iris_tts_tpu_torch.scripts.make_synthetic_corpus \
        --root data_synth --n 600
"""

from __future__ import annotations

import argparse

from iris_tts_tpu_torch.data.synthetic_speech import (
    CorpusSpec,
    generate_corpus,
)
from iris_tts_tpu_torch.runtime import resolve_device
from iris_tts_tpu_torch.scripts.common import (
    add_device_arg,
    setup_logging,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", type=str, default="data_synth")
    parser.add_argument("--n", type=int, default=600)
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--verbose", action="store_true")
    add_device_arg(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging(args.verbose)
    # The corpus is rendered on the host; the device is resolved all the
    # same, so every driver fails alike where the card it defaults to is
    # missing.
    resolve_device(args.device)
    root, align = generate_corpus(
        args.root, CorpusSpec(n_utterances=args.n, seed=args.seed))
    print(f"corpus: {root}")
    print(f"alignments: {align}")
    return root, align


if __name__ == "__main__":
    main()
