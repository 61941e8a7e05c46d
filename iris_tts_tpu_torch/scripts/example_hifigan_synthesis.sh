#!/usr/bin/env bash
# End-to-end synthesis with a pretrained HiFiGAN vocoder, through the
# PyTorch port (iris_tts_tpu_torch).
#
# Usage: example_hifigan_synthesis.sh [TEXT] [OUT_WAV]
#
# Prerequisites:
#   - trained stage checkpoints under outputs/ (train_full_pipeline or the
#     per-stage drivers of iris_tts_tpu_torch.scripts)
#   - a torch HiFiGAN generator.ckpt (e.g. speechbrain's
#     tts-hifigan-ljspeech) at models/hifigan/generator.ckpt; it is
#     converted to the port's generator on load
# It runs on the CUDA device; set DEVICE=cpu to run on the CPU.
set -euo pipefail

TEXT="${1:-Hello world, this is Iris running natively on the GPU.}"
OUT="${2:-outputs/sample_hifigan.wav}"

python -m iris_tts_tpu_torch.scripts.synthesize \
    --text "$TEXT" \
    --output_wav "$OUT" \
    --encoder_checkpoint outputs/encoder/checkpoints \
    --vae_checkpoint outputs/vae/checkpoints \
    --postnet_checkpoint outputs/postnet/checkpoints \
    --hifigan_checkpoint models/hifigan/generator.ckpt \
    ${DEVICE:+--device "$DEVICE"}

echo "wrote $OUT"
