"""HTTP text-to-speech server: dynamic batching over one CUDA device.

Loads a pipeline directory written by ``TTSPipeline.save``, or builds one
with seeded random weights for smoke testing, runs every serving shape
once on the batcher's device thread (``warmup_fused``, then
``warmup_batched`` over the batch buckets), and serves:

    POST /synthesize         {"text": "..."}  → audio/wav
    POST /synthesize_stream  {"text": "..."}  → chunked PCM16LE
    GET  /healthz, /stats

Usage:
    python -m iris_tts_tpu_torch.serve --pipeline outputs/exported --port 8080
    python -m iris_tts_tpu_torch.serve --random_weights --port 8080

Not here yet: ahead-of-time executables (the JAX package's ``--aot``;
per-bucket CUDA graphs are their planned counterpart) and data-parallel
serving over several devices (``--mesh``).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from iris_tts_tpu_torch.config import load_config
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.serve.server import serve_forever

logger = logging.getLogger("iris_tts_tpu_torch.serve")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--pipeline", type=Path,
                        help="pipeline directory (TTSPipeline.save)")
    parser.add_argument("--random_weights", action="store_true",
                        help="serve an untrained pipeline (smoke testing)")
    parser.add_argument("--config", type=Path, default=None,
                        help="IrisConfig JSON of this package for "
                        "--random_weights (default: IrisConfig())")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max_batch", type=int, default=8,
                        help="dispatch cap under light load")
    parser.add_argument("--max_batch_limit", type=int, default=None,
                        help="adaptive growth ceiling: sustained queue depth "
                        "doubles the effective batch from --max_batch toward "
                        "this; every extra batch bucket is warmed up before "
                        "serving (default: no growth)")
    parser.add_argument("--max_wait_ms", type=float, default=5.0)
    parser.add_argument("--request_timeout_s", type=float, default=600.0)
    parser.add_argument("--max_queue", type=int, default=256,
                        help="queue-depth admission limit: requests past it "
                        "get HTTP 503 + Retry-After (backpressure)")
    parser.add_argument("--float_transfer", action="store_true",
                        help="copy float32 audio to the host instead of "
                        "quantizing to PCM16 on the device (PCM16 halves "
                        "the device→host bytes)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    if args.pipeline:
        pipe = TTSPipeline.load(args.pipeline, device=args.device)
    elif args.random_weights:
        config = load_config(args.config) if args.config else None
        pipe = TTSPipeline.initialize(config, device=args.device)
    else:
        parser.error("need --pipeline DIR or --random_weights")
    logger.info("pipeline on %s", pipe.device)
    serve_forever(pipe, host=args.host, port=args.port,
                  max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                  request_timeout_s=args.request_timeout_s,
                  pcm16_transfer=not args.float_transfer,
                  max_queue=args.max_queue,
                  max_batch_limit=args.max_batch_limit)


if __name__ == "__main__":
    main()
