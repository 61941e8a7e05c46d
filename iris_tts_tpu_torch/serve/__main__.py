"""HTTP text-to-speech server: dynamic batching over one CUDA device.

Loads an ahead-of-time artifact directory (``--aot``, written by ``python
-m iris_tts_tpu_torch.serve.export``: no model code, each bucket's program
captured once as a CUDA graph and replayed), a pipeline directory written
by ``TTSPipeline.save``, or builds one with seeded random weights for smoke
testing. A live pipeline runs every serving shape once on the batcher's
device thread (``warmup_fused``, then ``warmup_batched`` over the batch
buckets); an artifact's programs are captured smallest first, the rest in
the background unless ``--full_warmup``. Then it serves:

    POST /synthesize         {"text": "..."}  → audio/wav
    POST /synthesize_stream  {"text": "..."}  → chunked PCM16LE
    GET  /healthz, /stats

Usage:
    python -m iris_tts_tpu_torch.serve --aot outputs/aot --port 8080
    python -m iris_tts_tpu_torch.serve --pipeline outputs/exported --port 8080
    python -m iris_tts_tpu_torch.serve --random_weights --port 8080
    torchrun --nproc_per_node 4 -m iris_tts_tpu_torch.serve --mesh \
        --pipeline outputs/exported --port 8080

``--mesh`` serves data-parallel over the processes of a
``torch.distributed`` group (torchrun's environment, one process a
device; ``TTSPipeline.use_mesh``, as the JAX package's ``--mesh``): world
rank 0 runs the batcher and the HTTP server, and every other rank follows
its device calls (``serve/mesh.py``). ``--backend gloo`` runs several ranks
on one card (NCCL refuses that). ``--mesh`` with ``--aot`` is refused.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch.distributed as dist

from iris_tts_tpu_torch.config import load_config
from iris_tts_tpu_torch.models.pipeline import TTSPipeline
from iris_tts_tpu_torch.serve.server import serve_forever

logger = logging.getLogger("iris_tts_tpu_torch.serve")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--aot", type=Path,
                        help="artifact directory (python -m "
                        "iris_tts_tpu_torch.serve.export): no model code")
    parser.add_argument("--pipeline", type=Path,
                        help="pipeline directory (TTSPipeline.save, this "
                        "package's or the JAX package's)")
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
    parser.add_argument("--full_warmup", action="store_true",
                        help="--aot: capture every program before serving "
                        "(default: the smallest bucket, the rest in the "
                        "background)")
    parser.add_argument("--mesh", action="store_true",
                        help="data-parallel serving over the processes of "
                        "the torch.distributed group (TTSPipeline.use_mesh): "
                        "rank 0 serves, the other ranks follow its device "
                        "calls")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="--mesh: the process group's backend (default: "
                        "nccl on the card, gloo on the CPU; gloo takes "
                        "several ranks on one card)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.mesh and args.aot:
        parser.error("--mesh applies to live pipelines, not --aot artifacts")
    if args.mesh:
        from iris_tts_tpu_torch.parallel.mesh import initialize_multihost

        initialize_multihost(backend=args.backend, device=args.device)
        if not dist.is_initialized():
            parser.error("--mesh needs a process group: launch under "
                         "torchrun (RANK, WORLD_SIZE, MASTER_ADDR, "
                         "MASTER_PORT)")

    if args.aot:
        from iris_tts_tpu_torch.serve.export import AotPipeline

        pipe = AotPipeline(args.aot, device=args.device)
        top = max(pipe.batch_buckets)
        if args.max_batch > top:
            logger.info("clamping max_batch %d -> %d (largest exported "
                        "batch bucket)", args.max_batch, top)
            args.max_batch = top
        if args.max_batch_limit and args.max_batch_limit > top:
            args.max_batch_limit = top
        t0 = time.monotonic()
        n = pipe.warmup(block=args.full_warmup)
        logger.info("AOT warmup: %d of %d programs captured in %.1f s (%s)",
                    n, len(pipe._programs), time.monotonic() - t0,
                    "all up front" if args.full_warmup
                    else "the rest in the background")
    elif args.pipeline:
        pipe = TTSPipeline.load(args.pipeline, device=args.device)
    elif args.random_weights:
        config = load_config(args.config) if args.config else None
        pipe = TTSPipeline.initialize(config, device=args.device)
    else:
        parser.error("need --aot DIR, --pipeline DIR or --random_weights")
    logger.info("pipeline on %s", pipe.device)
    leader = None
    if args.mesh:
        from iris_tts_tpu_torch.ops.mel_cuda import log_mel_cuda
        from iris_tts_tpu_torch.parallel.mesh import is_primary
        from iris_tts_tpu_torch.serve.mesh import MeshLeader, follow

        pipe.use_mesh()
        if not is_primary(pipe._mesh):
            logger.info("mesh follower %d of %s: following rank 0",
                        pipe._mesh.world_rank, pipe._mesh.shape)
            logger.info("mesh follower: %d device calls, %d log-mel "
                        "launches", follow(pipe), log_mel_cuda.launches)
            return
        pipe = leader = MeshLeader(pipe)
    try:
        serve_forever(pipe, host=args.host, port=args.port,
                      max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                      request_timeout_s=args.request_timeout_s,
                      pcm16_transfer=not args.float_transfer,
                      max_queue=args.max_queue,
                      max_batch_limit=args.max_batch_limit)
    finally:
        if leader is not None:
            leader.stop()
            logger.info("mesh leader: %d device calls, %d log-mel launches",
                        leader.calls, log_mel_cuda.launches)


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
