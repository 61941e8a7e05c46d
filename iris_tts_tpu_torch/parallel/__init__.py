"""Multi-device execution on ``torch.distributed``: data-parallel
synthesis and training, sequence-parallel vocoding
(``TTSPipeline.vocode_sharded``) and the two-stage pipeline split."""

from iris_tts_tpu_torch.parallel.mesh import (
    build_mesh,
    data_sharding,
    initialize_multihost,
    replicate_params,
    replicated,
    shard_batch,
)
from iris_tts_tpu_torch.parallel.pp import PipelineParallelSynthesizer

__all__ = [
    "PipelineParallelSynthesizer",
    "build_mesh",
    "data_sharding",
    "initialize_multihost",
    "replicate_params",
    "replicated",
    "shard_batch",
]
