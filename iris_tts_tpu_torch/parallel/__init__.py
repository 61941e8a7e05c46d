"""Multi-device execution on ``torch.distributed``: synthesis and training
over a ``(data, model)`` mesh (the batch split over the data axis, the
wide layers' output channels over the model axis: ``tp.py``,
``sharding.py``), sequence-parallel vocoding
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
